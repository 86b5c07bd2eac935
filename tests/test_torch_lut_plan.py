"""The K split of the shared gather body (K1-K8, ``csrc/fused_gather.cuh``)
held on the CPU through its mirror ``fused_matmul.k_split``, and its
arithmetic through a plain emulation.

* Plan: at the ten layer shapes of a 64-image ResNet-8 forward and at
  ragged K, with 1, 12 and 17 lanes, the work units the persistent blocks
  walk (the even split of ``split_starts``, each unit decoded as the
  kernel decodes it) cover every (lane, tile, KC chunk) exactly once; one
  lane at the deep layers (4096 x 288 x 64, 4096 x 576 x 64) takes two K
  ranges; a split is taken only where it shortens the busiest block.
* Sums: partial LUT-gather sums per K range, added mod 2^32 in a shuffled
  order (as the kernels' ``red.global.add`` lands them), equal the whole
  sum of the plain version and of the JAX reference bit for bit, codes
  whose int32 sums wrap included; the composed limbs likewise.
* On the card (``gpu``): K1, K3, K5 and K7 at shapes that take the split
  against their plain versions.  JAX is imported only by the CPU tests,
  so ``pytest -m gpu`` runs on a machine without it."""
import re
from collections import Counter

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.kernels import build, ref
from repro_torch.kernels import fused_matmul as fm
from repro_torch.launch.case_study import main_path_shapes
from repro_torch.models import resnet

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRID = 132                                  # an H100's SMs
LAYERS = main_path_shapes(resnet.resnet_config(8), 64)
CASES = {f"{label} x{lanes}": (lanes, *mkn)
         for label, mkn in LAYERS.items() for lanes in (1, 12, 17)}
CASES.update({f"ragged K={k} {m}x{n} x{lanes}": (lanes, m, k, n)
              for k in (16, 27, 33, 576) for m, n in ((4096, 64), (64, 10))
              for lanes in (1, 12, 17)})
# single-lane shapes that take the split: the deep layers, a ragged K
# whose last range is short (4 chunks, the last of 4 codes) and many
# ranges with a one-code last chunk
SPLIT_SHAPES = [(4096, 576, 64), (4096, 288, 64), (4096, 100, 64),
                (512, 577, 64)]


def _blocks(plan: fm.KSplit, grid: int = GRID):
    """Each block's work units: the kernels' even split of the units
    (``range_start`` with equal lanes) as ``split_starts`` mirrors it."""
    starts = fm.split_starts([1] * plan.lanes, plan.tiles * plan.splits,
                             grid)
    return [[plan.unit(u) for u in range(starts[b], starts[b + 1])]
            for b in range(grid)]


def _busiest(plan: fm.KSplit) -> int:
    """KC chunks the busiest block sums."""
    return max(sum(len(c) for _, _, c in units) for units in _blocks(plan))


@pytest.mark.parametrize("case", list(CASES))
def test_k_split_covers_every_chunk_once(case):
    plan = fm.k_split(*CASES[case], GRID)
    assert 1 <= plan.splits <= max(plan.chunks, 1)
    seen = Counter((lane, tile, c) for units in _blocks(plan)
                   for lane, tile, chunks in units for c in chunks)
    assert set(seen.values()) == {1}
    assert len(seen) == plan.items * plan.chunks
    assert all(len(c) for units in _blocks(plan) for _, _, c in units)


@pytest.mark.parametrize("k", [288, 576])
def test_k_split_halves_the_deep_layers(k):
    plan = fm.k_split(1, 4096, k, 64, GRID)
    assert (plan.items, plan.splits) == (64, 2)
    chunks = k // fm.KC
    assert _busiest(plan._replace(splits=1)) == chunks
    assert _busiest(plan) == chunks // 2 + chunks % 2


@pytest.mark.parametrize("case", list(CASES))
def test_k_split_only_where_it_shortens_the_busiest_block(case):
    plan = fm.k_split(*CASES[case], GRID)
    if plan.items >= GRID:                  # every block has an item
        assert plan.splits == 1
        return
    walked = [_busiest(plan._replace(splits=s))
              for s in range(1, plan.chunks + 1)] or [0]
    # the first count that gives the least busiest block; 1 where no
    # split shortens it
    assert plan.splits == walked.index(min(walked)) + 1
    if plan.splits > 1:
        assert walked[plan.splits - 1] < walked[0]


def test_k_split_mirror_uses_the_kernels_constants():
    src = (build.CSRC / "fused_gather.cuh").read_text()
    for name, value in (("kThreads", fm.THREADS), ("kNT", fm.NT),
                        ("kKC", fm.KC)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1)) == value


def _ranges(plan: fm.KSplit, k: int) -> list[tuple[int, int]]:
    """The K ranges [k0, k1) of one item's units."""
    return [(c[0] * fm.KC, min(k, (c[-1] + 1) * fm.KC))
            for c in (plan.unit(u)[2] for u in range(plan.splits))]


def _add_shuffled(parts, seed: int) -> torch.Tensor:
    """Partial int32 sums added mod 2^32 in a shuffled order."""
    order = np.random.default_rng(seed).permutation(len(parts))
    acc = torch.zeros_like(parts[0], dtype=torch.int64)
    for i in order:
        acc = (acc + parts[i].to(torch.int64)) & 0xFFFFFFFF
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


EMULATED = {"deep conv2": (64, 576, 64, 4096), "ragged": (40, 100, 64, 4096),
            "head": (64, 64, 10, 64), "one-code chunks": (9, 577, 7, 512),
            "wrapping sums": (2, 33000, 3, 2)}


@pytest.mark.parametrize("case", list(EMULATED))
def test_split_sums_equal_the_plain_and_reference_sums(case):
    from repro.kernels.ref import approx_matmul_lut_ref
    m, k, n, plan_m = EMULATED[case]
    # the split the kernel takes at plan_m rows (the emulation sums every
    # row the same way)
    plan = fm.k_split(1, plan_m, k, n, GRID)
    assert plan.splits > 1
    rng = np.random.default_rng(k)
    qa = rng.integers(0, 256, (m, k)).astype(np.int32)
    qw = rng.integers(0, 256, (k, n)).astype(np.int32)
    lut = rng.integers(0, 1 << 16, (256, 256)).astype(np.int32)
    if case == "wrapping sums":
        lut[:] = (1 << 16) - 1              # 65535 * 33000 > 2^31
    ta, tw, tl = (torch.from_numpy(a) for a in (qa, qw, lut))
    parts = [ref.approx_matmul_lut_ref(ta[:, k0:k1].contiguous(),
                                       tw[k0:k1].contiguous(), tl)
             for k0, k1 in _ranges(plan, k)]
    got = _add_shuffled(parts, seed=m)
    want = ref.approx_matmul_lut_ref(ta, tw, tl)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(approx_matmul_lut_ref(qa, qw, lut)))
    if case == "wrapping sums":
        assert int(want.min()) < 0          # the int32 sums did wrap


@pytest.mark.parametrize("mask,reduce", [(0xFFFFFFFF, ("loa", 4)),
                                         (0xFFFFFF, ("trunc", 3)),
                                         (0, ("exact", 0))])
def test_split_limbs_equal_the_whole_limbs(mask, reduce):
    """The composed kernels' limbs: lo = acc - (hi << 16) per unit is
    linear, so per-range limbs added mod 2^32 are the whole limbs."""
    from repro_torch.approx.registry import encode_reduce
    m, k, n = 16, 577, 9
    plan = fm.k_split(1, 512, k, 64, GRID)
    rng = np.random.default_rng(3)
    qa = torch.from_numpy(rng.integers(0, 1 << 16, (m, k)).astype(np.int32))
    qw = torch.from_numpy(rng.integers(0, 1 << 16, (k, n)).astype(np.int32))
    lut = torch.from_numpy(rng.integers(0, 1 << 16, (256, 256)).astype(
        np.int32))
    masks = torch.tensor([mask], dtype=torch.int64)
    codes = torch.tensor([encode_reduce(reduce)], dtype=torch.int32)
    parts = [ref.composed_matmul_limbs_ref(qa[:, k0:k1].contiguous(),
                                           qw[k0:k1].contiguous(), lut,
                                           masks, codes)
             for k0, k1 in _ranges(plan, k)]
    want = ref.composed_matmul_limbs_ref(qa, qw, lut, masks, codes)
    for limb in range(2):
        assert torch.equal(_add_shuffled([p[limb] for p in parts], seed=7),
                           want[limb])


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile and run on "
                    "the card only (chip_smoke.py runs this comparison)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
def test_cuda_split_kernels_match_plain(cuda, m, k, n):
    from repro_torch.approx.quant import calibrate, scalar_params
    from repro_torch.approx.registry import encode_reduce
    from repro_torch.kernels import ops
    from repro_torch.kernels.approx_matmul import sm_count
    assert fm.k_split(1, m, k, n, sm_count(cuda.index or 0)).splits > 1
    gen = torch.Generator(device=cuda).manual_seed(k)
    lut = torch.randint(0, 1 << 16, (256, 256), generator=gen,
                        dtype=torch.int32, device=cuda)
    lut16 = lut.to(torch.uint16)
    qa = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.int32,
                       device=cuda)
    qw = torch.randint(0, 256, (k, n), generator=gen, dtype=torch.int32,
                       device=cuda)
    pairs = [([ops.approx_matmul_lut(qa, qw, lut16)],
              [ref.approx_matmul_lut_ref(qa, qw, lut)])]
    wa = torch.randint(0, 1 << 16, (m, k), generator=gen, dtype=torch.int32,
                       device=cuda)
    ww = torch.randint(0, 1 << 16, (k, n), generator=gen, dtype=torch.int32,
                       device=cuda)
    masks = torch.tensor([0xFFFFFFFF], dtype=torch.int64, device=cuda)
    codes = torch.tensor([encode_reduce(("loa", 4))], dtype=torch.int32,
                         device=cuda)
    pairs.append((ops.composed_matmul_lut(wa, ww, lut16, 0xFFFFFFFF,
                                          ("loa", 4), raw=True),
                  ref.composed_matmul_limbs_ref(wa, ww, lut, masks, codes)))
    x = torch.randn((m, k), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.2
    for bits, op, plain, codes_ in (
            (8, ops.fused_matmul_lut, ref.fused_matmul_ref, ()),
            (16, ops.fused_composed_matmul_lut,
             ref.fused_composed_matmul_ref, (masks, codes))):
        sp = scalar_params(calibrate(x, bits), calibrate(w, bits))
        fp, ip = fm.pack_scalars(1, cuda, *sp)
        args = (0xFFFFFFFF, encode_reduce(("loa", 4))) if codes_ else ()
        pairs.append((op(x, w, lut16, *args, *sp, raw=True),
                      plain(x, w, lut, *codes_, fp, ip)))
    torch.cuda.synchronize()
    for got, want in pairs:
        for g, v in zip(got, want):
            assert torch.equal(g, v.reshape(g.shape))
