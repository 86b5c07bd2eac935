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
* K3/K4's tile plan (``fused_matmul.quant8_tile``, mirroring
  ``quant8_tile`` and ``kQuant8Tiles``): at ragged and capacity M by
  narrow and wide N, the work units and each unit's threads cover every
  row, column and KC chunk exactly once, and gather no padded row at
  qwen3-moe's capacity (M = 80, N = 768 / 2 048); every ResNet-8
  projection and M = 1 024 keep the tile of the other kernels; each
  compiled tile stages whole rows a warp and one column a thread within
  its registers and shared memory; ``ops`` counts a call's gathered and
  padded lookups while the profiler records.
* On the card (``gpu``): K1, K3, K5 and K7 at shapes that take the split
  against their plain versions; K3, K4 and K4's expert form at every
  compiled tile's ragged M edges, x shared and banked, K split on and
  off.  JAX is imported only by the CPU tests, so ``pytest -m gpu`` runs
  on a machine without it."""
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


PLAN_M = (1, 4, 16, 63, 64, 65, 80, 81, 127, 1024, 3000)
PLAN_N = (10, 16, 64, 768, 2048)
QWEN_EXPERTS = {"wi/wg": (8 * 128, 80, 2048, 768),
                "wo": (8 * 128, 80, 768, 2048)}


def _thread_slots(tile: fm.Tile) -> np.ndarray:
    """How often the threads of one unit gather each (row, column) of
    its tile: thread t rows t // tn + i THREADS // tn (i < rows), columns
    (t % tn) NT + j (j < NT)."""
    seen = np.zeros((tile.tm, tile.tile_n), np.int64)
    t = np.arange(fm.THREADS)
    for i in range(tile.rows):
        for j in range(fm.NT):
            np.add.at(seen, (t // tile.tn + i * (fm.THREADS // tile.tn),
                             (t % tile.tn) * fm.NT + j), 1)
    return seen


@pytest.mark.parametrize("m", PLAN_M)
@pytest.mark.parametrize("n", PLAN_N)
def test_quant8_plan_covers_every_slot_once(m, n):
    for lanes, k in ((1, 100), (3, 577)):
        plan = fm.k_split(lanes, m, k, n, GRID, quant8=True)
        tile = plan.tile
        assert tile == fm.quant8_tile(m, n)
        assert (_thread_slots(tile) == 1).all()
        tiles_m, tiles_n = -(-m // tile.tm), -(-n // tile.tile_n)
        assert plan.tiles == tiles_m * tiles_n
        seen = Counter((lane, t, c) for units in _blocks(plan)
                       for lane, t, chunks in units for c in chunks)
        assert set(seen.values()) == {1}
        assert len(seen) == lanes * plan.tiles * plan.chunks
        # the tiles cover M x N, padded by less than a tile each way
        assert (tiles_m - 1) * tile.tm < m <= tiles_m * tile.tm
        assert (tiles_n - 1) * tile.tile_n < n <= tiles_n * tile.tile_n
        looked, pad = fm.quant8_lookups(lanes, m, k, n)
        assert looked == lanes * plan.tiles * tile.tm * tile.tile_n * k
        assert pad == looked - lanes * m * n * k >= 0
        # no compiled tile pads less; a tie keeps the earlier one
        tiles = [fm.Tile(tn, r) if tn else fm.gather_tile(n)
                 for tn, r in fm.QUANT8_TILES]
        least = min(t.slots(m, n) for t in tiles)
        assert tile.slots(m, n) == least
        assert tile == next(t for t in tiles if t.slots(m, n) == least)


@pytest.mark.parametrize("proj", list(QWEN_EXPERTS))
def test_quant8_plan_gathers_no_padded_rows_at_qwen_capacity(proj):
    pairs, m, k, n = QWEN_EXPERTS[proj]
    plan = fm.k_split(pairs, m, k, n, GRID, quant8=True)
    assert plan.tile == fm.Tile(32, 5)
    assert (plan.tile.tm, plan.tile.tile_n) == (80, 256)
    assert fm.quant8_lookups(pairs, m, k, n) == (pairs * m * n * k, 0)
    # the 64-row tile gathered 128 rows of every 80
    today = fm.gather_tile(n)
    assert today.slots(m, n) == 128 * n
    assert plan.splits == 1 and plan.items == pairs * n // 256


def _todays_shapes():
    from perfbench.counts import resnet_projections
    shapes = {p.name: (p.rows, p.n) for p in
              resnet_projections(64, 32, (16, 32, 64), 10)}
    shapes.update({f"M=1024 N={n}": (1024, n) for n in (512, 2048, 4096)})
    return shapes


@pytest.mark.parametrize("shape", list(_todays_shapes()))
def test_quant8_plan_keeps_todays_tile(shape):
    m, n = _todays_shapes()[shape]
    assert fm.quant8_tile(m, n) == fm.gather_tile(n)
    for lanes in (1, 57):
        assert fm.k_split(lanes, m, 144, n, GRID, quant8=True) == \
            fm.k_split(lanes, m, 144, n, GRID)


def test_quant8_tiles_mirror_the_header():
    src = (build.CSRC / "fused_gather.cuh").read_text()
    body = re.search(r"constexpr int kQuant8Tiles\[\]\[2\] = \{(.*?)\};",
                     src).group(1)
    tiles = tuple((int(a), int(b)) for a, b in
                  re.findall(r"\{(\d+), (\d+)\}", body))
    assert tiles == fm.QUANT8_TILES
    assert int(re.search(r"constexpr int kNumQuant8Tiles = (\d+);",
                         src).group(1)) == len(tiles)
    assert tiles[0] == (0, 1)               # gather_tile(N) first


@pytest.mark.parametrize("tile", [t for t in fm.QUANT8_TILES if t[0]],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_quant8_tile_stages_whole_rows_within_a_block(tile):
    """quant8_kernel<tn, rows>: a warp quantizes whole rows (tm / 16 a
    warp, its kA registers), a thread's W elements lie in one column
    (tile_n divides THREADS; kW registers), and the table, two byte
    buffers and the sums fit a block at 16-byte aligned offsets."""
    t = fm.Tile(*tile)
    warps = fm.THREADS // 32
    assert t.tm % warps == 0 and t.tm // warps == 32 * t.rows // t.tn
    assert fm.THREADS % t.tile_n == 0
    assert fm.KC * t.tile_n % fm.THREADS == 0
    owner = np.arange(fm.KC * t.tile_n) % fm.THREADS
    cols = np.arange(fm.KC * t.tile_n) % t.tile_n
    assert all(len(set(cols[owner == th])) == 1 for th in range(0, 512, 37))
    a_row = fm.KC + 4
    regions = [65536 * 2, 2 * t.tm * a_row, 2 * fm.KC * t.tile_n,
               (t.tm + t.tile_n) * 4]
    assert sum(regions) <= 232448
    assert all(r % 16 == 0 for r in regions)


def test_ops_count_a_calls_gathered_and_padded_lookups():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    luts = torch.from_numpy(rng.integers(0, 1 << 16, (3, 256, 256)).astype(
        np.int32))
    x = torch.randn(3, 4, 81, 40)
    w = torch.randn(2, 40, 768)
    sp = (0.05, 7, 0.01, 3, 255.0)
    off = ops.fused_matmul_lut_bank(x, w, luts, *sp)
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("outer"):
            on = ops.fused_matmul_lut_bank(x, w, luts, *sp)
            ops.fused_matmul_lut(x[0, 0], w[0], luts[0], *sp)
    assert torch.equal(on, off)
    snap = obs.snapshot()
    looked = fm.quant8_lookups(12, 81, 40, 768)
    single = fm.quant8_lookups(1, 81, 40, 768)
    assert obs.total(snap, "gather.lookups") == looked[0] + single[0]
    assert obs.total(snap, "gather.pad_lookups") == looked[1] + single[1]
    # 81 rows: six 16-row tiles, 15 of their rows padded
    assert looked == (12 * 96 * 768 * 40, 12 * 15 * 768 * 40)


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


# K3, K4 and K4's expert form at each compiled tile's ragged M edges: M
# one row, one short of, at and past a tile of 16, 64 and 80 rows, N of
# the tile of the other kernels and of the 256-column tiles
TILE_EDGES = [(m, n) for m in (1, 4, 15, 16, 17, 63, 64, 65, 79, 80, 81, 127)
              for n in (10, 64, 768)] + [(160, 2048), (1024, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", TILE_EDGES)
def test_cuda_quant8_tiles_match_plain(cuda, m, n):
    """Bit for bit against the plain versions: K3 (one table, K split on:
    a few items), K4 with x shared and banked, and K4's expert form over
    2 experts with 3 lanes (K split on where the items are fewer than the
    SMs) and 8 lanes x 24 slices (off at the wide tiles)."""
    from repro_torch.approx.quant import calibrate, calibrate_slices, \
        pair_scalars, scalar_params
    from repro_torch.kernels import ops
    from repro_torch.kernels.approx_matmul import sm_count
    sms = sm_count(cuda.index or 0)
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + n)
    luts = torch.randint(0, 1 << 16, (8, 256, 256), generator=gen,
                         dtype=torch.int32, device=cuda)
    k = 577 if m * n < 20000 else 100
    x = torch.randn((m, k), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.3
    splits = set()
    cases = []
    for lanes, xin in ((1, x), (3, x),
                       (3, torch.randn((3, m, k), generator=gen,
                                       device=cuda))):
        tab = luts[0] if lanes == 1 else luts[:lanes]
        op = ops.fused_matmul_lut if lanes == 1 else ops.fused_matmul_lut_bank
        plain = ref.fused_matmul_ref if lanes == 1 else \
            ref.fused_matmul_bank_ref
        sp = scalar_params(calibrate(xin, lanes=xin.ndim == 3), calibrate(w))
        cases.append((op, plain, xin, w, tab, sp, lanes))
        splits.add(fm.k_split(lanes, m, k, n, sms, quant8=True).splits > 1)
    for lanes, slices, experts in ((3, 4, 2), (8, 24, 2)):
        xe = torch.randn((lanes, slices, m, k), generator=gen, device=cuda)
        we = torch.randn((experts, k, n), generator=gen, device=cuda) * 0.3
        sp = pair_scalars(calibrate_slices(xe), calibrate_slices(we), lanes,
                          slices)
        cases.append((ops.fused_matmul_lut_bank,
                      ref.fused_matmul_bank_experts_ref, xe, we,
                      luts[:lanes], sp, lanes * slices))
        splits.add(fm.k_split(lanes * slices, m, k, n, sms,
                              quant8=True).splits > 1)
    assert True in splits                   # some case splits K
    for op, plain, xin, win, tab, sp, pairs in cases:
        got = op(xin, win, tab.to(torch.uint16), *sp, raw=True)
        want = plain(xin, win, tab, *fm.pack_scalars(pairs, cuda, *sp))
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b.reshape(a.shape)), (op.__name__, pairs)
