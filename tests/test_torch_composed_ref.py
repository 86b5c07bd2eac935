"""The plain composed path held bit for bit on the CPU, and the composed
kernels' cost-balanced split.

* ``registry.composed_limbs`` (the plain versions of K5-K8 and the
  ``lut`` datapath's composed core: int32 digit products, the tree of a
  host reduce code in closed form) against the formulation it replaced
  (int64 digit products, every node through ``reduce_apply_dyn``'s host
  path, kept below as ``_old_limbs``) and against the JAX reference's
  plain composed functions (``composed_matmul_ref`` for the static trees,
  ``registry.composed_reduce_dyn`` on JAX digit products for every code):
  exact/trunc/loa, widths 8/12/16, shift edges (k = 0, 1, 8, 9, 16, 17,
  31, 32 and beyond), ragged M/K/N, one and several row blocks, narrow
  lanes; the banked plain versions (K6, K8) with shared and banked codes
  on mixed-width, mixed-reduce banks.
* The split of ``fused_gather.cuh::range_start`` through its mirror
  ``fused_matmul.split_starts``: every item once, contiguous lane-major
  ranges, no block over the ideal by more than one item's cost, the even
  split for equal lanes.
* On the card (``gpu``): K6 and K8 against their plain versions on banks
  whose wide lanes come first, last and interleaved.

Kept apart from ``test_torch_composed.py``, whose wide-study test is the
suite's longest."""
import re

import numpy as np
import pytest
import torch

from repro_torch.approx import registry as port_reg
from repro_torch.kernels import build, ref
from repro_torch.kernels import fused_matmul as fm

M32 = 0xFFFFFFFF
# (kind, k) encode_reduce codes: every kind at the shift edges of the
# closed forms (k <= 8 and k <= 16 make a loa node an add) and of the
# guarded path (k = 0, k >= 32); kind 7 is read as loa, as
# reduce_apply_dyn reads it
CODES = [(0, 0), (0, 7), (1, 1), (1, 3), (1, 8), (1, 9), (1, 16), (1, 17),
         (1, 31), (1, 32), (1, 40), (2, 0), (2, 1), (2, 4), (2, 8), (2, 9),
         (2, 16), (2, 17), (2, 31), (2, 32), (2, 33), (7, 4)]
SHAPES = [(37, 41, 10), (5, 130, 3), (1, 1, 1)]


def _lut(seed):
    lut = np.random.default_rng(seed).integers(0, 1 << 16, (256, 256))
    lut[0, 0] = 4321
    return torch.from_numpy(lut.astype(np.int32))


def _codes(rng, shape, bits):
    return torch.from_numpy(rng.integers(0, 1 << bits, shape).astype(
        np.int32))


def _shl(a, s):
    return (a << s) & M32 if s < 32 else torch.zeros_like(a)


def _shr(a, s):
    return a >> s if s < 32 else torch.zeros_like(a)


def _node(a, b, kind, k):
    """One tree node as the replaced ``reduce_apply_dyn`` host path
    computed it (int64 holding uint32)."""
    k &= M32
    km = max(k, 1)
    low = ((1 << km) - 1) & M32 if km < 32 else M32
    hs = (_shr(a, k) + _shr(b, k)) & M32
    if kind == 0:
        return (a + b) & M32
    if kind == 1:
        return _shl(hs, k)
    carry = _shr(a, km - 1) & _shr(b, km - 1) & 1
    return ((a | b) & low) | _shl((hs + carry) & M32, k)


def _old_limbs(qa, qw, lut, mask, kind, k):
    """The replaced plain path: int64 (rows, K, N) gathers, the tree node
    by node masked to 32 bits, the mask, the limb sums."""
    flat = lut.reshape(-1).to(torch.int64)

    def pp(x, y):
        return flat[x[:, :, None].long() * 256 + y[None].long()]

    a0, a1, w0, w1 = qa & 255, qa >> 8, qw & 255, qw >> 8
    if not mask:
        return (torch.sum(pp(a0, w0), dim=1, dtype=torch.int32),
                torch.zeros((qa.shape[0], qw.shape[1]), dtype=torch.int32))
    s1 = _node(pp(a0, w1), pp(a1, w0), kind, k)
    s2 = _node(pp(a0, w0), (s1 << 8) & M32, kind, k)
    p = _node(s2, (pp(a1, w1) << 16) & M32, kind, k) & mask
    return (torch.sum(p & 0xFFFF, dim=1, dtype=torch.int32),
            torch.sum(p >> 16, dim=1, dtype=torch.int32))


def _reference():
    """The JAX reference's numpy, registry and ``composed_matmul_ref``,
    imported by the tests that use them: the gpu cases also run on a
    card whose machine has no JAX."""
    import jax.numpy as jnp
    from repro.approx import registry
    from repro.kernels.composed_matmul import composed_matmul_ref
    return jnp, registry, composed_matmul_ref


def _jax_limbs(qa, qw, lut, mask, kind, k):
    """The JAX reference's composed helpers on the same codes: uint32
    digit products, ``composed_reduce_dyn``, the mask, the limb sums."""
    jnp, jax_reg, _ = _reference()
    flat = jnp.asarray(lut.numpy()).reshape(-1)
    a, w = jnp.asarray(qa.numpy()), jnp.asarray(qw.numpy())

    def pp(x, y):
        return jnp.take(flat, x[:, :, None] * 256 + y[None], axis=0).astype(
            jnp.uint32)

    a0, a1, w0, w1 = a & 255, a >> 8, w & 255, w >> 8
    p = jax_reg.composed_reduce_dyn(pp(a0, w0), pp(a0, w1), pp(a1, w0),
                                    pp(a1, w1), jnp.int32(kind),
                                    jnp.uint32(k & M32)) & jnp.uint32(mask)
    lo = jnp.sum((p & 0xFFFF).astype(jnp.int32), axis=1, dtype=jnp.int32)
    hi = jnp.sum((p >> 16).astype(jnp.int32), axis=1, dtype=jnp.int32)
    return np.asarray(lo), np.asarray(hi)


def _static_reduce(kind, k):
    """The static tree a code names, where ``parse_reduce`` has one."""
    if kind == 0:
        return ("exact", 0)
    if kind in (1, 2) and 1 <= k <= 31:
        return (("trunc", "loa")[kind - 1], k)
    return None


def _assert_limbs(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("bits", [8, 12, 16])
@pytest.mark.parametrize("code", CODES, ids=str)
def test_composed_limbs_bit_equal_to_old_and_reference(code, bits):
    jnp, _, jax_ref = _reference()
    kind, k = code
    rng = np.random.default_rng([kind, k, bits])
    lut = _lut(bits)
    mask = int(port_reg.product_mask(bits))
    for m, kk, n in SHAPES:
        qa, qw = _codes(rng, (m, kk), bits), _codes(rng, (kk, n), bits)
        want = _old_limbs(qa, qw, lut, mask, kind, k)
        _assert_limbs(ref._composed_limbs(qa, qw, lut, mask, kind, k), want)
        flat = lut.reshape(-1)
        _assert_limbs(port_reg.composed_limbs(qa, qw, flat, mask, kind, k,
                                              3), want)       # row blocks
        _assert_limbs(_jax_limbs(qa, qw, lut, mask, kind, k), want)
        reduce = _static_reduce(kind, k)
        if reduce is not None:
            f32 = np.asarray(jax_ref(jnp.asarray(qa.numpy()),
                                     jnp.asarray(qw.numpy()),
                                     jnp.asarray(lut.numpy()),
                                     jnp.uint32(mask), reduce))
            np.testing.assert_array_equal(
                ref.composed_matmul_ref(qa, qw, lut, mask, reduce).numpy(),
                f32)
            np.testing.assert_array_equal(
                port_reg.composed_forward(qa, qw, lut, mask, reduce,
                                          4).numpy(), f32)


@pytest.mark.parametrize("bits", [8, 12, 16])
def test_composed_narrow_lane_is_the_low_digit_tile_sum(bits):
    jnp, _, jax_ref = _reference()
    rng = np.random.default_rng(bits)
    qa, qw = _codes(rng, (29, 77), bits), _codes(rng, (77, 9), bits)
    lut = _lut(3)
    want = _old_limbs(qa, qw, lut, 0, 2, 4)
    assert not want[1].any()
    _assert_limbs(ref._composed_limbs(qa, qw, lut, 0, 2, 4), want)
    f32 = np.asarray(jax_ref(jnp.asarray(qa.numpy()), jnp.asarray(qw.numpy()),
                             jnp.asarray(lut.numpy()), jnp.uint32(0),
                             ("loa", 4)))
    np.testing.assert_array_equal(
        port_reg.composed_forward(qa, qw, lut, 0, ("loa", 4), 5).numpy(),
        f32)
    np.testing.assert_array_equal(want[0].numpy().astype(np.float32), f32)


# banks mixing widths (0 = narrow lane) and reduce codes, wide lanes
# first, last and interleaved
LAYOUTS = {"wide_first": [16, 12, 16, 8, 8, 8],
           "wide_last": [8, 8, 8, 12, 16, 16],
           "interleaved": [8, 16, 8, 12, 8, 16]}
BANK_CODES = [(2, 4), (1, 3), (0, 0), (2, 9), (1, 17), (2, 4)]


def _bank(widths, seed):
    luts = torch.stack([_lut(seed + i) for i in range(len(widths))])
    masks = torch.from_numpy(port_reg.lane_mask_np(widths).astype(np.int64))
    codes = torch.tensor(BANK_CODES[:len(widths)], dtype=torch.int32)
    return luts, masks, codes


@pytest.mark.parametrize("banked", ["shared", "qa", "qa+qw"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_composed_bank_plain_version_bit_equal(layout, banked):
    """K6's plain version: lane b equals the old formulation on lane b's
    codes, its mask and its own reduce code."""
    widths = LAYOUTS[layout]
    luts, masks, codes = _bank(widths, 30)
    rng = np.random.default_rng(len(banked))
    n, m, k, n_out = len(widths), 23, 70, 13
    qa = (torch.stack([_codes(rng, (m, k), b) for b in widths])
          if banked != "shared" else _codes(rng, (m, k), 16))
    qw = (torch.stack([_codes(rng, (k, n_out), b) for b in widths])
          if banked == "qa+qw" else _codes(rng, (k, n_out), 16))
    lo, hi = ref.composed_matmul_bank_ref(qa, qw, luts, masks, codes)
    assert lo.shape == hi.shape == (n, m, n_out)
    for b in range(n):
        want = _old_limbs(qa[b] if qa.ndim == 3 else qa,
                          qw[b] if qw.ndim == 3 else qw, luts[b],
                          int(masks[b]), *BANK_CODES[b])
        _assert_limbs((lo[b], hi[b]), want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fused_composed_bank_plain_version_bit_equal(layout):
    """K8's plain version: per lane, the old formulation on the codes
    the lane's own scalars quantize to, and the code sums."""
    widths = LAYOUTS[layout]
    luts, masks, codes = _bank(widths, 50)
    n = len(widths)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(0.2, 1.3, (n, 31, 45)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0.0, 0.3, (45, 7)).astype(np.float32))
    qmax = torch.tensor([(1 << b) - 1 for b in widths], dtype=torch.float32)
    fp = torch.stack([torch.full((n,), 0.01), torch.full((n,), 0.002),
                      qmax], dim=1)
    ip = torch.tensor([[7, 11]] * n, dtype=torch.int32)
    lo, hi, row, col = ref.fused_composed_matmul_bank_ref(x, w, luts, masks,
                                                          codes, fp, ip)
    for b in range(n):
        qa, qw = ref._lane_codes(x, w, b, fp, ip)
        assert int(qa.max()) > 255 or widths[b] == 8
        _assert_limbs((lo[b], hi[b]), _old_limbs(qa, qw, luts[b],
                                                 int(masks[b]),
                                                 *BANK_CODES[b]))
        _assert_limbs((row[b], col[b]), (qa.sum(1, dtype=torch.int32),
                                         qw.sum(0, dtype=torch.int32)))


# ----------------------------------------------------------------------
# the cost-balanced split (fused_gather.cuh::range_start)
# ----------------------------------------------------------------------
WIDE, NARROW = fm.WIDE_COST, fm.NARROW_COST
SPLITS = {
    "wide12_n16": ([NARROW] * 7 + [WIDE] * 5, 256, 132),
    "wide12_n64": ([NARROW] * 7 + [WIDE] * 5, 64, 132),
    "wide12_head": ([NARROW] * 7 + [WIDE] * 5, 1, 132),
    "wide_first": ([WIDE] * 5 + [NARROW] * 7, 64, 132),
    "interleaved": ([NARROW, WIDE] * 6, 37, 132),
    "mixed_costs": ([3, 1, 8, 2, 1], 1000, 7),
    "fewer_items": ([NARROW, WIDE, NARROW], 2, 132),
}


@pytest.mark.parametrize("case", list(SPLITS))
def test_split_covers_every_item_once_within_one_item(case):
    costs, per_lane, grid = SPLITS[case]
    starts = fm.split_starts(costs, per_lane, grid)
    total = len(costs) * per_lane
    assert len(starts) == grid + 1 and starts[0] == 0
    assert starts[-1] == total
    assert all(a <= b for a, b in zip(starts, starts[1:]))   # contiguous
    item_cost = [c for c in costs for _ in range(per_lane)]  # lane-major
    ideal = sum(item_cost) / grid
    for b in range(grid):
        assert sum(item_cost[starts[b]:starts[b + 1]]) <= ideal + max(costs)


@pytest.mark.parametrize("cost", [1, NARROW, WIDE])
@pytest.mark.parametrize("lanes,per_lane", [(1, 513), (17, 64), (5, 3),
                                            (12, 256)])
def test_split_is_the_even_split_for_equal_lanes(lanes, per_lane, cost):
    grid = 132
    total = lanes * per_lane
    assert fm.split_starts([cost] * lanes, per_lane, grid) == [
        total * b // grid for b in range(grid + 1)]


def test_split_mirror_uses_the_kernels_costs():
    src = (build.CSRC / "fused_gather.cuh").read_text()
    for name, cost in (("kWideCost", fm.WIDE_COST),
                       ("kNarrowCost", fm.NARROW_COST)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1)) == cost


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
@pytest.mark.parametrize("m,k,n", [(4096, 144, 16), (1000, 37, 10)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cuda_composed_banks_match_plain_in_any_lane_order(cuda, layout, m,
                                                          k, n):
    from repro_torch.kernels import composed_matmul as cm
    from repro_torch.kernels import ops
    widths = LAYOUTS[layout]
    luts, masks, codes = (t.to(cuda) for t in _bank(widths, 70))
    luts16 = luts.to(torch.uint16)
    lanes = len(widths)
    gen = torch.Generator(device=cuda).manual_seed(0)
    qa = torch.randint(0, 1 << 16, (lanes, m, k), generator=gen,
                       dtype=torch.int32, device=cuda)
    qw = torch.randint(0, 1 << 16, (k, n), generator=gen, dtype=torch.int32,
                       device=cuda)
    got = cm.composed_matmul_bank(qa, qw, luts16, masks, codes)
    want = ref.composed_matmul_bank_ref(qa, qw, luts, masks, codes)
    x = torch.randn((lanes, m, k), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.2
    bits = torch.tensor(widths, device=cuda)
    from repro_torch.approx.quant import calibrate, scalar_params
    sp = scalar_params(calibrate(x, bits, lanes=True), calibrate(w, bits))
    got += ops.fused_composed_matmul_lut_bank(x, w, luts16, masks, codes,
                                              *sp, raw=True)
    fp, ip = fm.pack_scalars(lanes, cuda, *sp)
    want += ref.fused_composed_matmul_bank_ref(x, w, luts, masks, codes, fp,
                                               ip)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
