"""K3/K4's scalar interface and staging plan (``kernels.fused_matmul``,
``csrc/fused_gather.cuh::quant8_kernel``).

On the CPU:
* every form a quantization scalar takes (a number, a 0-d, ``(1,)``,
  ``(n,)`` or ``(n, 1, 1)`` tensor, a per-lane ``qmax``) gives, through
  ``kernels.ops`` (the plain versions here), the reference's
  ``fused_matmul_pallas`` / ``fused_matmul_bank_pallas`` result (and
  K7's / K8's) in interpret mode, bit for bit; ``lane_scalars`` hands
  the kernels a device tensor of the right dtype as a view, with its
  lane stride; ``dequant_lanes`` on those scalars equals ``dequant`` on
  the packed ones, bit for bit;
* the staging plan, mirrored from the header's constants, makes every
  code of a chunk once, each warp whole rows and each thread one column,
  and its shared memory fits a block at every tile.

On the card (``gpu``-marked, no JAX needed: ``python -m pytest -m gpu
tests/test_torch_fused_plan.py``): K3 and K4 against their plain
versions, bit for bit, at ragged, shared, banked and split shapes.
"""
import re

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.kernels import build
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(18)
HEADER = (build.CSRC / "fused_gather.cuh").read_text()


def _const(name: str) -> int:
    """An int constant of the header, as compiled."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         HEADER).group(1))


def _lut(seed):
    lut = np.random.default_rng(seed).integers(0, 1 << 16, (256, 256))
    lut[0, 0] = 4321
    return lut.astype(np.int32)


def _ref_scalars(xs, w, bits):
    """The reference's per-lane scalars (sa, za, sw, zw, qmax), (n,)."""
    import jax.numpy as jnp
    from repro.approx import quant as ref_quant
    per = [ref_quant.scalar_params(ref_quant.calibrate(jnp.asarray(x), b),
                                   ref_quant.calibrate(jnp.asarray(w), b))
           for x, b in zip(xs, bits)]
    return tuple(np.stack([np.asarray(p[j]) for p in per]) for j in range(5))


DTYPES = (np.float32, np.int32, np.float32, np.int32, np.float32)


def _form(sp, form: str, n: int):
    """Port scalars in ``form`` and the per-lane (n,) values they mean."""
    if form in ("number", "0-d", "(1,)"):       # lane 0's, shared
        vals = tuple(np.full(n, v[0], dt) for v, dt in zip(sp, DTYPES))
        if form == "number":
            port = tuple(v[0].item() for v in vals)
        else:
            shape = () if form == "0-d" else (1,)
            port = tuple(torch.tensor(v[0]).reshape(shape) for v in vals)
        return port, vals
    vals = tuple(v.astype(dt) for v, dt in zip(sp, DTYPES))
    if form == "qmax per lane":                 # clips the lanes apart
        vals = vals[:4] + (np.asarray([255, 200, 127][:n], np.float32),)
    shape = (n, 1, 1) if form == "(n,1,1)" else (n,)
    return tuple(torch.from_numpy(v.copy()).reshape(shape)
                 for v in vals), vals


SHARED_FORMS = ("number", "0-d", "(1,)")
LANE_FORMS = ("(n,)", "(n,1,1)", "qmax per lane")


@pytest.mark.parametrize("form", SHARED_FORMS)
def test_k3_scalar_forms_match_reference_kernel(form):
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    x = RNG.normal(0.2, 1.3, (9, 37)).astype(np.float32)
    w = RNG.normal(0.0, 0.4, (37, 6)).astype(np.float32)
    lut = _lut(1)
    port, vals = _form(_ref_scalars([x], w, [8]), form, 1)
    want = np.asarray(ref_ops.fused_matmul_lut(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(lut),
        *(jnp.asarray(v[0]) for v in vals)))
    got = ops.fused_matmul_lut(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(lut), *port)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("form", SHARED_FORMS + LANE_FORMS)
def test_k4_scalar_forms_match_reference_kernel(form):
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    n = 3
    x = RNG.normal(0.2, 1.3, (n, 9, 37)).astype(np.float32)
    w = RNG.normal(0.0, 0.4, (37, 6)).astype(np.float32)
    luts = np.stack([_lut(s) for s in range(n)])
    port, vals = _form(_ref_scalars(x, w, [8] * n), form, n)
    want = np.asarray(ref_ops.fused_matmul_lut_bank(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(luts),
        *(jnp.asarray(v) for v in vals)))
    got = ops.fused_matmul_lut_bank(torch.from_numpy(x),
                                    torch.from_numpy(w),
                                    torch.from_numpy(luts), *port)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("form", ("number", "(n,)", "(n,1,1)"))
def test_k7_k8_scalar_forms_match_reference_kernel(form):
    """The composed kernels take the same scalar interface: K8 on a bank
    mixing widths (a per-lane qmax), K7 on its 16-bit lane."""
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    from repro_torch.approx import registry as port_reg
    widths = [8, 12, 16]
    x = RNG.normal(0.2, 1.3, (3, 7, 21)).astype(np.float32)
    w = RNG.normal(0.0, 0.4, (21, 5)).astype(np.float32)
    luts = np.stack([_lut(10 + s) for s in range(3)])
    masks = port_reg.lane_mask_np(widths).astype(np.int64)
    codes = np.asarray([port_reg.encode_reduce(("loa", 4))] * 3, np.int32)
    sp = _ref_scalars(x, w, widths)
    if form == "number":                        # K7 on the 16-bit lane
        vals = tuple(v[2:3].astype(dt) for v, dt in zip(sp, DTYPES))
        want = np.asarray(ref_ops.fused_composed_matmul_lut(
            jnp.asarray(x[2]), jnp.asarray(w), jnp.asarray(luts[2]),
            jnp.uint32(int(masks[2])), jnp.asarray(codes[2]),
            *(jnp.asarray(v[0]) for v in vals)))
        got = ops.fused_composed_matmul_lut(
            torch.from_numpy(x[2]), torch.from_numpy(w),
            torch.from_numpy(luts[2]), int(masks[2]),
            torch.from_numpy(codes[2]), *(v[0].item() for v in vals))
    else:
        port, vals = _form(sp, form, 3)
        want = np.asarray(ref_ops.fused_composed_matmul_lut_bank(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(luts),
            jnp.asarray(masks, jnp.uint32), jnp.asarray(codes),
            *(jnp.asarray(v) for v in vals)))
        got = ops.fused_composed_matmul_lut_bank(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(luts),
            torch.from_numpy(masks), torch.from_numpy(codes), *port)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("banked,form",
                         [(False, f) for f in SHARED_FORMS]
                         + [(True, f) for f in SHARED_FORMS + LANE_FORMS])
def test_dequant_lanes_equals_packed_dequant(banked, form):
    """``ops`` dequantizes with the scalars as they came
    (``dequant_lanes``); it gives ``dequant`` of the packed scalars (what
    ``chip_smoke.py`` holds the kernels' results to) bit for bit, one
    lane (K3) or three (K4)."""
    n = 3 if banked else 1
    k, m, cols = 577, 5, 7
    sp = (RNG.uniform(0.01, 0.1, n), RNG.integers(0, 256, n),
          RNG.uniform(0.001, 0.01, n), RNG.integers(0, 256, n),
          np.full(n, 255.0))
    port, _ = _form(sp, form, n)
    shape = (n, m, cols) if banked else (m, cols)
    s = torch.from_numpy(RNG.integers(-2**30, 2**30, shape)).to(
        torch.float32)
    row = torch.from_numpy(RNG.integers(0, 255 * k, shape[:-1])).to(
        torch.int32)
    col = torch.from_numpy(RNG.integers(0, 255 * k, shape[:-2] + shape[-1:])
                           ).to(torch.int32)
    cpu = torch.device("cpu")
    got = fm.dequant_lanes(s, row, col, fm.lane_scalars(n, cpu, *port), k)
    want = fm.dequant(s, row, col, *fm.pack_scalars(n, cpu, *port), k)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def test_lane_scalars_pass_device_tensors_as_views():
    cpu = torch.device("cpu")
    sa = torch.rand(4, 1, 1)
    za = torch.tensor(3, dtype=torch.int32)
    sw = torch.rand(1)
    zw = torch.arange(4, dtype=torch.int32)
    sc = fm.lane_scalars(4, cpu, sa, za, sw, zw, 255.0)
    assert list(sc.struct.stride) == [1, 0, 0, 1, 0]
    for v, ptr, t in zip(sc.values, sc.struct.ptr, (sa, za, sw, zw)):
        assert v is t and ptr == t.data_ptr()   # the tensor as it is
    assert sc.values[4] == 255.0 and sc.struct.ptr[4] is None
    assert sc.struct.value[4] == 255.0
    # another dtype is converted; numbers pass by value (za, zw as ints)
    v = fm.lane_scalars(1, cpu, torch.tensor(0.5, dtype=torch.float64),
                        2.0, 0.25, 7, 255).values[0]
    assert v.dtype == torch.float32
    assert fm.lane_scalars(1, cpu, 0.5, 2.0, 0.25, 7, 255).values[1] == 2
    with pytest.raises(ValueError, match="per-lane value"):
        fm.lane_scalars(3, cpu, torch.rand(2), 0, 1.0, 0, 255.0)


def _staging(tn: int, threads: int):
    """Mirror of quant8_kernel's staging: the thread of each A code (tm,
    KC) and W code (KC, tile_n) of a chunk (load_chunk, store_chunk), the
    lane that keeps each row's sum, and the one sums_out writes it by."""
    tm, tile_n = fm.THREADS // tn, tn * fm.NT
    warps = threads // 32
    a_owner = np.full((tm, fm.KC), -1)
    keeper = np.full(tm, -1)
    for t in range(threads):
        warp, lane = divmod(t, 32)
        for i in range(tm // warps):
            row = warp + i * warps
            assert a_owner[row, lane] == -1
            a_owner[row, lane] = t
            if lane == i % 32:
                keeper[row] = t
    writer = np.full(tm, -1)
    for t in range(threads):
        warp, lane = divmod(t, 32)
        for i in range(lane, tm // warps, 32):
            writer[warp + i * warps] = t
    w_owner = np.full((fm.KC, tile_n), -1)
    for t in range(threads):
        for e in range(t, fm.KC * tile_n, threads):
            assert w_owner[e // tile_n, e % tile_n] == -1
            w_owner[e // tile_n, e % tile_n] = t
    return a_owner, w_owner, keeper, writer


@pytest.mark.parametrize("tn", [1, 2, 4, 8])
def test_staging_makes_every_code_once(tn):
    assert (_const("kThreads"), _const("kNT"), _const("kKC")) == (
        fm.THREADS, fm.NT, fm.KC)
    threads = fm.THREADS
    # a thread's registers hold its share of a chunk
    tm, tile_n = fm.THREADS // tn, tn * fm.NT
    assert tm // (threads // 32) <= _const("kARegs")
    assert fm.KC * tile_n <= _const("kWRegs") * threads
    a_owner, w_owner, keeper, writer = _staging(tn, threads)
    assert (a_owner >= 0).all() and (w_owner >= 0).all()
    # each row of A codes made by one warp, lane k at k (one reduction)
    assert (a_owner // 32 == a_owner[:, :1] // 32).all()
    assert (a_owner % 32 == np.arange(fm.KC)).all()
    # each W code's thread keeps one column's sum
    assert (w_owner % (tn * fm.NT) == np.arange(tn * fm.NT)).all()
    # a row's sum is written by the lane that kept it
    np.testing.assert_array_equal(keeper, writer)


@pytest.mark.parametrize("tn", [1, 2, 4, 8])
def test_quant8_buffers_fit_a_block(tn):
    """quant_smem_bytes mirrored from the header's constants: the table,
    kStages byte buffers of A (kARow a row, rows of a warp in distinct
    banks) and W codes, and the sums fit 232 448 bytes, and every region
    starts 16-byte aligned."""
    assert "constexpr int kARow = kKC + 4;" in HEADER
    stages, a_row = _const("kStages"), fm.KC + 4
    assert (a_row // 4) % 2 == 1
    tm, tile_n = fm.THREADS // tn, tn * fm.NT
    regions = [65536 * 2, stages * tm * a_row, stages * fm.KC * tile_n,
               (tm + tile_n) * 4]
    assert sum(regions) <= 232448
    assert all(r % 16 == 0 for r in regions)
    # the 32 / tn rows a warp gathers read distinct banks at each step
    rows = np.arange(32 // tn)
    assert len(set((rows * a_row // 4) % 32)) == len(rows)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile and run on "
                    "the card only (chip_smoke.py runs this comparison)")
    return torch.device("cuda")


QUANT8_SHAPES = ([(m, k, n) for m in (1, 513) for k in (1, 31, 33, 577)
                  for n in (1, 8)]
                 + [(4096, 576, 64), (4096, 288, 64), (64, 64, 10)])


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", QUANT8_SHAPES)
def test_cuda_k3_k4_match_plain(cuda, m, k, n):
    from repro_torch.approx.quant import calibrate, scalar_params
    gen = torch.Generator(device=cuda).manual_seed(0)
    luts = torch.randint(0, 1 << 16, (5, 256, 256), generator=gen,
                         dtype=torch.int32, device=cuda)
    x = torch.randn((m, k), generator=gen, device=cuda)
    xb = torch.randn((5, m, k), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.3
    cases = ((ops.fused_matmul_lut, ref.fused_matmul_ref, x, luts[0], 1),
             (ops.fused_matmul_lut_bank, ref.fused_matmul_bank_ref, x, luts,
              5),
             (ops.fused_matmul_lut_bank, ref.fused_matmul_bank_ref, xb,
              luts, 5))
    for op, plain, xin, tab, lanes in cases:
        sp = scalar_params(calibrate(xin, lanes=xin.ndim == 3),
                           calibrate(w))
        got = op(xin, w, tab.to(torch.uint16), *sp, raw=True)
        want = plain(xin, w, tab, *fm.pack_scalars(lanes, cuda, *sp))
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b.reshape(a.shape))
