"""The fused datapath's kernels (K3, K4, K7, K8) and what they stand on,
held against the JAX reference on the CPU.

* Kernels: each port wrapper (``repro_torch.kernels.ops.fused_*``, the
  plain version on CPU tensors) against the reference's op (the Pallas
  kernel in interpret mode), f32 results bit for bit; the int32 outputs
  (accumulator or limbs, code sums) against the reference's oracles.
* Quantization: ``calibrate`` at 8/12/16 bits and at per-lane widths
  against ``jax.jit(calibrate)`` and ``jax.jit(jax.vmap(calibrate))``,
  bit for bit (XLA multiplies by the f32 reciprocal of every constant
  qmax, traced width or not).
* Composed registry helpers: uint32 semantics (int64 in the port)
  equal to the reference's uint32 arrays.

The CUDA kernels themselves are compared with their plain versions by
the ``gpu``-marked test (and ``chip_smoke.py``) on the card."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import quant as ref_quant
from repro.approx import registry as ref_reg
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.approx import quant as port_quant
from repro_torch.approx import registry as port_reg
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(12)
REDUCES = [("exact", 0), ("trunc", 3), ("loa", 4)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _lut(seed=0):
    lut = np.random.default_rng(seed).integers(0, 1 << 16, (256, 256))
    lut[0, 0] = 4321                     # a K-pad term would show
    return lut.astype(np.int32)


def _operands(m, k, n, lanes=None):
    lead = () if lanes is None else (lanes,)
    x = RNG.normal(0.2, 1.3, (*lead, m, k)).astype(np.float32)
    w = RNG.normal(0.0, 0.4, (k, n)).astype(np.float32)
    return x, w


@functools.lru_cache(maxsize=None)
def _ref_cal(bits):
    return jax.jit(functools.partial(ref_quant.calibrate, bits=bits))


def _scalars(x, w, bits):
    """Reference scalars (sa, za, sw, zw, qmax) as numpy, one lane."""
    return tuple(np.asarray(v) for v in ref_quant.scalar_params(
        _ref_cal(bits)(jnp.asarray(x)), _ref_cal(bits)(jnp.asarray(w))))


def _lane_scalars(xs, w, widths):
    per = [_scalars(x, w, b) for x, b in zip(xs, widths)]
    return tuple(np.stack([p[j] for p in per]) for j in range(5))


def _jax(*args):
    return [jnp.asarray(a) for a in args]


def _torch(*args):
    return [_t(a) for a in args]


def _mask(bits):
    return int(port_reg.lane_mask_np(bits))


# ----------------------------------------------------------------------
# kernels against the reference's ops
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(64, 61, 16), (7, 37, 9), (1, 1, 1)])
def test_fused_matmul_matches_reference_kernel(m, k, n):
    x, w = _operands(m, k, n)
    lut = _lut()
    sp = _scalars(x, w, 8)
    want = np.asarray(ref_ops.fused_matmul_lut(*_jax(x, w, lut, *sp)))
    got = ops.fused_matmul_lut(*_torch(x, w, lut, *sp))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    acc, row, col = ops.fused_matmul_lut(*_torch(x, w, lut, *sp), raw=True)
    qa = ref_ref._affine_q(jnp.asarray(x), sp[0], sp[1], sp[4])
    qw = ref_ref._affine_q(jnp.asarray(w), sp[2], sp[3], sp[4])
    np.testing.assert_array_equal(acc.numpy(), np.asarray(
        ref_ref.approx_matmul_lut_ref(qa, qw, jnp.asarray(lut))))
    np.testing.assert_array_equal(row.numpy(), np.asarray(qa).sum(1))
    np.testing.assert_array_equal(col.numpy(), np.asarray(qw).sum(0))


@pytest.mark.parametrize("banked", [False, True])
def test_fused_bank_matches_reference_kernel(banked):
    n_lanes, m, k, n = 3, 45, 50, 12
    x, w = _operands(m, k, n, n_lanes if banked else None)
    luts = np.stack([_lut(s) for s in range(n_lanes)])
    sp = _lane_scalars(x if banked else [x] * n_lanes, w, [8] * n_lanes)
    want = np.asarray(ref_ops.fused_matmul_lut_bank(*_jax(x, w, luts, *sp)))
    got = ops.fused_matmul_lut_bank(*_torch(x, w, luts, *sp))
    assert tuple(got.shape) == (n_lanes, m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(n_lanes):                  # lane b == K3 with lane b
        one = ops.fused_matmul_lut(*_torch(x[b] if banked else x, w,
                                           luts[b], *(v[b] for v in sp)))
        np.testing.assert_array_equal(got[b].numpy(), one.numpy())


@pytest.mark.parametrize("reduce", REDUCES, ids=str)
@pytest.mark.parametrize("bits", [12, 16])
def test_fused_composed_matches_reference_kernel(bits, reduce):
    x, w = _operands(33, 41, 10)
    lut = _lut(bits)
    sp = _scalars(x, w, bits)
    code = ref_reg.encode_reduce(reduce)
    want = np.asarray(ref_ops.fused_composed_matmul_lut(
        *_jax(x, w, lut), jnp.uint32(_mask(bits)),
        jnp.asarray(code, jnp.int32), *_jax(*sp)))
    got = ops.fused_composed_matmul_lut(
        *_torch(x, w, lut), _mask(bits),
        torch.tensor(port_reg.encode_reduce(reduce), dtype=torch.int32),
        *_torch(*sp))
    np.testing.assert_array_equal(got.numpy(), want)
    # the static-tree oracle agrees with the runtime-code selection
    oracle = np.asarray(ref_ref.fused_composed_matmul_ref(
        *_jax(x, w, lut), jnp.uint32(_mask(bits)), *_jax(*sp),
        reduce=reduce))
    np.testing.assert_array_equal(got.numpy(), oracle)


def _mixed_bank():
    """Mixed width AND mixed reduce AND a narrow lane (mask 0)."""
    widths = [12, 8, 16, 16]
    reduces = [("trunc", 3), ("exact", 0), ("loa", 8), ("loa", 4)]
    luts = np.stack([_lut(10 + i) for i in range(4)])
    masks = port_reg.lane_mask_np(widths).astype(np.int64)
    codes = np.asarray([port_reg.encode_reduce(r) for r in reduces],
                       np.int32)
    return widths, reduces, luts, masks, codes


@pytest.mark.parametrize("banked", [False, True])
def test_fused_composed_bank_matches_reference_kernel(banked):
    widths, reduces, luts, masks, codes = _mixed_bank()
    m, k, n = 21, 70, 14
    x, w = _operands(m, k, n, 4 if banked else None)
    sp = _lane_scalars(x if banked else [x] * 4, w, widths)
    want = np.asarray(ref_ops.fused_composed_matmul_lut_bank(
        *_jax(x, w, luts), jnp.asarray(masks, jnp.uint32),
        jnp.asarray(codes), *_jax(*sp)))
    got = ops.fused_composed_matmul_lut_bank(
        *_torch(x, w, luts, masks, codes, *sp))
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = np.asarray(ref_ref.fused_composed_matmul_bank_ref(
        *_jax(x, w, luts), jnp.asarray(masks, jnp.uint32), reduces,
        *_jax(*sp)))
    np.testing.assert_array_equal(got.numpy(), oracle)
    lo, hi, row, col = ops.fused_composed_matmul_lut_bank(
        *_torch(x, w, luts, masks, codes, *sp), raw=True)
    assert not hi[1].any()                   # narrow lane: no high limb
    for b in range(4):
        one = ops.fused_composed_matmul_lut(
            *_torch(x[b] if banked else x, w, luts[b]), int(masks[b]),
            _t(codes[b]), *(_t(v[b]) for v in sp), raw=True)
        for a, c in zip(one, (lo[b], hi[b], row[b], col[b])):
            np.testing.assert_array_equal(a.numpy(), c.numpy())


def test_composed_matmul_ref_matches_reference_oracle():
    qa = RNG.integers(0, 1 << 16, (19, 33)).astype(np.int32)
    qw = RNG.integers(0, 1 << 16, (33, 7)).astype(np.int32)
    lut = _lut(3)
    for bits, reduce in ((16, ("loa", 4)), (12, ("trunc", 2)), (8, None)):
        mask = _mask(bits)
        reduce = reduce or ("exact", 0)
        want = np.asarray(ref_ref.composed_matmul_ref(
            *_jax(qa, qw, lut), jnp.uint32(mask), reduce))
        got = ref.composed_matmul_ref(*_torch(qa, qw, lut), mask, reduce)
        np.testing.assert_array_equal(got.numpy(), want)


def test_fused_wrappers_reject_bad_operands():
    x, w = _torch(*_operands(4, 5, 3))
    lut = _t(_lut())
    sp = (1.0, 0, 1.0, 0, 255.0)
    k = port_reg.MAX_COMPOSED_K + 1
    with pytest.raises(ValueError, match="composed limb"):
        ops.fused_composed_matmul_lut(torch.zeros((1, k)),
                                      torch.zeros((k, 1)), lut, 0,
                                      (0, 0), *sp)
    with pytest.raises(TypeError, match="float32"):
        ops.fused_matmul_lut(x.double(), w, lut, *sp)
    with pytest.raises(ValueError, match="contraction"):
        ops.fused_matmul_lut(x, w[:4], lut, *sp)
    luts = lut.expand(2, 256, 256).contiguous()
    with pytest.raises(ValueError, match="lanes"):
        ops.fused_matmul_lut_bank(x.expand(3, 4, 5).contiguous(), w, luts,
                                  *sp)
    with pytest.raises(ValueError, match="entries"):
        ops.fused_matmul_lut_bank(x, w, luts, torch.ones(3), 0, 1.0, 0,
                                  255.0)
    meta = [t.to("meta") for t in (x, w, lut.to(torch.uint16))]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.fused_matmul_lut(*meta, *sp)


def test_launch_counts_cover_six_kernels_untouched_on_cpu():
    ops.reset_launch_counts()
    x, w = _operands(4, 5, 3)
    ops.fused_matmul_lut(*_torch(x, w, _lut()), 1.0, 0, 1.0, 0, 255.0)
    ops.fused_composed_matmul_lut(*_torch(x, w, _lut()), _mask(16), (0, 0),
                                  1.0, 0, 1.0, 0, 65535.0)
    assert ops.launch_counts() == {
        "lut_matmul": 0, "lut_matmul_bank": 0, "fused_matmul": 0,
        "fused_matmul_bank": 0, "fused_composed_matmul": 0,
        "fused_composed_matmul_bank": 0, "composed_matmul": 0,
        "composed_matmul_bank": 0, "bitsim": 0, "bitsim_pop": 0,
        "lowrank_matmul": 0}


def test_packed_scalars_and_codes_broadcast_per_lane():
    fp, ip = fm.pack_scalars(3, "cpu", torch.tensor(0.5),
                             torch.tensor([1, 2, 3]), 0.25, 7, 4095.0)
    np.testing.assert_array_equal(
        fp.numpy(), [[0.5, 0.25, 4095.0]] * 3)
    np.testing.assert_array_equal(ip.numpy(), [[1, 7], [2, 7], [3, 7]])
    masks, codes = fm.pack_codes(3, "cpu", 0xFFFFFFFF, (2, 4))
    assert masks.tolist() == [0xFFFFFFFF] * 3
    assert codes.tolist() == [[2, 4]] * 3
    assert fm._mask_bits(masks).tolist() == [-1] * 3
    with pytest.raises(ValueError, match="reduce codes"):
        fm.pack_codes(3, "cpu", 0, torch.zeros((2, 2), dtype=torch.int32))


# ----------------------------------------------------------------------
# quantization at 8/12/16 bits and per-lane widths
# ----------------------------------------------------------------------
def _cal_cases():
    rng = np.random.default_rng(21)
    out = [rng.normal(0, rng.uniform(0.01, 10), (9, 13)) for _ in range(12)]
    out.append(rng.uniform(0.1, 3.0, (6, 5)))
    out.append(-rng.uniform(0.2, 7.0, (5, 6)))
    out.append(np.zeros((4, 4)))
    out.append(rng.normal(0, 1e-7, (8, 8)))
    return [c.astype(np.float32) for c in out]


@pytest.mark.parametrize("bits", [8, 12, 16])
def test_calibrate_wide_widths_bit_exact(bits):
    for x in _cal_cases():
        rq = _ref_cal(bits)(jnp.asarray(x))
        pq = port_quant.calibrate(_t(x), bits)
        np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(rq.scale))
        np.testing.assert_array_equal(pq.zero_point.numpy(),
                                      np.asarray(rq.zero_point))
        assert pq.qmax == float(rq.qmax) == float((1 << bits) - 1)
        np.testing.assert_array_equal(
            port_quant.quantize(_t(x), pq).numpy(),
            np.asarray(jax.jit(ref_quant.quantize)(jnp.asarray(x), rq)))


def test_calibrate_per_lane_widths_bit_exact():
    """Per-lane widths against the reference's vmap over a traced width:
    a lane-carrying tensor (``lanes=True``), and an unbanked tensor
    calibrated once per lane width."""
    cases = _cal_cases()[:6]
    x = np.stack(cases)                               # (6, 9, 13)
    widths = np.asarray([8, 12, 16, 16, 8, 12], np.int32)
    vcal = jax.jit(jax.vmap(ref_quant.calibrate))
    rq = vcal(jnp.asarray(x), jnp.asarray(widths))
    pq = port_quant.calibrate(_t(x), _t(widths), lanes=True)
    assert tuple(pq.scale.shape) == (6, 1, 1)
    for got, want in ((pq.scale, rq.scale), (pq.zero_point, rq.zero_point),
                      (pq.qmax, rq.qmax)):
        np.testing.assert_array_equal(got.numpy().ravel(), np.asarray(want))
    codes = port_quant.quantize(_t(x), pq).numpy()
    want = jax.jit(jax.vmap(ref_quant.quantize))(jnp.asarray(x), rq)
    np.testing.assert_array_equal(codes, np.asarray(want))
    # one tensor, one calibration per lane width
    shared = cases[0]
    rq = jax.jit(jax.vmap(ref_quant.calibrate, in_axes=(None, 0)))(
        jnp.asarray(shared), jnp.asarray(widths))
    pq = port_quant.calibrate(_t(shared), _t(widths))
    np.testing.assert_array_equal(pq.scale.numpy().ravel(),
                                  np.asarray(rq.scale))
    np.testing.assert_array_equal(pq.zero_point.numpy().ravel(),
                                  np.asarray(rq.zero_point))
    assert tuple(port_quant.quantize(_t(shared), pq).shape) == (6, 9, 13)


def test_qmax_for_traced_widths():
    bits = torch.tensor([8, 12, 16, 20])
    assert port_quant.qmax_for(bits).tolist() == [255.0, 4095.0, 65535.0,
                                                  65535.0]
    want = np.asarray(jax.vmap(ref_quant.qmax_for)(jnp.asarray(bits.numpy())))
    np.testing.assert_array_equal(port_quant.qmax_for(bits).numpy(), want)
    assert port_quant.TRACED_WIDTHS == ref_quant.TRACED_WIDTHS


# ----------------------------------------------------------------------
# composed registry helpers: uint32 semantics
# ----------------------------------------------------------------------
def _u32(*shape):
    return RNG.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _port_u32(a):
    return _t(a.astype(np.int64))


@pytest.mark.parametrize("reduce", REDUCES + [("trunc", 31), ("loa", 1)],
                         ids=str)
def test_reduce_apply_and_tree_match_reference(reduce):
    a, b, c, d = (_u32(300) for _ in range(4))
    want = np.asarray(ref_reg.reduce_apply(*_jax(a, b), reduce))
    got = port_reg.reduce_apply(_port_u32(a), _port_u32(b), reduce)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    pp = [RNG.integers(0, 1 << 16, 300).astype(np.uint32) for _ in range(4)]
    want = np.asarray(ref_reg.composed_reduce(*_jax(*pp), reduce))
    got = port_reg.composed_reduce(*(_port_u32(p) for p in pp), reduce)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    code = port_reg.encode_reduce(reduce)
    assert code == ref_reg.encode_reduce(reduce)
    for kind, k in (code, (torch.tensor(code[0]), torch.tensor(code[1]))):
        dyn = port_reg.composed_reduce_dyn(*(_port_u32(p) for p in pp),
                                           kind, k)
        np.testing.assert_array_equal(dyn.numpy(), want.astype(np.int64))


def test_reduce_apply_dyn_matches_reference_on_every_code():
    """Per-element codes, edge shifts included: k = 0 under loa (the
    max(k, 1) guard) and k >= 32 (XLA shifts to 0)."""
    ks = [0, 1, 3, 8, 31, 32, 40]
    kinds = np.asarray([0, 1, 2, 3], np.int32)[:, None, None]
    a, b = _u32(1, 1, 64), _u32(1, 1, 64)
    want = np.asarray(jax.jit(ref_reg.reduce_apply_dyn)(
        *_jax(a, b, kinds, np.asarray(ks, np.int32)[None, :, None])))
    want = want.astype(np.int64)
    got = port_reg.reduce_apply_dyn(_port_u32(a), _port_u32(b), _t(kinds),
                                    torch.tensor(ks)[None, :, None])
    np.testing.assert_array_equal(got.numpy(), want)
    for kind in range(4):                   # host codes: the same values
        for j, k in enumerate(ks):
            got = port_reg.reduce_apply_dyn(_port_u32(a), _port_u32(b),
                                            kind, k)
            np.testing.assert_array_equal(got.numpy().ravel(), want[kind, j])


def test_masks_and_encodings_match_reference():
    bits = [8, 9, 12, 15, 16]
    np.testing.assert_array_equal(port_reg.lane_mask_np(bits),
                                  ref_reg.lane_mask_np(bits))
    for b in (8, 12, 16):
        assert port_reg.product_mask(b) == int(ref_reg.product_mask(b))
    traced = port_reg.product_mask(torch.tensor([8, 12, 16]))
    np.testing.assert_array_equal(
        traced.numpy(), np.asarray(jax.vmap(ref_reg.product_mask)(
            jnp.asarray([8, 12, 16]))).astype(np.int64))
    assert port_reg.REDUCE_KINDS == ref_reg.REDUCE_KINDS
    assert port_reg.MAX_COMPOSED_K == ref_reg.MAX_COMPOSED_K == 32768
    with pytest.raises(ValueError, match="unknown reduction kind"):
        port_reg.encode_reduce(("booth", 2))
    with pytest.raises(ValueError, match="unknown reduction kind"):
        port_reg.reduce_apply(_port_u32(_u32(3)), _port_u32(_u32(3)),
                              ("booth", 2))


def test_composed_product_matches_reference():
    qa = RNG.integers(0, 1 << 16, (40, 1)).astype(np.int32)
    qw = RNG.integers(0, 1 << 16, (1, 30)).astype(np.int32)
    flat = _lut(5).reshape(-1)
    for bits, reduce in ((16, ("loa", 4)), (12, ("exact", 0))):
        q_a, q_w = qa >> (16 - bits), qw >> (16 - bits)
        want = np.asarray(ref_reg.composed_product(
            *_jax(q_a, q_w, flat), reduce, bits))
        got = port_reg.composed_product(*_torch(q_a, q_w, flat), reduce,
                                        bits)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


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
@pytest.mark.parametrize("m,k,n", [(65536, 27, 16), (4096, 576, 64),
                                   (1000, 37, 10), (129, 577, 65)])
def test_cuda_fused_kernels_match_plain(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, m, k), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.3
    widths, _, luts, masks, codes = _mixed_bank()
    luts, masks, codes = (_t(a).to(cuda) for a in (luts, masks, codes))
    bits = torch.tensor(widths, device=cuda)
    sp = port_quant.scalar_params(port_quant.calibrate(x, bits, lanes=True),
                                  port_quant.calibrate(w, bits))
    sp8 = port_quant.scalar_params(port_quant.calibrate(x[0]),
                                   port_quant.calibrate(w))
    ops.reset_launch_counts()
    cases = (
        (ops.fused_matmul_lut, ref.fused_matmul_ref, (x[0], w, luts[0]),
         (), sp8, 1),
        (ops.fused_matmul_lut_bank, ref.fused_matmul_bank_ref,
         (x, w, luts), (), sp8, 4),
        (ops.fused_composed_matmul_lut, ref.fused_composed_matmul_ref,
         (x[2], w, luts[2]), (masks[2:3], codes[2:3]),
         tuple(v.reshape(-1)[2] if isinstance(v, torch.Tensor) else v
               for v in sp), 1),
        (ops.fused_composed_matmul_lut_bank,
         ref.fused_composed_matmul_bank_ref, (x, w, luts), (masks, codes),
         sp, 4))
    for op, plain, args, codes_, s, lanes in cases:
        got = op(*args, *codes_, *s, raw=True)
        fp, ip = fm.pack_scalars(lanes, cuda, *s)
        packed = (fm.pack_codes(lanes, cuda, *codes_) if codes_ else ())
        want = plain(*args, *packed, fp, ip)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b.reshape(a.shape))
    assert all(v == 1 for name, v in ops.launch_counts().items()
               if name.startswith("fused"))
