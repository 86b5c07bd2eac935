"""The two-step composed datapath (kernels K5, K6) held against the JAX
reference on the CPU.

* Kernels: ``ops.composed_matmul_lut`` and ``ops.composed_matmul_lut_bank``
  (the plain versions on CPU tensors) against the reference's
  ``composed_matmul_pallas`` and ``composed_matmul_bank_pallas`` in
  interpret mode, f32 results bit for bit: 12 and 16 bits, exact/trunc/
  loa trees, narrow lanes (mask 0), ragged shapes, shared and banked
  codes; the int32 limbs lane by lane; K past ``MAX_COMPOSED_K`` raises.
* Datapath: ``backend_matmul`` under ``lut_pallas`` equals ``lut_fused``
  and the reference's ``lut_pallas`` at 12/16 bits, one multiplier and a
  mixed-width bank.
* Entry point: ``wide_pareto.run(variant="pallas")`` gives the rows of
  the ``fused`` run (1 image).

The CUDA kernels are compared with their plain versions by the
``gpu``-marked test (and ``chip_smoke.py``) on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import backend as ref_backend
from repro.approx import registry as ref_reg
from repro.approx.specs import BackendSpec as RefSpec
from repro.core.library import build_default_library as ref_build
from repro.kernels.composed_matmul import (composed_matmul_bank_pallas,
                                           composed_matmul_pallas)
from repro_torch.approx import backend as port_backend
from repro_torch.approx import registry as port_reg
from repro_torch.approx.layers import bank_backend
from repro_torch.approx.specs import BackendSpec, LutBank
from repro_torch.kernels import ops, ref
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


RNG = np.random.default_rng(13)
REDUCES = [("exact", 0), ("trunc", 3), ("loa", 4)]
SHAPES = [(33, 41, 10), (7, 130, 65), (1, 1, 1)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _lut(seed=0):
    lut = np.random.default_rng(seed).integers(0, 1 << 16, (256, 256))
    lut[0, 0] = 4321                     # a K-pad term would show
    return lut.astype(np.int32)


def _codes(shape, bits):
    return RNG.integers(0, 1 << bits, shape).astype(np.int32)


def _mask(bits):
    return int(port_reg.lane_mask_np(bits))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("reduce", REDUCES, ids=str)
@pytest.mark.parametrize("bits", [12, 16])
def test_composed_matches_reference_kernel(bits, reduce, m, k, n):
    qa, qw = _codes((m, k), bits), _codes((k, n), bits)
    lut = _lut(bits)
    want = np.asarray(composed_matmul_pallas(
        jnp.asarray(qa), jnp.asarray(qw), jnp.asarray(lut),
        jnp.uint32(_mask(bits)), reduce=reduce, interpret=True))
    got = ops.composed_matmul_lut(_t(qa), _t(qw), _t(lut), _mask(bits),
                                  reduce)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # the datapath's f32 core (``composed_matmul_ref``) agrees
    np.testing.assert_array_equal(
        ref.composed_matmul_ref(_t(qa), _t(qw), _t(lut), _mask(bits),
                                reduce).numpy(), want)


def test_composed_narrow_lane_is_the_tile_sum():
    """mask 0: the plain 8-bit tile sum of the low digits, hi limb 0."""
    qa, qw = _codes((19, 23), 8), _codes((23, 6), 8)
    lut = _lut(5)
    want = np.asarray(composed_matmul_pallas(
        *(jnp.asarray(a) for a in (qa, qw, lut)), jnp.uint32(0),
        reduce=("loa", 4), interpret=True))
    lo, hi = ops.composed_matmul_lut(_t(qa), _t(qw), _t(lut), 0,
                                     ("loa", 4), raw=True)
    assert not hi.any()
    np.testing.assert_array_equal(lo.numpy(), ops.approx_matmul_lut(
        _t(qa), _t(qw), _t(lut)).numpy())
    np.testing.assert_array_equal(lo.numpy().astype(np.float32), want)


def _bank(widths, seed=20):
    luts = np.stack([_lut(seed + i) for i in range(len(widths))])
    return luts, port_reg.lane_mask_np(widths).astype(np.int64)


@pytest.mark.parametrize("reduce", REDUCES, ids=str)
@pytest.mark.parametrize("banked", [False, True])
def test_composed_bank_matches_reference_kernel(banked, reduce):
    widths = [12, 8, 16, 16]
    luts, masks = _bank(widths)
    m, k, n = 21, 70, 14
    qa = (np.stack([_codes((m, k), b) for b in widths]) if banked
          else _codes((m, k), 12))
    qw = _codes((k, n), 12)
    want = np.asarray(composed_matmul_bank_pallas(
        *(jnp.asarray(a) for a in (qa, qw, luts)),
        jnp.asarray(masks, jnp.uint32), reduce=reduce, interpret=True))
    got = ops.composed_matmul_lut_bank(_t(qa), _t(qw), _t(luts),
                                       _t(masks), reduce)
    assert tuple(got.shape) == (4, m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    lo, hi = ops.composed_matmul_lut_bank(_t(qa), _t(qw), _t(luts),
                                          _t(masks), reduce, raw=True)
    assert not hi[1].any()                   # narrow lane: no high limb
    for b in range(4):                       # lane b == K5 with lane b
        one = ops.composed_matmul_lut(_t(qa[b] if banked else qa), _t(qw),
                                      _t(luts[b]), int(masks[b]), reduce,
                                      raw=True)
        for a, c in zip(one, (lo[b], hi[b])):
            np.testing.assert_array_equal(a.numpy(), c.numpy())


def test_composed_bank_banked_weights_match_reference_lanes():
    """A bank mixing widths quantizes the weights per lane, so K6 also
    takes (n,K,N) codes: lane b equals the reference's single-table
    kernel on lane b's codes (its vmap rule for batched weights)."""
    widths = [16, 8, 12]
    luts, masks = _bank(widths, seed=40)
    qa = np.stack([_codes((17, 45), b) for b in widths])
    qw = np.stack([_codes((45, 11), b) for b in widths])
    got = ops.composed_matmul_lut_bank(_t(qa), _t(qw), _t(luts), _t(masks),
                                       ("loa", 4))
    for b in range(3):
        want = np.asarray(composed_matmul_pallas(
            *(jnp.asarray(a) for a in (qa[b], qw[b], luts[b])),
            jnp.uint32(masks[b]), reduce=("loa", 4), interpret=True))
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_composed_wrappers_reject_bad_operands():
    lut = _t(_lut())
    k = port_reg.MAX_COMPOSED_K + 1
    qa = torch.zeros((1, k), dtype=torch.int32)
    qw = torch.zeros((k, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="composed limb"):
        ops.composed_matmul_lut(qa, qw, lut, _mask(16))
    with pytest.raises(ValueError, match="composed limb"):
        ops.composed_matmul_lut_bank(qa, qw, lut[None], [0])
    qa, qw = _t(_codes((4, 5), 12)), _t(_codes((5, 3), 12))
    luts = lut.expand(2, 256, 256).contiguous()
    with pytest.raises(ValueError, match="lanes"):
        ops.composed_matmul_lut_bank(qa.expand(3, 4, 5).contiguous(), qw,
                                     luts, [0, 0])
    with pytest.raises(ValueError, match="lanes"):
        ops.composed_matmul_lut_bank(qa, qw.expand(3, 5, 3).contiguous(),
                                     luts, [0, 0])
    with pytest.raises(ValueError, match="qw 2"):
        ops.composed_matmul_lut(qa, qw.expand(1, 5, 3).contiguous(), lut, 0)
    with pytest.raises(ValueError, match="entries"):
        ops.composed_matmul_lut_bank(qa, qw, luts, torch.zeros(3))
    with pytest.raises(TypeError, match="int32"):
        ops.composed_matmul_lut(qa.long(), qw, lut, 0)
    with pytest.raises(ValueError, match="unknown reduction"):
        ops.composed_matmul_lut(qa, qw, lut, 0, ("bogus", 1))
    meta = [t.to("meta") for t in (qa, qw, lut.to(torch.uint16))]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.composed_matmul_lut(*meta, 0)


# ----------------------------------------------------------------------
# the lut_pallas datapath at 12/16 bits
# ----------------------------------------------------------------------
RECIPES = (("mul8u_exact", 12, "loa4"), ("mul8u_trunc5", 16, "loa4"))


@pytest.fixture(scope="module")
def lib():
    """One library object serves both packages (the port's own build
    equals the reference's entry for entry, tests/test_torch_core.py)."""
    lib = ref_build("tiny")
    for tile, width, reduce in RECIPES:
        lib.add_composed(tile, width, reduce, samples=512)
    return lib


def _names():
    return [f"mul{w}u_c_{t}_{r}" for t, w, r in RECIPES]


@pytest.mark.parametrize("which", [0, 1], ids=["12", "16"])
def test_backend_matmul_pallas_matches_fused_and_reference(which, lib):
    name = _names()[which]
    rng = np.random.default_rng(which)
    x = rng.normal(0.3, 1.5, (37, 29)).astype(np.float32)
    w = rng.normal(0.0, 0.2, (29, 11)).astype(np.float32)
    mb = RefSpec(mode="lut", multiplier=name,
                 variant="pallas").materialize(lib)
    want = np.asarray(jax.jit(lambda a, b: ref_backend.backend_matmul(
        a, b, mb))(jnp.asarray(x), jnp.asarray(w)))
    for variant in ("pallas", "fused"):
        got = port_backend.backend_matmul(
            torch.from_numpy(x), torch.from_numpy(w),
            BackendSpec(mode="lut", multiplier=name,
                        variant=variant).materialize(lib))
        np.testing.assert_array_equal(got.detach().numpy(), want)


@pytest.mark.parametrize("lanes", [False, True])
def test_banked_backend_pallas_matches_fused(lanes, lib):
    """A mixed-width bank (8, 12, 16 bits, one tree) under ``lut_pallas``
    (one K6 call) equals the ``lut_fused`` bank and the sequential
    ``lut_pallas`` lanes, shared or lane-carrying activations."""
    names = ["mul8u_bam_h0_v4"] + _names()
    bank = LutBank.from_library(names, lib)
    assert bank.bit_widths == (8, 12, 16)
    rng = np.random.default_rng(4)
    shape = (3, 40, 27) if lanes else (40, 27)
    x = torch.from_numpy(rng.normal(0.1, 1.2, shape).astype(np.float32))
    w = torch.from_numpy(rng.normal(0.0, 0.3, (27, 9)).astype(np.float32))
    out = {v: port_backend.backend_matmul(x, w, bank_backend(bank, "lut", v),
                                          lanes=lanes)
           for v in ("pallas", "fused")}
    np.testing.assert_array_equal(out["pallas"].numpy(),
                                  out["fused"].numpy())
    for b, name in enumerate(names):
        one = port_backend.backend_matmul(
            x[b] if lanes else x, w,
            BackendSpec(mode="lut", multiplier=name,
                        variant="pallas").materialize(lib))
        np.testing.assert_array_equal(out["pallas"][b].numpy(),
                                      one.detach().numpy())


def test_wide_pareto_pallas_rows_equal_fused():
    """The study's entry point under ``variant="pallas"`` (K1/K5/K6's
    plain versions) gives the ``fused`` run's rows: accuracy and
    logit fidelity, point for point, over all 12 candidates."""
    from repro_torch.launch import wide_pareto
    recs = {v: wide_pareto.run("cpu", eval_n=1, batch=1,
                               log=lambda s: None, variant=v)
            for v in ("pallas", "fused")}
    assert len(recs["pallas"]["candidates"]) == 12
    assert recs["pallas"]["variant"] == "pallas"
    assert recs["pallas"]["mixed_bit_identical"]
    assert recs["pallas"]["wide_bit_identical"]
    for key in ("sweep", "candidates", "pareto_front_accuracy",
                "pareto_front_fidelity", "wide_beyond_8bit_fidelity",
                "baseline_accuracy"):
        assert recs["pallas"][key] == recs["fused"][key], key


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
def test_cuda_composed_kernels_match_plain(cuda, m, k, n):
    widths = [12, 8, 16, 16]
    luts, masks = (_t(a).to(cuda) for a in _bank(widths))
    gen = torch.Generator(device=cuda).manual_seed(0)
    qa = torch.randint(0, 1 << 16, (4, m, k), generator=gen,
                       dtype=torch.int32, device=cuda)
    qw = torch.randint(0, 1 << 16, (k, n), generator=gen,
                       dtype=torch.int32, device=cuda)
    code = torch.tensor([port_reg.encode_reduce(("loa", 4))] * 4,
                        dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    got = ops.composed_matmul_lut(qa[2], qw, luts[2], masks[2], ("loa", 4),
                                  raw=True)
    want = ref.composed_matmul_limbs_ref(qa[2], qw, luts[2].to(torch.int32),
                                         masks[2:3], code[:1])
    qwb = torch.randint(0, 1 << 16, (4, k, n), generator=gen,
                        dtype=torch.int32, device=cuda)
    for a, w in ((qa[0], qw), (qa, qw), (qa, qwb)):
        got += ops.composed_matmul_lut_bank(a, w, luts, masks, ("loa", 4),
                                            raw=True)
        want += ref.composed_matmul_bank_ref(a, w, luts.to(torch.int32),
                                             masks, code)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    counts = ops.launch_counts()
    assert counts["composed_matmul"] == 1
    assert counts["composed_matmul_bank"] == 3
