"""``backend_matmul`` of the port against the jitted reference: int8 and
LUT datapaths (ref and the CUDA-kernel variant, which runs its plain
version on the CPU) bit for bit on ragged shapes; f32 within 1e-5
relative (float sums in another order).  Also: banked evaluation lane
by lane, the JSON form of specs and policies across the two packages,
and the lowrank datapaths' factors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import backend as ref_backend
from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.approx.specs import BackendSpec as RefSpec
from repro.core.library import build_default_library as ref_build
from repro_torch.approx import backend as port_backend
from repro_torch.approx.layers import ApproxPolicy, bank_backend
from repro_torch.approx.specs import BackendSpec, LutBank, bank_for
from repro_torch.core.library import build_default_library as port_build

SHAPES = [(37, 29, 11), (3, 5, 7, 16), (128, 144, 32), (1, 64, 10)]


@pytest.fixture(scope="module")
def libs():
    ref, port = ref_build("tiny"), port_build("tiny")
    names = [e.name for e in port.case_study_selection()][-3:]
    return ref, port, names


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    *lead, k, n = shape
    x = rng.normal(0.3, 1.5, (*lead, k)).astype(np.float32)
    w = rng.normal(0.0, 0.2, (k, n)).astype(np.float32)
    return x, w


def _ref(x, w, spec, lib):
    mb = spec.materialize(lib)
    return np.asarray(jax.jit(lambda a, b: ref_backend.backend_matmul(
        a, b, mb))(jnp.asarray(x), jnp.asarray(w)))


def _port(x, w, spec, lib, **kw):
    return port_backend.backend_matmul(
        torch.from_numpy(x), torch.from_numpy(w), spec.materialize(lib),
        **kw).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_int8_bit_exact(shape, libs):
    ref, port, _ = libs
    x, w = _operands(shape, 1)
    np.testing.assert_array_equal(
        _port(x, w, BackendSpec.golden(), port),
        _ref(x, w, RefSpec.golden(), ref))


@pytest.mark.parametrize("variant", ["ref", "pallas"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_lut_bit_exact(shape, variant, libs):
    """The port's CUDA-kernel variant (plain version on the CPU) and its
    ref variant both equal the reference's jitted LUT datapath."""
    ref, port, names = libs
    x, w = _operands(shape, 2)
    for name in names:
        want = _ref(x, w, RefSpec(mode="lut", multiplier=name), ref)
        got = _port(x, w, BackendSpec(mode="lut", multiplier=name,
                                      variant=variant), port)
        np.testing.assert_array_equal(got, want)


def test_lut_pallas_variant_matches_reference_pallas(libs):
    ref, port, names = libs
    x, w = _operands((20, 33, 12), 3)
    want = _ref(x, w, RefSpec(mode="lut", multiplier=names[0],
                              variant="pallas"), ref)
    got = _port(x, w, BackendSpec(mode="lut", multiplier=names[0],
                                  variant="pallas"), port)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_f32_close(shape, libs):
    ref, port, _ = libs
    x, w = _operands(shape, 4)
    want = _ref(x, w, RefSpec(mode="f32"), ref)
    got = _port(x, w, BackendSpec(mode="f32"), port)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_close(libs):
    ref, port, _ = libs
    x, w = _operands((16, 40, 8), 5)
    want = _ref(x, w, RefSpec(mode="bf16"), ref)
    got = _port(x, w, BackendSpec(mode="bf16"), port)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["ref", "pallas"])
def test_banked_backend_lanes_equal_reference(variant, libs):
    """A banked backend on unbanked x: lane i equals the reference's
    sequential backend_matmul with multiplier i."""
    ref, port, names = libs
    x, w = _operands((2, 9, 30, 14), 6)
    mb = bank_backend(bank_for(names, port), "lut", variant)
    got = port_backend.backend_matmul(torch.from_numpy(x),
                                      torch.from_numpy(w), mb).numpy()
    assert got.shape == (len(names), 2, 9, 14)
    for i, name in enumerate(names):
        np.testing.assert_array_equal(
            got[i], _ref(x, w, RefSpec(mode="lut", multiplier=name), ref))


@pytest.mark.parametrize("spec", [BackendSpec.golden(),
                                  BackendSpec(mode="lut",
                                              multiplier="mul8u_trunc6",
                                              variant="pallas"),
                                  BackendSpec(mode="f32")],
                         ids=["int8", "lut_pallas", "f32"])
def test_lane_carrying_input_calibrates_per_lane(spec, libs):
    """x with a lane axis (lanes=True): each lane calibrates on its own
    and equals the reference's evaluation of that lane alone."""
    ref, port, _ = libs
    x, w = _operands((3, 25, 18, 6), 7)
    x[1] *= 5.0
    got = _port(x, w, spec, port, lanes=True)
    ref_spec = RefSpec.from_dict(spec.to_dict())
    assert got.shape == (3, 25, 6)
    for i in range(3):
        want = _ref(x[i], w, ref_spec, ref)
        if spec.mode == "f32":
            np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[i], want)


def test_ste_gradients_are_the_exact_matmul(libs):
    _, port, names = libs
    x, w = (torch.from_numpy(a) for a in _operands((6, 10, 4), 8))
    x.requires_grad_(True)
    w.requires_grad_(True)
    spec = BackendSpec(mode="lut", multiplier=names[0])
    y = port_backend.backend_matmul(x, w, spec.materialize(port))
    g = torch.ones_like(y)
    y.backward(g)
    np.testing.assert_allclose(x.grad.numpy(), (g @ w.T).detach().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), (x.T @ g).detach().numpy(),
                               rtol=1e-6)


def test_spec_and_policy_json_cross_packages():
    specs = [BackendSpec(), BackendSpec.golden(), BackendSpec(mode="f32"),
             BackendSpec(mode="lut", multiplier="mul8u_trunc6",
                         variant="pallas", block_m=256, ste=False),
             BackendSpec(mode="lut", multiplier="mul8u_bam_h1_v4",
                         bit_width=8, rank=3)]
    for s in specs:
        r = RefSpec.from_json(s.to_json())
        assert r.to_json() == s.to_json()
        assert BackendSpec.from_json(r.to_json()) == s
        assert BackendSpec.from_dict(r.to_dict()) == s
    policy = ApproxPolicy(default=specs[1],
                          overrides=[("s1_*", specs[3]), ("head", specs[2])])
    blob = policy.to_json()
    back = RefPolicy.from_json(blob)
    assert back.to_json() == blob
    again = ApproxPolicy.from_json(back.to_json())
    assert again.to_json() == blob
    assert again.backend_for("s1_b0_conv1") == specs[3]
    assert again.cache_key() == policy.cache_key()
    with pytest.raises(ValueError, match="unknown BackendSpec fields"):
        BackendSpec.from_dict({"mode": "lut", "bogus": 1})
    with pytest.raises(ValueError, match="variant"):
        BackendSpec(variant="triton")


def test_unported_datapaths_raise_with_roadmap_item(libs):
    """Every datapath is ported now: both lowrank variants (``pallas``
    runs kernel K9) materialize to the reference's factors bit for bit,
    and composed widths materialize under every variant (``pallas``
    runs the two-step composed kernels K5/K6)."""
    ref, port, names = libs
    for variant in ("ref", "pallas"):
        for rank in (None, 4):
            want = RefSpec(mode="lowrank", multiplier=names[0], rank=rank,
                           variant=variant).materialize(ref).consts
            got = BackendSpec(mode="lowrank", multiplier=names[0],
                              rank=rank, variant=variant).materialize(
                                  port).consts
            for key in ("u", "v"):
                np.testing.assert_array_equal(got[key], want[key])
    lib = port_build("tiny")
    wide = lib.add_composed(names[0], 12, samples=1 << 10)
    for variant in ("ref", "fused", "pallas"):
        assert BackendSpec(mode="lut", multiplier=wide.name,
                           variant=variant).materialize(lib).consts["bits"] \
            == 12
    bank = LutBank.from_library([names[0], wide.name], lib)
    assert bank.any_wide and bank.bit_widths == (8, 12)
    for variant in ("ref", "fused", "pallas"):
        consts = bank_backend(bank, "lut", variant).consts
        assert consts["composed"] and consts["masks"][0] == 0


def test_materialize_cache_shares_backends(libs):
    _, port, names = libs
    a = BackendSpec(mode="lut", multiplier=names[0], variant="pallas")
    b = a.with_(block_m=64)          # block_m: not a lut_pallas field
    assert a.materialize(port) is b.materialize(port)
    assert (BackendSpec.golden().materialize()
            is BackendSpec(mode="int8", multiplier="x").materialize())
