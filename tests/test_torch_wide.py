"""The wide-width slice of the port against the JAX reference: the
width-generic ``LutBank``, the composed ``lut`` and fused datapaths
through ``backend_matmul``, ``logit_fidelity``, and a mixed-width bank
(two accurate 8-bit lanes, one 12-bit and one 16-bit composed lane) run
through the trained ResNet-8.

Tolerances.  Layer-level results are bit-exact.  Model-level logits
hold ``QUANT_ATOL`` = 0.05 against the reference, the bound of
``tests/test_torch_resnet.py``: batch-statistics BN reduces in another
order than XLA, so a code on a rounding boundary can quantize one step
apart in a later layer.  The ResNet-8 here sees 8 test images cropped
to 16x16 (the conv weights do not depend on the image size): the
composed plain path gathers four products per multiply on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import backend as ref_backend
from repro.approx import workload as ref_workload
from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.approx.specs import BackendSpec as RefSpec
from repro.approx.specs import LutBank as RefBank
from repro.core.library import build_default_library as ref_build
from repro.data.synthetic import CifarBatches
from repro.models import resnet as ref_resnet
from repro.train.checkpoint import CheckpointManager
from repro_torch.approx import backend as port_backend
from repro_torch.approx.layers import ApproxPolicy, bank_eval
from repro_torch.approx.specs import BackendSpec, LutBank, bank_for
from repro_torch.approx.workload import logit_fidelity
from repro_torch.models import resnet, weights
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


QUANT_ATOL = 0.05
GOOD = ("mul8u_bam_h0_v4", "mul8u_bam_h1_v0")
#: accurate composed entries (exact tiles): the model-level tolerance
#: holds for accurate multipliers only (tests/test_torch_resnet.py)
RECIPES = (("mul8u_exact", 12, "loa4"), ("mul8u_exact", 16, "loa4"),
           ("mul8u_exact", 16, "trunc3"))


@pytest.fixture(scope="module")
def lib():
    """One library object serves both packages (the port's own build
    equals the reference's entry for entry, tests/test_torch_core.py)."""
    lib = ref_build("tiny")
    for tile, width, reduce in RECIPES:
        lib.add_composed(tile, width, reduce, samples=512)
    return lib


@pytest.fixture(scope="module")
def wide(lib):
    n12, n16, n16t = (f"mul{w}u_c_{t}_{r}" for t, w, r in RECIPES)
    assert {n12, n16, n16t} <= set(lib.entries)
    return n12, n16, n16t


def test_wide_lut_bank_matches_reference(lib, wide):
    n12, n16, n16t = wide
    names = [GOOD[0], n12, n16, GOOD[1]]
    port, ref = LutBank.from_library(names, lib), RefBank.from_library(
        names, lib)
    np.testing.assert_array_equal(port.luts, ref.luts)
    for attr in ("bit_widths", "reduce", "reduces", "is_mixed_reduce",
                 "any_wide", "n_mult"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for attr in ("lane_bits", "lane_masks", "lane_reduce_codes"):
        np.testing.assert_array_equal(getattr(port, attr),
                                      getattr(ref, attr))
    assert port.bit_widths == (8, 12, 16, 8) and port.reduce == "loa4"
    with pytest.raises(ValueError, match="mixed"):
        LutBank.from_library([n16, n16t], lib)
    mixed = bank_for([n16, n16t, GOOD[0]], lib, mixed_reduce=True)
    ref_mixed = RefBank.from_library([n16, n16t, GOOD[0]], lib,
                                     mixed_reduce=True)
    assert mixed.is_mixed_reduce and mixed.reduces == ref_mixed.reduces
    np.testing.assert_array_equal(mixed.lane_reduce_codes,
                                  ref_mixed.lane_reduce_codes)
    assert bank_for([n16, n16t, GOOD[0]], lib, mixed_reduce=True) is mixed
    narrow = LutBank.from_library(GOOD, lib)
    assert not narrow.any_wide and narrow.lane_masks.tolist() == [0, 0]


@pytest.mark.parametrize("which", ["8", "12", "16"])
def test_backend_matmul_fused_and_ref_match_reference(which, lib, wide):
    """One multiplier through ``backend_matmul``: the port's fused and
    plain datapaths equal each other and the jitted reference bit for
    bit, 12/16-bit composed entries included."""
    name = {"8": GOOD[0], "12": wide[0], "16": wide[1]}[which]
    rng = np.random.default_rng(int(which))
    x = rng.normal(0.3, 1.5, (37, 29)).astype(np.float32)
    w = rng.normal(0.0, 0.2, (29, 11)).astype(np.float32)
    mb = RefSpec(mode="lut", multiplier=name).materialize(lib)
    want = np.asarray(jax.jit(lambda a, b: ref_backend.backend_matmul(
        a, b, mb))(jnp.asarray(x), jnp.asarray(w)))
    for variant in ("ref", "fused"):
        got = port_backend.backend_matmul(
            torch.from_numpy(x), torch.from_numpy(w),
            BackendSpec(mode="lut", multiplier=name,
                        variant=variant).materialize(lib))
        np.testing.assert_array_equal(got.detach().numpy(), want)


@pytest.fixture(scope="module")
def resnet8():
    cfg = resnet.resnet_config(8)
    template = jax.tree.map(np.zeros_like,
                            weights.load_resnet8_checkpoint())
    (params, _), _ = CheckpointManager(
        str(weights.RESNET8_CKPT.parent), keep=1).restore((template,
                                                           template))
    b = next(CifarBatches("test", 8, 8).eval_batches())
    images = np.ascontiguousarray(b["images"][:, :16, :16])
    return cfg, params, weights.load_resnet8(), images


@pytest.mark.parametrize("layer", [None, "s1_b0_conv1"])
def test_mixed_width_resnet_slice(layer, lib, wide, resnet8):
    """Two 8-bit lanes, one 12-bit and one 16-bit lane in one bank:
    banked fused == sequential fused, and (per-layer sweep) == the banked
    plain datapath, bit for bit.  All layers approximated, the wide lanes
    stay within ``QUANT_ATOL`` of the reference's sequential
    ``variant="ref"`` logits (the 8-bit lanes' are held in
    tests/test_torch_resnet.py).  With one layer approximated the other
    layers run golden int8, whose own port-vs-reference logit noise on
    these 16x16 crops is 0.06 (0.017 at 32x32), so that case is held
    inside the port only."""
    cfg, params, model, images = resnet8
    names = [GOOD[0], wide[0], wide[1], GOOD[1]]
    bank = bank_for(names, lib)
    img = torch.from_numpy(images)

    def fn(policy):
        return {"logits": resnet.forward(model, img, cfg, policy)}

    fused = bank_eval(fn, bank, variant="fused", layer_pattern=layer)
    assert tuple(fused["logits"].shape) == (4, 8, 10)
    if layer is not None:
        plain = bank_eval(fn, bank, variant="ref", layer_pattern=layer)
        assert torch.equal(fused["logits"], plain["logits"])
    golden = BackendSpec.golden().materialize()
    for i, name in enumerate(names):
        mb = BackendSpec(mode="lut", multiplier=name,
                         variant="fused").materialize(lib)
        policy = (ApproxPolicy(default=mb) if layer is None else
                  ApproxPolicy(default=golden, overrides=[(layer, mb)]))
        with torch.inference_mode():
            seq = resnet.forward(model, img, cfg, policy)
        assert torch.equal(fused["logits"][i], seq), name
        if layer is not None or name in GOOD:
            continue
        rpol = RefPolicy(default=RefSpec(mode="lut", multiplier=name)
                         .materialize(lib))
        want = np.asarray(jax.jit(lambda x: ref_resnet.forward(
            params, x, cfg, rpol))(jnp.asarray(images)))
        np.testing.assert_allclose(seq.numpy(), want, rtol=0,
                                   atol=QUANT_ATOL, err_msg=name)


def _toy():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    w_a = rng.normal(size=(16, 16)).astype(np.float32)
    w_b = rng.normal(size=(16, 4)).astype(np.float32)
    return x, w_a, w_b


def test_mixed_reduce_bank_fused_only(lib, wide):
    """A bank mixing reduction trees runs under ``fused`` only (the
    reference's rule), one launch per layer, each lane equal to its
    sequential evaluation."""
    _, n16, n16t = wide
    x, w_a, w_b = (torch.from_numpy(a) for a in _toy())

    def fn(policy):
        y = policy.matmul("lin_a", x, w_a)
        lanes = y.ndim == 3
        return {"y": policy.matmul("lin_b", torch.relu(y), w_b,
                                   lanes=lanes)}

    names = [n16, n16t, GOOD[0]]
    bank = bank_for(names, lib, mixed_reduce=True)
    with pytest.raises(ValueError, match="fused"):
        bank_eval(fn, bank, variant="ref")
    out = bank_eval(fn, bank, variant="fused")["y"]
    for i, name in enumerate(names):
        mb = BackendSpec(mode="lut", multiplier=name,
                         variant="fused").materialize(lib)
        with torch.inference_mode():
            assert torch.equal(out[i], fn(ApproxPolicy(default=mb))["y"])


def test_logit_fidelity_matches_reference(lib, wide):
    x, w_a, w_b = _toy()
    inputs = [x, x[::-1].copy()]

    def ref_forward(policy, a):
        return policy.matmul("lin_b", jax.nn.relu(
            policy.matmul("lin_a", a, jnp.asarray(w_a))), jnp.asarray(w_b))

    def port_forward(policy, a):
        y = policy.matmul("lin_a", a, torch.from_numpy(w_a))
        return policy.matmul("lin_b", torch.relu(y), torch.from_numpy(w_b),
                             lanes=y.ndim == 3)

    ref_wl = ref_workload.logit_fidelity(ref_forward,
                                         [jnp.asarray(a) for a in inputs])
    port_wl = logit_fidelity(port_forward,
                             [torch.from_numpy(a) for a in inputs])
    assert (port_wl.metrics, port_wl.primary, dict(port_wl.directions)) == (
        ref_wl.metrics, ref_wl.primary, dict(ref_wl.directions))
    names = [GOOD[0], wide[1]]
    seq = []
    for name in names:
        got = port_wl.measure(ApproxPolicy(default=BackendSpec(
            mode="lut", multiplier=name).materialize(lib)))
        want = ref_wl.measure(RefPolicy(default=RefSpec(
            mode="lut", multiplier=name).materialize(lib)))
        assert got["top1_agreement"] == want["top1_agreement"]
        # the f32 reference logits sum in another order than XLA's
        np.testing.assert_allclose(got["logit_mae"], want["logit_mae"],
                                   rtol=0, atol=1e-6)
        seq.append(got)
    banked = bank_eval(port_wl.traceable_metrics, bank_for(names, lib),
                       variant="fused")
    for i, got in enumerate(seq):
        assert {k: float(v[i]) for k, v in banked.items()} == got
