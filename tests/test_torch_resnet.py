"""ResNet-8 of the port against the reference: im2col convolutions bit
for bit through the quantized datapaths, checkpoint logits within a
stated tolerance, and banked evaluation lane by lane.

Tolerances.  f32: ``F32_ATOL`` (float reductions in another order).
Quantized datapaths: ``QUANT_ATOL``.  Batch-statistics BN runs its
reductions in another order than XLA's, so its outputs differ in the
last bits; every later layer re-calibrates on them, and codes that sit
on a rounding boundary quantize one step apart.  The reference is no
steadier against itself: on the committed checkpoint and the four
test images used here its eager and jitted int8 logits differ by up
to 0.030 (port vs jitted reference: 0.022), and by 0.023-0.033 under
the high-accuracy LUT multipliers used here (port: 0.014-0.027).  Badly approximating
multipliers amplify the same noise to tenths of a logit in both
packages, so the model-level checks use the accurate end of the
case-study set; the sweep tests bound accuracies instead."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import layers as ref_layers
from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.approx.specs import BackendSpec as RefSpec
from repro.core.library import build_default_library as ref_build
from repro.data.synthetic import CifarBatches
from repro.models import resnet as ref_resnet
from repro.train.checkpoint import CheckpointManager
from repro_torch.approx import layers as port_layers
from repro_torch.approx.layers import ApproxPolicy, bank_eval
from repro_torch.approx.specs import BackendSpec, bank_for
from repro_torch.models import resnet, weights
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


F32_ATOL = 1e-4
QUANT_ATOL = 0.05
#: accurate case-study multipliers (all-layers accuracy >= 0.97 on the
#: full eval set)
GOOD = ("mul8u_bam_h0_v4", "mul8u_bam_h1_v0", "mul8u_bam_h0_v5")
CKPT = weights.RESNET8_CKPT.parent


@pytest.fixture(scope="module")
def setup():
    cfg = resnet.resnet_config(8)
    # restore needs only the param tree's structure and shapes
    template = jax.tree.map(np.zeros_like,
                            weights.load_resnet8_checkpoint())
    (params, _), _ = CheckpointManager(str(CKPT), keep=1).restore(
        (template, template))
    model = weights.load_resnet8()
    b = next(CifarBatches("test", 4, 4).eval_batches())
    # one library object serves both packages: the port's own build
    # equals the reference's entry for entry (tests/test_torch_core.py)
    ref_lib = port_lib = ref_build("tiny")
    names = [e.name for e in port_lib.case_study_selection()]
    assert set(GOOD) <= set(names)
    return cfg, params, model, b, ref_lib, port_lib, list(GOOD)


def _ref_logits(params, images, cfg, policy):
    return np.asarray(jax.jit(lambda x: ref_resnet.forward(
        params, x, cfg, policy))(jnp.asarray(images)))


def _port_logits(model, images, cfg, policy):
    with torch.inference_mode():
        return resnet.forward(model, torch.from_numpy(images), cfg,
                              policy).numpy()


def test_checkpoint_reader_matches_reference_restore(setup):
    cfg, params, model, *_ = setup
    tree = weights.load_resnet8_checkpoint()
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == sum(1 for _ in model.parameters()) == 25
    for path, leaf in flat:
        node = tree
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    again = weights.params_from_numpy(jax.tree.map(np.asarray, params))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k
    assert again.cfg == cfg


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 2)])
@pytest.mark.parametrize("mode", ["int8", "lut", "f32"])
def test_conv2d_matches_reference(kernel, stride, mode, setup):
    *_, ref_lib, port_lib, names = setup
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.normal(0, 1, (2, 9, 10, 5)).astype(np.float32)
    w = rng.normal(0, 0.3, (kernel, kernel, 5, 7)).astype(np.float32)
    spec = {"int8": dict(mode="int8"),
            "lut": dict(mode="lut", multiplier=names[0]),
            "f32": dict(mode="f32")}[mode]
    rp = RefPolicy(default=RefSpec(**spec).materialize(ref_lib))
    want = np.asarray(jax.jit(lambda a, b: ref_layers.conv2d(
        rp, "c", a, b, stride=stride))(jnp.asarray(x), jnp.asarray(w)))
    pp = ApproxPolicy(default=BackendSpec(**spec).materialize(port_lib))
    got = port_layers.conv2d(pp, "c", torch.from_numpy(x),
                             torch.from_numpy(w), stride=stride).numpy()
    assert got.shape == want.shape
    if mode == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["f32", "int8", "lut"])
def test_checkpoint_logits_close_to_reference(mode, setup):
    cfg, params, model, b, ref_lib, port_lib, names = setup
    spec = {"f32": dict(mode="f32"), "int8": dict(mode="int8"),
            "lut": dict(mode="lut", multiplier=names[0])}[mode]
    want = _ref_logits(params, b["images"], cfg,
                       RefPolicy(default=RefSpec(**spec)
                                 .materialize(ref_lib)))
    got = _port_logits(model, b["images"], cfg,
                       ApproxPolicy(default=BackendSpec(**spec)
                                    .materialize(port_lib)))
    assert got.shape == (4, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_ATOL if mode == "f32" else QUANT_ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def ref_lane0(setup):
    """Reference logits of the bank's first lane, per swept layer (one
    jit compile per layer, shared by both variants)."""
    cfg, params, _, b, ref_lib, *_ = setup
    rspec = RefSpec(mode="lut", multiplier=GOOD[0]).materialize(ref_lib)
    cache = {}

    def get(layer):
        if layer not in cache:
            rpol = (RefPolicy(default=rspec) if layer is None else
                    RefPolicy(default=RefSpec.golden().materialize(),
                              overrides=[(layer, rspec)]))
            cache[layer] = _ref_logits(params, b["images"], cfg, rpol)
        return cache[layer]
    return get


@pytest.mark.parametrize("layer", [None, "s2_b0_proj"])
@pytest.mark.parametrize("variant", ["ref", "pallas"])
def test_bank_eval_lanes_equal_sequential(layer, variant, setup, ref_lane0):
    """Lane i of a banked pass equals the sequential policy for
    multiplier i bit for bit in the port (``mul8u_trunc5``, a badly
    approximating lane, included); lane 0 stays within the logit
    tolerance of the reference's sequential evaluation."""
    cfg, params, model, b, ref_lib, port_lib, names = setup
    names = names + ["mul8u_trunc5"]
    bank = bank_for(names, port_lib)
    images = torch.from_numpy(b["images"])
    labels = torch.from_numpy(b["labels"])

    def fn(policy):
        logits = resnet.forward(model, images, cfg, policy)
        acc = torch.mean((logits.argmax(-1) == labels).float(), dim=-1)
        return {"logits": logits, "accuracy": acc}

    out = bank_eval(fn, bank, mode="lut", variant=variant,
                    layer_pattern=layer)
    assert tuple(out["logits"].shape) == (4, 4, 10)
    golden = BackendSpec.golden().materialize()
    for i, name in enumerate(names):
        spec = BackendSpec(mode="lut", multiplier=name, variant=variant)
        mb = spec.materialize(port_lib)
        policy = (ApproxPolicy(default=mb) if layer is None else
                  ApproxPolicy(default=golden, overrides=[(layer, mb)]))
        seq = _port_logits(model, b["images"], cfg, policy)
        np.testing.assert_array_equal(out["logits"][i].numpy(), seq)
        assert float(out["accuracy"][i]) == float(
            np.mean(seq.argmax(-1) == b["labels"]))
    np.testing.assert_allclose(out["logits"][0].numpy(), ref_lane0(layer),
                               rtol=0, atol=QUANT_ATOL)


def test_loss_and_accuracy_match_reference(setup):
    cfg, params, model, b, *_ = setup
    batch = {"images": jnp.asarray(b["images"]),
             "labels": jnp.asarray(b["labels"])}
    tb = {"images": torch.from_numpy(b["images"]),
          "labels": torch.from_numpy(b["labels"])}
    with torch.inference_mode():
        loss = float(resnet.loss_fn(model, tb))
        acc = float(resnet.accuracy(model, tb))
    np.testing.assert_allclose(
        loss, float(jax.jit(lambda p: ref_resnet.loss_fn(p, batch, cfg))(
            params)), rtol=1e-5)
    assert acc == float(jax.jit(lambda p: ref_resnet.accuracy(
        p, batch, cfg))(params))


def test_layer_mult_counts_match_reference(setup):
    from repro.approx.workload import layer_mult_counts as ref_counts
    from repro_torch.approx.workload import layer_mult_counts
    cfg = setup[0]
    for batch in (1, 64):
        assert layer_mult_counts(cfg, batch) == ref_counts(cfg, batch)
        assert (resnet.layer_mult_counts(cfg, batch)
                == ref_resnet.layer_mult_counts(cfg, batch))
    assert len(resnet.layer_mult_counts(cfg)) == 9


def test_random_init_is_seeded():
    cfg = resnet.resnet_config(8)
    a = resnet.ResNet(cfg, torch.Generator().manual_seed(3))
    b = resnet.ResNet(cfg, torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    with pytest.raises(ValueError, match="6n\\+2"):
        resnet.resnet_config(9)
