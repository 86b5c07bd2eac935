"""ResNet-8 training in the port against the JAX reference on the CPU,
on 16x16 crops (as ``tests/test_torch_wide.py``; the conv weights do not
depend on the image size), from the reference's parameters:

* five ``Trainer`` steps from the reference's init — losses within 1e-4
  relative, every leaf within 1e-3 of its largest magnitude (BN reduces
  in another order than XLA, and Adam's first steps move each weight by
  about ``lr`` whatever the gradient's size);
* one STE step of the trained checkpoint under a ``lut`` policy against
  ``jax.grad`` of the jitted reference: the gradients within 1e-3 of
  each leaf's largest (the forward is quantized: a code on a rounding
  boundary can move one step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.approx.specs import BackendSpec as RefSpec
from repro.data.synthetic import CifarBatches
from repro.models import resnet as ref_resnet
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch.approx.layers import ApproxPolicy
from repro_torch.approx.specs import BackendSpec
from repro_torch.core.library import get_default_library
from repro_torch.models import resnet, weights
from repro_torch.train import loop, optimizer
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_parity import port_batch

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _resnet_data(n: int = 16, batch: int = 8):
    """Train batches of 16x16 crops, as numpy."""
    data = CifarBatches("train", n, batch)
    out = []
    for b in data.epoch():
        out.append({"images": np.ascontiguousarray(b["images"][:, :16, :16]),
                    "labels": b["labels"]})
    return out


def test_resnet_trainer_five_steps_match_reference(tmp_path):
    cfg = resnet.resnet_config(8)
    rp = ref_resnet.init_params(jax.random.PRNGKey(0), cfg)
    model = weights.params_from_numpy(jax.tree.map(np.asarray, rp))
    data = _resnet_data()
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5, weight_decay=1e-4)
    lkw = dict(total_steps=5, ckpt_every=10 ** 9, log_every=10 ** 9)

    def stream(conv):
        while True:
            for b in data:
                yield {k: conv(v) for k, v in b.items()}

    ref = ref_loop.Trainer(lambda p, b: ref_resnet.loss_fn(p, b, cfg), rp,
                           ref_opt.OptimizerConfig(**kw),
                           ref_loop.TrainLoopConfig(
                               ckpt_dir=str(tmp_path / "ref"), **lkw),
                           donate=False)
    ref_hist = ref.run(stream(jnp.asarray), log=lambda s: None)
    port = loop.Trainer(lambda m, b: resnet.loss_fn(m, b, cfg), model,
                        optimizer.OptimizerConfig(**kw),
                        loop.TrainLoopConfig(
                            ckpt_dir=str(tmp_path / "port"), **lkw))
    hist = port.run(stream(torch.from_numpy), log=lambda s: None)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in ref_hist], rtol=1e-4)
    assert port.params is model
    want = ref_opt._tree_paths(ref.params)
    got = optimizer.tree_leaves(model)
    assert [k for k, _ in got] == list(want)
    for k, p in got:
        r = np.asarray(want[k])
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=0,
                                   atol=1e-3 * float(np.max(np.abs(r))),
                                   err_msg=k)


def test_resnet_ste_step_matches_reference():
    """One STE step of the trained ResNet-8 under a ``lut`` policy (an
    approximate multiplier on two convs over the golden int8 base): the
    forward quantizes, the backward is the exact f32 matmul."""
    cfg = resnet.resnet_config(8)
    tree = weights.load_resnet8_checkpoint()
    model = weights.params_from_numpy(tree)
    rp = jax.tree.map(jnp.asarray, tree)
    lib = get_default_library()
    overrides = [("s0_b0_conv1", "mul8u_trunc6"),
                 ("s2_b0_conv2", "mul8u_bam_h0_v4")]
    policy = ApproxPolicy(default=BackendSpec.golden(), overrides=[
        (layer, BackendSpec(mode="lut", multiplier=m))
        for layer, m in overrides]).materialize(lib)
    ref_policy = RefPolicy(default=RefSpec.golden(), overrides=[
        (layer, RefSpec(mode="lut", multiplier=m))
        for layer, m in overrides]).materialize(lib)
    b = _resnet_data(8, 8)[0]
    loss_r, g_r = jax.jit(jax.value_and_grad(lambda p: ref_resnet.loss_fn(
        p, {k: jnp.asarray(v) for k, v in b.items()}, cfg, ref_policy)))(rp)
    loss = resnet.loss_fn(model, port_batch(b), cfg, policy)
    loss.backward()
    assert loss.item() == pytest.approx(float(loss_r), rel=1e-3)
    want = ref_opt._tree_paths(g_r)
    for k, p in optimizer.tree_leaves(model):
        r = np.asarray(want[k])
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=1e-3 * float(np.max(np.abs(r))),
                                   err_msg=k)
