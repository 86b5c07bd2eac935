"""The training core of the port (``repro_torch.train``, ``approx.quant.
fake_quant``) held against the JAX reference on the CPU.

* ``fake_quant``, ``quantize_leaf`` and ``compress_with_feedback``: bit
  for bit (the reference's calibration jitted, as its main paths run
  it; the compression eager, as its tests call it).
* ``lr_at`` within 1 ulp over the whole schedule; one ``adamw_update``
  on identical gradients within 2 ulp a leaf (``grad_norm`` within 1e-6
  relative) on a tree with decayed and exempt leaves — ``final_norm``
  among the decayed, as the reference's ``_decayable`` has it.
* microbatched accumulation equal to the full batch within 1e-5, and
  the microbatched step within 4 ulp of the reference's.
* checkpoints in both directions (bit for bit, same manifest keys,
  shapes, dtypes and policy), the committed ResNet-8 checkpoint into the
  port's ``ResNet``, an async save whose tensors change in place right
  after, the NaN guard, gc and atomicity.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import quant as ref_quant
from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.models import resnet as ref_resnet
from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_comp
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch.approx import quant
from repro_torch.approx.layers import ApproxPolicy
from repro_torch.approx.specs import BackendSpec
from repro_torch.models import resnet, weights
from repro_torch.train import checkpoint, compression, loop, optimizer
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tree(seed: int = 0) -> dict:
    """An LM-like tree: decayed weights, exempt norms/biases, a stacked
    leaf and ``final_norm`` (decayed: it does not start with ``norm``)."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": f(11, 6), "final_norm": f(6), "unembed": f(11, 6),
            "blocks": {"norm1_0": f(2, 6), "mixer_0": {
                "wq": f(2, 6, 8), "bq": f(2, 8), "qnorm": f(2, 4),
                "a_log": f(2, 3), "dt_bias": f(2, 3)},
                "ffn_0": {"wi": f(2, 6, 5), "wo": f(2, 5, 6)}}}


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _ulps(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b) / np.spacing(np.maximum(
        np.abs(a), np.finfo(np.float32).tiny))))


@pytest.mark.parametrize("bits", [8, 12, 16])
def test_fake_quant_bit_for_bit(bits):
    x = np.random.default_rng(bits).normal(0.3, 2.0, (37, 29)).astype(
        np.float32)
    want = jax.jit(ref_quant.fake_quant, static_argnames="bits")(
        jnp.asarray(x), bits=bits)
    got = quant.fake_quant(torch.from_numpy(x), bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    qp = quant.calibrate(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(
        quant.fake_quant(torch.from_numpy(x), qp).numpy(), got.numpy())


def test_quantize_leaf_and_feedback_bit_for_bit():
    tree = _tree(1)
    q, s = compression.quantize_leaf(torch.from_numpy(tree["embed"]))
    rq, rs = ref_comp.quantize_leaf(jnp.asarray(tree["embed"]))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(
        compression.dequantize_leaf(q, s).numpy(),
        np.asarray(ref_comp.dequantize_leaf(rq, rs)))
    res = compression.init_residual(_to_torch(tree))
    ref_res = ref_comp.init_residual(jax.tree.map(jnp.asarray, tree))
    for step in range(3):
        grads = _tree(10 + step)
        deq, res = compression.compress_with_feedback(_to_torch(grads),
                                                      res)
        rdeq, ref_res = ref_comp.compress_with_feedback(
            jax.tree.map(jnp.asarray, grads), ref_res)
        for (k, a), (_, b) in zip(optimizer.tree_leaves(deq),
                                  optimizer.tree_leaves(_to_torch(rdeq))):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
        for (k, a), (_, b) in zip(
                optimizer.tree_leaves(res),
                optimizer.tree_leaves(_to_torch(ref_res))):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)


def test_lr_at_within_one_ulp():
    """Within 1 ulp wherever both packages' f32 cosines agree.  XLA's
    f32 cos is one ulp off the correctly rounded value on a few steps
    (torch's is not); there ``1 + cos`` near 0 magnifies that ulp, and
    the bound adds what it moves: ``lr (1 - min_lr) / 2 |dcos|``."""
    for kw in (dict(lr=3e-3, warmup_steps=20, total_steps=320),
               dict(lr=3e-4, warmup_steps=0, total_steps=9),
               dict(lr=1e-2, warmup_steps=5, total_steps=5)):
        rc, pc = ref_opt.OptimizerConfig(**kw), optimizer.OptimizerConfig(
            **kw)
        for s in range(kw["total_steps"] + 3):
            want = np.float32(ref_opt.lr_at(rc, jnp.int32(s)))
            got = optimizer.lr_at(pc, torch.tensor(s, dtype=torch.int32))
            prog = min(max((s - kw["warmup_steps"])
                           / max(kw["total_steps"] - kw["warmup_steps"], 1),
                           0.0), 1.0)
            x = np.float32(np.pi) * np.float32(prog)
            dcos = abs(float(jnp.cos(jnp.float32(x)))
                       - float(torch.cos(torch.tensor(x))))
            assert dcos <= np.spacing(np.float32(1.0)), (kw, s)
            bound = (np.spacing(want)
                     + kw["lr"] * (1 - rc.min_lr_ratio) / 2 * dcos * 1.001)
            assert abs(float(got) - float(want)) <= bound, (kw, s)


def test_paths_and_decay_mask_match_reference():
    """Leaf paths and order equal ``jax.tree_util``'s for an LM tree, a
    ResNet (module vs the reference's param dict) and an optimizer
    state; ``_decayable`` equal on every path."""
    tree = _tree()
    want = [(k, p) for k, p in ref_opt._tree_paths(tree).items()]
    got = optimizer.tree_leaves(_to_torch(tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    cfg = resnet.resnet_config(8)
    ref_params = ref_resnet.init_params(jax.random.PRNGKey(0), cfg)
    assert ([k for k, _ in optimizer.tree_leaves(resnet.ResNet(cfg))]
            == list(ref_opt._tree_paths(ref_params)))
    state = ref_opt.init_opt_state(tree)
    flat, _ = jax.tree_util.tree_flatten_with_path((tree, state))
    ref_keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path) for path, _ in flat]
    port = _to_torch(tree)
    assert [k for k, _ in optimizer.tree_leaves(
        (port, optimizer.init_opt_state(port)))] == ref_keys
    for k in list(ref_opt._tree_paths(tree)) + ["a/final_norm", "x/b",
                                                 "x/bias", "y/kvn_w"]:
        assert optimizer._decayable(k) == ref_opt._decayable(k), k
    assert optimizer._decayable("final_norm")
    assert not optimizer._decayable("blocks/norm1_0")


def test_adamw_update_matches_reference():
    """One step on identical gradients (clipped: the norm is above
    ``clip_norm``), then a second: each leaf within 2 ulp."""
    tree = _tree()
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    rc, pc = ref_opt.OptimizerConfig(**kw), optimizer.OptimizerConfig(**kw)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref_opt.init_opt_state(rp)
    pp = _to_torch(tree)
    ps = optimizer.init_opt_state(pp)
    for step in range(2):
        g = _tree(20 + step)
        rp, rs, rm = ref_opt.adamw_update(
            rp, jax.tree.map(jnp.asarray, g), rs, rc)
        pp, ps, pm = optimizer.adamw_update(pp, _to_torch(g), ps, pc)
        assert float(pm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        assert _ulps(rm["lr"], pm["lr"]) <= 1.0
        assert int(ps.step) == int(rs.step) == step + 1
        for (k, a), (_, b) in zip(
                optimizer.tree_leaves((pp, ps.m, ps.v)),
                optimizer.tree_leaves(_to_torch((rp, rs.m, rs.v)))):
            assert _ulps(b.numpy(), a.numpy()) <= 2.0, k


def _quadratic_loss(params, batch):
    return torch.sum((params["w"] * batch["x"] - batch["y"]) ** 2)


def test_microbatched_equals_full_batch():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    y = rng.standard_normal((8, 5)).astype(np.float32)
    w0 = rng.standard_normal(5).astype(np.float32)

    def loss(params, batch):
        return torch.mean((params["w"] * batch["x"] - batch["y"]) ** 2)
    cfg = optimizer.OptimizerConfig(lr=0.05, warmup_steps=0)
    out = {}
    for mb in (1, 4):
        params = {"w": torch.from_numpy(w0.copy())}
        state = optimizer.init_opt_state(params)
        step = loop.make_train_step(loss, cfg, microbatches=mb)
        batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        if mb > 1:
            batch = {k: v.reshape(mb, -1, 5) for k, v in batch.items()}
        for _ in range(3):
            _, _, metrics = step(params, state, batch)
        out[mb] = (params["w"].detach().numpy(), float(metrics["loss"]))
    np.testing.assert_allclose(out[4][0], out[1][0], rtol=0, atol=1e-5)
    assert out[4][1] == pytest.approx(out[1][1], abs=1e-5)


def test_microbatched_step_matches_reference():
    """``make_train_step(..., microbatches=4)`` in both packages on the
    same parameters and (4, 2, 5) batches for 3 steps: the microbatch
    order, the loss division and the gradient scaling as the reference's
    ``lax.scan`` has them.  The loss within 2 ulp, each leaf within 4
    ulp of its largest magnitude: XLA compiles the scan's body, and its
    fused backward gives a microbatch's gradient entries a few ulp off
    torch's (eager ``jax.grad`` equals torch's bit for bit), which small
    entries of m and v magnify when counted in their own ulps."""
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal(5).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    batches = [{"x": rng.standard_normal((4, 2, 5)).astype(np.float32),
                "y": rng.standard_normal((4, 2, 5)).astype(np.float32)}
               for _ in range(3)]

    def ref_loss(params, batch):
        return jnp.mean((params["w"] * batch["x"] + params["b"]
                         - batch["y"]) ** 2)

    def loss(params, batch):
        return torch.mean((params["w"] * batch["x"] + params["b"]
                           - batch["y"]) ** 2)
    kw = dict(lr=0.05, warmup_steps=1, total_steps=3)
    ref_step = ref_loop.make_train_step(
        ref_loss, ref_opt.OptimizerConfig(**kw), microbatches=4)
    step = loop.make_train_step(loss, optimizer.OptimizerConfig(**kw),
                                microbatches=4)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref_opt.init_opt_state(rp)
    pp = _to_torch(tree)
    ps = optimizer.init_opt_state(pp)
    for b in batches:
        rp, rs, rm = ref_step(rp, rs, jax.tree.map(jnp.asarray, b))
        pp, ps, pm = step(pp, ps, _to_torch(b))
        assert _ulps(rm["loss"], pm["loss"].detach()) <= 2.0
        for (k, a), (_, r) in zip(
                optimizer.tree_leaves((pp, ps.m, ps.v)),
                optimizer.tree_leaves(_to_torch((rp, rs.m, rs.v)))):
            a, r = a.detach().numpy(), r.numpy()
            assert (np.max(np.abs(a - r))
                    <= 4 * np.spacing(np.max(np.abs(r)))), k


def test_tree_leaves_rejects_module_without_param_tree():
    with pytest.raises(TypeError, match="has no param_tree"):
        optimizer.tree_leaves(torch.nn.Linear(2, 2))


def _opt_pair(tree):
    """The same (params, opt_state) in both packages, after one update
    so that m, v and step are not trivial."""
    g = _tree(30)
    rp = jax.tree.map(jnp.asarray, tree)
    rp, rs, _ = ref_opt.adamw_update(rp, jax.tree.map(jnp.asarray, g),
                                     ref_opt.init_opt_state(rp),
                                     ref_opt.OptimizerConfig())
    return rp, rs


def _manifest(d, step):
    with open(os.path.join(d, f"step-{step:09d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_reference_writes_port_restores(tmp_path):
    rp, rs = _opt_pair(_tree())
    policy = RefPolicy.from_json_dict(ApproxPolicy(
        default=BackendSpec.golden(),
        overrides=[("s0_b0_conv1", BackendSpec(
            mode="lut", multiplier="mul8u_trunc6"))]).to_json_dict())
    ref_ckpt.CheckpointManager(str(tmp_path)).save(
        4, (rp, rs), metadata={"step": 4}, policy=policy)
    zeros = jax.tree.map(lambda x: torch.zeros(np.shape(x)), _tree())
    template = (zeros, optimizer.init_opt_state(zeros))
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 4
    (pp, ps), meta = mgr.restore(template)
    assert pp is zeros and ps is template[1]
    for (k, a), (k2, b) in zip(optimizer.tree_leaves((pp, ps)),
                               optimizer.tree_leaves(_to_torch((rp, rs)))):
        assert k == k2
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert ps.step.dtype == torch.int32 and int(ps.step) == 1
    assert meta["step"] == 4
    assert (checkpoint.policy_from_metadata(meta).to_json()
            == ref_ckpt.policy_from_metadata(meta).to_json())


def test_checkpoint_port_writes_reference_restores(tmp_path):
    rp, rs = _opt_pair(_tree())
    pp, ps = _to_torch((rp, rs))
    ps = optimizer.OptState(*ps)
    policy = ApproxPolicy(default=BackendSpec.golden(), overrides=[(
        "s1_b0_*", BackendSpec(mode="lut", multiplier="mul8u_bam_h0_v4",
                               variant="fused"))])
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    checkpoint.CheckpointManager(str(port_dir)).save(
        7, (pp, ps), metadata={"step": 7}, policy=policy)
    ref_ckpt.CheckpointManager(str(ref_dir)).save(
        7, (rp, rs), metadata={"step": 7},
        policy=RefPolicy.from_json_dict(policy.to_json_dict()))
    want, got = _manifest(ref_dir, 7), _manifest(port_dir, 7)
    assert got["leaves"] == want["leaves"]
    assert list(got["leaves"]) == list(want["leaves"])
    assert got["metadata"] == want["metadata"]
    assert got["step"] == 7 and got["n_hosts"] == 1
    template = jax.tree.map(jnp.zeros_like, (rp, rs))
    (rp2, rs2), meta = ref_ckpt.CheckpointManager(str(port_dir)).restore(
        template)
    for a, b in zip(jax.tree.leaves((rp2, rs2)), jax.tree.leaves((rp, rs))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert (ref_ckpt.policy_from_metadata(meta).to_json()
            == checkpoint.policy_from_metadata(meta).to_json()
            == policy.to_json())


def test_committed_resnet8_checkpoint_restores_into_port_resnet():
    cfg = resnet.resnet_config(8)
    model = resnet.ResNet(cfg)
    mgr = checkpoint.CheckpointManager(str(weights.RESNET8_CKPT.parent))
    assert mgr.latest_step() == 320
    (got, _), _ = mgr.restore((model, model))
    want = weights.load_resnet8()
    for (k, a), (_, b) in zip(optimizer.tree_leaves(got),
                              optimizer.tree_leaves(want)):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(), err_msg=k)


def test_async_save_holds_values_changed_in_place(tmp_path):
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, params, block=False)
    params["w"].mul_(-7.0)          # the next step, in place
    mgr.wait()
    restored = {"w": torch.zeros(2, 3)}
    mgr.restore(restored)
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  np.arange(6, dtype=np.float32)
                                  .reshape(2, 3))


def test_checkpoint_gc_shape_check_and_atomicity(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"a": torch.full((2,), float(s))})
    assert sorted(os.listdir(tmp_path)) == ["step-000000002",
                                            "step-000000003"]
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"b": torch.zeros(2)})
    assert not any(d.startswith("tmp-") for d in os.listdir(tmp_path))
    empty = checkpoint.CheckpointManager(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        empty.restore({"a": torch.zeros(2)})


def test_nan_guard_restores(tmp_path):
    """Step 5 gets a poisoned batch: the trainer restores the last
    checkpoint into the same tensors, skips the window and keeps the
    parameters finite (``tests/test_train.py::test_nan_guard_restores``),
    and stays step for step with the reference."""
    def batches(np_mod):
        step = 0
        while True:
            x = np.ones(4, np.float32)
            if step == 5:
                x = x * np.nan
            yield {"x": np_mod(x)}
            step += 1

    kw = dict(total_steps=12, ckpt_every=2, log_every=100,
              nan_skip_window=2)
    w = torch.ones(4)
    params = {"w": w}
    trainer = loop.Trainer(
        lambda p, b: torch.sum((p["w"] * b["x"]) ** 2), params,
        optimizer.OptimizerConfig(lr=0.01, warmup_steps=0),
        loop.TrainLoopConfig(ckpt_dir=str(tmp_path / "port"), **kw))
    hist = trainer.run(batches(torch.from_numpy), log=lambda s: None)
    assert trainer.nan_events == [5]
    assert trainer.params["w"] is w and torch.isfinite(w).all()
    assert trainer.step >= 12
    ref = ref_loop.Trainer(
        lambda p, b: jnp.sum((p["w"] * b["x"]) ** 2), {"w": jnp.ones(4)},
        ref_opt.OptimizerConfig(lr=0.01, warmup_steps=0),
        ref_loop.TrainLoopConfig(ckpt_dir=str(tmp_path / "ref"), **kw),
        donate=False)
    ref_hist = ref.run(batches(jnp.asarray), log=lambda s: None)
    assert [h["step"] for h in hist] == [h["step"] for h in ref_hist]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in ref_hist], rtol=1e-6)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(ref.params["w"]),
                               rtol=1e-6)


def test_trainer_resume_restores_params_and_state(tmp_path):
    def run(steps, resume):
        params = {"w": torch.ones(4)}
        tr = loop.Trainer(_quadratic_loss, params,
                          optimizer.OptimizerConfig(lr=0.1, warmup_steps=0),
                          loop.TrainLoopConfig(total_steps=steps,
                                               ckpt_every=3,
                                               ckpt_dir=str(tmp_path),
                                               log_every=100))
        if resume:
            assert tr.maybe_resume()
        return tr

    data = {"x": torch.full((4,), 0.5), "y": torch.ones(4)}
    first = run(5, False)
    first.run(iter(lambda: data, None), log=lambda s: None)
    second = run(5, True)
    assert second.step == 5
    for (k, a), (_, b) in zip(
            optimizer.tree_leaves((second.params, second.opt_state)),
            optimizer.tree_leaves((first.params, first.opt_state))):
        assert torch.equal(a, b), k


def test_straggler_monitor():
    mon = loop.StragglerMonitor(factor=3.0)
    for i in range(10):
        assert not mon.record(i, 0.1)
    assert mon.record(10, 1.0)
    assert mon.flagged == [(10, 1.0)]
