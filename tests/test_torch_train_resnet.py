"""The training entry points on the CPU: ``repro_torch.launch.
train_resnet`` (sweeps first, then the STE fine-tune, in one process:
the sweeps' ``torch.inference_mode`` tables must not leak into the
graph) and the LM trainer CLI ``repro_torch.launch.train`` (a reduced
run, its resume, its CLI line)."""
import json
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import train, train_resnet
from repro_torch.models import resnet
from repro_torch.train import checkpoint, optimizer
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_train_resnet_sweeps_then_fine_tunes(tmp_path):
    rec = train_resnet.run("cpu", steps=20, batch=8, train_n=64,
                           eval_n=16, n_mult=3, from_checkpoint=True,
                           ckpt_dir=str(tmp_path / "ck"),
                           log=lambda s: None)
    assert rec["accuracy_f32"] > 0.5 and rec["accuracy_int8"] > 0.5
    assert len(rec["table_ii"]) == 3 and len(rec["fig4"]) == 9
    assert rec["heterogeneous"]
    ft = rec["fine_tune"]
    assert ft is not None and ft["steps"] == 20
    assert np.isfinite(ft["losses"]).all() and len(ft["losses"]) == 20
    assert set(ft["assignment"]) == set(resnet.layer_mult_counts(
        resnet.resnet_config(8)))
    assert ft["launches"] == {}                 # CPU: plain versions
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck_hetero"))
    assert mgr.latest_step() == 20
    model = resnet.ResNet(resnet.resnet_config(8))
    _, meta = mgr.restore(model)
    policy = checkpoint.policy_from_metadata(meta)
    assert policy.to_json_dict() == ft["policy"]
    assert dict(policy.overrides).keys() == ft["assignment"].keys()
    json.dumps(rec)


def test_train_resnet_trains_from_random_init(tmp_path):
    cfg, model, hist, _ = train_resnet.train(
        "cpu", steps=6, batch=8, train_n=32, ckpt_dir=str(tmp_path),
        log=lambda s: None)
    losses = [h["loss"] for h in hist]
    assert len(losses) == 6 and np.isfinite(losses).all()
    again = resnet.ResNet(cfg, torch.Generator().manual_seed(0))
    assert not all(torch.equal(a, b) for (_, a), (_, b) in zip(
        optimizer.tree_leaves(model), optimizer.tree_leaves(again)))
    assert checkpoint.CheckpointManager(str(tmp_path)).latest_step() == 6


def test_lm_train_reduced_and_resume(tmp_path):
    kw = dict(reduced=True, steps=6, batch=2, seq=16,
              ckpt_dir=str(tmp_path), log=lambda s: None)
    rec = train.run("cpu", **kw)
    hist = rec["history"]
    assert len(hist) == 6 and np.isfinite([h["loss"] for h in hist]).all()
    assert rec["n_params"] > 0 and rec["tokens_per_s"] > 0
    steps_s = sum(h["ms"] for h in hist) / 1e3
    assert rec["tokens_per_s_steps"] == pytest.approx(6 * 2 * 16 / steps_s)
    assert 0 < rec["tokens_per_s_run"] <= rec["tokens_per_s_steps"]
    assert rec["step_ms_max"] >= rec["step_ms"]
    first = rec["trainer"]
    cfg = train.get_config("qwen1.5-0.5b").reduced()
    resumed = train.make_trainer(
        cfg, train.init_params(cfg, torch.device("cpu"), seed=1), 6, 3e-4,
        1, str(tmp_path))
    assert resumed.maybe_resume() and resumed.step == 6
    for (k, a), (_, b) in zip(
            optimizer.tree_leaves((resumed.params, resumed.opt_state)),
            optimizer.tree_leaves((first.params, first.opt_state))):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-34b"])
def test_lm_train_cli_microbatched(arch, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--device", "cpu", "--arch", arch, "--reduced",
        "--steps", "3", "--batch", "4", "--seq", "8", "--microbatches",
        "2", "--ckpt-dir", str(tmp_path)])
    train.main()
    out = capsys.readouterr().out
    assert "over 3 steps" in out and f"[train] {arch} (reduced)" in out
