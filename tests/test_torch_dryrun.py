"""The port's dry run (``repro_torch.launch.dryrun``): each cell's step
over DTensors on a ``"fake"`` process group, the counterpart of the
reference's lowering on 512 placeholder XLA devices.

The fake groups live in spawned processes
(``tests/_torch_fake_mesh_worker.py``), never in the test process:
  * a dense arch at narrow widths (``NARROW``) on fake (2, 2) and
    (16, 16) meshes is ``ok``; its per-device flops times the chips are
    at least the one-device (global) count, and its collective bytes are
    nonzero;
  * on a (1, 1) mesh a decode probe's flops equal the hand count of its
    matmuls (projections, attention, unembedding), and there are no
    collectives;
  * the full-depth step on the DTensors (no probes) counts what the
    probes extrapolate to;
  * after the dry runs a gloo group comes up in the same process (the
    fake group is torn down).
``tests/test_torch_dryrun_cli.py`` holds ``main``, ``_combine_linear``
and the argument bytes against the reference's.
"""
import json

import pytest

from _torch_fake_mesh_worker import dryrun_cases, spawn


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "runs.json")
    spawn(dryrun_cases, out)
    with open(out) as f:
        return json.load(f)


def test_dense_cells_lower_on_fake_meshes(runs):
    one = runs["1x1/decode"]
    for name, chips in (("2x2/decode", 4), ("16x16/decode", 256),
                        ("16x16/train", 256)):
        r = runs[name]
        assert r["ok"] and r["n_chips"] == chips, name
        assert r["collectives"]["total_bytes"] > 0, name
        assert r["roofline"]["collective_s"] > 0, name
        assert r["memory"]["argument_bytes"] > 0, name
    for name, chips in (("2x2/decode", 4), ("16x16/decode", 256)):
        assert runs[name]["flops_per_device"] * chips >= \
            one["flops_per_device"]
    # a train step: n_mb x stack + opt, n_mb = 256 / 16
    assert runs["16x16/train"]["extrapolation"]["microbatches"] == 16


def test_one_device_probe_flops_equal_the_hand_count(runs):
    """serve_mode bf16 (f32 matmuls): d1 is one layer of the narrow
    arch, decoding B=128 tokens against a 32 768-row cache."""
    r = runs["1x1/decode/bf16"]
    assert r["collectives"] == {"total_bytes": 0}
    b, t, d, h, hk, hd, f, v = 128, 32768, 64, 4, 2, 16, 128, 256
    proj = 2 * b * (d * h * hd + 2 * d * hk * hd + h * hd * d
                    + 2 * d * f + f * d)
    attn = 2 * (2 * b * h * t * hd)       # scores and probs @ v
    unembed = 2 * b * d * v
    d1 = [p for p in r["probe_details"] if p["probe"] == "stack_d1"][0]
    assert d1["flops"] == proj + attn + unembed
    assert d1["collective_bytes"] == 0
    assert runs["1x1/decode"]["collectives"]["total_bytes"] == 0


def test_full_depth_on_dtensors_equals_the_extrapolation(runs):
    full, probed = runs["16x16/decode/full"], runs["16x16/decode"]
    assert full["lower"] == "dtensor" and full["probe_details"] is None
    assert full["flops_per_device"] == probed["flops_per_device"]
    assert full["bytes_per_device"] == probed["bytes_per_device"]
    assert full["collectives"]["total_bytes"] == \
        probed["collectives"]["total_bytes"]
    for m in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert full["memory"][m] == probed["memory"][m]


def test_teardown_lets_a_real_group_come_up(runs):
    assert runs["gloo_after"] == [1.0, 1.0, 1.0]
