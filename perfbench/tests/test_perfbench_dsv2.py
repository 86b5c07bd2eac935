"""The two cells added with DeepSeek-V2 (``dsv2.ppl_fused``,
``resnet8.fig4_fused``) at a tiny size on the CPU, through the kernels'
plain versions and the harness, against their plain references.

Their own tiny checkout (``make_tiny_root`` and two more cells added the
way a change adds one, by new files and manifest entries): ``tiny.dsv2``
(the deepseek-v2 file at toy widths, 1 dense + 2 MoE layers, 4 of 16
experts held, 3 lanes, 2 x 16 tokens a pass) and ``tiny.fig4`` (the
Fig. 4 sweep at 3 lanes and 4 images; ``resnet8.fig4_fused`` has a
workload file but no manifest entry, so the tiny copy is given Table
II's rate and ``.fig4`` kernel and device metrics)."""
import json

import pytest
import torch

from perfbench.harness import (Context, cell_metrics, find, import_file,
                               load_manifest, read_metric)
from perfbench.run import _finite
from perfbench.trace import Kernel, Trace

from perfbench.tests.helpers import LANES, ROOT, make_tiny_root, run_tiny

TINY_DSV2 = {"name": "tiny-dsv2", "num_hidden_layers": 3,
             "hidden_size": 64, "intermediate_size": 96,
             "moe_intermediate_size": 16, "num_attention_heads": 4,
             "num_key_value_heads": 4, "q_lora_rank": 32,
             "kv_lora_rank": 16, "qk_nope_head_dim": 16,
             "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 4,
             "num_experts_per_tok": 3, "n_group": 4, "topk_group": 2,
             "vocab_size": 512, "published": {"num_hidden_layers": 60,
                                              "n_routed_experts": 16}}
CELLS = {"tiny.dsv2": "dsv2.ppl_fused", "tiny.fig4": "resnet8.fig4_fused"}
SUFFIX = {"tiny.dsv2": "dsv2", "tiny.fig4": "fig4"}


def _write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = make_tiny_root(tmp_path_factory.mktemp("checkout"))
    bench = base / "perfbench"
    real = ROOT / "perfbench"
    dsv2 = json.loads((real / "configs" / "deepseek-v2-236b.json")
                      .read_text())
    dsv2.update(TINY_DSV2)
    dsv2["port"] = dict(dsv2["port"], expert_first=4)
    _write(bench / "configs" / "tiny-dsv2.json", dsv2)
    lm = json.loads((real / "workloads" / "dsv2.ppl_fused.json")
                    .read_text())
    lm.update(config="tiny-dsv2", lanes=LANES, seq_len=16, pool_batches=2,
              check_passes=2, trace_passes=1)
    _write(bench / "workloads" / "tiny.dsv2.json", lm)
    fig4 = json.loads((real / "workloads" / "resnet8.fig4_fused.json")
                      .read_text())
    fig4.update(lanes=LANES, batch=4, pool_sets=2, check_passes=1,
                trace_passes=1)
    _write(bench / "workloads" / "tiny.fig4.json", fig4)
    manifest = load_manifest(base / "BENCHMARK.json")
    manifest["configs"].append({
        "name": "tiny-dsv2", "source": "the deepseek-v2 file at toy widths",
        "file": "perfbench/configs/tiny-dsv2.json", "reduced": [],
        "why": "CPU tests"})
    manifest["workloads"] += [
        {"name": "tiny.dsv2", "config": "tiny-dsv2", "traffic": "tiny",
         "chips": 1, "why": "CPU tests"},
        {"name": "tiny.fig4", "config": "resnet8-cifar10",
         "traffic": "tiny_fig4", "chips": 1, "why": "CPU tests"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        cells = m.get("workloads", [])
        for tiny, real_cell in CELLS.items():
            if real_cell in cells:
                cells.append(tiny)
    # the Fig. 4 cell has no manifest entry: its tiny copy reports what
    # it would, Table II's rate and the kernel and device metrics
    find(manifest, "end_to_end", "lane_images_per_s")["workloads"].append(
        "tiny.fig4")
    manifest["per_layer"] += [
        dict(m, name=m["name"].replace(".images", ".fig4"),
             workloads=["tiny.fig4"]) for m in manifest["per_layer"]
        if m["name"] in ("gather_roofline.images", "eager_device_ms.images",
                         "device_idle.images")]
    _write(base / "BENCHMARK.json", manifest)
    return base


def _build(root, cell, seed=2 ** 32 + 9):
    manifest = load_manifest(root / "BENCHMARK.json")
    entry = find(manifest, "workloads", cell)
    spec = json.loads((root / "perfbench" / "workloads"
                       / f"{cell}.json").read_text())
    config = json.loads((root / find(manifest, "configs", entry["config"])
                         ["file"]).read_text())
    driver = import_file(root / "perfbench" / "drivers"
                         / f"{spec['driver']}.py")
    return driver.build(spec, config, seed, torch.device("cpu"), root), spec


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_runs_and_matches_the_reference(root, cell):
    r = run_tiny(root, cell)
    line = json.dumps(_finite(r), allow_nan=False)
    assert list(json.loads(line))[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    manifest = load_manifest(root / "BENCHMARK.json")
    want = {m["name"] for m in cell_metrics(manifest, cell, "end_to_end")}
    assert set(r["metrics"]) == want
    for name, c in r["checks"].items():
        assert c["value"] == 0.0, (name, c)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_and_the_program_passes(root, cell):
    run, spec = _build(root, cell)
    got = run.run_pass(0)
    for name, value in run.numbers_of(got, 0).items():
        assert value <= spec["limits"][name]
    # the control fails by one of the limits at least (at 4 images a
    # lane's accuracy seldom moves; its logit MAE does)
    control = run.control(0)
    assert any(v > spec["limits"][n] for n, v in control.items()), control


def test_the_driver_draws_the_programs_tree(root):
    """The benchmark's weights have the shapes of the program's own
    ``init_params`` for the same configuration."""
    from repro_torch.models.registry import abstract_params
    run, _ = _build(root, "tiny.dsv2")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}
    assert shapes(run.params) == shapes(abstract_params(run.cfg))
    assert run.cfg.held_experts == range(4, 8)
    assert run.params["blocks"]["ffn_0"]["router"].shape[-1] == 16


def _ctx(kernels):
    return Context(trace=Trace(kernels=kernels, spans=[], passes=1,
                               window_s=1.0))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_run_and_its_readers(root, cell):
    """Silent in the line without a device kernel; beside a stand-in
    kernel the span and counter readers read the run's recording."""
    from repro_torch import obs
    r = run_tiny(root, cell, trace=True)
    assert r["correct"] is True
    assert r["metrics"] == {}
    manifest = load_manifest(root / "BENCHMARK.json")
    listed = {m["name"] for m in cell_metrics(manifest, cell, "per_layer")}
    sfx = SUFFIX[cell]
    assert {f"gather_roofline.{sfx}", f"eager_device_ms.{sfx}",
            f"device_idle.{sfx}"} <= listed
    if cell == "tiny.fig4":
        return
    assert {f"mla_ms.{sfx}", f"expert_fill.{sfx}"} <= listed
    stand_in = _ctx([Kernel("stand-in", 0.0, 1.0)])
    assert read_metric("mla_ms.dsv2", _ctx([]), root) is None
    assert read_metric("mla_ms.dsv2", stand_in, root) > 0
    snap = obs.snapshot()
    held = obs.total(snap, "moe.held_slots")
    rows = obs.total(snap, "moe.capacity_rows")
    # 3 lanes x 2 MoE layers x 4 held experts x capacity
    # ceil(32 x 3 / 16 x 1.25) = 8 rows
    assert rows == 3 * 2 * 4 * 8
    assert 0 < held <= rows
    assert read_metric("expert_fill.dsv2", stand_in, root) == \
        pytest.approx(100.0 * held / rows)
    for name in ("moe_route_ms.dsv2", "model_ms.dsv2", "calib_ms.dsv2"):
        assert read_metric(name, stand_in, root) > 0


def test_expert_fill_silent_without_the_counters(root, monkeypatch):
    from repro_torch import obs
    run_tiny(root, "tiny.moe", trace=True)
    stand_in = _ctx([Kernel("stand-in", 0.0, 1.0)])
    assert read_metric("expert_fill.tokens", stand_in, root) > 0
    monkeypatch.setattr(obs, "total", lambda snap, counter: 0)
    assert read_metric("expert_fill.tokens", stand_in, root) is None
    assert read_metric("mla_ms.dsv2", stand_in, root) is None
