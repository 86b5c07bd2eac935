"""Each cell end to end at a tiny size on the CPU, through the kernels'
plain versions: the run prints a line of the contract's shape, and the
plain reference matches the port (to the last bit here)."""
import json

import pytest

from perfbench.harness import cell_metrics, load_manifest
from perfbench.run import _finite

from perfbench.tests.helpers import run_tiny

CELLS = ["tiny.resnet", "tiny.moe"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_matches_the_reference(tiny_root, cell):
    r = run_tiny(tiny_root, cell)
    line = json.dumps(_finite(r), allow_nan=False)
    assert list(json.loads(line))[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    manifest = load_manifest(tiny_root / "BENCHMARK.json")
    want = {m["name"] for m in cell_metrics(manifest, cell, "end_to_end")}
    assert set(r["metrics"]) == want
    for name, m in r["metrics"].items():
        assert m["value"] > 0, name
    for name, c in r["checks"].items():
        assert c["value"] == 0.0, (name, c)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(tiny_root, cell):
    r = run_tiny(tiny_root, cell, trace=True)
    assert r["correct"] is True
    # no device work on the CPU: every per-layer reader stays silent
    assert r["metrics"] == {}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
