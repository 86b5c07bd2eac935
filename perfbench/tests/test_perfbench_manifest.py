"""``BENCHMARK.json`` against the contract's shape, the harness's
data-driven lookups, and the guards: nothing of JAX or the JAX package
is imported, and a run without the program or without a card ends with
no result."""
import ast
import json
import re
import shutil
import subprocess
import sys
import types

import pytest

from perfbench import harness

from perfbench.tests.helpers import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert c["file"].startswith("perfbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
            assert not key.endswith(("_dim", "_rank", "_size"))
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_cells_find_their_files():
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec = json.loads((ROOT / "perfbench" / "workloads"
                           / f"{w['name']}.json").read_text())
        assert spec["config"] == w["config"]
        assert (ROOT / "perfbench" / "drivers"
                / f"{spec['driver']}.py").exists()
        e2e = harness.cell_metrics(MANIFEST, w["name"], "end_to_end")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(MANIFEST, w["name"], "per_layer")
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_metrics_and_their_readers():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        reader = harness.import_file(ROOT / "perfbench" / "metrics"
                                     / f"{m['name'].split('.')[0]}.py")
        assert callable(reader.read)
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
    ref = (ROOT / "perfbench" / "reference")
    for path in ref.rglob("*.py"):     # the reference imports no program
        assert "repro_torch" not in {n.split(".")[0]
                                     for n in _imports(path)}, path


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_fake",
                        types.ModuleType("repro_torch_fake"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.approx",
                        types.ModuleType("repro.approx"))
    assert harness.forbidden_modules() == ["repro"]
    with pytest.raises(harness.RunError):
        harness.guard_modules("test")


def _run(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "resnet8.table2_fused", "--seed", str(2 ** 33), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def _no_result(out):
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_run_without_the_program_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))


def test_run_without_a_card_gives_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    _no_result(out)
    assert "no CUDA device" in out.stderr
