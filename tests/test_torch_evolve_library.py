"""The evolve study's entry point (``repro_torch.launch.evolve_library``)
on the CPU (the device engine through K11's plain version): a
``--quick``-sized run whose metric identity holds, whose ladder equals
the reference's ``evolve_ladder`` at the same configuration (circuits,
candidate evaluations, archive sizes) and whose ``tiny`` builds equal
the reference's recorded counts (``benchmarks/results/BENCH_evolve.json``:
84 / 22 legacy, 129 / 66 device), and ``main``'s record, written only
where ``--out`` says and written before a failed gate raises."""
import json
import os
import sys

import numpy as np
import pytest

import benchmarks.evolve_library as ref_el
from repro.core import evolve_pop as ref_pop
from repro.core.cgp import CgpParams as RefParams
from repro.core.cgp import pad_nodes as ref_pad_nodes
from repro.core.seeds import array_multiplier as ref_array_multiplier
from repro_torch.launch import GateError
from repro_torch.launch import evolve_library as el
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def quick_run():
    return el.run("cpu", quick=True, log=lambda s: None)


def _ref_ladder(gens: int, samples: int):
    """The reference benchmark's ladder, run with its own numpy engine
    (the script itself writes its record into the repository)."""
    exact = ref_array_multiplier(8)
    seed_nl = ref_pad_nodes(exact, exact.n_nodes, seed=7)
    max_out = float((2 ** 8 - 1) ** 2)
    ladder = [max_out * (2.0 ** -e) for e in np.linspace(14, 4, 4)]
    lp = RefParams(metric="mae", generations=gens, search_samples=samples,
                   seed=5)
    sizes = []
    ev = ref_pop.PopEvaluator(exact, lp, engine="numpy")
    results = ref_pop.evolve_ladder(
        seed_nl, exact, ladder, lp, engine="numpy", evaluator=ev,
        on_candidate=lambda *a: sizes.append(len(sizes) + 1))
    return {"circuits": len(sizes) + len(results),
            "candidate_evals": ev.n_scored, "sizes": sizes}


def test_quick_run_equals_reference(quick_run):
    r = quick_run
    assert r["device"] == "cpu" and r["quick"]
    assert r["pop_size"] == 32 and r["search_samples"] == 4096
    assert r["metric_identity"] == {m: True for m in
                                    ("er", "mae", "mse", "mre", "wce",
                                     "wcre")}
    assert r["device_metrics"] == ["er", "mae", "wce"]
    assert el.SPEEDUP_GATE == ref_el.SPEEDUP_GATE
    assert r["throughput"]["speedup_gate_met"] == (
        r["throughput"]["speedup"] >= 3.0)
    want = _ref_ladder(15, 4096)
    lad = r["ladder"]
    assert (lad["rungs"], lad["generations"]) == (4, 15)
    assert lad["circuits"] == want["circuits"]
    assert lad["candidate_evals"] == want["candidate_evals"]
    assert ([p["archive_size"] for p in lad["archive_vs_wall_clock"]]
            == want["sizes"])
    with open(os.path.join(ROOT, "benchmarks", "results",
                           "BENCH_evolve.json")) as f:
        bench = json.load(f)["library_tiny"]
    for engine in ("legacy", "device"):
        for key in ("entries", "evolved"):
            assert r["library_tiny"][engine][key] == bench[engine][key]
    assert r["library_tiny"]["grew"]
    json.dumps(r)


def test_main_writes_record_only_to_out(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rec.json"
    monkeypatch.setattr(sys, "argv", ["evolve_library", "--device", "cpu",
                                      "--quick", "--out", str(out)])
    el.main()
    assert json.loads(out.read_text())["library_tiny"]["grew"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rec.json"]


def test_main_writes_record_before_a_failed_gate(monkeypatch, tmp_path):
    """A device build no larger than the legacy one fails the growth
    gate, after the record is written."""
    real = el.build_default_library
    monkeypatch.setattr(el, "build_default_library",
                        lambda budget, **kw: real(budget))
    out = tmp_path / "rec.json"
    monkeypatch.setattr(sys, "argv", ["evolve_library", "--device", "cpu",
                                      "--quick", "--out", str(out)])
    with pytest.raises(GateError) as e:
        el.main()
    assert e.value.gate == "library_growth"
    assert json.loads(out.read_text())["library_tiny"]["grew"] is False
