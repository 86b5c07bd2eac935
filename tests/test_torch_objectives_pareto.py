"""The objectives study's entry point (``repro_torch.launch.
objectives_pareto``) on the CPU: its candidates and the legacy 2-D
front against ``benchmarks/objectives_pareto.py``'s, one small run (8
images in one batch) whose gates hold, and ``main``'s record, written
only where ``--out`` says and written before a failed gate raises."""
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import benchmarks.objectives_pareto as ref_op
import benchmarks.resilience_common as ref_rc
from repro.core.library import get_default_library as ref_default_library
from repro_torch.core.library import get_default_library
from repro_torch.launch import GateError
from repro_torch.launch import objectives_pareto as op
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("n_mult", [3, 8])
def test_study_names_equal_reference(n_mult):
    """The reference script builds them inline in its ``run``."""
    want = ref_rc.case_study_names(ref_default_library(), n_mult)
    for extra in ("mul8u_trunc5", "mul8u_trunc4"):
        if extra not in want:
            want.append(extra)
    assert op.study_names(get_default_library(), n_mult) == want
    assert op.DECODER_ARCH == ref_op.DECODER_ARCH


def test_legacy_pareto_2d_equals_reference():
    """Ties in power and in accuracy included."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        pts = [SimpleNamespace(network_rel_power=float(rng.integers(0, 5)),
                               accuracy=float(rng.integers(0, 4)), i=i)
               for i in range(12)]
        assert ([p.i for p in op._legacy_pareto_2d(pts)]
                == [p.i for p in ref_op._legacy_pareto_2d(pts)])


@pytest.fixture(scope="module")
def small_run():
    return op.run("cpu", n_mult=3, eval_n=8, log=lambda s: None)


def test_small_run_gates_hold(small_run):
    r = small_run
    rn, lm = r["resnet"], r["decoder"]
    assert r["device"] == "cpu" and r["variant"] == "pallas"
    assert rn["candidates"] == op.study_names(get_default_library(), 3)
    assert rn["bit_identical_2d"] and lm["bit_identical"]
    assert rn["objectives"] == ["accuracy", "power", "delay"]
    assert lm["objectives"] == ["logit_mae", "power", "delay"]
    assert len(rn["sweep"]) == len(rn["candidates"])
    assert lm["candidates"] == rn["candidates"][:6] and lm["pareto_3d"]
    assert {p["multiplier"] for p in rn["pareto_2d"]} <= set(
        rn["candidates"])
    assert rn["launches"] == {} == lm["batched_launches"]   # CPU
    assert rn["selected"] is not None and lm["selected"] is not None
    json.dumps(r)


def _main(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["objectives_pareto", *argv])
    real = op.run
    monkeypatch.setattr(op, "run", lambda *a, **kw: real(
        *a, **{**kw, "eval_n": 8, "n_mult": 3}))
    op.main()


def test_main_writes_record_only_to_out(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rec.json"
    _main(monkeypatch, ["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["resnet"]["bit_identical_2d"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rec.json"]


def test_main_writes_record_before_a_failed_gate(monkeypatch, tmp_path):
    monkeypatch.setattr(op, "_legacy_pareto_2d", lambda pts: [])
    out = tmp_path / "rec.json"
    with pytest.raises(GateError) as e:
        _main(monkeypatch, ["--device", "cpu", "--out", str(out)])
    assert e.value.gate == "bit_identical_2d"
    assert json.loads(out.read_text())["resnet"]["bit_identical_2d"] is False
