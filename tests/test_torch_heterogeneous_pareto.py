"""The heterogeneous study's entry point
(``repro_torch.launch.heterogeneous_pareto``) on the CPU: its candidate
lists against ``benchmarks/heterogeneous_pareto.py``'s on the same
library, names and layer counts, one small run of ``run`` (8 images in
one batch, 3 picks, top 4) whose equal-assignment and verification gates
must hold, and ``main``'s record, written only where ``--out`` says and
written before a failed gate raises."""
import json
import sys

import pytest

import benchmarks.heterogeneous_pareto as ref_hp
import benchmarks.resilience_common as ref_rc
from repro.core.library import get_default_library as ref_default_library
from repro.models import resnet as ref_resnet
from repro_torch.core.library import get_default_library
from repro_torch.launch import heterogeneous_pareto as hp
from repro_torch.models import resnet
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_MULTS = (3, 8, 12)


def _ref_names(lib, n_mult):
    """The reference script's multipliers (built inline in its ``run``)."""
    names = ref_rc.case_study_names(lib, n_mult)
    for extra in ("mul8u_trunc4", "mul8u_trunc3", "mul8u_trunc2"):
        if extra in lib.entries and extra not in names:
            names.append(extra)
    return names


@pytest.fixture(scope="module")
def libs():
    return get_default_library(), ref_default_library()


@pytest.mark.parametrize("n_mult", N_MULTS)
def test_study_names_equal_reference(n_mult, libs):
    lib, ref_lib = libs
    assert hp.study_names(lib, n_mult) == _ref_names(ref_lib, n_mult)


@pytest.mark.parametrize("n_mult", N_MULTS)
def test_downgrade_candidates_equal_reference(n_mult, libs):
    """Every study multiplier as the uniform pick (the cheapest has no
    cheaper candidate, so no downgrade), at the default cap and a small
    one."""
    lib, ref_lib = libs
    names = hp.study_names(lib, n_mult)
    counts = resnet.layer_mult_counts(resnet.resnet_config(8))
    ref_counts = ref_resnet.layer_mult_counts(ref_resnet.resnet_config(8))
    assert counts == ref_counts
    sizes = set()
    for base in names:
        for cap in (14, 3):
            got = hp._downgrade_candidates(lib, names, counts, base, cap)
            assert got == ref_hp._downgrade_candidates(
                ref_lib, names, ref_counts, base, cap)
            assert all(lib.entries[m].rel_power
                       < lib.entries[base].rel_power
                       for a in got for m in a.values() if m != base)
            sizes.add(len(got))
    assert 0 in sizes and 14 in sizes


@pytest.fixture(scope="module")
def small_run(libs):
    """``run`` at 8 images, one batch: a failed dominance gate still
    gives its record; any other gate fails the test."""
    log = []
    try:
        rec = hp.run("cpu", eval_n=8, batch=8, n_mult=3, top_k=4,
                     log=log.append)
    except hp.GateError as e:
        assert e.gate == "dominance", str(e)
        rec = e.record
    return rec, log


def test_small_run_gates_hold(small_run, libs):
    rec, log = small_run
    assert rec["device"] == "cpu" and rec["variant"] == "pallas"
    assert (rec["eval_n"], rec["batch"], rec["eval_batches"]) == (8, 8, 1)
    assert rec["multipliers"] == hp.study_names(libs[0], 3)
    assert rec["equal_assignment_bit_identical"] is True
    v = rec["verification"]
    assert v["bit_identical"] is True and v["layers"] == 9
    # the wrappers run their plain versions on the CPU: no launch
    assert v["batched_launches"] == {}
    assert v["k"] == len(rec["heterogeneous"]) >= 2
    assert len(rec["uniform"]) == len(rec["multipliers"])
    best = rec["uniform_best"]
    assert best is not None
    for p in rec["heterogeneous"]:
        assert set(p["assignment"]) == set(
            resnet.layer_mult_counts(resnet.resnet_config(8)))
    dom = rec["dominating"]
    if dom is not None:
        assert dom["network_rel_power"] < best["network_rel_power"]
        assert dom["accuracy"] >= best["accuracy"]
        assert dom in rec["heterogeneous"]
    assert any("bit identical: True" in line for line in log)


def _main(monkeypatch, tmp_path, outcome, *args):
    """``main`` with ``run`` replaced by ``outcome`` (a record, or a
    ``GateError`` to raise), from an empty working directory."""
    def fake_run(device, **kw):
        if isinstance(outcome, Exception):
            raise outcome
        return outcome

    monkeypatch.setattr(hp, "run", fake_run)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["heterogeneous_pareto", *args])
    hp.main()


def test_main_writes_record_only_to_out(monkeypatch, tmp_path):
    _main(monkeypatch, tmp_path, {"benchmark": "heterogeneous_pareto"})
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "rec.json"
    _main(monkeypatch, tmp_path, {"benchmark": "heterogeneous_pareto"},
          "--out", str(out))
    assert json.loads(out.read_text()) == {
        "benchmark": "heterogeneous_pareto"}


@pytest.mark.parametrize("gate", ["equal_assignment", "verification",
                                  "dominance"])
def test_main_writes_record_before_a_failed_gate(gate, monkeypatch,
                                                 tmp_path):
    out = tmp_path / "rec.json"
    record = {"benchmark": "heterogeneous_pareto", "dominating": None}
    with pytest.raises(hp.GateError) as e:
        _main(monkeypatch, tmp_path, hp.GateError("failed", gate, record),
              "--out", str(out))
    assert e.value.gate == gate
    assert json.loads(out.read_text()) == record
