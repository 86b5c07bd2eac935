"""The surrogate-guided DSE's workload and entry points in the port
against the JAX reference, on the CPU, plus two ``gpu``-marked checks
(``python -m pytest -m gpu tests/test_torch_dse_surrogate.py`` on a
card; they need no JAX).

What is held, and how closely:
  * ``classification(fidelity=True)`` on the committed ResNet-8
    checkpoint (8 images in two batches): its name, metrics, primary and
    directions equal the reference's; ``logit_mae`` within
    ``LOGIT_MAE_ATOL`` of the reference's and accuracy within two images
    (BN reduces in another order and every layer re-calibrates: the
    logits differ by up to 0.05, the settled ResNet tolerance, and the
    measured logit_mae differences are at most 0.0076); banked lanes
    (``all_layers_sweep``/``per_layer_sweep`` batched, and
    ``verify_assignments`` through ``policy_bank_eval``) equal the
    sequential evaluations bit for bit, both metrics;
  * ``launch.dse_surrogate``: ``widen_candidate_set`` gives
    ``benchmarks/dse_surrogate.py``'s names and entries on the same
    library; ``_front``, ``_front_dict`` and ``_matches_or_dominates``
    equal the reference's on the same points; ``main`` writes its record
    only where ``--out`` says, also before a failed gate raises; one
    small ``run`` keeps the process-wide default library unchanged and
    records what it measured;
  * ``launch.rank_analysis`` prints the reference's lines and returns
    its numbers;
  * without CUDA the study's entry point, the fit and the warm-up raise
    unless asked for the CPU.
On a card: the MLP fit captured as a CUDA graph equals the eager fit
bit for bit, and one 108-lane per-layer pass under ``pallas`` (K2) and
``fused`` (K4) equals the plain datapath's logits with one launch."""
import copy
import json
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.approx import dse as port_dse
from repro_torch.approx.layers import ApproxPolicy
from repro_torch.approx.objectives import ensure_objective
from repro_torch.approx.resilience import all_layers_sweep, per_layer_sweep
from repro_torch.approx.specs import BackendSpec
from repro_torch.approx.surrogate import fit_surrogate, fit_walls, warm_up
from repro_torch.approx.workload import classification
from repro_torch.core.library import (build_default_library,
                                      get_default_library,
                                      load_default_library)
from repro_torch.launch import dse_surrogate as ds
from repro_torch.launch import rank_analysis
from repro_torch.models import resnet, weights
from _torch_threads import one_torch_thread  # noqa: F401

try:
    import jax

    import benchmarks.dse_surrogate as ref_ds
    import benchmarks.rank_analysis as ref_rank
    from repro.approx import dse as ref_dse
    from repro.approx.layers import ApproxPolicy as RefPolicy
    from repro.approx.objectives import ensure_objective as ref_ensure
    from repro.approx.specs import BackendSpec as RefSpec
    from repro.approx.workload import classification as ref_classification
    from repro.core.library import build_default_library as ref_build
    from repro.train.checkpoint import CheckpointManager
except ImportError:     # the GPU machine: only the gpu-marked tests run
    pass

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EVAL_N, BATCH = 8, 4
#: logit_mae between the packages on the same images and policy
LOGIT_MAE_ATOL = 0.01
MULTS = ["mul8u_trunc4", "mul8u_bam_h3_v7"]


@pytest.fixture(scope="module")
def workloads():
    cfg = resnet.resnet_config(8)
    template = jax.tree.map(np.zeros_like,
                            weights.load_resnet8_checkpoint())
    (params, _), _ = CheckpointManager(
        str(weights.RESNET8_CKPT.parent), keep=1).restore(
            (template, template))
    return (ref_classification(cfg, params, eval_n=EVAL_N, batch=BATCH,
                               fidelity=True),
            classification(cfg, weights.load_resnet8(), eval_n=EVAL_N,
                           batch=BATCH, fidelity=True, device="cpu"))


@pytest.fixture(scope="module")
def libs():
    return ref_build("tiny"), build_default_library("tiny")


# ----------------------------------------------------------------------
# classification(fidelity=True)
# ----------------------------------------------------------------------
def test_classification_fidelity_declares_the_reference_metrics(workloads):
    want, got = workloads
    assert got.name == want.name == "classification[resnet8]+fidelity"
    assert got.metrics == want.metrics == ("logit_mae", "accuracy")
    assert got.primary == want.primary == "logit_mae"
    assert dict(got.directions) == dict(want.directions)
    assert got.layer_counts == want.layer_counts
    plain = classification(resnet.resnet_config(8), weights.load_resnet8(),
                           eval_n=EVAL_N, batch=BATCH, device="cpu")
    assert plain.metrics == ("accuracy",) and "+" not in plain.name


@pytest.mark.parametrize("mult", [None, *MULTS])
def test_classification_fidelity_matches_reference(workloads, libs, mult):
    want_wl, got_wl = workloads
    ref_lib, port_lib = libs
    if mult is None:
        want = want_wl.measure(RefPolicy(
            default=RefSpec.golden().materialize()))
        got = got_wl.measure(ApproxPolicy(
            default=BackendSpec.golden().materialize()))
        assert got["logit_mae"] == 0.0 == want["logit_mae"]
    else:
        want = want_wl.measure(RefPolicy(default=RefSpec(
            mode="lut", multiplier=mult).materialize(ref_lib)))
        got = got_wl.measure(ApproxPolicy(default=BackendSpec(
            mode="lut", multiplier=mult).materialize(port_lib)))
        assert got["logit_mae"] > 0.5
    assert list(got) == ["logit_mae", "accuracy"]
    assert abs(got["logit_mae"] - want["logit_mae"]) <= LOGIT_MAE_ATOL
    assert abs(got["accuracy"] - want["accuracy"]) <= 2 / EVAL_N


def test_classification_fidelity_banked_equals_sequential(workloads, libs):
    """Under ``pallas`` (the card's datapath; its plain version here):
    the all-layers sweep, a per-layer sweep at the first and last conv
    layers, and a policy bank's verification."""
    _, wl = workloads
    _, lib = libs
    counts = wl.layer_counts
    names = ["mul8u_exact", *MULTS]
    some = {l: counts[l] for l in ("conv_init", "s2_b0_proj")}
    for sweep, c, kw in ((all_layers_sweep, counts, {}),
                         (per_layer_sweep, some,
                          {"base": BackendSpec.golden()})):
        batched = sweep(wl, c, names, lib, variant="pallas", batch=True,
                        **kw)
        seq = sweep(wl, c, names, lib, variant="pallas", batch=False,
                    **kw)
        assert [r.metrics for r in batched] == [r.metrics for r in seq]
        assert all(set(r.metrics) == {"logit_mae", "accuracy"}
                   for r in batched)
    layers = tuple(counts)
    rows = [{l: names[(p + j) % len(names)] for j, l in enumerate(layers)}
            for p in range(3)]
    bat = port_dse.verify_assignments(wl, rows, counts, lib,
                                      variant="pallas", batch=True)
    seq = port_dse.verify_assignments(wl, rows, counts, lib,
                                      variant="pallas", batch=False)
    assert [p.metrics for p in bat] == [p.metrics for p in seq]
    assert all(p.metrics["logit_mae"] > 0 for p in bat)


# ----------------------------------------------------------------------
# launch.dse_surrogate
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [20, 60, 108])
def test_widen_candidate_set_equals_reference(n, libs):
    ref_lib, lib = (copy.deepcopy(x) for x in libs)
    before = set(lib.entries)
    got = ds.widen_candidate_set(lib, n)
    assert got == ref_ds.widen_candidate_set(ref_lib, n)
    assert len(got) == max(n, 57)
    assert list(lib.entries) == list(ref_lib.entries)
    for name in set(lib.entries) - before:
        assert lib.entries[name].source == "bam"
        assert (lib.entries[name].as_dict()
                == ref_lib.entries[name].as_dict())


def _points(dp_cls, seed):
    """Verified-looking heterogeneous points (logit_mae primary) with a
    few exact ties in power and quality."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        mae = float(np.round(rng.uniform(1.0, 3.0), 2))
        power = float(np.round(rng.uniform(0.3, 0.6), 2))
        a = {"l0": f"m{i % 4}", "l1": f"m{(i + 1) % 4}"}
        out.append(dp_cls.from_assignment(
            a, mae, power, metrics={"logit_mae": mae,
                                    "accuracy": float(i) / 12}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_front_and_dominance_equal_reference(seed):
    ensure_objective("logit_mae", "min", source="workload")
    ref_ensure("logit_mae", "min", source="workload")
    got_pts = _points(port_dse.DesignPoint, seed)
    want_pts = _points(ref_dse.DesignPoint, seed)
    got, want = ds._front(got_pts), ref_ds._front(want_pts)
    assert ds._front_dict(got) == ref_ds._front_dict(want)
    assert [p.network_rel_power for p in got] == sorted(
        p.network_rel_power for p in got)
    # a front matches or dominates itself and any subset of the points
    for a, b in ((got, got), (got_pts, got), (got, got_pts)):
        assert ds._matches_or_dominates(a, b) == ref_ds._matches_or_dominates(
            [want_pts[got_pts.index(p)] for p in a],
            [want_pts[got_pts.index(p)] for p in b])
    assert ds._matches_or_dominates(got_pts, got) == (True, [])
    # a point better than the whole front on both axes is missed
    best = port_dse.DesignPoint.from_assignment(
        {"l0": "m0", "l1": "m0"}, 0.5, 0.1, metrics={"logit_mae": 0.5})
    ok, misses = ds._matches_or_dominates(got, [best])
    assert not ok and misses == [{"logit_mae": 0.5,
                                  "network_rel_power": 0.1}]


def _main(monkeypatch, tmp_path, outcome, *args):
    """``main`` with ``run`` replaced by ``outcome`` (a record, or a
    ``GateError`` to raise), in an empty working directory."""
    def fake_run(*a, **kw):
        if isinstance(outcome, Exception):
            raise outcome
        return outcome

    monkeypatch.setattr(ds, "run", fake_run)
    monkeypatch.chdir(tmp_path)
    ds.main(list(args))


def test_main_writes_record_only_to_out(monkeypatch, tmp_path):
    _main(monkeypatch, tmp_path, {"benchmark": "dse_surrogate"})
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "rec.json"
    _main(monkeypatch, tmp_path, {"benchmark": "dse_surrogate"},
          "--out", str(out))
    assert json.loads(out.read_text()) == {"benchmark": "dse_surrogate"}
    assert [p.name for p in tmp_path.iterdir()] == ["rec.json"]


@pytest.mark.parametrize("gate", ["speedup", "fidelity", "front"])
def test_main_writes_record_before_a_failed_gate(gate, monkeypatch,
                                                 tmp_path):
    out = tmp_path / "rec.json"
    record = {"benchmark": "dse_surrogate", "gate": gate}
    with pytest.raises(ds.GateError) as e:
        _main(monkeypatch, tmp_path, ds.GateError("failed", gate, record),
              "--out", str(out))
    assert e.value.gate == gate
    assert json.loads(out.read_text()) == record


def test_run_leaves_the_default_library_alone(libs, monkeypatch):
    """One small run (58 candidates: one widened bam entry, one image):
    the process-wide default library keeps its entries; the record counts
    what each path measured; a failed gate (timings and fidelity at this
    size are not the study's) names a gate the record shows failing.
    The run's new library instance is a copy of a ``tiny`` build (what
    ``load_default_library`` builds here), made once for the module."""
    monkeypatch.setattr(ds, "load_default_library",
                        lambda: copy.deepcopy(libs[1]))
    lib = get_default_library()
    before = {n: e.as_dict() for n, e in lib.entries.items()}
    try:
        record = ds.run("cpu", n_circuits=58, eval_n=1, batch=1,
                        log=lambda s: None)
        failed = None
    except ds.GateError as e:
        record, failed = e.record, e.gate
    assert get_default_library() is lib
    assert {n: e.as_dict() for n, e in lib.entries.items()} == before
    assert "mul8u_bam_h0_v1" in lib.entries
    assert record["n_circuits"] == 58 and record["n_layers"] == 9
    sur, e2e = record["surrogate"], record["end_to_end"]
    assert sur["n_train"] + sur["n_val"] == 15        # ceil(0.25 * 58)
    assert e2e["evals_surrogate"] == 15 * 9
    assert e2e["evals_exact"] == 58 * 9
    assert set(e2e["surrogate_stages"]) == {
        "per_layer_sweep_s", "fit_s", "beam_s", "verification_s"}
    assert set(e2e["exact_stages"]) == {
        "per_layer_sweep_s", "beam_s", "verification_s"}
    assert record["launches"] == {"surrogate": {}, "exact": {}}
    assert record["fit"] is None and record["card"] is None
    assert record["front"]["surrogate"] and record["front"]["exact"]
    failing = {"speedup": e2e["speedup"] < ds.SPEEDUP_GATE,
               "fidelity": not record["fidelity"]["mean_rho"]
               >= ds.FIDELITY_GATE,
               "front": not record["front"]["matches_or_dominates"]}
    if failed is None:
        assert not any(failing.values())
    else:
        assert failing[failed]
        assert not any(failing[g] for g in list(failing)[
            :list(failing).index(failed)])
    json.dumps(record)


def test_rank_analysis_equals_reference(libs, capsys, monkeypatch):
    ref_lib, lib = libs
    monkeypatch.setattr(ref_rank, "get_default_library", lambda: ref_lib)
    ref_rank.run()
    want = capsys.readouterr().out.splitlines()
    lines = []
    got = rank_analysis.run(lib, log=lines.append)

    def strip_us(line):
        return re.sub(r"^([^,]+),[0-9.]+,", r"\1,", line)

    assert [strip_us(l) for l in lines] == [strip_us(l) for l in want]
    assert len(got["circuits"]) == len(want) - 1
    from repro.approx.ranking import kendall, spearman
    mae = [c["circuit_mae"] for c in got["circuits"]]
    r1 = [c["mae_r1"] for c in got["circuits"]]
    assert got["spearman"] == spearman(mae, r1)
    assert got["kendall"] == kendall(mae, r1)


# ----------------------------------------------------------------------
# On a card (no JAX needed)
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured fit and the "
                    "kernels run on the card only (chip_smoke.py runs "
                    "these checks)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_captured_fit_equals_eager(cuda):
    lib = build_default_library("tiny")
    names = [e.name for e in lib.select(kind="multiplier", width=8)]
    rows = [SimpleNamespace(layer=l, multiplier=n,
                            accuracy=s * np.log1p(lib.entry(n).errors.mae))
            for n in names for s, l in ((1.0, "a"), (0.4, "b"))]
    fit = fit_walls(rows, lib, 0.0, "min", device=cuda)
    assert fit["bit_equal"], fit


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["pallas", "fused"])
def test_cuda_108_lane_layer_pass_equals_plain(cuda, variant):
    lib = load_default_library()
    names = ds.widen_candidate_set(lib, 108)
    want, _ = ds.layer_pass(lib, names, "s0_b0_conv1", "ref", cuda)
    got, launches = ds.layer_pass(lib, names, "s0_b0_conv1", variant, cuda)
    assert launches == {ds.BANK_KERNEL[variant]: 1}
    assert got.shape == (108, 32, 10) and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_entry_points_without_cuda_raise(monkeypatch, libs):
    """The study's entry point, the fit and the warm-up run on the card
    unless the caller asks for the CPU."""
    _, lib = libs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = [SimpleNamespace(layer="l0", multiplier=n, accuracy=float(i))
            for i, n in enumerate(("mul8u_exact", "mul8u_trunc4",
                                   "mul8u_trunc2"))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_surrogate(rows, lib, 0.0, "min")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm_up()
