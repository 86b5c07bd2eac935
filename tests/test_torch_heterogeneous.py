"""The heterogeneous per-layer DSE of the port against the JAX reference,
on the reference's two-matmul toy network (tests/test_heterogeneous.py)
and on deterministic evaluations.

What is held, and how closely:
  * ``PolicyBank`` and ``policy_assignment``: assignment matrix, bank
    names and spec overrides equal the reference's; the same inputs
    raise.
  * ``policy_bank_eval``: every lane's outputs ``y`` equal the
    reference's lanes bit for bit (layer-level results are bit-exact,
    and the toy net has no float reduction), for an 8-bit bank and a
    bank mixing 8-bit and composed 12/16-bit lanes, under the plain
    datapath and under ``pallas``/``fused`` (the kernels' plain versions
    on the CPU); and the port's sequential ``policy_for_lane``
    evaluations bit for bit.  Under ``pallas``/``fused`` each layer is
    one banked datapath call, whatever the number of policies.
  * Decisions: ``compose_assignments`` on identical ``LayerComponents``
    and ``explore_heterogeneous`` on an evaluation that both packages
    compute identically give equal rows, results and selections.
  * A min primary (``logit_fidelity`` on the toy net): the same
    assignments in the same order and the same selection; metrics
    within ``MAE_RTOL`` (the f32 reference logits come from two matmul
    implementations)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import dse as ref_dse
from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.approx.layers import policy_bank_eval as ref_policy_bank_eval
from repro.approx.layers import spec_of as ref_spec_of
from repro.approx.resilience import LayerComponents as RefComponents
from repro.approx.specs import BackendSpec as RefSpec
from repro.approx.specs import PolicyBank as RefPolicyBank
from repro.approx.specs import policy_assignment as ref_policy_assignment
from repro.approx.workload import logit_fidelity as ref_logit_fidelity
from repro.core.library import build_default_library as ref_build
from repro_torch.approx import dse as port_dse
from repro_torch.approx.layers import (ApproxPolicy, policy_bank_eval,
                                       policy_for_lane, spec_of)
from repro_torch.approx.resilience import LayerComponents
from repro_torch.approx.specs import (BackendSpec, LutBank, PolicyBank,
                                      policy_assignment)
from repro_torch.approx.workload import logit_fidelity
from repro_torch.core.library import build_default_library as port_build
from repro_torch.kernels import datapaths
from repro_torch.models import resnet
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MULTS = ["mul8u_exact", "mul8u_trunc4", "mul8u_trunc2"]
#: composed lanes of the mixed-width bank: one tree (loa4), so the
#: ``pallas`` variant takes the bank too
WIDE = (("mul8u_exact", 12, "loa4"), ("mul8u_trunc4", 16, "loa4"))
LAYERS = ("lin_a", "lin_b")
COUNTS = {"lin_a": 100, "lin_b": 300}
#: relative tolerance on logit_mae between the packages (f32 reference
#: logits from torch.matmul and XLA's dot)
MAE_RTOL = 1e-4


@pytest.fixture(scope="module")
def libs():
    ref_lib, port_lib = ref_build("tiny"), port_build("tiny")
    wide = [(ref_lib.add_composed(*r).name, port_lib.add_composed(*r).name)
            for r in WIDE]
    assert all(a == b for a, b in wide)
    return ref_lib, port_lib, [a for a, _ in wide]


@pytest.fixture(scope="module")
def toy():
    """The reference test's two-matmul toy net, in both packages, on the
    same seeded inputs; each returns the outputs ``y`` (not their
    mean)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    w_a = rng.normal(size=(16, 16)).astype(np.float32)
    w_b = rng.normal(size=(16, 4)).astype(np.float32)
    jx, ja, jb = (jnp.asarray(a) for a in (x, w_a, w_b))
    tx, ta, tb = (torch.from_numpy(a) for a in (x, w_a, w_b))

    def ref_forward(policy, xb=jx):
        y = policy.matmul("lin_a", xb, ja)
        return policy.matmul("lin_b", jax.nn.relu(y), jb)

    def port_forward(policy, xb=tx):
        y = policy.matmul("lin_a", xb, ta)
        lanes = y.ndim == 3
        return policy.matmul("lin_b", torch.relu(y), tb, lanes=lanes)

    return ref_forward, port_forward, jx, tx


def _rows(names, n_policies, seed):
    rng = np.random.default_rng(seed)
    return [{l: names[rng.integers(0, len(names))] for l in LAYERS}
            for _ in range(n_policies)]


def _banks(libs, rows, **kw):
    ref_lib, port_lib, _ = libs
    return (RefPolicyBank.from_assignments(rows, ref_lib, **kw),
            PolicyBank.from_assignments(rows, port_lib, **kw))


def _same_bank(ref_pb, port_pb):
    assert port_pb.layers == ref_pb.layers
    assert port_pb.bank.names == ref_pb.bank.names
    np.testing.assert_array_equal(port_pb.assign, ref_pb.assign)
    assert port_pb.assign.dtype == np.int32
    for p in range(port_pb.n_policies):
        assert port_pb.assignment(p) == ref_pb.assignment(p)
        for variant in ("ref", "pallas"):
            got = [(l, s.to_dict()) for l, s in
                   port_pb.spec_overrides(p, variant=variant)]
            want = [(l, s.to_dict()) for l, s in
                    ref_pb.spec_overrides(p, variant=variant)]
            assert got == want


# ----------------------------------------------------------------------
# PolicyBank
# ----------------------------------------------------------------------
def test_policy_bank_construction_matches_reference(libs):
    rows = [{"lin_a": "mul8u_trunc4", "lin_b": "mul8u_exact"},
            {"lin_a": "mul8u_trunc2", "lin_b": "mul8u_trunc4"},
            {"lin_b": "mul8u_trunc2", "lin_a": "mul8u_trunc2"}]
    ref_pb, port_pb = _banks(libs, rows)
    assert (port_pb.n_policies, port_pb.n_layers) == (3, 2)
    _same_bank(ref_pb, port_pb)
    # the fill multiplier pads rows that do not cover the layer axis
    partial = [{"lin_a": "mul8u_trunc4"}, {"lin_b": "mul8u_trunc2"}]
    _same_bank(*_banks(libs, partial, layers=LAYERS, fill="mul8u_exact"))


def test_policy_bank_uniform_matches_reference(libs):
    ref_lib, port_lib, wide = libs
    names = MULTS + wide
    ref_pb = RefPolicyBank.uniform(names, LAYERS, ref_lib)
    port_pb = PolicyBank.uniform(names, LAYERS, port_lib)
    _same_bank(ref_pb, port_pb)
    assert port_pb.bank.bit_widths == ref_pb.bank.bit_widths
    for p, name in enumerate(names):
        assert set(port_pb.assignment(p).values()) == {name}


@pytest.mark.parametrize("case", ["misses", "assign_shape", "indices"])
def test_policy_bank_validation_errors(case, libs):
    ref_lib, port_lib, _ = libs
    made = {}
    for tag, cls, lib in (("ref", RefPolicyBank, ref_lib),
                          ("port", PolicyBank, port_lib)):
        pb = cls.from_assignments(_rows(MULTS, 2, 0), lib, layers=LAYERS)
        if case == "misses":
            call = lambda: cls.from_assignments(  # noqa: E731
                [{"lin_a": "mul8u_exact"}], lib, layers=LAYERS)
        elif case == "assign_shape":
            call = lambda: cls(bank=pb.bank, layers=LAYERS,  # noqa: E731
                               assign=np.zeros((2, 3), np.int32))
        else:
            call = lambda: cls(bank=pb.bank, layers=LAYERS,  # noqa: E731
                               assign=np.full((1, 2), 99, np.int32))
        with pytest.raises(ValueError) as err:
            call()
        made[tag] = str(err.value)
    assert made["port"] == made["ref"]


def test_from_policies_matches_reference(libs):
    ref_lib, port_lib, _ = libs
    layers = ("lin_a", "lin_b", "head")

    def policies(policy_cls, spec_cls):
        lut = lambda m: spec_cls(mode="lut", multiplier=m)  # noqa: E731
        return [policy_cls(default=lut("mul8u_exact")),
                policy_cls(default=lut("mul8u_trunc4"),
                           overrides=[("lin_*", lut("mul8u_trunc2"))]),
                policy_cls(default=lut("mul8u_trunc2"),
                           overrides=[("head", lut("mul8u_trunc4")),
                                      ("lin_b", lut("mul8u_exact"))])]

    ref_pols = policies(RefPolicy, RefSpec)
    port_pols = policies(ApproxPolicy, BackendSpec)
    for rp, pp in zip(ref_pols, port_pols):
        assert (policy_assignment(pp, layers)
                == ref_policy_assignment(rp, layers))
    _same_bank(RefPolicyBank.from_policies(ref_pols, layers, ref_lib),
               PolicyBank.from_policies(port_pols, layers, port_lib))


@pytest.mark.parametrize("bad", ["mode", "block_m"])
def test_policy_assignment_errors_match_reference(bad, libs):
    made = {}
    for tag, policy_cls, spec_cls, fn in (
            ("ref", RefPolicy, RefSpec, ref_policy_assignment),
            ("port", ApproxPolicy, BackendSpec, policy_assignment)):
        spec = (spec_cls(mode="int8") if bad == "mode" else
                spec_cls(mode="lut", multiplier="mul8u_trunc4",
                         block_m=256))
        policy = policy_cls(default=spec_cls(mode="lut"),
                            overrides=[("lin_b", spec)])
        with pytest.raises(ValueError) as err:
            fn(policy, LAYERS)
        made[tag] = str(err.value)
    assert made["port"] == made["ref"]


# ----------------------------------------------------------------------
# policy_bank_eval on the toy net
# ----------------------------------------------------------------------
def _bank_rows(libs, kind: str):
    """Five policy rows over the 8-bit names or over a mixed-width set;
    ``same_table``: a bank whose lin_a takes one table in every lane."""
    _, _, wide = libs
    if kind == "narrow":
        return _rows(MULTS, 5, 0)
    if kind == "mixed":
        return _rows(MULTS + wide, 5, 1)
    rows = _rows(MULTS + wide, 4, 2)
    return [{**r, "lin_a": wide[1]} for r in rows]


@pytest.mark.parametrize("variant", ["ref", "pallas", "fused"])
@pytest.mark.parametrize("kind", ["narrow", "mixed", "same_table"])
def test_policy_bank_eval_lanes_bit_equal(kind, variant, libs, toy):
    ref_lib, port_lib, _ = libs
    ref_forward, port_forward, _, _ = toy
    ref_pb, port_pb = _banks(libs, _bank_rows(libs, kind), layers=LAYERS)
    got = policy_bank_eval(lambda pol: {"y": port_forward(pol)}, port_pb,
                           variant=variant)["y"]
    assert got.shape == (port_pb.n_policies, 8, 4)
    # the reference's plain lanes: the port's variants are bit-exact to
    # the plain datapath, whose lanes the reference computes
    want = np.asarray(ref_policy_bank_eval(ref_forward, ref_pb))
    np.testing.assert_array_equal(got.numpy(), want)
    seq = [port_forward(policy_for_lane(port_pb, p, variant=variant)
                        .materialize(port_lib))
           for p in range(port_pb.n_policies)]
    assert torch.equal(got, torch.stack(seq))


@pytest.mark.parametrize("kind", ["narrow", "mixed"])
def test_policy_bank_eval_reference_pallas_lanes(kind, libs, toy):
    """The reference's banked ``pallas`` lanes (its kernels in interpret
    mode) against the port's ``pallas`` lanes."""
    ref_forward, port_forward, _, _ = toy
    ref_pb, port_pb = _banks(libs, _bank_rows(libs, kind), layers=LAYERS)
    got = policy_bank_eval(lambda pol: {"y": port_forward(pol)}, port_pb,
                           variant="pallas")["y"]
    want = np.asarray(ref_policy_bank_eval(ref_forward, ref_pb,
                                           variant="pallas"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_layers_outside_the_bank_run_base(libs, toy):
    """A bank over lin_b only: lin_a runs the golden base without a lane
    axis, lin_b's lanes follow, as in the reference."""
    ref_lib, port_lib, _ = libs
    ref_forward, port_forward, _, _ = toy
    rows = [{"lin_b": m} for m in MULTS]
    ref_pb, port_pb = _banks(libs, rows)
    got = policy_bank_eval(lambda pol: {"y": port_forward(pol)},
                           port_pb)["y"]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_policy_bank_eval(ref_forward, ref_pb)))


@pytest.mark.parametrize("variant,patched", [
    ("pallas", "approx_matmul_lut_bank"), ("fused", "fused_matmul_lut_bank")])
@pytest.mark.parametrize("n_policies", [2, 7])
def test_one_banked_call_a_layer(n_policies, variant, patched, libs, toy,
                                 monkeypatch):
    _, port_lib, _ = libs
    _, port_forward, _, _ = toy
    single = {"pallas": "approx_matmul_lut",
              "fused": "fused_matmul_lut"}[variant]
    calls = {patched: 0, single: 0}
    for name in calls:
        orig = getattr(datapaths, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(datapaths, name, counted)
    pb = PolicyBank.from_assignments(_rows(MULTS, n_policies, 5), port_lib,
                                     layers=LAYERS)
    out = policy_bank_eval(lambda pol: {"y": port_forward(pol)}, pb,
                           variant=variant)["y"]
    assert out.shape[0] == n_policies
    assert calls == {patched: len(LAYERS), single: 0}


def test_mixed_reduce_bank_needs_fused(libs, toy):
    _, port_lib, _ = libs
    _, port_forward, _, _ = toy
    a = port_lib.add_composed("mul8u_exact", 12, "exact").name
    b = port_lib.add_composed("mul8u_trunc4", 12, "loa4").name
    bank = LutBank.from_library([a, b], port_lib, mixed_reduce=True)
    pb = PolicyBank(bank=bank, layers=LAYERS,
                    assign=np.asarray([[0, 1], [1, 0]], np.int32))
    with pytest.raises(ValueError, match="fused"):
        policy_bank_eval(lambda pol: {"y": port_forward(pol)}, pb,
                         variant="pallas")
    got = policy_bank_eval(lambda pol: {"y": port_forward(pol)}, pb,
                           variant="fused")["y"]
    seq = [port_forward(policy_for_lane(pb, p, variant="fused")
                        .materialize(port_lib)) for p in range(2)]
    assert torch.equal(got, torch.stack(seq))


# ----------------------------------------------------------------------
# Decisions
# ----------------------------------------------------------------------
def _components(cls, direction):
    if direction == "max":
        quality = [[0.9, 0.88, 0.6], [0.9, 0.7, 0.5]]
        baseline = 0.9
    else:
        quality = [[0.001, 0.010, 0.200], [0.001, 0.080, 0.500]]
        baseline = 0.001
    return cls(layers=LAYERS, multipliers=tuple(MULTS),
               quality=np.asarray(quality),
               rel_power=np.asarray([1.0, 0.2, 0.02]),
               counts=(100, 300), total_count=400, baseline=baseline,
               direction=direction)


@pytest.mark.parametrize("direction", ["max", "min"])
@pytest.mark.parametrize("bound,budget,top_k", [
    (0.05, None, 4), (0.05, 0.5, 4), (None, None, 6), (0.3, 0.3, 8),
    (1e-6, None, 3)])
def test_compose_assignments_equal_rows(direction, bound, budget, top_k):
    want = ref_dse.compose_assignments(
        _components(RefComponents, direction), quality_bound=bound,
        power_budget=budget, top_k=top_k)
    got = port_dse.compose_assignments(
        _components(LayerComponents, direction), quality_bound=bound,
        power_budget=budget, top_k=top_k)
    assert [r.tolist() for r in got] == [r.tolist() for r in want]
    assert all(r.dtype == np.int32 for r in got)


def _additive_accuracy(spec_of_fn, library):
    """A deterministic accuracy per policy, additive over its per-layer
    overrides (each costs its multiplier's mae / 20000): identical
    values in both packages."""
    def fn(policy):
        drop = sum(library.entry(spec_of_fn(be).multiplier).errors.mae
                   / 20000.0 for _, be in policy.overrides)
        spec = spec_of_fn(policy.default)
        if spec.mode != "int8":
            drop += library.entry(spec.multiplier).errors.mae / 2000.0
        return 1.0 - drop
    return fn


@pytest.mark.parametrize("with_extras", [False, True])
@pytest.mark.parametrize("bound,budget", [(0.005, None), (0.02, None),
                                          (0.02, 0.9)])
def test_explore_heterogeneous_equal_results(bound, budget, with_extras,
                                             libs):
    ref_lib, port_lib, _ = libs
    counts = resnet.layer_mult_counts(resnet.resnet_config(8))
    names = [e.name for e in port_lib.case_study_selection()][:6]
    extras = None
    if with_extras:
        layers = list(counts)
        extras = [{l: names[(i + j) % len(names)]
                   for j, l in enumerate(layers)} for i in range(3)]
    kw = dict(multipliers=names, quality_bound=bound, power_budget=budget,
              top_k=5, extra_assignments=extras)
    want = ref_dse.explore_heterogeneous(
        _additive_accuracy(ref_spec_of, ref_lib), counts, ref_lib, **kw)
    got = port_dse.explore_heterogeneous(
        _additive_accuracy(spec_of, port_lib), counts, port_lib, **kw)
    assert got.heterogeneous
    assert got.to_json_dict() == want.to_json_dict()
    assert (got.selected is None) == (want.selected is None)
    if got.selected is not None:
        assert got.selected.assignment == want.selected.assignment
    # the port reads the reference's JSON back into the same decisions
    restored = port_dse.ExploreResult.from_json_dict(want.to_json_dict())
    a = port_dse.select_point(restored, bound, axis="heterogeneous")
    b = ref_dse.select_point(want, bound, axis="heterogeneous")
    assert (a is None and b is None) or a.assignment == b.assignment


def test_explore_heterogeneous_unknown_predictor_raises(libs):
    _, port_lib, _ = libs
    with pytest.raises(ValueError, match="predictor"):
        port_dse.explore_heterogeneous(
            _additive_accuracy(spec_of, port_lib), COUNTS, port_lib,
            multipliers=MULTS, predictor="mlp")


def test_design_point_from_assignment_matches_reference():
    a = {"lin_a": "mul8u_trunc4", "lin_b": "mul8u_trunc2"}
    for assignment, kw in ((a, {}), (a, {"variant": "pallas"}),
                           ({"lin_a": "mul8u_trunc4",
                             "lin_b": "mul8u_trunc4"}, {})):
        got = port_dse.DesignPoint.from_assignment(
            assignment, 0.9, 0.25, metrics={"accuracy": 0.9}, **kw)
        want = ref_dse.DesignPoint.from_assignment(
            assignment, 0.9, 0.25, metrics={"accuracy": 0.9}, **kw)
        assert got.to_dict() == want.to_dict()
        assert (got.policy().to_json_dict()
                == want.policy().to_json_dict())


# ----------------------------------------------------------------------
# Min primary: logit fidelity of the toy net
# ----------------------------------------------------------------------
def test_explore_heterogeneous_min_primary(libs, toy):
    ref_lib, port_lib, _ = libs
    ref_forward, port_forward, jx, tx = toy
    ref_wl = ref_logit_fidelity(ref_forward, [jx],
                                layer_counts=dict(COUNTS))
    port_wl = logit_fidelity(port_forward, [tx], layer_counts=dict(COUNTS))
    kw = dict(multipliers=MULTS, quality_bound=30.0, top_k=6)
    want = ref_dse.explore_heterogeneous(ref_wl, dict(COUNTS), ref_lib,
                                         **kw)
    got = port_dse.explore_heterogeneous(port_wl, dict(COUNTS), port_lib,
                                         **kw)
    assert [p.assignment for p in got.heterogeneous] == \
        [p.assignment for p in want.heterogeneous]
    assert [p.network_rel_power for p in got.heterogeneous] == \
        [p.network_rel_power for p in want.heterogeneous]
    assert got.selected.assignment == want.selected.assignment
    for g, w in zip(got.heterogeneous + got.per_layer,
                    want.heterogeneous + want.per_layer):
        for m in ("logit_mae", "top1_agreement"):
            np.testing.assert_allclose(g.metrics[m], w.metrics[m],
                                       rtol=MAE_RTOL, atol=0)
    np.testing.assert_allclose(got.baseline_accuracy,
                               want.baseline_accuracy, rtol=MAE_RTOL)
    # batched verification (the port's banked lanes) equals sequential
    assignments = [dict(p.assignment) for p in got.heterogeneous]
    bat = port_dse.verify_assignments(port_wl, assignments, COUNTS,
                                      port_lib, variant="pallas")
    seq = port_dse.verify_assignments(port_wl, assignments, COUNTS,
                                      port_lib, variant="pallas",
                                      batch=False)
    assert [p.metrics for p in bat] == [p.metrics for p in seq]
    assert [p.metrics for p in bat] == [p.metrics for p in
                                        got.heterogeneous]
