"""The population-parallel CGP engine of the port
(``repro_torch.core.evolve_pop``) held against the JAX reference on the
CPU: scores, search trajectories and whole library builds.

* ``PopEvaluator.errors_of``: all six metrics, both engines (the device
  engine on the CPU runs K11's plain version and the device reduction in
  PyTorch), equal to the reference's float64 values — equal, not close —
  on a 6-bit multiplier and an 8-bit adder.
* ``evolve_pop`` / ``evolve_ladder``: the reference's trajectories at a
  fixed seed (same ``netlist.to_dict()``, same ``ErrorReport``s).
* ``build_default_library("tiny", engine=...)``: the reference's build
  under the same engine, entry for entry, as ``tests/test_torch_core.py``
  checks the legacy build."""
from dataclasses import replace

import numpy as np
import pytest

from repro.core import evolve_pop as ref_pop
from repro.core import library as ref_library
from repro.core.cgp import CgpParams as RefParams
from repro_torch.core import evolve_pop as port_pop
from repro_torch.core import library as port_library
from repro_torch.core.cgp import CgpParams, pad_nodes
from repro_torch.core.metrics import METRIC_NAMES, evaluate_errors
from repro_torch.core.seeds import array_multiplier, ripple_carry_adder
from tests.test_torch_bitsim import random_netlist

ENGINES = ("numpy", "device")


def _ref_params(p: CgpParams) -> RefParams:
    return RefParams(**p.__dict__)


@pytest.fixture(scope="module")
def mult6():
    return array_multiplier(6)


@pytest.fixture(scope="module")
def params():
    return CgpParams(metric="mae", e_max=40.0, generations=25, seed=5,
                     search_samples=4096)


def _port_eval(exact, p, engine, **kw):
    return port_pop.PopEvaluator(exact, p, engine=engine, device="cpu",
                                 **kw)


@pytest.mark.parametrize("metric", METRIC_NAMES)
def test_errors_of_equals_reference_every_metric(mult6, metric):
    """Device-reduced metrics (er/mae/wce) and the host-reduced fallback
    alike: the port's two engines give the reference's float64 values
    exactly, on a population of 11 (the reference pads it to 16)."""
    p = CgpParams(metric=metric, search_samples=2048, seed=3)
    rng = np.random.default_rng(7)
    pop = [random_netlist(rng, mult6.n_i, mult6.n_o, 80)
           for _ in range(ref_pop.POP_PAD + 3)]
    want = ref_pop.PopEvaluator(mult6, _ref_params(p),
                                engine="device").errors_of(pop)
    assert want.dtype == np.float64
    for engine in ENGINES:
        got = _port_eval(mult6, p, engine).errors_of(pop)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", METRIC_NAMES)
def test_adder_errors_of_equals_reference(metric):
    add = ripple_carry_adder(8)
    p = CgpParams(metric=metric, search_samples=1024, seed=11)
    rng = np.random.default_rng(METRIC_NAMES.index(metric))
    pop = [random_netlist(rng, add.n_i, add.n_o, 50) for _ in range(5)]
    want = ref_pop.PopEvaluator(add, _ref_params(p),
                                engine="numpy").errors_of(pop)
    for engine in ENGINES:
        np.testing.assert_array_equal(
            _port_eval(add, p, engine).errors_of(pop), want)


@pytest.mark.parametrize("metric", port_pop.DEVICE_METRICS)
@pytest.mark.parametrize("width", [24, 31])
def test_wide_output_device_reduction_equals_reference(width, metric):
    """25 and 32 output bits: the port reduces on the device in exact
    int64 where the reference reduces on the host (its int32 chunked
    sums stop at 24 bits); the floats are the same."""
    add = ripple_carry_adder(width)
    assert add.n_o == width + 1
    p = CgpParams(metric=metric, search_samples=1024, seed=13)
    rng = np.random.default_rng(width)
    pop = [random_netlist(rng, add.n_i, add.n_o, 60) for _ in range(5)]
    pop.append(add)
    want = ref_pop.PopEvaluator(add, _ref_params(p),
                                engine="device").errors_of(pop)
    assert want[-1] == 0.0 and np.all(want[:-1] > 0)
    for engine in ENGINES:
        np.testing.assert_array_equal(
            _port_eval(add, p, engine).errors_of(pop), want)


def _same(a, b):
    assert a.netlist.to_dict() == b.netlist.to_dict()
    assert a.errors.as_dict() == b.errors.as_dict()
    assert (a.cost_area, a.cost_power) == (b.cost_area, b.cost_power)


@pytest.mark.parametrize("engine", ENGINES)
def test_evolve_pop_walks_reference_trajectory(mult6, params, engine):
    seed_nl = pad_nodes(mult6, mult6.n_nodes + 10, seed=99)
    want = ref_pop.evolve_pop(seed_nl, mult6, _ref_params(params),
                              engine="numpy")
    got = port_pop.evolve_pop(seed_nl, mult6, params, engine=engine,
                              device="cpu")
    _same(got, want)
    assert got.errors.mae <= params.e_max


@pytest.mark.parametrize("engine", ENGINES)
def test_evolve_ladder_walks_reference_trajectories(mult6, params, engine):
    """Every rung of the fused ladder equals the reference's rung, and
    the callbacks fire for the same improved parents."""
    seed_nl = pad_nodes(mult6, mult6.n_nodes + 10, seed=99)
    ladder = [10.0, 40.0, 120.0]
    seen_ref, seen = [], []
    want = ref_pop.evolve_ladder(
        seed_nl, mult6, ladder, _ref_params(params), engine="device",
        on_candidate=lambda i, nl, e, a: seen_ref.append((i, e, a)))
    got = port_pop.evolve_ladder(
        seed_nl, mult6, ladder, params, engine=engine, device="cpu",
        on_candidate=lambda i, nl, e, a: seen.append((i, e, a)))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _same(a, b)
    assert seen == seen_ref


def test_ladder_rung_equals_standalone_run(mult6, params):
    seed_nl = pad_nodes(mult6, mult6.n_nodes + 10, seed=99)
    ev = _port_eval(mult6, params, "device")
    lad = port_pop.evolve_ladder(seed_nl, mult6, [10.0, 40.0], params,
                                 evaluator=ev)
    for i, e_max in enumerate([10.0, 40.0]):
        solo = port_pop.evolve_pop(
            seed_nl, mult6, replace(params, e_max=e_max,
                                    seed=params.seed + i),
            engine="device", device="cpu")
        _same(lad[i], solo)
    # one evaluation per generation for the whole ladder, plus the seed
    assert ev.n_calls == 1 + params.generations
    assert ev.n_scored == 1 + params.generations * params.lam * 2
    assert ev.device_s > 0 and ev.host_s > 0


def test_verify_on_device_engine_equals_evaluate_errors(mult6):
    """The device engine re-verifies through K10 (its plain version
    here): the exhaustive report of ``metrics.evaluate_errors``."""
    ev = _port_eval(mult6, CgpParams(), "device")
    rng = np.random.default_rng(3)
    for _ in range(3):
        nl = random_netlist(rng, mult6.n_i, mult6.n_o, 60).compact()
        assert ev.verify(nl).as_dict() == \
            evaluate_errors(nl, mult6).as_dict()


def test_evaluator_rejects_bad_config(mult6, params):
    with pytest.raises(ValueError, match="engine"):
        port_pop.PopEvaluator(mult6, params, engine="cuda")
    with pytest.raises(ValueError, match="metric"):
        port_pop.PopEvaluator(mult6, replace(params, metric="nope"))
    wide = ripple_carry_adder(40)      # n_o = 41 > device cap
    with pytest.raises(ValueError, match="numpy"):
        _port_eval(wide, params, "device")


@pytest.mark.parametrize("engine", ENGINES)
def test_tiny_library_equals_reference_build(engine):
    """The population build at budget 'tiny' (66 evolved of 129 entries,
    composed 12-bit rows over the evolved tiles) equals the reference's
    build under the same engine, entry for entry."""
    ref = ref_library.build_default_library("tiny", engine=engine)
    stats: dict = {}
    port = port_library.build_default_library("tiny", engine=engine,
                                              device="cpu", stats=stats)
    assert list(port.entries) == list(ref.entries)
    for name, e in ref.entries.items():
        p = port.entries[name]
        assert (p.kind, p.width, p.source) == (e.kind, e.width, e.source)
        assert p.rel_power == e.rel_power
        assert p.errors.as_dict() == e.errors.as_dict()
        assert p.cost.as_dict() == e.cost.as_dict()
        assert p.netlist.to_dict() == e.netlist.to_dict()
        assert p.composition == e.composition
    assert sum(e.source == "evolved" for e in port.entries.values()) == 66
    assert set(stats) == {"mul8u", "add8u"}
    assert stats["mul8u"]["evaluator_calls"] == 41
    assert stats["mul8u"]["scored"] == 1 + 40 * 3 * 4
