"""The port's surrogate predict stage (``repro_torch.approx.surrogate``)
against the JAX reference (``repro.approx.surrogate``) on the ``tiny``
library (57 8-bit multipliers) and the reference test's two-matmul toy
net (tests/test_surrogate.py).

What is held, and how closely:
  * features, the feature names and the structure slice, the drop
    matrix, the held-out split, the training subset and the
    standardization statistics: float64 numpy and name ordering, equal
    bit for bit;
  * the initial weights (drawn in float64 from the same generator, cast
    to float32): bit for bit;
  * the fit, on identical rows: one Adam step within ``STEP_ATOL`` of
    the reference's parameters; after the full 1500 epochs the predicted
    drops within ``DROP_RTOL`` of the largest drop, in the same order,
    layer by layer (the reference runs its steps in one XLA program,
    the port in float32 torch: the difference is accumulation order,
    which 1500 steps amplify from 3e-8 to about 1e-2 in the weights);
  * the cost head, ``train_names``/``val_names``: equal;
  * on the toy net, ``surrogate_components`` and
    ``explore_heterogeneous(predictor="surrogate")``: the measured
    (layer, multiplier) rows, ``train_names`` and ``n_train`` equal, the
    measured metrics within ``MAE_RTOL`` (the f32 reference logits come
    from two matmul implementations), ``beam_bound`` within the fit
    tolerance, the shortlists contained one in the other, the
    assignments verified by both within ``MAE_RTOL``, and the record's
    JSON round trip."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import dse as ref_dse
from repro.approx import surrogate as ref
from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.approx.specs import BackendSpec as RefSpec
from repro.approx.workload import logit_fidelity as ref_logit_fidelity
from repro.core.library import build_default_library as ref_build
from repro_torch.approx import dse as port_dse
from repro_torch.approx import surrogate as port
from repro_torch.approx.layers import ApproxPolicy
from repro_torch.approx.specs import BackendSpec
from repro_torch.approx.workload import logit_fidelity
from repro_torch.core.library import build_default_library as port_build
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LAYERS = ("lin_a", "lin_b")
COUNTS = {"lin_a": 100, "lin_b": 300}
#: one Adam step from bit-equal weights (float32 rounding of a step)
STEP_ATOL = 1e-6
#: predicted drops after the full fit, relative to the largest drop
DROP_RTOL = 2e-3
#: relative tolerance on the toy net's logit_mae between the packages
MAE_RTOL = 1e-4


@pytest.fixture(scope="module")
def libs():
    return ref_build("tiny"), port_build("tiny")


@pytest.fixture(scope="module")
def names(libs):
    ref_lib, port_lib = libs
    got = [e.name for e in port_lib.select(kind="multiplier", width=8)]
    assert got == [e.name for e in ref_lib.select(kind="multiplier",
                                                  width=8)]
    return got


def _synthetic_rows(lib, names):
    """The reference test's duck-typed rows: a drop that is a smooth
    monotone function of the error features, plus an "all" row that
    must be ignored."""
    rows = []
    for n in names:
        e = lib.entry(n)
        d = 2.0 * np.log1p(e.errors.mae) + 0.5 * np.log1p(e.errors.wce)
        for scale, layer in zip((1.0, 0.4), LAYERS):
            rows.append(SimpleNamespace(layer=layer, multiplier=n,
                                        accuracy=1.0 - scale * d))
    rows.append(SimpleNamespace(layer="all", multiplier=names[0],
                                accuracy=0.0))
    return rows


@pytest.fixture(scope="module")
def fits(libs, names):
    """Both packages' full fits on the same rows (1500 epochs)."""
    ref_lib, port_lib = libs
    rows = _synthetic_rows(ref_lib, names)
    return (ref.fit_surrogate(rows, ref_lib, baseline=1.0),
            port.fit_surrogate(rows, port_lib, baseline=1.0,
                               device="cpu"))


@pytest.fixture(scope="module")
def toy():
    """The reference test's toy net under ``logit_fidelity`` in both
    packages, on the same seeded inputs."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    w_a = rng.normal(size=(16, 16)).astype(np.float32)
    w_b = rng.normal(size=(16, 4)).astype(np.float32)
    jx, ja, jb = (jnp.asarray(a) for a in (x, w_a, w_b))
    tx, ta, tb = (torch.from_numpy(a) for a in (x, w_a, w_b))

    def ref_forward(policy, xb):
        y = policy.matmul("lin_a", xb, ja)
        return policy.matmul("lin_b", jax.nn.relu(y), jb)

    def port_forward(policy, xb):
        y = policy.matmul("lin_a", xb, ta)
        lanes = y.ndim == 3
        return policy.matmul("lin_b", torch.relu(y), tb, lanes=lanes)

    return (ref_logit_fidelity(ref_forward, [jx], layer_counts=dict(COUNTS)),
            logit_fidelity(port_forward, [tx], layer_counts=dict(COUNTS)))


def _params_np(params):
    return [np.asarray(a) if not isinstance(a, torch.Tensor)
            else a.cpu().numpy() for wb in params for a in wb]


# ----------------------------------------------------------------------
# Features, splits, subsets: bit for bit
# ----------------------------------------------------------------------
def test_feature_names_equal_reference():
    assert port.FEATURE_NAMES == ref.FEATURE_NAMES
    assert port.STRUCTURE_SLICE == ref.STRUCTURE_SLICE
    assert port.FEATURE_NAMES[port.STRUCTURE_SLICE][0] == "width_over_8"


def test_features_equal_reference(libs, names):
    ref_lib, port_lib = libs
    want = ref.feature_matrix([ref_lib.entry(n) for n in names])
    got = port.feature_matrix([port_lib.entry(n) for n in names])
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    assert len({tuple(r) for r in got[:10]}) == 10
    for n in ("mul8u_exact", "mul8u_trunc4", names[-1]):
        assert np.array_equal(port.circuit_features(port_lib.entry(n)),
                              ref.circuit_features(ref_lib.entry(n)))


@pytest.mark.parametrize("val_fraction", [0.0, 0.1, 0.2, 0.5])
def test_split_indices_equal_reference(libs, names, val_fraction):
    ref_lib, port_lib = libs
    for sub in (names, names[:7], names[:3]):
        assert (port._split_indices(sub, port_lib, val_fraction)
                == ref._split_indices(sub, ref_lib, val_fraction))


@pytest.mark.parametrize("fraction", [0.05, 0.25, 0.4, 1.0])
def test_train_subset_equal_reference(libs, names, fraction):
    ref_lib, port_lib = libs
    rp = {n: 1.0 / (1 + i) for i, n in enumerate(names)}
    for sub in (names, names[:4], names[:20]):
        assert (port.train_subset(sub, port_lib, fraction)
                == ref.train_subset(sub, ref_lib, fraction))
        assert (port.train_subset(sub, port_lib, fraction, rel_power=rp)
                == ref.train_subset(sub, ref_lib, fraction, rel_power=rp))


def test_rows_and_stats_equal_reference(libs, names):
    ref_lib, port_lib = libs
    rows = _synthetic_rows(ref_lib, names)
    for direction in ("max", "min"):
        got = port._rows_to_matrix(rows, 1.0, direction)
        want = ref._rows_to_matrix(rows, 1.0, direction)
        assert got[:2] == want[:2] and got[0] == LAYERS
        assert np.array_equal(got[2], want[2])
    x = port.feature_matrix([port_lib.entry(n) for n in names])
    for a, b in zip(port._stats(x), ref._stats(x)):
        assert np.array_equal(a, b)
    mu, sigma = ref._stats(x)
    assert np.array_equal(port._standardize(x, mu, sigma),
                          ref._standardize(x, mu, sigma))


# ----------------------------------------------------------------------
# The model: initial weights bit for bit, one step, the full fit
# ----------------------------------------------------------------------
def test_initial_weights_equal_reference():
    sizes = [len(port.FEATURE_NAMES), 32, 32, 2]
    got = port._init_params(np.random.default_rng(0), sizes)
    want = ref._init_params(np.random.default_rng(0), sizes)
    for g, w in zip(_params_np(got), _params_np(want)):
        assert g.dtype == w.dtype == np.float32
        assert np.array_equal(g, w)
    assert all(b.device.type == "cpu" for _, b in got)


def test_one_adam_step_within_tolerance(libs, names):
    ref_lib, port_lib = libs
    rows = _synthetic_rows(ref_lib, names)
    cfg = port.SurrogateConfig(epochs=1)
    c = port._corpus(rows, port_lib, 1.0, "max", cfg)
    x, y = c.xs[c.train], c.ys[c.train]
    init = c.initial_params(cfg)
    want = ref._train_mlp(
        ref._init_params(np.random.default_rng(0), [x.shape[1], 32, 32, 2]),
        x, y, ref.SurrogateConfig(epochs=1))
    got = port._train_mlp(init, x, y, cfg)
    moved = 0.0
    for g, w, i in zip(_params_np(got), _params_np(want),
                       _params_np(init)):
        assert np.max(np.abs(g - w)) <= STEP_ATOL
        moved = max(moved, float(np.max(np.abs(w - i))))
    assert moved > 100 * STEP_ATOL         # the step moved the weights
    # the initial weights are left as they were
    assert np.array_equal(_params_np(init)[0], _params_np(
        c.initial_params(cfg))[0])


def test_full_fit_predictions_within_tolerance(fits, libs, names):
    want_fit, got_fit = fits
    ref_lib, port_lib = libs
    want = want_fit.predict_drop(names, ref_lib)
    got = got_fit.predict_drop(names, port_lib)
    assert got.shape == want.shape == (2, len(names)) and (got >= 0).all()
    assert np.max(np.abs(got - want)) <= DROP_RTOL * np.max(want)
    for j in range(len(LAYERS)):
        assert (np.argsort(got[j], kind="stable").tolist()
                == np.argsort(want[j], kind="stable").tolist())
    np.testing.assert_array_equal(got_fit.predict_quality(names, port_lib),
                                  1.0 - got)


def test_full_fit_record_equals_reference(fits, libs, names):
    want, got = fits
    ref_lib, port_lib = libs
    assert got.layers == want.layers == LAYERS
    assert got.train_names == want.train_names
    assert got.val_names == want.val_names and got.val_names
    for a in ("x_mu", "x_sigma", "y_mu", "y_sigma", "cost_coef"):
        assert np.array_equal(getattr(got, a), getattr(want, a))
    assert got.cost_mean == want.cost_mean
    assert np.array_equal(got.predict_rel_power(names, port_lib),
                          want.predict_rel_power(names, ref_lib))
    s_got, s_want = got.summary(), want.summary()
    assert ({k: v for k, v in s_got.items() if k not in _FIT_KEYS}
            == {k: v for k, v in s_want.items() if k not in _FIT_KEYS})
    largest = float(np.max(want.predict_drop(names, ref_lib)))
    # the calibration band sums two layers' predicted drops
    assert (abs(got.calibration - want.calibration)
            <= len(LAYERS) * DROP_RTOL * largest)


#: summary keys that come from the trained MLP's predictions
_FIT_KEYS = ("calibration", "cell_residual_q", "total_residual_mean",
             "val_spearman")


def test_fit_min_direction_and_errors(libs, names):
    _, port_lib = libs
    rows = [SimpleNamespace(layer="l0", multiplier=n,
                            accuracy=0.1 + np.log1p(
                                port_lib.entry(n).errors.mae))
            for n in names]
    pred = port.fit_surrogate(rows, port_lib, baseline=0.1,
                              direction="min",
                              config=port.SurrogateConfig(epochs=200),
                              device="cpu")
    assert (pred.predict_quality(names, port_lib) >= 0.1).all()
    with pytest.raises(ValueError, match=">= 3 circuits"):
        port.fit_surrogate(_synthetic_rows(port_lib, names[:2]), port_lib,
                           baseline=1.0, device="cpu")
    with pytest.raises(ValueError, match="cost head"):
        port.SurrogatePredictor(
            layers=("l0",), baseline=0.0, direction="max",
            params=pred.params, x_mu=pred.x_mu, x_sigma=pred.x_sigma,
            y_mu=pred.y_mu, y_sigma=pred.y_sigma, train_names=(),
            val_names=(), calibration=0.0,
            config=port.SurrogateConfig()).predict_rel_power(names,
                                                             port_lib)
    with pytest.raises(ValueError, match="CUDA"):
        port.fit_walls(rows, port_lib, 0.1, "min", device="cpu")


# ----------------------------------------------------------------------
# The predict stage and the DSE wiring on the toy net
# ----------------------------------------------------------------------
def _within(got, want, rtol=MAE_RTOL):
    return abs(got - want) <= rtol * max(abs(want), 1e-12)


def test_surrogate_components_equal_reference(libs, names, toy):
    ref_lib, port_lib = libs
    ref_wl, port_wl = toy
    sub = names[:16]
    ref_base = ref_wl.measure(RefPolicy(
        default=RefSpec.golden().materialize()))["logit_mae"]
    base = port_wl.measure(ApproxPolicy(
        default=BackendSpec.golden().materialize()))["logit_mae"]
    want = ref.surrogate_components(ref_wl, COUNTS, sub, ref_lib,
                                    baseline=ref_base, direction="min",
                                    train_fraction=0.4, batch=True)
    walls = {}
    got = port.surrogate_components(port_wl, COUNTS, sub, port_lib,
                                    baseline=base, direction="min",
                                    train_fraction=0.4, batch=True,
                                    device="cpu", stage_walls=walls)
    assert set(walls) == {"per_layer_sweep_s", "fit_s"}
    (comp, pred, rows), (rcomp, rpred, rrows) = got, want
    assert [(r.layer, r.multiplier) for r in rows] == [
        (r.layer, r.multiplier) for r in rrows]
    assert all(_within(r.accuracy, w.accuracy) for r, w in zip(rows, rrows))
    assert pred.train_names == rpred.train_names
    assert pred.val_names == rpred.val_names
    assert comp.layers == rcomp.layers and comp.multipliers == tuple(sub)
    assert np.array_equal(comp.rel_power, rcomp.rel_power)
    assert (comp.counts, comp.total_count) == (rcomp.counts,
                                               rcomp.total_count)
    li = {l: j for j, l in enumerate(comp.layers)}
    mi = {m: i for i, m in enumerate(comp.multipliers)}
    for r in rows:                   # measured cells are exact
        assert comp.quality[li[r.layer], mi[r.multiplier]] == r.accuracy
    assert {r.multiplier for r in rows} == (set(pred.train_names)
                                            | set(pred.val_names))


@pytest.fixture(scope="module")
def explored(libs, names, toy):
    ref_lib, port_lib = libs
    ref_wl, port_wl = toy
    kw = dict(multipliers=names[:16], quality_bound=10.0, top_k=4,
              predictor="surrogate", train_fraction=0.4)
    return (ref_dse.explore_heterogeneous(ref_wl, COUNTS, ref_lib, **kw),
            port_dse.explore_heterogeneous(port_wl, COUNTS, port_lib,
                                           device="cpu", **kw))


def test_explore_heterogeneous_surrogate_equals_reference(explored):
    want, got = explored
    s, rs = got.surrogate, want.surrogate
    assert s["train_fraction"] == rs["train_fraction"] == 0.4
    for k in ("n_train", "n_val", "train_names", "val_names", "layers",
              "direction", "config", "holdout"):
        assert s[k] == rs[k]
    assert s["beam_bound"] == 10.0 + s["calibration"]
    # the rows it measured: the training subset, every layer
    assert [(p.layer, p.multiplier) for p in got.per_layer] == [
        (p.layer, p.multiplier) for p in want.per_layer]
    assert len(got.per_layer) == len(LAYERS) * (s["n_train"] + s["n_val"])
    for p, w in zip(got.per_layer, want.per_layer):
        assert _within(p.accuracy, w.accuracy)
        assert p.network_rel_power == w.network_rel_power
    # the beam band: the calibration of fits on rows that agree within
    # MAE_RTOL, held to the fit tolerance on the largest measured drop
    drops = [max(p.accuracy - want.baseline_accuracy, 0.0)
             for p in want.per_layer]
    assert (abs(s["beam_bound"] - rs["beam_bound"])
            <= len(LAYERS) * DROP_RTOL * max(drops))


def test_explore_heterogeneous_surrogate_shortlist(explored):
    """The shortlists contain one another (prediction error can move the
    beam's edge); every assignment both verified has metrics within
    ``MAE_RTOL`` and equal power; the selection is a verified point of
    the port's shortlist within the bound."""
    want, got = explored
    key = lambda p: tuple(sorted(dict(p.assignment).items()))  # noqa: E731
    g = {key(p): p for p in got.heterogeneous}
    w = {key(p): p for p in want.heterogeneous}
    assert g and (set(g) <= set(w) or set(w) <= set(g))
    for k in set(g) & set(w):
        assert g[k].network_rel_power == w[k].network_rel_power
        for m in ("logit_mae", "top1_agreement"):
            assert _within(g[k].metrics[m], w[k].metrics[m])
    for p in got.heterogeneous:
        assert p.layer == "hetero" and set(dict(p.assignment)) == set(COUNTS)
    if got.selected is not None:
        assert key(got.selected) in g
        assert got.selected.accuracy <= got.baseline_accuracy + 10.0


def test_explore_heterogeneous_surrogate_json_round_trip(explored):
    _, got = explored
    d = got.to_json_dict()
    assert "surrogate" in d
    rt = port_dse.ExploreResult.from_json_dict(d)
    assert rt.to_json_dict() == d
    # the reference reads the port's record back as well
    assert ref_dse.ExploreResult.from_json_dict(d).to_json_dict() == d
