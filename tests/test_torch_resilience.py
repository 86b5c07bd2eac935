"""Resilience sweeps and DSE selection of the port against the reference,
on the committed ResNet-8 checkpoint at eval_n 16.

Rows: power, multiplication share, error statistics and cost axes equal
the reference's exactly; accuracies agree within 2/eval_n (two images:
the quantized network's last-bit noise, see tests/test_torch_resnet.py).
Batched and sequential sweeps of the port agree exactly.  Selection:
``select_multiplier`` / ``explore(..., quality_bound)`` pick the same
point from identical rows."""
import jax
import numpy as np
import pytest

from repro.approx import dse as ref_dse
from repro.approx import resilience as ref_res
from repro.approx.layers import spec_of as ref_spec_of
from repro.approx.workload import classification as ref_classification
from repro.core.library import build_default_library as ref_build
from repro.models import resnet as ref_resnet
from repro.train.checkpoint import CheckpointManager
from repro_torch.approx import dse as port_dse
from repro_torch.approx import resilience as port_res
from repro_torch.approx.layers import spec_of as port_spec_of
from repro_torch.approx.workload import classification
from repro_torch.core.library import build_default_library as port_build
from repro_torch.models import resnet, weights
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


EVAL_N, BATCH = 16, 8
MULTS = ["mul8u_bam_h0_v4", "mul8u_bam_h3_v7", "mul8u_bam_h0_v8"]
LAYERS = ("s1_b0_conv1", "s2_b0_proj")


@pytest.fixture(scope="module")
def env():
    cfg = resnet.resnet_config(8)
    # restore needs only the param tree's structure and shapes
    template = jax.tree.map(np.zeros_like,
                            weights.load_resnet8_checkpoint())
    (params, _), _ = CheckpointManager(
        str(weights.RESNET8_CKPT.parent), keep=1).restore(
            (template, template))
    ref_wl = ref_classification(cfg, params, eval_n=EVAL_N, batch=BATCH)
    port_wl = classification(cfg, weights.load_resnet8(), eval_n=EVAL_N,
                             batch=BATCH, device="cpu")
    return cfg, ref_build("tiny"), port_build("tiny"), ref_wl, port_wl


def _same_rows(port_rows, ref_rows):
    assert len(port_rows) == len(ref_rows)
    for p, r in zip(port_rows, ref_rows):
        assert (p.multiplier, p.layer) == (r.multiplier, r.layer)
        assert p.network_rel_power == r.network_rel_power
        assert p.multiplier_rel_power == r.multiplier_rel_power
        assert p.mult_share == r.mult_share
        assert p.errors == r.errors
        assert p.costs == r.costs
        assert p.spec.to_dict() == {**r.spec.to_dict(),
                                    "variant": p.spec.variant}
        assert abs(p.accuracy - r.accuracy) <= 2 / EVAL_N


def test_all_layers_sweep(env):
    cfg, ref_lib, port_lib, ref_wl, port_wl = env
    counts = resnet.layer_mult_counts(cfg)
    want = ref_res.all_layers_sweep(ref_wl, counts, MULTS, ref_lib,
                                    batch=True)
    seq = port_res.all_layers_sweep(port_wl, counts, MULTS, port_lib,
                                    variant="pallas")
    bat = port_res.all_layers_sweep(port_wl, counts, MULTS, port_lib,
                                    variant="pallas", batch=True)
    assert [r.accuracy for r in seq] == [r.accuracy for r in bat]
    _same_rows(bat, want)
    assert {r.spec.variant for r in bat} == {"pallas"}


def test_per_layer_sweep(env):
    cfg, ref_lib, port_lib, ref_wl, port_wl = env
    full = resnet.layer_mult_counts(cfg)
    counts = {l: full[l] for l in LAYERS}
    want = ref_res.per_layer_sweep(ref_wl, counts, MULTS, ref_lib,
                                   batch=True)
    seq = port_res.per_layer_sweep(port_wl, counts, MULTS, port_lib,
                                   variant="pallas")
    bat = port_res.per_layer_sweep(port_wl, counts, MULTS, port_lib,
                                   variant="pallas", batch=True)
    assert [r.accuracy for r in seq] == [r.accuracy for r in bat]
    _same_rows(bat, want)
    comp_p = port_res.LayerComponents.from_rows(bat, counts, 1.0)
    comp_r = ref_res.LayerComponents.from_rows(want, counts, 1.0)
    assert (comp_p.layers, comp_p.multipliers) == (comp_r.layers,
                                                   comp_r.multipliers)
    np.testing.assert_array_equal(comp_p.rel_power, comp_r.rel_power)
    np.testing.assert_allclose(comp_p.quality, comp_r.quality, rtol=0,
                               atol=2 / EVAL_N)


def test_batch_requires_bankable_eval(env):
    cfg, _, port_lib, _, port_wl = env
    counts = resnet.layer_mult_counts(cfg)
    with pytest.raises(ValueError, match="bank-traceable"):
        port_res.all_layers_sweep(lambda policy: 1.0, counts, MULTS,
                                  port_lib, batch=True)
    assert port_res.can_bank(port_wl, "lut", "pallas")
    assert not port_res.can_bank(port_wl, "int8")
    assert port_res.can_bank(port_wl, "lut", "fused")
    assert not port_res.can_bank(port_wl, "lowrank", "pallas")


def _fake_accuracy(spec_of, library):
    """A deterministic accuracy per policy, from the swept multiplier's
    error statistics: identical rows in both packages."""
    def fn(policy):
        for _, be in policy.overrides:
            name = spec_of(be).multiplier
            return 1.0 - library.entry(name).errors.mae / 20000.0
        spec = spec_of(policy.default)
        if spec.mode == "int8":
            return 1.0
        return 1.0 - library.entry(spec.multiplier).errors.mae / 2000.0
    return fn


@pytest.mark.parametrize("bound", [0.0, 0.01, 0.05, 0.3])
def test_explore_selects_the_same_point(bound, env):
    cfg, ref_lib, port_lib, *_ = env
    counts = resnet.layer_mult_counts(cfg)
    names = [e.name for e in port_lib.case_study_selection()]
    want = ref_dse.explore(_fake_accuracy(ref_spec_of, ref_lib), counts,
                           ref_lib, multipliers=names, quality_bound=bound,
                           batch=True)
    got = port_dse.explore(_fake_accuracy(port_spec_of, port_lib), counts,
                           port_lib, multipliers=names,
                           quality_bound=bound, batch=True)
    assert got.to_json_dict() == want.to_json_dict()
    assert (got.selected is None) == (want.selected is None)
    if got.selected is not None:
        assert got.selected.multiplier == want.selected.multiplier
    blob = want.to_json_dict()
    restored = port_dse.ExploreResult.from_json_dict(blob)
    for drop in (0.0, 0.02, 0.2):
        a = port_dse.select_multiplier(restored, drop)
        b = ref_dse.select_multiplier(want, drop)
        assert (a is None and b is None) or a.multiplier == b.multiplier
    pa = [p.multiplier for p in port_dse.pareto_points(restored.all_layers)]
    pb = [p.multiplier for p in ref_dse.pareto_points(want.all_layers)]
    assert pa == pb


def test_explore_batched_equals_sequential_and_seeds_cache(env):
    cfg, _, port_lib, _, port_wl = env
    cache = {}
    bat = port_dse.explore(workload=port_wl, library=port_lib,
                           multipliers=MULTS[:2], variant="pallas",
                           batch=True, per_layer=False, cache=cache,
                           quality_bound=0.5)
    seq = port_dse.explore(workload=port_wl, library=port_lib,
                           multipliers=MULTS[:2], variant="pallas",
                           per_layer=False, cache={}, quality_bound=0.5)
    assert bat.to_json_dict() == seq.to_json_dict()
    assert len(cache) == 3          # golden baseline + one per multiplier
    assert bat.selected is not None
    # a sequential re-run over the seeded cache evaluates nothing new
    calls = []
    again = port_dse.explore(lambda p: calls.append(p) or 0.0,
                             resnet.layer_mult_counts(cfg), port_lib,
                             multipliers=MULTS[:2], variant="pallas",
                             per_layer=False, cache=cache)
    assert calls == []
    assert [p.accuracy for p in again.all_layers] == [
        p.accuracy for p in bat.all_layers]
