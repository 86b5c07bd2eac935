"""The heterogeneous DSE of the port on the committed ResNet-8 checkpoint
(eval_n 16, batch 8) under ``variant="pallas"`` (the kernels' plain
versions on the CPU), against the JAX reference.

The port's batched verification (one ``policy_bank_eval`` pass, one
banked call a layer and batch) equals its sequential one exactly, and
under ``fused`` too; its verified accuracies match the reference's
verification of the same assignments within 2/eval_n (two images: the
quantized network's last-bit noise, as in tests/test_torch_resilience.py),
with powers, costs and assignments equal."""
import jax
import numpy as np
import pytest

from repro.approx import dse as ref_dse
from repro.approx.workload import classification as ref_classification
from repro.core.library import build_default_library as ref_build
from repro.train.checkpoint import CheckpointManager
from repro_torch.approx import dse as port_dse
from repro_torch.approx.workload import classification
from repro_torch.core.library import build_default_library as port_build
from repro_torch.models import resnet, weights
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EVAL_N, BATCH = 16, 8
MULTS = ["mul8u_bam_h3_v7", "mul8u_trunc5", "mul8u_trunc4"]
QUALITY_BOUND = 0.1
TOP_K = 4


def _extras(layers):
    """The uniform ``mul8u_bam_h3_v7`` point and two downgrades of it, as
    ``launch.heterogeneous_pareto`` adds them: the beam's own shortlist
    here (its additive model) is cheap but compounds past the bound."""
    base = {l: MULTS[0] for l in layers}
    return [base, {**base, "s2_b0_conv2": MULTS[1]},
            {**base, "s1_b0_conv2": MULTS[2], "s2_b0_conv1": MULTS[1]}]


@pytest.fixture(scope="module")
def env():
    cfg = resnet.resnet_config(8)
    template = jax.tree.map(np.zeros_like,
                            weights.load_resnet8_checkpoint())
    (params, _), _ = CheckpointManager(
        str(weights.RESNET8_CKPT.parent), keep=1).restore(
            (template, template))
    ref_wl = ref_classification(cfg, params, eval_n=EVAL_N, batch=BATCH)
    port_wl = classification(cfg, weights.load_resnet8(), eval_n=EVAL_N,
                             batch=BATCH, device="cpu")
    port_lib = port_build("tiny")
    result = port_dse.explore_heterogeneous(
        port_wl, port_wl.layer_counts, port_lib, multipliers=MULTS,
        variant="pallas", quality_bound=QUALITY_BOUND, top_k=TOP_K,
        extra_assignments=_extras(port_wl.layer_counts))
    return ref_build("tiny"), port_lib, ref_wl, port_wl, result


def _assignments(result):
    return [dict(p.assignment) for p in result.heterogeneous]


def test_explore_heterogeneous_resnet(env):
    _, _, _, port_wl, result = env
    assert len(result.per_layer) == len(MULTS) * len(port_wl.layer_counts)
    assert len(result.heterogeneous) == TOP_K + 3
    pick = result.selected
    assert pick is not None and pick.layer == "hetero"
    assert pick.accuracy >= result.baseline_accuracy - QUALITY_BOUND
    uniform = next(p for p in result.heterogeneous
                   if p.multiplier == MULTS[0])
    assert pick.network_rel_power <= uniform.network_rel_power
    for p in result.heterogeneous:
        assert p.variant == "pallas" and p.layer == "hetero"
        assert set(dict(p.assignment)) == set(port_wl.layer_counts)


@pytest.mark.parametrize("variant", ["pallas", "fused"])
def test_batched_verification_equals_sequential(variant, env):
    _, port_lib, _, port_wl, result = env
    counts = port_wl.layer_counts
    bat = port_dse.verify_assignments(port_wl, _assignments(result), counts,
                                      port_lib, variant=variant)
    seq = port_dse.verify_assignments(port_wl, _assignments(result), counts,
                                      port_lib, variant=variant,
                                      batch=False)
    assert [p.to_dict() for p in bat] == [p.to_dict() for p in seq]
    # every variant computes the same bits: the explore's own verified
    # accuracies (pallas, batched) equal these
    assert [p.accuracy for p in bat] == [p.accuracy for p in
                                         result.heterogeneous]


def test_verified_accuracies_match_reference(env):
    ref_lib, _, ref_wl, port_wl, result = env
    want = ref_dse.verify_assignments(ref_wl, _assignments(result),
                                      port_wl.layer_counts, ref_lib,
                                      batch=True)
    got = result.heterogeneous
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.assignment == w.assignment
        assert g.network_rel_power == w.network_rel_power
        assert g.costs == w.costs
        assert abs(g.accuracy - w.accuracy) <= 2 / EVAL_N
