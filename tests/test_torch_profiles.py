"""``approx.profiles`` and ``launch.arch_profiles`` of the port against
the reference.

What is held:
  * ``profile_architecture`` on reduced qwen3-moe (the reference's
    parameters carried across, one batch of 2 x 8 tokens, the
    reference's test library, ``MAX_DROP`` so that the selection mixes
    multipliers): modules, module shares, the (module, multiplier) rows,
    the tolerance ranking and the selected per-module and per-layer
    assignment equal the reference's; every quality, drop and the
    baseline within ``MAE_RTOL`` (the f32 logits reduce in other
    orders); powers equal;
  * the same on reduced whisper-large-v3 (the encoder-decoder, whose
    cross-attention is the one family no other arch has; a bound of
    0.1, inside which its selection mixes multipliers), the qualities
    within ``ENCDEC_MAE_RTOL``;
  * the ``ArchProfile`` JSON round trip and ``profile_zoo``'s record;
  * a bound no multiplier meets falls back to the all-exact uniform;
  * ``launch.arch_profiles`` keeps the reference benchmark's zoo, bound
    and gates' constants, and one ``main`` run on a single arch writes
    its record only where ``--out`` says, also when its coverage gate
    fails.
"""
import json

import jax
import numpy as np
import pytest

import benchmarks.arch_profiles as ref_bench
from repro.approx.modules import ModuleMap as RefModuleMap
from repro.approx.profiles import \
    profile_architecture as ref_profile_architecture
from repro.approx.workload import lm_fidelity as ref_lm_fidelity
from repro.configs import get_config as ref_get_config
from repro.core.families import truncated_multiplier as ref_trunc
from repro.core.library import ApproxLibrary as RefLibrary
from repro.core.seeds import array_multiplier as ref_array
from repro.models.registry import model_fns as ref_model_fns
from repro_torch.approx.modules import ModuleMap
from repro_torch.approx.profiles import (ArchProfile, ModuleRow,
                                         profile_architecture, profile_zoo)
from repro_torch.approx.workload import lm_fidelity
from repro_torch.configs import get_config
from repro_torch.core.families import truncated_multiplier
from repro_torch.core.library import ApproxLibrary
from repro_torch.core.seeds import array_multiplier
from repro_torch.launch import GateError, arch_profiles
from repro_torch.models.weights import lm_params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MULTS = ["mul8u_exact", "mul8u_trunc6", "mul8u_trunc3"]
ARCH = "qwen3-moe-30b-a3b"
#: a bound inside which some single-module rows drop and others do not
MAX_DROP = 0.1
#: logit MAE between the packages, relative (f32 reference logits and
#: the approximate ones from two summation orders; measured 1.7e-7)
MAE_RTOL = 1e-4
#: the same for reduced whisper, whose logits pass through an encoder,
#: the cross-KV and a decoder of re-calibrated int8 projections: 19 of
#: its 21 rows agree within 3e-8, and on two a last-bit float difference
#: moves an int8 code and the logit MAE by 7.4e-5 and 1.1e-4 (5e-4 of
#: the largest quality, 0.219)
ENCDEC_MAE_RTOL = 1e-3


def _lib(lib_cls, arr, trunc):
    lib = lib_cls()
    exact = arr(8)
    lib.add_netlist(exact, "multiplier", 8, "exact", exact,
                    name="mul8u_exact")
    for k in (2, 5):
        lib.add_netlist(trunc(8, k), "multiplier", 8, "truncation", exact)
    return lib


@pytest.fixture(scope="module")
def profiles():
    ref_cfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    ref_params = ref_model_fns(ref_cfg).init_params(jax.random.PRNGKey(0),
                                                    ref_cfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, ref_params))
    ref_wl = ref_lm_fidelity(ref_cfg, ref_params, batch=2, seq_len=8,
                             n_batches=1)
    wl = lm_fidelity(cfg, params, batch=2, seq_len=8, n_batches=1,
                     device="cpu")
    ref_map = RefModuleMap.for_config(ref_cfg, batch=2, seq_len=8)
    mmap = ModuleMap.for_config(cfg, batch=2, seq_len=8)
    lib = _lib(ApproxLibrary, array_multiplier, truncated_multiplier)
    ref = ref_profile_architecture(
        ref_wl, ref_map, _lib(RefLibrary, ref_array, ref_trunc), MULTS,
        arch=ARCH, model_family="moe", max_drop=MAX_DROP)
    walls = {}
    port = profile_architecture(wl, mmap, lib, MULTS, arch=ARCH,
                                model_family="moe", max_drop=MAX_DROP,
                                variant="pallas", stage_walls=walls)
    return ref, port, (wl, mmap, lib, walls)


def test_profile_matches_reference(profiles):
    ref, port, (_wl, _mmap, _lib_, walls) = profiles
    assert set(walls) == {"baseline_s", "sweep_s", "compose_s",
                          "verify_s"}
    assert port.modules == ref.modules
    assert port.module_shares == ref.module_shares
    assert (port.primary, port.direction) == (ref.primary, ref.direction)
    assert [(r.module, r.multiplier) for r in port.rows] == \
        [(r.module, r.multiplier) for r in ref.rows]
    scale = max(r.quality for r in ref.rows)
    for got, want in zip(port.rows, ref.rows):
        assert got.network_rel_power == want.network_rel_power
        assert got.multiplier_rel_power == want.multiplier_rel_power
        assert got.mult_share == want.mult_share
        assert abs(got.quality - want.quality) <= MAE_RTOL * scale
        assert abs(got.quality_drop - want.quality_drop) <= MAE_RTOL * scale
        assert got.metrics["top1_agreement"] == \
            want.metrics["top1_agreement"]
    base, ref_base = port.baseline_metrics, ref.baseline_metrics
    assert abs(base["logit_mae"] - ref_base["logit_mae"]) <= MAE_RTOL * scale
    assert port.ranking == ref.ranking
    assert port.selected is not None
    assert port.selected["modules"] == ref.selected["modules"]
    assert port.selected["layers"] == ref.selected["layers"]
    assert port.selected["power"] == ref.selected["power"]
    assert len(set(port.selected["modules"].values())) > 1
    assert port.selected["quality_drop"] <= MAX_DROP


def _held(port, ref, rtol):
    """``port`` equals the reference's ``ref`` profile: modules, shares,
    rows, ranking and selection; qualities within ``rtol`` of the
    largest."""
    assert port.modules == ref.modules
    assert port.module_shares == ref.module_shares
    assert [(r.module, r.multiplier) for r in port.rows] == \
        [(r.module, r.multiplier) for r in ref.rows]
    scale = max(r.quality for r in ref.rows)
    for got, want in zip(port.rows, ref.rows):
        assert got.network_rel_power == want.network_rel_power
        assert abs(got.quality - want.quality) <= rtol * scale
        assert abs(got.quality_drop - want.quality_drop) <= rtol * scale
    assert port.ranking == ref.ranking
    assert port.selected["modules"] == ref.selected["modules"]
    assert port.selected["layers"] == ref.selected["layers"]
    assert port.selected["power"] == ref.selected["power"]


def test_whisper_profile_matches_reference():
    arch, max_drop = "whisper-large-v3", 0.1
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    ref_params = ref_model_fns(ref_cfg).init_params(jax.random.PRNGKey(0),
                                                    ref_cfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, ref_params))
    kw = dict(batch=2, seq_len=8, n_batches=1)
    ref = ref_profile_architecture(
        ref_lm_fidelity(ref_cfg, ref_params, **kw),
        RefModuleMap.for_config(ref_cfg, batch=2, seq_len=8),
        _lib(RefLibrary, ref_array, ref_trunc), MULTS, arch=arch,
        model_family="encdec", max_drop=max_drop)
    port = profile_architecture(
        lm_fidelity(cfg, params, device="cpu", **kw),
        ModuleMap.for_config(cfg, batch=2, seq_len=8),
        _lib(ApproxLibrary, array_multiplier, truncated_multiplier), MULTS,
        arch=arch, model_family="encdec", max_drop=max_drop,
        variant="fused")
    assert "cross_attention" in port.modules
    _held(port, ref, ENCDEC_MAE_RTOL)
    assert len(set(port.selected["modules"].values())) > 1
    assert port.selected["quality_drop"] <= max_drop


def test_profile_round_trips_through_json(profiles):
    _ref, prof, _ = profiles
    zoo = profile_zoo({ARCH: prof})
    blob = json.loads(json.dumps(zoo))
    back = ArchProfile.from_dict(blob["archs"][ARCH])
    assert back.ranking == prof.ranking
    assert back.modules == prof.modules
    assert back.selected == prof.selected
    assert [r.to_dict() for r in back.rows] == \
        [r.to_dict() for r in prof.rows]
    assert all(isinstance(r, ModuleRow) for r in back.rows)
    assert set(blob["family_mean_drop"]) == set(prof.modules)


def test_infeasible_bound_falls_back_to_exact(profiles):
    _ref, _port, (wl, mmap, lib, _walls) = profiles
    prof = profile_architecture(wl, mmap, lib, MULTS, max_drop=0.0,
                                variant="fused")
    assert prof.selected is not None
    assert set(prof.selected["modules"].values()) == {"mul8u_exact"}
    assert prof.selected["power"] == 1.0


def test_launcher_keeps_the_reference_benchmark():
    assert arch_profiles.QUICK_ARCHS == ref_bench.QUICK_ARCHS
    assert arch_profiles.FULL_EXTRA_ARCHS == ref_bench.FULL_EXTRA_ARCHS
    assert arch_profiles.IDENTITY_ARCHS == ref_bench.IDENTITY_ARCHS
    assert arch_profiles.MAX_DROP == ref_bench.MAX_DROP
    assert arch_profiles.MIN_ARCHS_GATE == ref_bench.MIN_ARCHS_GATE
    assert arch_profiles._multipliers(None, True) == \
        ref_bench._multipliers(None, True)


def test_launcher_writes_only_to_out(tmp_path, monkeypatch):
    """One arch: the coverage gate fails, after ``--out`` is written."""
    bench = ref_bench.BENCH_PATH
    before = open(bench).read()
    out = tmp_path / "profiles.json"
    monkeypatch.setattr(arch_profiles, "QUICK_ARCHS",
                        [("mamba2-780m", "ssm")])
    with pytest.raises(GateError) as err:
        arch_profiles.main(["--device", "cpu", "--quick", "--out",
                            str(out)])
    assert err.value.gate == "coverage"
    record = json.loads(out.read_text())
    assert record == json.loads(json.dumps(err.value.record))
    assert list(record["zoo"]["archs"]) == ["mamba2-780m"]
    assert record["gates"] == {"coverage": False, "selection": True,
                               "bit_identity": True,
                               "single_program": True}
    ident = record["identity_checks"]["mamba2-780m"]
    assert ident["bit_identical"] and ident["rows"] == 4
    assert ident["banked_calls_full"] == ident["banked_calls_truncated"] \
        == ident["banked_calls_expected"] == 4
    assert record["multipliers"] == MULTS
    assert record["device"] == "cpu" and "not_ported" not in record
    assert list(record["zoo"]["archs"]) == [
        a for a, _f in arch_profiles.QUICK_ARCHS]
    assert open(bench).read() == before
