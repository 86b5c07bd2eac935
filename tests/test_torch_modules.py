"""The module axis of the port (``approx.modules``, the LM half of
``approx.workload.layer_mult_counts``) against the reference, and the
banked module sweep of the port against its own sequential evaluation.

What is held:
  * ``module_of`` gives the reference's family for every tag of the
    reference's test, and rejects the same unknown tag;
  * ``layer_mult_counts`` equals the reference's exactly for seven LM
    archs (reduced, batch 2, seq 8), at full size and with
    ``capacity_factor=1.0`` / block-local dispatch, for the vlm, encdec
    and MLA variants of a dense config, and for ResNet-8 (the MLA,
    encdec and vlm archs themselves: ``tests/test_torch_mla.py``,
    ``test_torch_encdec.py``, ``test_torch_vlm.py``);
  * ``ModuleMap.for_config(validate=True)`` (a prefill on the ``meta``
    device) gives the reference's map; its lowering, its errors and
    ``module_policy_bank``'s fill equal the reference's;
  * the banked module sweep (``verify_assignments`` over the full tag
    axis with the exact-LUT fill) equals the sequential
    ``policy_for_lane`` evaluations bit for bit on reduced qwen3-moe
    and mamba2, under ``pallas`` and ``fused`` (the kernels' plain
    versions on the CPU), with the banked calls
    ``launch.arch_profiles.banked_calls_per_forward`` counts (one a
    projection, ``moe.*`` one for all its experts), and a 2-row sweep
    makes as many;
  * that count equals the banked calls of one banked pass on each of
    the eight archs of ``arch_profiles``' full mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.approx import modules as ref_modules
from repro.approx.modules import ModuleMap as RefModuleMap
from repro.approx.workload import layer_mult_counts as ref_counts
from repro.configs import get_config as ref_get_config
from repro.core.families import truncated_multiplier as ref_trunc
from repro.core.library import ApproxLibrary as RefLibrary
from repro.core.seeds import array_multiplier as ref_array
from repro.models import resnet as ref_resnet
from repro_torch.approx.dse import verify_assignments
from repro_torch.approx.layers import ApproxPolicy
from repro_torch.approx.modules import (EXACT_FAMILIES, FILL_EXACT,
                                        MODULE_FAMILIES, ModuleMap,
                                        module_of, module_policy_bank,
                                        module_sweep_assignments)
from repro_torch.approx.specs import BackendSpec
from repro_torch.approx.workload import layer_mult_counts
from repro_torch.configs import get_config
from repro_torch.core.families import truncated_multiplier
from repro_torch.core.library import ApproxLibrary
from repro_torch.core.seeds import array_multiplier
from repro_torch.launch.arch_profiles import (FULL_EXTRA_ARCHS, QUICK_ARCHS,
                                              banked_calls_per_forward,
                                              counting_banked_calls,
                                              _lm_workload)
from repro_torch.models import resnet
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MULTS = ["mul8u_exact", "mul8u_trunc6", "mul8u_trunc3"]
ZOO = ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "mamba2-780m",
       "jamba-v0.1-52b", "qwen3-14b", "yi-34b", "nemotron-4-15b")
#: every tag ``tests/test_modules.py`` classifies
TAGS = ("attn.wq", "enc.attn.wk", "dec.attn.wo", "mla.wdq", "mla.wuk",
        "mla.wkr", "mla.wuv", "mla.wo", "ffn.wi", "ffn.wg",
        "moe.shared.wo", "moe.wi", "moe.wg", "mamba.in_proj",
        "mamba.out_proj", "xattn.wq", "img_proj", "conv_init",
        "s1_b0_proj", "s0_b1_conv2", "head", "mla.wdkv", "ffn.wo",
        "moe.shared.wi", "xattn.wv")


def _lib(lib_cls, arr, trunc):
    lib = lib_cls()
    exact = arr(8)
    lib.add_netlist(exact, "multiplier", 8, "exact", exact,
                    name="mul8u_exact")
    for k in (2, 5):
        lib.add_netlist(trunc(8, k), "multiplier", 8, "truncation", exact)
    return lib


@pytest.fixture(scope="module")
def lib():
    return _lib(ApproxLibrary, array_multiplier, truncated_multiplier)


@pytest.fixture(scope="module")
def ref_lib():
    return _lib(RefLibrary, ref_array, ref_trunc)


def test_module_of_matches_reference():
    for tag in TAGS:
        assert module_of(tag) == ref_modules.module_of(tag), tag
        assert module_of(tag) in MODULE_FAMILIES
        assert module_of(tag) not in EXACT_FAMILIES
    assert MODULE_FAMILIES == ref_modules.MODULE_FAMILIES
    assert EXACT_FAMILIES == ref_modules.EXACT_FAMILIES
    with pytest.raises(ValueError, match="unknown layer tag"):
        module_of("mystery.w")


@pytest.mark.parametrize("arch", ZOO)
def test_layer_mult_counts_match_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    for r, p in ((ref_cfg.reduced(), cfg.reduced()), (ref_cfg, cfg)):
        got = layer_mult_counts(p, batch=2, seq_len=8)
        assert got == ref_counts(r, batch=2, seq_len=8)
        assert list(got) == list(ref_counts(r, batch=2, seq_len=8))
    if cfg.n_experts:       # dropping capacity, block-local dispatch
        for kw in ({"capacity_factor": 1.0}, {"moe_blocks": 4}):
            assert layer_mult_counts(dataclasses.replace(cfg, **kw), 2, 8) \
                == ref_counts(dataclasses.replace(ref_cfg, **kw), 2, 8)


def test_resnet_counts_and_unported_families():
    """ResNet-8, and the vlm, encdec and MLA families on a dense config
    (once unported, now counted as the reference counts them)."""
    assert layer_mult_counts(resnet.resnet_config(8), batch=32) \
        == ref_counts(ref_resnet.resnet_config(8), batch=32)
    cfg = get_config("qwen1.5-0.5b").reduced()
    ref_cfg = ref_get_config("qwen1.5-0.5b").reduced()
    for kw in ({"family": "vlm", "n_img_tokens": 3},
               {"family": "encdec", "n_enc_layers": 2, "enc_frames": 5},
               {"use_mla": True, "kv_lora": 32, "q_lora": 16}):
        got = layer_mult_counts(dataclasses.replace(cfg, **kw), 2, 8)
        assert got == ref_counts(dataclasses.replace(ref_cfg, **kw), 2, 8)
        assert got


#: the full-mode zoo of ``launch.arch_profiles``
FULL_ZOO = [a for a, _f in QUICK_ARCHS + FULL_EXTRA_ARCHS]


@pytest.mark.parametrize("arch", FULL_ZOO)
def test_banked_calls_formula_matches_counted_calls(arch, lib):
    """``banked_calls_per_forward`` equals the banked datapath calls of
    one banked pass (one row, every call site banked) on each arch of
    the full-mode zoo."""
    cfg = get_config(arch).reduced()
    wl, mmap = _lm_workload(cfg, device="cpu")
    row = mmap.lower({mmap.modules[0]: "mul8u_trunc6"})
    with counting_banked_calls() as calls:
        verify_assignments(wl, [row], mmap.layer_counts, lib,
                           layers=mmap.layers, fill=FILL_EXACT,
                           variant="pallas")
    assert calls["approx_matmul_lut_bank"] == sum(calls.values()) \
        == banked_calls_per_forward(cfg) > 0


@pytest.fixture(scope="module")
def moe_maps():
    ref_cfg = ref_get_config("qwen3-moe-30b-a3b").reduced()
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    return (RefModuleMap.for_config(ref_cfg, batch=2, seq_len=8),
            ModuleMap.for_config(cfg, batch=2, seq_len=8))


@pytest.mark.parametrize("arch", ZOO[1:4])
def test_module_map_for_config_matches_reference(arch):
    ref_map = RefModuleMap.for_config(ref_get_config(arch).reduced(),
                                      batch=2, seq_len=8, validate=False)
    mmap = ModuleMap.for_config(get_config(arch).reduced(), batch=2,
                                seq_len=8, validate=True)
    assert mmap.layers == ref_map.layers
    assert dict(mmap.layer_module) == dict(ref_map.layer_module)
    assert dict(mmap.layer_counts) == dict(ref_map.layer_counts)
    assert mmap.modules == ref_map.modules
    assert mmap.module_counts() == ref_map.module_counts()
    assert mmap.module_shares() == ref_map.module_shares()


def test_module_map_validation_catches_drift():
    cfg = get_config("mamba2-780m").reduced()
    bad = ModuleMap.for_config(cfg, batch=2, seq_len=8)
    assert bad.layers == ("mamba.in_proj", "mamba.out_proj")
    from repro_torch.approx import workload
    orig = workload.layer_mult_counts
    try:
        workload.layer_mult_counts = lambda c, **kw: {
            **orig(c, **kw), "ffn.wi": 1}
        with pytest.raises(AssertionError, match="MAC accounting drift"):
            ModuleMap.for_config(cfg, batch=2, seq_len=8)
    finally:
        workload.layer_mult_counts = orig


def test_lowering_errors_and_fill_match_reference(moe_maps, lib, ref_lib):
    ref_map, mmap = moe_maps
    a = {"moe.expert": "mul8u_trunc3", "attention.q": "mul8u_trunc6"}
    assert mmap.lower(a) == ref_map.lower(a)
    assert mmap.lower(a)["moe.wo"] == "mul8u_trunc3"
    assert "attn.wk" not in mmap.lower(a)
    for bad, msg in (({"moe.router": "mul8u_trunc3"}, "exact by design"),
                     ({"conv": "mul8u_trunc3"}, "no call sites")):
        with pytest.raises(ValueError, match=msg):
            mmap.lower(bad)
        with pytest.raises(ValueError, match=msg):
            ref_map.lower(bad)
    rows = [{"moe.expert": "mul8u_trunc3"}, {"attention.v": "mul8u_trunc6"}]
    pbank, lowered = module_policy_bank(mmap, rows, lib)
    ref_pbank, ref_lowered = ref_modules.module_policy_bank(ref_map, rows,
                                                            ref_lib)
    assert lowered == ref_lowered
    assert pbank.layers == ref_pbank.layers == mmap.layers
    assert pbank.bank.names == ref_pbank.bank.names
    np.testing.assert_array_equal(pbank.assign, ref_pbank.assign)
    for l in set(mmap.layers) - set(mmap.module_layers("moe.expert")):
        assert pbank.assignment(0)[l] == FILL_EXACT
    grid = module_sweep_assignments(mmap, MULTS)
    assert grid == ref_modules.module_sweep_assignments(ref_map, MULTS)


def test_fill_lane_matches_golden_base(lib):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    golden = ApproxPolicy(default=BackendSpec.golden().materialize())
    filled = golden.with_override("m", BackendSpec(
        mode="lut", multiplier=FILL_EXACT).materialize(lib))
    assert torch.equal(golden.matmul("m", x, w), filled.matmul("m", x, w))


@pytest.mark.parametrize("variant", ["pallas", "fused"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-780m"])
def test_banked_module_sweep_bit_identity_and_calls(arch, variant, lib):
    cfg = get_config(arch).reduced()
    wl, mmap = _lm_workload(cfg, device="cpu")
    grid = module_sweep_assignments(mmap, MULTS[1:])
    lowered = [mmap.lower(a) for _f, _m, a in grid]
    kw = dict(layers=mmap.layers, fill=FILL_EXACT, variant=variant)
    with counting_banked_calls() as full:
        banked = verify_assignments(wl, lowered, mmap.layer_counts, lib,
                                    **kw)
    sequential = verify_assignments(wl, lowered, mmap.layer_counts, lib,
                                    batch=False, **kw)
    assert len(banked) == len(lowered) == 2 * len(mmap.modules)
    for b, s in zip(banked, sequential):
        assert b.metrics == s.metrics
        assert b.network_rel_power == s.network_rel_power
    # the explicit per-layer rows give the same lanes
    explicit = [{l: a.get(l, FILL_EXACT) for l in mmap.layers}
                for a in lowered]
    per_layer = verify_assignments(wl, explicit, mmap.layer_counts, lib,
                                   variant=variant)
    assert [p.metrics for p in per_layer] == [b.metrics for b in banked]
    with counting_banked_calls() as half:
        verify_assignments(wl, lowered[:2], mmap.layer_counts, lib, **kw)
    name = {"pallas": "approx_matmul_lut_bank",
            "fused": "fused_matmul_lut_bank"}[variant]
    expected = {"qwen3-moe-30b-a3b": 2 * (4 + 3),
                "mamba2-780m": 2 * 2}[arch]
    assert banked_calls_per_forward(cfg) == expected
    assert full[name] == half[name] == expected
    assert sum(full.values()) == sum(half.values()) == expected
