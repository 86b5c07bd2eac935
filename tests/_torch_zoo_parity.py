"""Checks shared by the parity tests of the LM zoo's MLA, encoder-decoder
and VLM families (``tests/test_torch_mla.py``, ``test_torch_encdec.py``,
``test_torch_vlm.py``): the reference and the port at ``reduced()``
size on the same parameters (the reference's, norm gains randomised so
that they matter, carried across with ``lm_params_from_numpy``) and the
same inputs from numpy generators.

Tolerances: ``F32_RTOL`` of the largest |logit| under ``f32`` (float
sums in other orders), ``QUANT_RTOL`` under the quantized policies
(every projection re-calibrates on its input, so a last-bit difference
can move a code; ``tests/test_torch_lm.py`` states why 2.5%).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.approx.modules import ModuleMap as RefModuleMap
from repro.approx.specs import BackendSpec as RefSpec
from repro.approx.workload import layer_mult_counts as ref_counts
from repro.configs import get_config as ref_get_config
from repro.core.families import truncated_multiplier as ref_trunc
from repro.core.library import ApproxLibrary as RefLibrary
from repro.core.seeds import array_multiplier as ref_array
from repro.models.registry import model_fns as ref_model_fns
from repro.models.registry import probe_layer_tags as ref_probe
from repro_torch.approx.dse import verify_assignments
from repro_torch.approx.layers import ApproxPolicy
from repro_torch.approx.modules import (FILL_EXACT, ModuleMap,
                                        module_sweep_assignments)
from repro_torch.approx.specs import BackendSpec
from repro_torch.approx.workload import layer_mult_counts
from repro_torch.configs import get_config
from repro_torch.core.families import truncated_multiplier
from repro_torch.core.library import ApproxLibrary
from repro_torch.core.seeds import array_multiplier
from repro_torch.launch.arch_profiles import (BANKED, _lm_workload,
                                              banked_calls_per_forward,
                                              counting_banked_calls)
from repro_torch.models.registry import (abstract_params, input_extras,
                                         model_fns, probe_layer_tags,
                                         prompt_extra_len)
from repro_torch.models.weights import lm_params_from_numpy

F32_RTOL = 1e-5
QUANT_RTOL = 0.025
MULTS = ["mul8u_exact", "mul8u_trunc6", "mul8u_trunc3"]
B, S = 2, 8


def cfgs(arch, **kw):
    """(reference, port) ``reduced(**kw)`` configs of ``arch``."""
    return (ref_get_config(arch).reduced(**kw),
            get_config(arch).reduced(**kw))


def ref_params(ref_cfg, seed=0):
    """The reference's parameters as numpy, every norm gain (``*norm*``,
    MLA's ``qn``/``kvn``) drawn from U(0.8, 1.2)."""
    params = jax.tree.map(np.asarray, ref_model_fns(ref_cfg).init_params(
        jax.random.PRNGKey(seed), ref_cfg))
    rng = np.random.default_rng(seed + 5)

    def walk(tree):
        for key, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub)
            elif "norm" in key or key in ("qn", "kvn"):
                tree[key] = rng.uniform(0.8, 1.2, sub.shape).astype(
                    np.float32)
    walk(params)
    return params


def policies(mode, libs=None, multiplier="mul8u_trunc3"):
    """(reference, port) policies of one mode for every call site;
    ``lut`` materialized on ``libs`` = (reference, port) libraries."""
    if mode != "lut":
        return (RefPolicy(default=RefSpec(mode=mode)),
                ApproxPolicy(default=BackendSpec(mode=mode)))
    return (RefPolicy(default=RefSpec(mode="lut", multiplier=multiplier)
                      .materialize(libs[0])),
            ApproxPolicy(default=BackendSpec(mode="lut",
                                             multiplier=multiplier)
                         .materialize(libs[1])))


def make_libs():
    """(reference, port) libraries: the exact 8-bit multiplier and two
    truncations, ``mul8u_trunc6`` and ``mul8u_trunc3``."""
    out = []
    for lib_cls, arr, trunc in ((RefLibrary, ref_array, ref_trunc),
                                (ApproxLibrary, array_multiplier,
                                 truncated_multiplier)):
        lib = lib_cls()
        exact = arr(8)
        lib.add_netlist(exact, "multiplier", 8, "exact", exact,
                        name="mul8u_exact")
        for k in (2, 5):
            lib.add_netlist(trunc(8, k), "multiplier", 8, "truncation",
                            exact)
        out.append(lib)
    return out


def random_extras(cfg, rng) -> dict:
    """The family's non-token prefill inputs (``input_extras``' shapes)
    drawn from N(0, 1)."""
    return {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in input_extras(cfg, B).items()}


def check_prefill_decode(ref_cfg, cfg, modes=("f32", "int8"), n_decode=2,
                         seed=4) -> dict:
    """``forward_prefill`` (with the family's extras, random) then
    ``n_decode`` teacher-forced ``forward_decode`` steps of the port
    against the jitted reference, under each mode: ``F32_RTOL`` /
    ``QUANT_RTOL`` of the largest |logit|.  Returns the port's last
    cache of the first mode."""
    rp = ref_params(ref_cfg)
    pp = lm_params_from_numpy(rp)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab, (n_decode, B)).astype(np.int32)
    extras = random_extras(cfg, rng)
    max_len = S + prompt_extra_len(cfg, extras) + n_decode
    rf, pf = ref_model_fns(ref_cfg), model_fns(cfg)
    first = None
    for mode in modes:
        rpol, ppol = policies(mode)
        prefill = jax.jit(lambda p, b, c: rf.forward_prefill(
            p, b, c, ref_cfg, rpol))
        decode = jax.jit(lambda p, t, c: rf.forward_decode(
            p, t, c, ref_cfg, rpol))
        logits, rcache = prefill(
            rp, {"tokens": jnp.asarray(tokens),
                 **{k: jnp.asarray(v) for k, v in extras.items()}},
            rf.init_cache(ref_cfg, B, max_len))
        want = [logits]
        for t in feed:
            logits, rcache = decode(rp, jnp.asarray(t), rcache)
            want.append(logits)
        with torch.inference_mode():
            logits, cache = pf.forward_prefill(
                pp, {"tokens": torch.from_numpy(tokens),
                     **{k: torch.from_numpy(v) for k, v in extras.items()}},
                pf.init_cache(cfg, B, max_len), cfg, ppol)
            got = [logits]
            for t in feed:
                logits, cache = pf.forward_decode(pp, torch.from_numpy(t),
                                                  cache, cfg, ppol)
                got.append(logits)
        rtol = F32_RTOL if mode == "f32" else QUANT_RTOL
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            assert g.shape == w.shape and torch.isfinite(g).all()
            np.testing.assert_allclose(
                g.numpy(), w, rtol=0, atol=rtol * np.abs(w).max(),
                err_msg=f"{cfg.name} {mode} step {i}")
        first = cache if first is None else first
    return first


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


def check_trees_and_probe(arch):
    """The port's parameter tree equals the reference's key for key in
    shape and dtype (f32), and ``probe_layer_tags`` on the ``meta``
    device equals the reference's tags, in order."""
    ref_cfg, cfg = cfgs(arch)
    fns = ref_model_fns(ref_cfg)
    ref_p = jax.eval_shape(lambda k: fns.init_params(k, ref_cfg),
                           jax.random.PRNGKey(0))
    port = model_fns(cfg).init_params(torch.Generator().manual_seed(0),
                                      cfg)
    ref_leaves = {tuple(p.key for p in path): leaf for path, leaf in
                  jax.tree_util.tree_flatten_with_path(ref_p)[0]}
    port_leaves = dict(_leaves(port))
    assert set(port_leaves) == set(ref_leaves)
    for path, leaf in ref_leaves.items():
        assert tuple(port_leaves[path].shape) == leaf.shape, path
        assert port_leaves[path].dtype == torch.float32, path
    params = abstract_params(cfg)
    assert all(t.device.type == "meta" for _p, t in _leaves(params))
    assert probe_layer_tags(cfg, params) == ref_probe(ref_cfg, ref_p)


def check_counts_and_module_map(arch):
    """``layer_mult_counts`` equals the reference's at ``batch=2,
    seq_len=8``, reduced and at full size; ``ModuleMap.for_config(
    validate=True)`` (a prefill on ``meta``) gives the reference's
    map."""
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    for r, p in ((ref_cfg.reduced(), cfg.reduced()), (ref_cfg, cfg)):
        got, want = (layer_mult_counts(p, batch=B, seq_len=S),
                     ref_counts(r, batch=B, seq_len=S))
        assert got == want and list(got) == list(want)
    ref_map = RefModuleMap.for_config(ref_cfg.reduced(), batch=B,
                                      seq_len=S, validate=False)
    mmap = ModuleMap.for_config(cfg.reduced(), batch=B, seq_len=S,
                                validate=True)
    assert mmap.layers == ref_map.layers
    assert dict(mmap.layer_module) == dict(ref_map.layer_module)
    assert dict(mmap.layer_counts) == dict(ref_map.layer_counts)
    assert mmap.modules == ref_map.modules
    assert mmap.module_shares() == ref_map.module_shares()


def check_banked_sweep(arch, variant, lib, expected_calls: int):
    """The banked module sweep (every family x 2 multipliers, the
    exact-LUT fill elsewhere) equals the sequential ``policy_for_lane``
    evaluations bit for bit, and makes exactly ``expected_calls`` banked
    datapath calls, which ``banked_calls_per_forward`` must count."""
    cfg = get_config(arch).reduced()
    wl, mmap = _lm_workload(cfg, device="cpu")
    lowered = [mmap.lower(a) for _f, _m, a in
               module_sweep_assignments(mmap, MULTS[1:])]
    kw = dict(layers=mmap.layers, fill=FILL_EXACT, variant=variant)
    with counting_banked_calls() as calls:
        banked = verify_assignments(wl, lowered, mmap.layer_counts, lib,
                                    **kw)
    sequential = verify_assignments(wl, lowered, mmap.layer_counts, lib,
                                    batch=False, **kw)
    assert len(banked) == len(lowered) == 2 * len(mmap.modules)
    for b, s in zip(banked, sequential):
        assert b.metrics == s.metrics
        assert b.network_rel_power == s.network_rel_power
    assert banked_calls_per_forward(cfg) == expected_calls
    assert calls[BANKED[variant]] == sum(calls.values()) == expected_calls
