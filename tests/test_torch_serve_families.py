"""Continuous serving of the MoE, SSM, hybrid, MLA, encoder-decoder and
VLM families (and chunked attention) in the port, against the reference
and against the port's own sequential ``Engine.generate``.

The archs are the reference test's (``tests/test_serve.py::
test_families_serve_bit_identical``) plus qwen3-moe-30b-a3b, at
``reduced()`` size, the reference's parameters carried across with
``models.weights.lm_params_from_numpy``; its three ``ServeConfig``s
(greedy, sampled with seed 5, the default policy), 2 slots, a 32-row
capacity in 4-row blocks.

What is held, and how closely:
  * ``cache_layout``: the same sequence axes, shapes and dtypes, and the
    same dense leaves (the reference's ``pos`` an int32 array, the
    port's a host int).
  * Tokens: the continuous engine's equal the port's own sequential
    ``Engine.generate`` under ``lane_policy`` token for token, under the
    plain datapath and ``pallas``/``fused`` (the kernels' plain versions
    on the CPU); for two chunked-attention configs too (dense and MLA,
    ``kv_chunk`` 4).  Against the reference (its continuous engine for
    mamba2, deepseek and whisper, its sequential ``generate`` for the
    rest), greedy tokens are equal wherever the reference's top-1/top-2
    logit margin exceeds ``QUANT_RTOL`` of its largest |logit| (a
    last-bit difference can move a quantization code;
    ``tests/test_torch_serve_continuous.py``).  Sampled tokens come from
    the port's own ``torch.Generator`` chain and are compared within the
    port only.
  * Banked calls: every prefill and decode step made one banked datapath
    call a projection site (E an MoE layer's expert projection), counted
    at ``kernels.datapaths`` and derived here from the parameter tree's
    projection weights, independently of ``launch.serve_load``'s formula,
    which must agree.
  * A pure-SSM engine holds zero blocks; a mamba slot's state stays as
    it is in a step where the slot does not run; an MLA request admitted
    into blocks a longer request released decodes with the logits of its
    sequential ``generate``, bit for bit (the released rows are zeroed).
  * ``launch.serve_load`` holds its gates for an MoE and an SSM arch, and
    ``launch.serve --continuous`` runs whisper and llava.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.approx.specs import BackendSpec as RefSpec
from repro.configs import get_config as ref_get_config
from repro.core.families import truncated_multiplier as ref_truncated
from repro.core.library import ApproxLibrary as RefLibrary
from repro.core.seeds import array_multiplier as ref_array
from repro.models.registry import input_extras as ref_input_extras
from repro.models.registry import model_fns as ref_model_fns
from repro.serve.engine import ContinuousEngine as RefContinuousEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.kv_cache import cache_layout as ref_cache_layout
from repro_torch.approx.layers import ApproxPolicy
from repro_torch.approx.specs import BackendSpec
from repro_torch.configs import get_config
from repro_torch.core.families import truncated_multiplier
from repro_torch.core.library import ApproxLibrary
from repro_torch.core.seeds import array_multiplier
from repro_torch.kernels import datapaths
from repro_torch.launch import serve, serve_load
from repro_torch.models.registry import input_extras, model_fns
from repro_torch.models.weights import lm_params_from_numpy
from repro_torch.serve import (ContinuousEngine, Engine, ServeConfig,
                               cache_layout)
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MULTS = ["mul8u_exact", "mul8u_trunc6", "mul8u_trunc5", "mul8u_trunc3"]
QUANT_RTOL = 0.025
ARCHS = ("mamba2-780m", "deepseek-v2-236b", "qwen3-moe-30b-a3b",
         "whisper-large-v3", "llava-next-34b", "jamba-v0.1-52b")
CHUNKED = {"attn_impl": "chunked", "kv_chunk": 4}
#: config name -> (arch, reduced() overrides)
CONFIGS = {**{a: (a, {}) for a in ARCHS},
           "qwen1.5-0.5b+chunked": ("qwen1.5-0.5b", CHUNKED),
           "deepseek-v2-236b+chunked": ("deepseek-v2-236b", CHUNKED)}
#: held against the reference's continuous engine; the rest against its
#: sequential generate
REF_ENGINE = ("mamba2-780m", "deepseek-v2-236b", "whisper-large-v3")
ENGINE_KW = dict(n_slots=2, capacity=32, block_size=4)
#: projection weights of the parameter tree (one datapath call each a
#: layer, E for an (E, K, N) expert stack); the routers, convs and norms
#: are not projections
PROJECTIONS = {"wq", "wk", "wv", "wo", "wi", "wg", "wdq", "wuq", "wqr",
               "wdkv", "wuk", "wuv", "wkr", "in_proj", "out_proj"}


@pytest.fixture(scope="module")
def libs():
    """The reference test's library (exact + truncations 2/3/5), built
    in both packages."""
    out = []
    for lib_cls, exact_fn, trunc_fn in (
            (RefLibrary, ref_array, ref_truncated),
            (ApproxLibrary, array_multiplier, truncated_multiplier)):
        lib = lib_cls()
        exact = exact_fn(8)
        lib.add_netlist(exact, "multiplier", 8, "exact", exact,
                        name="mul8u_exact")
        for k in (2, 3, 5):
            lib.add_netlist(trunc_fn(8, k), "multiplier", 8, "truncation",
                            exact)
        out.append(lib)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _models(name):
    """(ref_cfg, ref_params, cfg, params) of a config: the reference's
    parameters from ``PRNGKey(0)`` (its jitted init, several times
    faster than the eager one) and the port's copy of them."""
    arch, kw = CONFIGS[name]
    ref_cfg = ref_get_config(arch).reduced(**kw)
    ref_params = jax.jit(lambda key: ref_model_fns(ref_cfg).init_params(
        key, ref_cfg))(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced(**kw)
    return (ref_cfg, ref_params, cfg,
            lm_params_from_numpy(jax.tree.map(np.asarray, ref_params)))


def _uniform(policy_cls, spec_cls, mult):
    return policy_cls(default=spec_cls(mode="lut", multiplier=mult,
                                       ste=False)).to_json()


def _requests(vocab):
    """The reference test's prompts and three serve configs (as kwargs
    both packages take)."""
    rng = np.random.default_rng(2)
    kw = [dict(max_new_tokens=4, policy=("mul8u_trunc6",)),
          dict(max_new_tokens=5, policy=("mul8u_trunc5",),
               temperature=0.9, seed=5),
          dict(max_new_tokens=3, policy=None)]
    prompts = [rng.integers(0, vocab, (int(rng.integers(3, 7)),)
                            ).astype(np.int32) for _ in kw]
    return prompts, kw


def _serve(kw, policy_cls, spec_cls, serve_cls):
    kw = dict(kw)
    if kw["policy"] is not None:
        kw["policy"] = _uniform(policy_cls, spec_cls, kw["policy"][0])
    return serve_cls(**kw)


def _port_run(name, lib, variant="ref", **kw):
    """The port's engine over the three requests: (engine, serves,
    prompts, rids, tokens by rid)."""
    _, _, cfg, params = _models(name)
    eng = ContinuousEngine(cfg, params, library=lib, multipliers=MULTS[:3],
                           variant=variant, **{**ENGINE_KW, **kw})
    prompts, kws = _requests(cfg.vocab)
    serves = [_serve(k, ApproxPolicy, BackendSpec, ServeConfig)
              for k in kws]
    rids = [eng.submit(p, s) for p, s in zip(prompts, serves)]
    return eng, serves, prompts, rids, eng.run()


def _sequential(eng, serve_cfg, prompt, lib):
    cfg = eng.cfg
    return Engine(cfg, eng.params, eng.lane_policy(serve_cfg),
                  library=lib).generate(prompt[None], serve_cfg,
                                        extras=input_extras(cfg, 1) or None)


# ----------------------------------------------------------------------
# Cache layout
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_reference(arch):
    ref_cfg, _, cfg, _ = _models(arch)
    want = ref_cache_layout(ref_model_fns(ref_cfg), ref_cfg, 32)
    got = cache_layout(model_fns(cfg), cfg, 32)
    assert got.seq_axes == want.seq_axes
    assert got.seq_positions == want.seq_positions
    assert got.dense_positions == want.dense_positions
    assert got.capacity == want.capacity == 32
    for i, path in enumerate(got.paths):
        if got.dtypes[i] is None:          # the port's host-int ``pos``
            assert path[-1] == "pos" and got.seq_axes[i] is None
            assert str(want.dtypes[i]) == "int32", path
            continue
        assert got.shapes[i] == want.shapes[i], path
        assert str(got.dtypes[i]).split(".")[-1] == str(want.dtypes[i]), \
            path
    # paged: attention and self-attention k/v, MLA's ckv/kr; dense:
    # mamba's conv/state, the encoder-decoder's cross-KV, pos
    for i, path in enumerate(got.paths):
        paged = path[-1] in ("k", "v", "ckv", "kr") and path[0] != "cross"
        assert (got.seq_axes[i] is not None) == paged, (arch, path)
    if arch == "whisper-large-v3":
        dense = [got.paths[i] for i in got.dense_positions]
        assert ("cross", "k") in dense and ("cross", "v") in dense
        assert got.shapes[got.paths.index(("cross", "k"))] == (
            cfg.n_layers, 1, cfg.enc_frames, cfg.n_heads, cfg.head_dim)
    if arch == "mamba2-780m":
        assert not got.seq_positions


# ----------------------------------------------------------------------
# Continuous == sequential, in the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["ref", "pallas", "fused"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_continuous_equals_sequential_generate(libs, name, variant):
    _, lib = libs
    eng, serves, prompts, rids, out = _port_run(name, lib, variant)
    assert eng.scheduler.stats()["finished"] == 3
    assert eng.trace_counts["bank_builds"] == 1
    assert max(e["lanes"] for e in eng.step_log) == 2   # slots shared
    for p, s, rid in zip(prompts, serves, rids):
        np.testing.assert_array_equal(out[rid],
                                      _sequential(eng, s, p, lib)[0],
                                      err_msg=f"{name}/{variant}/{rid}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_equal_sequential_generate(libs, monkeypatch, arch):
    """At the configs' working dtype (bf16, as at full width) every
    logits row a request samples from equals its sequential
    ``generate``'s bit for bit: a cache leaf the model carries in
    another dtype than ``init_cache`` gives it (a mamba conv state comes
    back from the prefill in f32) keeps that dtype in the dense store."""
    _, lib = libs
    _, _, cfg, params = _models(arch)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    seen: dict = {}
    sample = Engine._sample

    def recorded(logits, serve_cfg, gen):
        seen.setdefault(id(serve_cfg), []).append(logits.clone())
        return sample(logits, serve_cfg, gen)

    monkeypatch.setattr(Engine, "_sample", staticmethod(recorded))
    eng = ContinuousEngine(cfg, params, library=lib, multipliers=MULTS[:3],
                           variant="pallas", **ENGINE_KW)
    prompts, kws = _requests(cfg.vocab)
    serves = [_serve(k, ApproxPolicy, BackendSpec, ServeConfig)
              for k in kws]
    for p, s in zip(prompts, serves):
        eng.submit(p, s)
    eng.run()
    got, seen = seen, {}
    for p, s in zip(prompts, serves):
        _sequential(eng, s, p, lib)
        assert len(got[id(s)]) == len(seen[id(s)]) == s.max_new_tokens
        for step, (g, w) in enumerate(zip(got[id(s)], seen[id(s)])):
            assert torch.equal(g, w), (arch, step)


# ----------------------------------------------------------------------
# Greedy tokens against the reference
# ----------------------------------------------------------------------
def _ref_greedy_margins(ref_cfg, ref_params, prompt, serve_cfg, policy):
    """The reference's sequential greedy tokens, top-1/top-2 margins and
    largest |logit| under ``policy`` (B=1, the family's extras)."""
    fns = ref_model_fns(ref_cfg)
    n = serve_cfg.max_new_tokens
    extras = ref_input_extras(ref_cfg, 1)
    extra_len = (extras["img_embeds"].shape[1] if "img_embeds" in extras
                 else 0)
    batch = {"tokens": jnp.asarray(prompt[None]),
             **{k: jnp.asarray(v) for k, v in extras.items()}}
    cache = fns.init_cache(ref_cfg, 1, len(prompt) + extra_len + n)
    logits, cache = jax.jit(lambda p, b, c: fns.forward_prefill(
        p, b, c, ref_cfg, policy))(ref_params, batch, cache)
    dec = jax.jit(lambda p, t, c: fns.forward_decode(p, t, c, ref_cfg,
                                                     policy))
    toks, margins, scale = [], [], 0.0
    for i in range(n):
        if i:
            logits, cache = dec(ref_params, jnp.asarray(toks[-1:]), cache)
        lg = np.asarray(logits)[0]
        top2 = np.sort(lg)[-2:]
        margins.append(top2[1] - top2[0])
        toks.append(int(lg.argmax()))
        scale = max(scale, float(np.abs(lg).max()))
    return np.asarray(toks, np.int32), np.asarray(margins), scale


@pytest.mark.parametrize("name", list(ARCHS) + ["qwen1.5-0.5b+chunked"])
def test_greedy_tokens_match_reference(libs, name):
    """The two greedy requests (one prompt length, so that the reference
    engine compiles one prefill) through the port's continuous engine:
    the first one's tokens equal the reference's (its continuous
    engine's where ``REF_ENGINE`` says, else its sequential generate's)
    wherever the reference's margin exceeds the quantized-logit
    tolerance; the first step at or below it ends the comparison."""
    ref_lib, lib = libs
    ref_cfg, ref_params, cfg, params = _models(name)
    prompts, kws = _requests(cfg.vocab)
    kws = [kws[0], kws[2]]
    prompts = [prompts[0], prompts[0][::-1].copy()]
    eng = ContinuousEngine(cfg, params, library=lib, multipliers=MULTS[:3],
                           **ENGINE_KW)
    rids = [eng.submit(p, _serve(k, ApproxPolicy, BackendSpec,
                                 ServeConfig))
            for p, k in zip(prompts, kws)]
    got = eng.run()
    assert max(e["lanes"] for e in eng.step_log) == 2
    ref_eng = RefContinuousEngine(ref_cfg, ref_params, library=ref_lib,
                                  multipliers=MULTS[:3], **ENGINE_KW)
    ref_serves = [_serve(k, RefPolicy, RefSpec, RefServeConfig)
                  for k in kws]
    if name in REF_ENGINE:
        ref_rids = [ref_eng.submit(p, s) for p, s in zip(prompts,
                                                         ref_serves)]
        want = ref_eng.run()
    # the first request's reference logits (a second costs two more
    # compilations of the reference's steps)
    toks, margins, scale = _ref_greedy_margins(
        ref_cfg, ref_params, prompts[0], ref_serves[0],
        ref_eng.lane_policy(ref_serves[0]))
    if name in REF_ENGINE:
        np.testing.assert_array_equal(want[ref_rids[0]], toks)
    compared = 0
    for step in range(len(toks)):
        if margins[step] <= QUANT_RTOL * scale:
            break
        assert got[rids[0]][step] == toks[step], (name, step, margins)
        compared += 1
    assert compared >= 1, (name, margins, scale)


# ----------------------------------------------------------------------
# One banked call a projection site a step
# ----------------------------------------------------------------------
def _projection_calls(tree, skip=()) -> int:
    """Datapath calls of one pass over a stacked parameter tree: each
    projection weight (lead, K, N) is one call a layer (lead), and so is
    an MoE's (lead, E, K, N) expert stack (its experts in one call); keys
    in ``skip`` left out."""
    n = 0
    experts = "router" in tree
    for key, value in tree.items():
        if key in skip:
            continue
        if isinstance(value, dict):
            n += _projection_calls(value, skip)
        elif key in PROJECTIONS and experts:
            n += int(np.prod(value.shape[:-3]))
        elif key in PROJECTIONS:
            n += int(np.prod(value.shape[:-2]))
    return n


def _expected_calls(cfg, params) -> dict:
    """Banked calls of a prefill and a decode step, from the parameter
    tree: a decode step runs the decoder's projections (an encdec's
    without cross-attention's wk/wv, made once from the frames); a
    prefill adds those, an encdec's encoder and a vlm's ``img_proj``."""
    if cfg.family == "encdec":
        blocks = params["dec_blocks"]
        decode = (_projection_calls(blocks, skip=("xattn",))
                  + _projection_calls({"xattn": {
                      k: v for k, v in blocks["xattn"].items()
                      if k in ("wq", "wo")}}))
        return {"prefill": decode + _projection_calls(params["enc_blocks"])
                + 2 * cfg.n_layers, "decode": decode}
    decode = _projection_calls(params["blocks"])
    return {"prefill": decode + ("img_proj" in params), "decode": decode}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_banked_call_a_projection_site_a_step(libs, monkeypatch, arch):
    _, lib = libs
    _, _, cfg, params = _models(arch)
    want = _expected_calls(cfg, params)
    assert serve_load.banked_calls_per_step(cfg) == want
    calls = {"approx_matmul_lut_bank": 0, "approx_matmul_lut": 0}
    for fn in calls:
        orig = getattr(datapaths, fn)

        def counted(*a, _orig=orig, _fn=fn, **k):
            calls[_fn] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(datapaths, fn, counted)
    eng, *_ = _port_run(arch, lib, "pallas")
    kinds = [e["kind"] for e in eng.step_log]
    assert kinds.count("prefill") == 3 and kinds.count("decode") >= 4
    assert calls == {"approx_matmul_lut_bank": sum(
        want[k] for k in kinds), "approx_matmul_lut": 0}
    assert all(e["banked"] == want[e["kind"]] and e["single"] == 0
               for e in eng.step_log), eng.step_log


# ----------------------------------------------------------------------
# Per-family slot state
# ----------------------------------------------------------------------
def test_pure_ssm_serves_with_zero_blocks(libs):
    """mamba2 has no sequence leaf: no pools, zero blocks a request,
    admission and retirement with an empty block pool, tokens equal to
    the sequential generate."""
    _, lib = libs
    eng, serves, prompts, rids, out = _port_run("mamba2-780m", lib,
                                                n_blocks=0)
    assert eng.kv.pools == [] and eng.kv.n_blocks == 0
    assert eng.kv.blocks_needed(32) == 0
    assert eng.scheduler.stats()["finished"] == 3
    eng.scheduler.check_invariants(eng.kv)
    assert (eng.kv.block_tables == -1).all()
    for p, s, rid in zip(prompts, serves, rids):
        np.testing.assert_array_equal(out[rid],
                                      _sequential(eng, s, p, lib)[0])


def test_inactive_mamba_slot_keeps_its_state(libs):
    """A slot whose request has emitted its last token does not run in
    the next step: its conv and SSM rows stay bit for bit, while the
    running slot's move on."""
    _, lib = libs
    _, _, cfg, params = _models("mamba2-780m")
    eng = ContinuousEngine(cfg, params, library=lib, **ENGINE_KW)
    prompt = np.arange(1, 5, dtype=np.int32)
    short = eng.submit(prompt, ServeConfig(max_new_tokens=2))
    eng.submit(prompt + 3, ServeConfig(max_new_tokens=6))
    eng.step()                          # 2 prefills + a step of both
    st = eng.scheduler.running[0]
    assert st.rid == short and st.done and not eng._active[0]
    before = [d[[0, 1]].clone() for d in eng.kv.dense
              if isinstance(d, torch.Tensor)]
    assert len(before) == 2             # conv, state
    eng.step()                          # slot 1 only
    assert eng.step_log[-1]["lanes"] == 1
    after = [d[[0, 1]] for d in eng.kv.dense if isinstance(d, torch.Tensor)]
    for b, a in zip(before, after):
        assert torch.equal(a[0], b[0])
        assert not torch.equal(a[1], b[1])


def test_mla_request_in_released_blocks_equals_generate(libs, monkeypatch):
    """An MLA request admitted into the blocks of a longer one that was
    released: every logits row it samples from equals its sequential
    ``generate``'s bit for bit.  The latent expansion takes the whole
    view into its calibration, so rows the first request left behind
    would move every code; the allocation zeroes them."""
    _, lib = libs
    _, _, cfg, params = _models("deepseek-v2-236b")
    eng = ContinuousEngine(cfg, params, library=lib, n_slots=1,
                           capacity=16, block_size=4, n_blocks=4)
    eng.submit(np.arange(2, 8, dtype=np.int32) * 7,
               ServeConfig(max_new_tokens=10))
    eng.run()
    # its rows are still in the pool: block 0 onward, all 16 of them
    assert all(bool(p[4:16].abs().amax() > 0) for p in eng.kv.pools)
    seen = []
    sample = Engine._sample

    def recorded(logits, serve_cfg, gen):
        seen.append(logits.clone())
        return sample(logits, serve_cfg, gen)

    monkeypatch.setattr(Engine, "_sample", staticmethod(recorded))
    prompt = np.asarray([5, 9, 3], np.int32)
    serve_cfg = ServeConfig(max_new_tokens=3,
                            policy=_uniform(ApproxPolicy, BackendSpec,
                                            "mul8u_trunc5"))
    rid = eng.submit(prompt, serve_cfg)
    out = eng.run()[rid]
    assert eng.kv.block_tables[0, 0] == -1       # retired
    got, seen[:] = list(seen), []
    want = _sequential(eng, serve_cfg, prompt, lib)[0]
    np.testing.assert_array_equal(out, want)
    assert len(got) == len(seen) == 3
    for g, w in zip(got, seen):
        assert torch.equal(g, w)


# ----------------------------------------------------------------------
# The serve launchers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-780m"])
def test_serve_load_gates_hold(arch):
    record = serve_load.run("cpu", arch=arch, reduced=True, levels=[2],
                            n_requests=4, log=lambda s: None)
    assert record["bit_identity"] and record["banked_per_step_gate"]
    _, _, cfg, params = _models(arch)
    want = _expected_calls(cfg, params)
    assert record["banked_per_prefill_expected"] == want["prefill"]
    assert record["banked_per_step_expected"] == want["decode"]
    for kind in ("prefill", "decode"):
        assert record["steps"][kind]["banked"] == [want[kind]]
        assert record["steps"][kind]["single"] == [0]
    assert record["bit_identity_requests"] == 4
    assert [lv["n_policies"] for lv in record["levels"]] == [2]
    assert record["bank_builds"] == 1


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-34b"])
def test_serve_continuous_cli(arch, capsys):
    """``serve --continuous --reduced`` on the CPU: the family's stub
    extras enter each request's prefill, one bank build, every token in
    the vocabulary."""
    serve.main(["--device", "cpu", "--arch", arch, "--reduced",
                "--continuous", "--batch", "2", "--prompt-len", "6",
                "--max-new", "3", "--no-warmup"])
    out = capsys.readouterr().out.splitlines()
    assert f"{arch} continuous n_slots=2" in out[-2]
    assert "bank_builds=1" in out[-2]
    toks = np.asarray([int(t) for t in out[-1].strip("[]").split()])
    vocab = get_config(arch).reduced().vocab
    assert toks.shape == (3,) and 0 <= toks.min() and toks.max() < vocab
