"""The continuous-batching serving stack of the port against the
reference's (``tests/test_serve.py``'s tiny dense config and library:
the exact multiplier and truncations 2/3/5; the reference's parameters
carried across with ``models.weights.lm_params_from_numpy``).

What is held, and how closely:
  * ``Scheduler`` and ``PagedKVCache``: on the same submissions, every
    step's admitted and finished requests, active and pending counts,
    block tables and free list equal the reference engine's, and
    ``check_invariants`` holds after every step; ``cache_layout`` and
    ``probe_layer_tags`` equal the reference's.
  * Tokens: the continuous engine's equal the port's own sequential
    ``Engine.generate`` under ``lane_policy`` token for token, for four
    policies (the engine default, two uniform, one heterogeneous;
    greedy and sampled) over three slots, under the plain datapath and
    the ``pallas``/``fused`` ones (the kernels' plain versions on the
    CPU).  Against the reference's continuous engine, greedy tokens
    are equal wherever the reference's top-1/top-2 logit margin exceeds
    ``QUANT_RTOL`` of its largest |logit| (a last-bit difference can
    move a quantization code; ``tests/test_torch_serve.py``).
  * One banked datapath call a projection a step (prefill and decode),
    none single-table, whatever the number of policies.
  * ``launch.serve_load``: its gates hold on the CPU and its decode
    steps and request counts equal the reference's recorded
    ``benchmarks/results/BENCH_serve.json``.
"""
import json
import os

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
from repro.models.common import LMConfig as RefLMConfig
from repro.models.registry import model_fns as ref_model_fns
from repro.models.registry import probe_layer_tags as ref_probe_layer_tags
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
from repro_torch.launch import serve_load
from repro_torch.models.common import LMConfig
from repro_torch.models.registry import model_fns, probe_layer_tags
from repro_torch.models.weights import lm_params_from_numpy
from repro_torch.serve import (ContinuousEngine, Engine, PagedKVCache,
                               Scheduler, ServeConfig, cache_layout)
from repro_torch.serve.kv_cache import tree_flatten
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MULTS = ["mul8u_exact", "mul8u_trunc6", "mul8u_trunc5", "mul8u_trunc3"]
QUANT_RTOL = 0.025
BENCH_SERVE = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                           "results", "BENCH_serve.json")
TINY = dict(name="tiny-dense", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=2, d_ff=64, vocab=128, head_dim=16,
            remat=False, loss_chunk=16)


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


@pytest.fixture(scope="module")
def tiny():
    """(ref_cfg, ref_params, cfg, params): the reference's tiny dense
    model and the port's copy of it."""
    ref_cfg = RefLMConfig(dtype=jnp.float32, **TINY)
    ref_params = ref_model_fns(ref_cfg).init_params(jax.random.PRNGKey(0),
                                                    ref_cfg)
    cfg = LMConfig(dtype=torch.float32, **TINY)
    return (ref_cfg, ref_params, cfg,
            lm_params_from_numpy(jax.tree.map(np.asarray, ref_params)))


def _uniform(policy_cls, spec_cls, mult):
    return policy_cls(default=spec_cls(mode="lut", multiplier=mult,
                                       ste=False)).to_json()


def _mixed_requests(vocab, rng):
    """The reference test's 4 distinct policies (engine default, two
    uniform, one heterogeneous), mixed greedy/sampled, as JSON that both
    packages read."""
    hetero = ApproxPolicy(
        default=BackendSpec(mode="lut", multiplier="mul8u_trunc5",
                            ste=False),
        overrides=[("attn.*", BackendSpec(mode="lut",
                                          multiplier="mul8u_trunc6",
                                          ste=False))]).to_json()
    kw = [dict(max_new_tokens=5, policy=None),
          dict(max_new_tokens=7, temperature=0.8, seed=3,
               policy=_uniform(ApproxPolicy, BackendSpec, "mul8u_trunc6")),
          dict(max_new_tokens=4,
               policy=_uniform(ApproxPolicy, BackendSpec, "mul8u_trunc3")),
          dict(max_new_tokens=6, policy=hetero, temperature=1.1, seed=9)]
    prompts = [rng.integers(0, vocab, (int(rng.integers(3, 9)),)
                            ).astype(np.int32) for _ in kw]
    return prompts, kw


def _step_trace(engine, invariants) -> list:
    """Step ``engine`` dry; each step's admitted and finished rids,
    active and pending counts, block tables and free list."""
    trace = []
    while not engine.scheduler.idle:
        r = engine.step()
        invariants(engine)
        trace.append({"admitted": [s.rid for s in r["admitted"]],
                      "finished": [s.rid for s in r["finished"]],
                      "n_active": r["n_active"],
                      "n_pending": r["n_pending"],
                      "tables": engine.kv.block_tables.tolist(),
                      "free": list(engine.kv._free)})
    return trace


def _engines(libs, tiny, **kw):
    ref_lib, lib = libs
    ref_cfg, ref_params, cfg, params = tiny
    return (RefContinuousEngine(ref_cfg, ref_params, library=ref_lib, **kw),
            ContinuousEngine(cfg, params, library=lib, **kw))


# ----------------------------------------------------------------------
# Scheduler + paged KV cache against the reference
# ----------------------------------------------------------------------
def test_scheduler_and_cache_steps_match_reference(libs, tiny):
    """More requests than slots and a pool too small for full occupancy
    (the reference test's scenario): the same admissions, retirements,
    block tables and free lists every step, invariants after each."""
    ref_eng, eng = _engines(libs, tiny, multipliers=MULTS, n_slots=3,
                            capacity=16, block_size=4, n_blocks=8)
    rng = np.random.default_rng(1)
    for i in range(7):
        max_new = int(rng.integers(2, 6))
        prompt = rng.integers(0, TINY["vocab"], (5,)).astype(np.int32)
        mult = MULTS[i % len(MULTS)]
        ref_eng.submit(prompt, RefServeConfig(
            max_new_tokens=max_new,
            policy=_uniform(RefPolicy, RefSpec, mult)))
        eng.submit(prompt, ServeConfig(
            max_new_tokens=max_new,
            policy=_uniform(ApproxPolicy, BackendSpec, mult)))
    want = _step_trace(ref_eng, lambda e: e.scheduler.check_invariants(
        e.kv))
    got = _step_trace(eng, lambda e: e.scheduler.check_invariants(e.kv))
    assert got == want
    assert max(s["n_active"] for s in got) >= 2
    assert eng.kv.n_free_blocks == eng.kv.n_blocks
    assert list(eng.scheduler.finished) == list(ref_eng.scheduler.finished)


def test_scheduler_strict_fifo_and_allocator(tiny):
    sched = Scheduler(n_slots=2)
    assert sched.idle and sched.head() is None
    assert sched.free_slots() == [0, 1]
    with pytest.raises(RuntimeError):
        sched.admit(0)                  # nothing queued
    cfg = tiny[2]
    kv = PagedKVCache(model_fns(cfg), cfg, n_slots=3, capacity=16,
                      block_size=4)
    assert kv.n_free_blocks == 12
    kv.allocate(0, 9)                   # ceil(9/4) = 3 blocks
    kv.allocate(2, 16)
    assert kv.n_free_blocks == 12 - 3 - 4
    with pytest.raises(RuntimeError, match="already holds"):
        kv.allocate(0, 4)
    kv.release(0)
    kv.release(2)
    assert kv.n_free_blocks == 12 and (kv.block_tables == -1).all()
    with pytest.raises(ValueError, match="capacity"):
        kv.blocks_needed(17)
    with pytest.raises(ValueError, match="no allocated rows"):
        kv.slot_rows(1, 4)


@pytest.mark.parametrize("capacity", [8, 16])
def test_cache_layout_matches_reference(tiny, capacity):
    ref_cfg, _, cfg, _ = tiny
    want = ref_cache_layout(ref_model_fns(ref_cfg), ref_cfg, capacity)
    got = cache_layout(model_fns(cfg), cfg, capacity)
    # the sequence leaves (k, v) alike; the reference's ``pos`` is an
    # int32 array of one entry a layer group, the port's one host int
    assert [got.shapes[i] for i in got.seq_positions] \
        == [want.shapes[i] for i in want.seq_positions]
    assert [want.shapes[i] for i in want.dense_positions] \
        == [(cfg.n_layers,)]
    assert [got.shapes[i] for i in got.dense_positions] == [()]
    assert got.seq_axes == want.seq_axes
    assert got.capacity == want.capacity == capacity
    assert got.seq_positions == want.seq_positions
    assert got.dense_positions == want.dense_positions
    assert [str(d).split(".")[-1] if d is not None else "host int"
            for d in got.dtypes] == ["float32", "host int", "float32"]
    assert got.paths == (("mixer_0", "k"), ("mixer_0", "pos"),
                         ("mixer_0", "v"))


def test_write_prefill_gather_slot_round_trip(tiny):
    """The prefill cache's first ``length`` rows come back from the
    pools, its ``pos`` from the dense store, and decode logits through
    the gathered cache equal the contiguous cache's."""
    _, _, cfg, params = tiny
    fns = model_fns(cfg)
    capacity, length = 16, 6
    kv = PagedKVCache(fns, cfg, n_slots=2, capacity=capacity, block_size=4)
    kv.allocate(0, 4)                   # slot 1 gets blocks 1.. (not 0)
    kv.allocate(1, capacity)
    with torch.inference_mode():
        cache = fns.init_cache(cfg, 1, capacity)
        _, cache = fns.forward_prefill(params, {"tokens": torch.arange(
            1, length + 1, dtype=torch.int32)[None]}, cache, cfg)
        kv.write_prefill(1, cache, length)
        back = kv.gather_slot(1)
        (a, pos_a, _), _ = tree_flatten(cache)
        (b, pos_b, _), _ = tree_flatten(back)
        assert pos_a == pos_b == length
        torch.testing.assert_close(b[:, :, :length], a[:, :, :length],
                                   rtol=0, atol=0)
        tok = torch.tensor([7], dtype=torch.int32)
        want, _ = fns.forward_decode(params, tok, cache, cfg)
        got, _ = fns.forward_decode(params, tok, back, cfg)
    assert torch.equal(got, want)


def test_inactive_slot_never_clobbers_the_last_pool_row(libs, tiny):
    """The reference's regression: after allocator churn a request's
    FIRST block is the pools' LAST, while the second slot stays empty.
    The port runs only the active slots, so no write reaches the last
    row from an empty slot: tokens equal the sequential ``generate``."""
    _, lib = libs
    _, _, cfg, params = tiny
    eng = ContinuousEngine(cfg, params, library=lib, n_slots=2,
                           capacity=8, block_size=4, n_blocks=3)
    eng.submit(np.arange(4, dtype=np.int32), ServeConfig(max_new_tokens=2))
    eng.run()
    assert eng.kv._free[0] == 2
    last = [p[-1].clone() for p in eng.kv.pools]
    prompt = np.arange(4, dtype=np.int32) + 7
    serve = ServeConfig(max_new_tokens=4)
    rid = eng.submit(prompt, serve)     # allocates blocks [2, 0]
    eng.step()                          # prefill + first decode step
    assert eng.kv.block_tables[0, 0] == 2 and not eng._active[1]
    phys = eng.kv.phys_indices(0)
    assert phys[3] == len(eng.kv.pools[0]) - 1   # the last row: prompt's
    out = eng.run()[rid]
    ref = Engine(cfg, params, eng.lane_policy(serve),
                 library=lib).generate(prompt[None], serve)[0]
    np.testing.assert_array_equal(out, ref)
    assert not any(torch.equal(p[-1], q) for p, q in zip(eng.kv.pools,
                                                          last))


@pytest.mark.parametrize("cname", ["tiny", "reduced"])
def test_probe_layer_tags_match_reference(tiny, cname):
    if cname == "tiny":
        ref_cfg, ref_params, cfg, params = tiny
    else:
        ref_cfg = ref_get_config("qwen1.5-0.5b").reduced()
        ref_params = ref_model_fns(ref_cfg).init_params(
            jax.random.PRNGKey(0), ref_cfg)
        cfg = get_config("qwen1.5-0.5b").reduced()
        params = lm_params_from_numpy(jax.tree.map(np.asarray, ref_params))
    want = ref_probe_layer_tags(ref_cfg, ref_params)
    assert probe_layer_tags(cfg, params) == want == (
        "attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.wi", "ffn.wg",
        "ffn.wo")


# ----------------------------------------------------------------------
# Mixed-policy tokens
# ----------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["ref", "pallas", "fused"])
def test_mixed_policies_equal_sequential_generate(libs, tiny, variant):
    _, lib = libs
    _, _, cfg, params = tiny
    eng = ContinuousEngine(cfg, params, library=lib, multipliers=MULTS,
                           n_slots=3, capacity=32, block_size=4,
                           variant=variant)
    prompts, kw = _mixed_requests(cfg.vocab, np.random.default_rng(0))
    serves = [ServeConfig(**k) for k in kw]
    rids = [eng.submit(p, s) for p, s in zip(prompts, serves)]
    out = eng.run()
    assert eng.scheduler.stats()["finished"] == 4
    assert eng.trace_counts["bank_builds"] == 1
    assert max(e["lanes"] for e in eng.step_log) == 3   # slots shared
    for p, s, rid in zip(prompts, serves, rids):
        want = Engine(cfg, params, eng.lane_policy(s),
                      library=lib).generate(p[None], s)[0]
        np.testing.assert_array_equal(out[rid], want, err_msg=rid)


@pytest.mark.parametrize("variant,banked,single", [
    ("pallas", "approx_matmul_lut_bank", "approx_matmul_lut"),
    ("fused", "fused_matmul_lut_bank", "fused_matmul_lut")])
def test_one_banked_call_a_projection_a_step(libs, tiny, monkeypatch,
                                             variant, banked, single):
    _, lib = libs
    _, _, cfg, params = tiny
    calls = {banked: 0, single: 0}
    for name in calls:
        orig = getattr(datapaths, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(datapaths, name, counted)
    eng = ContinuousEngine(cfg, params, library=lib, multipliers=MULTS,
                           n_slots=3, capacity=32, block_size=4,
                           variant=variant)
    prompts, kw = _mixed_requests(cfg.vocab, np.random.default_rng(0))
    for p, k in zip(prompts, kw):
        eng.submit(p, ServeConfig(**k))
    eng.run()
    per_step = 7 * cfg.n_layers
    n_steps = len(eng.step_log)         # 4 prefills + the decode steps
    assert calls == {banked: per_step * n_steps, single: 0}
    assert all(e["banked"] == per_step and e["single"] == 0
               for e in eng.step_log)
    kinds = [e["kind"] for e in eng.step_log]
    assert kinds.count("prefill") == 4 and kinds.count("decode") > 4


def _ref_greedy_margins(ref_cfg, ref_params, prompt, serve, policy):
    """The reference's sequential greedy tokens, top-1/top-2 margins and
    largest |logit| under ``policy`` (its jitted prefill/decode, B=1)."""
    fns = ref_model_fns(ref_cfg)
    pre = jax.jit(lambda p, b, c: fns.forward_prefill(p, b, c, ref_cfg,
                                                      policy))
    dec = jax.jit(lambda p, t, c: fns.forward_decode(p, t, c, ref_cfg,
                                                     policy))
    n = serve.max_new_tokens
    cache = fns.init_cache(ref_cfg, 1, len(prompt) + n)
    logits, cache = pre(ref_params, {"tokens": jnp.asarray(prompt[None])},
                        cache)
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


def test_greedy_tokens_match_reference_engine(libs, tiny):
    """Greedy requests of the mixed set through both continuous
    engines: equal wherever the reference's margin exceeds the
    quantized-logit tolerance (the first step at or below it ends the
    comparison of that request)."""
    ref_eng, eng = _engines(libs, tiny, multipliers=MULTS, n_slots=3,
                            capacity=32, block_size=4)
    ref_cfg, ref_params, cfg, _ = tiny
    prompts, kw = _mixed_requests(cfg.vocab, np.random.default_rng(0))
    rids = [(ref_eng.submit(p, RefServeConfig(**k)),
             eng.submit(p, ServeConfig(**k))) for p, k in zip(prompts, kw)]
    want, got = ref_eng.run(), eng.run()
    compared = 0
    for (rr, pr), p, k in zip(rids, prompts, kw):
        if k.get("temperature", 0.0) > 0:
            continue                    # different samplers' streams
        serve = RefServeConfig(**k)
        toks, margins, scale = _ref_greedy_margins(
            ref_cfg, ref_params, p, serve, ref_eng.lane_policy(serve))
        np.testing.assert_array_equal(want[rr], toks)
        for step in range(len(toks)):
            if margins[step] <= QUANT_RTOL * scale:
                break
            assert got[pr][step] == want[rr][step], (pr, step, margins)
            compared += 1
    assert compared >= 4


# ----------------------------------------------------------------------
# Admission control and the bank
# ----------------------------------------------------------------------
def test_rejections_at_submit(libs, tiny):
    _, lib = libs
    _, _, cfg, params = tiny
    fixed = ContinuousEngine(cfg, params, library=lib,
                             multipliers=["mul8u_exact"], n_slots=2,
                             capacity=8, block_size=4)
    with pytest.raises(ValueError, match="fixed bank"):
        fixed.submit(np.arange(4, dtype=np.int32), ServeConfig(
            policy=_uniform(ApproxPolicy, BackendSpec, "mul8u_trunc6")))
    f32 = ApproxPolicy(default=BackendSpec(mode="f32")).to_json()
    with pytest.raises(ValueError, match="mode"):
        fixed.submit(np.arange(4, dtype=np.int32), ServeConfig(policy=f32))
    with pytest.raises(ValueError, match="capacity"):
        fixed.submit(np.arange(6, dtype=np.int32),
                     ServeConfig(max_new_tokens=4))
    with pytest.raises(ValueError, match="fixed multiplier set"):
        ContinuousEngine(cfg, params, library=lib,
                         multipliers=["mul8u_trunc6"], capacity=8)
    assert fixed.scheduler.idle


def test_stall_is_an_error(libs, tiny):
    _, lib = libs
    _, _, cfg, params = tiny
    eng = ContinuousEngine(cfg, params, library=lib, n_slots=2, capacity=8,
                           block_size=4, n_blocks=1)
    eng.submit(np.arange(4, dtype=np.int32), ServeConfig(max_new_tokens=3))
    with pytest.raises(RuntimeError, match="stalled"):
        eng.step()


def test_bank_grows_once_then_stays(libs, tiny):
    _, lib = libs
    _, _, cfg, params = tiny
    eng = ContinuousEngine(cfg, params, library=lib, n_slots=2,
                           capacity=24, block_size=4)
    prompt = np.arange(4, dtype=np.int32) + 1
    eng.submit(prompt, ServeConfig(max_new_tokens=3))
    eng.run()
    assert eng.trace_counts["bank_builds"] == 1
    trunc6 = _uniform(ApproxPolicy, BackendSpec, "mul8u_trunc6")
    rid = eng.submit(prompt, ServeConfig(max_new_tokens=3, policy=trunc6))
    assert eng.trace_counts["bank_builds"] == 2
    assert eng._names == ["mul8u_exact", "mul8u_trunc6"]
    eng.submit(prompt, ServeConfig(max_new_tokens=3, policy=trunc6))
    eng.submit(prompt, ServeConfig(max_new_tokens=3))
    out = eng.run()
    assert eng.trace_counts["bank_builds"] == 2
    serve = ServeConfig(max_new_tokens=3, policy=trunc6)
    np.testing.assert_array_equal(out[rid], Engine(
        cfg, params, eng.lane_policy(serve), library=lib).generate(
            prompt[None], serve)[0])


# ----------------------------------------------------------------------
# The serve-load generator
# ----------------------------------------------------------------------
def test_serve_load_gates_and_steps_match_the_record(tmp_path):
    with open(BENCH_SERVE) as f:
        bench = json.load(f)
    record = serve_load.run("cpu", quick=True, reduced=True, log=print)
    assert record["bit_identity"] and record["banked_per_step_gate"]
    assert record["bit_identity_requests"] == bench["bit_identity_requests"]
    assert record["multiplier_bank"] == bench["multiplier_bank"]
    assert record["n_slots"] == bench["n_slots"]
    assert ([(lv["n_policies"], lv["n_requests"], lv["decode_steps"])
             for lv in record["levels"]]
            == [(lv["n_policies"], lv["n_requests"], lv["decode_steps"])
                for lv in bench["levels"]] == [(1, 8, 21), (2, 8, 21),
                                                (4, 8, 16)])
    per_step = record["banked_per_step_expected"]
    assert per_step == 7 * 2
    for kind in ("prefill", "decode"):
        assert record["steps"][kind]["banked"] == [per_step]
        assert record["steps"][kind]["single"] == [0]
    assert record["steps"]["prefill"]["n"] == 24 + 3
    assert record["bank_builds"] == 1
    assert json.loads(json.dumps(record)) == record
