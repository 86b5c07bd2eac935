"""DeepSeek-V2 as published on the port's loss path, at toy widths on the
CPU: the ``LMConfig`` fields the registry's config leaves at their
defaults (``first_dense``, ``n_group``/``topk_group``,
``norm_topk_prob``, ``routed_scaling``, ``rope_scaling``) and one
chip's share of the routed experts (``expert_first``/``experts_held``).

What is held, and how closely:
  * the share: the 8 groups' shares of an MoE layer, each run alone
    with its experts' weights, plus the shared experts counted once,
    add up to the uncut layer within ``SHARE_ATOL`` of its largest |y|
    (f32; the uncut combine sums a token's k slots in one sum, the
    shares in eight), under the exact f32 datapath and under int8 (each
    held expert's buffer is the same operand in both, so the per-expert
    outputs are the same bits); the aux loss is the same bits;
  * group-limited routing equals a plain loop over tokens, ids and
    weights bit for bit;
  * YaRN: the ramp's ends (10, 23), the inverse frequencies against the
    formula, cos/sin, and the scores scale 0.11472;
  * the leading dense layer: its tree and the loss bit for bit against
    the layer run by hand before the stacked MoE layers; the cached
    paths refuse such a model;
  * the MAC counts and banked calls count the dense layer at its width
    and the share's experts alone; the dry run's probes refuse both;
    dispatch counts the share's kept slots and capacity rows, with no
    reduction while the profiler records;
  * at their defaults the new fields leave ``route`` and
    ``forward_train`` of a qwen-shaped config bit for bit as the
    formula they replaced and as the whole share written out.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.approx.layers import EXACT_POLICY, ApproxPolicy
from repro_torch.approx.specs import BackendSpec
from repro_torch.approx.workload import layer_mult_counts
from repro_torch.launch.arch_profiles import banked_calls_per_forward
from repro_torch.launch.steps import build_probes
from repro_torch.models import common, decoder, mla, moe
from repro_torch.models.common import LMConfig, YarnRope

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: f32, eight partial sums of k = 6 slots against one: a few ulp of |y|
SHARE_ATOL = 1e-6

YARN = YarnRope(factor=40.0, original_max=4096, beta_fast=32.0,
                beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707)

TINY = LMConfig(
    name="tiny-dsv2", family="moe", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=16, vocab=256, head_dim=16, n_experts=32,
    n_shared_experts=2, top_k=6, moe_d_ff=16, capacity_factor=1.25,
    use_mla=True, kv_lora=16, q_lora=32, rope_head_dim=8, v_head_dim=16,
    dtype=torch.float32, remat=False, n_group=8, topk_group=3,
    norm_topk_prob=False, routed_scaling=16.0, first_dense=1,
    first_dense_d_ff=96, rope_scaling=YARN)


def _params(cfg, seed=0):
    return decoder.init_params(torch.Generator().manual_seed(seed), cfg)


def _tokens(cfg, b=2, s=24, seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=g)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _layer(params, g=0):
    return decoder._index(params["blocks"], g)["ffn_0"]


def _x(cfg, t=48, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, t // 2, cfg.d_model), generator=g)


POLICIES = {"f32": EXACT_POLICY,
            "int8": ApproxPolicy(default=BackendSpec.golden().materialize())}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_eight_shares_and_the_shared_experts_make_the_layer(policy):
    pol = POLICIES[policy]
    cfg = dataclasses.replace(TINY, first_dense=0, n_layers=2)
    p = _layer(_params(cfg))
    x = _x(cfg)
    with torch.inference_mode():
        whole, aux = moe.moe_ffn(p, x, cfg, pol)
        per = cfg.n_experts // cfg.n_group
        share_cfg = dataclasses.replace(cfg, n_shared_experts=0,
                                        experts_held=per)
        total = torch.zeros_like(whole)
        for g in range(cfg.n_group):
            part = {"router": p["router"]}
            part.update({k: p[k][g * per:(g + 1) * per]
                         for k in ("wi", "wg", "wo")})
            y, a = moe.moe_ffn(
                part, x, dataclasses.replace(share_cfg,
                                             expert_first=g * per), pol)
            assert torch.equal(a, aux)
            total = total + y
        total = total + common.ffn(p["shared"], x, cfg, pol,
                                   layer_tag="moe.shared")
    # slots past the capacity are dropped: the test covers drops
    r = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    assert bool((r.pos_in_e >= moe.capacity(cfg, x.shape[0] * x.shape[1]))
                .any())
    scale = whole.abs().amax()
    assert (total - whole).abs().amax() <= SHARE_ATOL * scale


def test_a_share_holds_only_its_experts():
    cfg = dataclasses.replace(TINY, first_dense=0, n_layers=2,
                              expert_first=8, experts_held=4)
    p = _params(cfg)
    ffn = p["blocks"]["ffn_0"]
    assert ffn["router"].shape == (2, 64, 32)
    assert ffn["wi"].shape == (2, 4, 64, 16)
    assert ffn["shared"]["wi"].shape == (2, 64, 32)
    x = _x(cfg).reshape(-1, cfg.d_model)
    r = moe.route(_layer(p), x, cfg)
    buf = moe.dispatch(x, r, cfg)
    assert buf.shape == (4, moe.capacity(cfg, x.shape[0]), 64)
    held = (r.sorted_e >= 8) & (r.sorted_e < 12) & (
        r.pos_in_e < buf.shape[1])
    assert int((buf.abs().sum(-1) > 0).sum()) == int(held.sum())


def test_a_share_counts_its_kept_slots_and_capacity_rows():
    cfg = dataclasses.replace(TINY, first_dense=0, n_layers=2,
                              expert_first=8, experts_held=4)
    x = _x(cfg).reshape(-1, cfg.d_model)
    r = moe.route(_layer(_params(cfg)), x, cfg)
    cap = moe.capacity(cfg, x.shape[0])
    held = (r.sorted_e >= 8) & (r.sorted_e < 12) & (r.pos_in_e < cap)
    obs._rec = None
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("model.moe.dispatch"):
                moe.dispatch(x, r, cfg)
        snap = obs.snapshot()
    finally:
        obs._rec = None
    assert obs.total(snap, "moe.held_slots") == int(held.sum()) > 0
    assert obs.total(snap, "moe.capacity_rows") == 4 * cap
    # the kept slots are summed by the snapshot, outside the window
    assert not any(e.name == "aten::sum" for e in prof.events())


def test_mac_counts_and_banked_calls_follow_the_dense_lead_and_share():
    cfg = dataclasses.replace(TINY, expert_first=8, experts_held=4)
    b, s = 2, 24
    t, d = b * s, cfg.d_model
    got = layer_mult_counts(cfg, batch=b, seq_len=s)
    cap = moe.capacity(cfg, t)
    assert got["mla.wdq"] == 3 * t * d * cfg.q_lora
    assert got["ffn.wi"] == got["ffn.wg"] == got["ffn.wo"] == t * d * 96
    assert got["moe.shared.wi"] == 2 * t * d * 2 * 16
    assert got["moe.wi"] == got["moe.wo"] == 2 * 4 * cap * d * 16
    assert banked_calls_per_forward(cfg) == (8 + 3) + 2 * (8 + 3 + 3)
    for over in ({"first_dense": 1, "first_dense_d_ff": 12288},
                 {"experts_held": 20}):
        with pytest.raises(NotImplementedError, match="another model"):
            build_probes("deepseek-v2-236b", "train_4k", 1,
                         overrides=over)


def _plain_route(probs, cfg):
    """Per token: the groups by their largest probability, the best
    ``topk_group`` kept, the top-k of their experts, times the scale."""
    t, e = probs.shape
    per = e // cfg.n_group
    ids, ws = [], []
    for i in range(t):
        row = probs[i].tolist()
        score = [max(row[g * per:(g + 1) * per]) for g in range(cfg.n_group)]
        groups = sorted(range(cfg.n_group), key=lambda g: -score[g])
        allowed = [x for g in groups[:cfg.topk_group]
                   for x in range(g * per, (g + 1) * per)]
        top = sorted(allowed, key=lambda x: -row[x])[:cfg.top_k]
        ids.append(top)
        ws.append([row[x] for x in top])
    w = torch.tensor(ws, dtype=torch.float32)
    if cfg.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return torch.tensor(ids), w * cfg.routed_scaling


def _route_ids(r, t, k):
    flat = torch.empty_like(r.sorted_e)
    flat[r.order] = r.sorted_e
    return flat.reshape(t, k)


@pytest.mark.parametrize("norm", [False, True])
def test_group_limited_routing_equals_a_plain_loop(norm):
    cfg = dataclasses.replace(TINY, norm_topk_prob=norm)
    p = _layer(_params(cfg))
    x = _x(cfg).reshape(-1, cfg.d_model)
    r = moe.route(p, x, cfg)
    probs = torch.softmax(x @ p["router"], dim=-1)
    ids, w = _plain_route(probs, cfg)
    assert torch.equal(_route_ids(r, x.shape[0], cfg.top_k), ids)
    assert torch.equal(r.top_w, w)
    # the aux loss: the Switch form over all experts
    t, e = probs.shape
    share = torch.bincount(ids.reshape(-1), minlength=e) / (t * cfg.top_k)
    want = e * torch.sum(probs.mean(dim=0) * share)
    assert torch.allclose(r.aux, want, rtol=1e-6, atol=0)


def test_yarn_tables_and_scale():
    low, high, ramp = common.yarn_ramp(64, 10000.0, YARN)
    assert (low, high) == (10, 23)
    i = np.arange(32, dtype=np.float64)
    assert np.array_equal(ramp, np.clip((i - 10) / 13, 0, 1))
    base = 1.0 / 10000.0 ** (np.arange(0, 64, 2, dtype=np.float32)
                             .astype(np.float64) / 64)
    mask = 1 - np.clip((i - 10) / 13, 0, 1)
    want = (base / 40 * (1 - mask) + base * mask).astype(np.float32)
    got = common.yarn_inv_freq(64, 10000.0, YARN)
    assert np.array_equal(got, want)
    assert got[0] == np.float32(1.0) and got[31] == np.float32(base[31] / 40)
    pos = torch.arange(7)
    cos, sin = common.rope_tables(pos, 64, 10000.0, YARN)
    ang = pos.to(torch.float32)[:, None] * torch.from_numpy(want)
    assert torch.equal(cos, torch.cos(ang)) and torch.equal(sin,
                                                            torch.sin(ang))
    cfg = dataclasses.replace(TINY, head_dim=128, rope_head_dim=64)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert mla._scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-15)
    assert mla._scale(cfg) == pytest.approx(0.11472, abs=5e-6)
    plain = dataclasses.replace(cfg, rope_scaling=None)
    assert mla._scale(plain) == 1.0 / math.sqrt(192)
    c0, s0 = common.rope_tables(pos, 64, 10000.0)
    assert torch.equal(c0, torch.cos(pos.to(torch.float32)[:, None]
                                     * torch.from_numpy(
                                         common.rope_inv_freq(64, 1e4))))
    assert not torch.equal(c0, cos) and s0.shape == sin.shape


def test_dense_lead_layer():
    cfg = TINY
    params = _params(cfg)
    dense = params["dense_blocks"]
    assert dense["ffn_0"]["wi"].shape == (1, 64, 96)
    assert dense["mixer_0"]["wdq"].shape == (1, 64, 32)
    assert params["blocks"]["ffn_0"]["wi"].shape == (2, 32, 64, 16)
    batch = _tokens(cfg)
    pol = POLICIES["int8"]
    with torch.inference_mode():
        loss = decoder.forward_train(params, batch, cfg, pol)
        h, pos = decoder._embed_inputs(params, batch, cfg, pol)
        lp = decoder._index(dense, 0)
        y, _ = mla.mla_attention(lp["mixer_0"], common.rms_norm(
            h, lp["norm1_0"], cfg.norm_eps), cfg, pol, positions=pos)
        h = h + y
        h = h + common.ffn(lp["ffn_0"], common.rms_norm(
            h, lp["norm2_0"], cfg.norm_eps), cfg, pol)
        rest = dataclasses.replace(cfg, first_dense=0, n_layers=2)
        h, aux, _ = decoder._run_stack(params, h, pos, rest, pol)
        want = decoder.lm_loss(params, h, batch["targets"], rest, 0,
                               "final_norm") + decoder.AUX_LOSS_COEF * aux
    assert torch.equal(loss, want)
    with pytest.raises(NotImplementedError, match="dense"):
        decoder.init_cache(cfg, 1, 8)
    with pytest.raises(NotImplementedError, match="dense"):
        decoder.forward_decode_lanes(params, None, None, None, cfg, pol)


QWEN_LIKE = LMConfig(name="qwen-like", family="moe", n_layers=2,
                     d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
                     vocab=256, head_dim=16, qk_norm=True, n_experts=8,
                     top_k=2, moe_d_ff=32, capacity_factor=1.25,
                     dtype=torch.float32, remat=False)
#: the new fields at values that spell out the default model
WHOLE = dict(expert_first=0, experts_held=8, n_group=1, topk_group=1,
             norm_topk_prob=True, routed_scaling=1.0, first_dense=0,
             rope_scaling=None)


def test_defaults_leave_route_and_forward_train_as_they_were():
    cfg = QWEN_LIKE
    params = _params(cfg)
    p = _layer(params)
    x = _x(cfg).reshape(-1, cfg.d_model)
    r = moe.route(p, x, cfg)
    # the formula the group-limited routing replaced
    probs = torch.softmax(x @ p["router"], dim=-1)
    w, ids = torch.topk(probs, cfg.top_k, dim=-1)
    assert torch.equal(r.top_w, w / torch.sum(w, dim=-1, keepdim=True))
    assert torch.equal(_route_ids(r, x.shape[0], cfg.top_k), ids)
    spelled = dataclasses.replace(cfg, **WHOLE)
    r2 = moe.route(p, x, spelled)
    for f in dataclasses.fields(r):
        assert torch.equal(getattr(r, f.name), getattr(r2, f.name))
    batch = _tokens(cfg)
    for pol in POLICIES.values():
        with torch.inference_mode():
            a = decoder.forward_train(params, batch, cfg, pol)
            b = decoder.forward_train(params, batch, spelled, pol)
        assert torch.equal(a, b)
