"""A DeepSeek-V2 decoder's training loss in plain PyTorch, every
projection through the emulated datapath (``datapath.approx_matmul``),
for one chip's share of the routed experts.

The model (hf:deepseek-ai/DeepSeek-V2, arXiv:2405.04434): token
embedding; per layer a pre-norm multi-head latent attention block and a
pre-norm FFN block; a final RMSNorm, the unembedding and the mean
cross-entropy, plus ``aux_loss_coef`` times the MoE layers' Switch
load-balance loss ``E * sum_e mean_prob_e * routed_share_e`` over all
``n_experts``.

Latent attention: ``c_q = RMSNorm(x W_dq)``; per head ``q_nope = c_q
W_uq``, ``q_rope = c_q W_qr``; ``c_kv = RMSNorm(x W_dkv)``; ``k_nope =
c_kv W_uk``, ``v = c_kv W_uv``; one shared rope key ``k_rope = x W_kr``.
RoPE (halves rotated) on ``q_rope`` and ``k_rope`` with YaRN's inverse
frequencies, written out below; causal softmax of ``(q_nope k_nope +
q_rope k_rope) * scale`` with ``scale = (d_nope + d_rope)^-1/2 *
mscale(factor, mscale_all_dim)^2``; the output projection.

The first ``first_dense`` layers' FFN is one SwiGLU of width
``dense_d_ff``.  The rest are DeepSeekMoE: router softmax over all
``n_experts``; each token keeps its experts in its ``topk_group`` best
of ``n_group`` groups (a group's score its largest probability) and
picks its top-k among them; the weights are times ``routed_scaling``
(renormalised only with ``norm_topk_prob``).  The routed slots go to
each expert in token order up to its capacity ``ceil(T k / E *
capacity_factor)`` over all ``E`` experts, the rest dropped; only the
held experts ``held_first .. held_first + held - 1`` are computed, and
slots on the others add nothing (the chip's share of the layer).  The
shared experts, one SwiGLU of ``shared_d_ff``, run on every token.

Precision, as the configuration states it: weights and every reduction
in f32; the residual stream, q/k/v and the attention probabilities
rounded to ``act`` (bfloat16) where the model stores them.  Each
expert's capacity buffer, zero rows included, is one operand of its
projection, calibrated on its own.  The control lowers ``cast`` to
bfloat16 and runs the float32 matmuls in TF32 (``drivers/mla_bank``).

One multiplier table a call: one lane at a time.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .datapath import approx_matmul
from .decoder_moe import rms_norm


def yarn_mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1.0 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, theta: float, yarn: dict) -> np.ndarray:
    """(dim/2,) f32: the base frequencies ``theta^(-2i/dim)`` (float64
    powers of the f32 exponents) over ``factor`` below the ramp, as they
    are above it, blended linearly between the correction dims of
    ``beta_fast`` and ``beta_slow`` rotations; rounded once."""
    def corr(beta):
        return (dim * math.log(yarn["original_max"] / (beta * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr(yarn["beta_fast"])), 0)
    high = min(math.ceil(corr(yarn["beta_slow"])), dim - 1)
    i = np.arange(dim // 2, dtype=np.float64)
    ramp = np.clip((i - low) / ((high - low) or 0.001), 0.0, 1.0)
    extra = 1.0 - ramp                       # the share kept unscaled
    expo = np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim)
    base = 1.0 / np.power(np.float64(theta), expo.astype(np.float64))
    return (base / yarn["factor"] * (1.0 - extra) + base * extra
            ).astype(np.float32)


def rope(x, positions, cfg):
    """x (B, S, H, D) f32, halves rotated, YaRN frequencies; cos and sin
    times YaRN's mscale ratio."""
    d = x.shape[-1]
    yarn = cfg["yarn"]
    inv = torch.from_numpy(yarn_inv_freq(d, cfg["rope_theta"], yarn)).to(
        x.device)
    ang = positions.to(torch.float32)[:, None] * inv
    m = (yarn_mscale(yarn["factor"], yarn["mscale"])
         / yarn_mscale(yarn["factor"], yarn["mscale_all_dim"]))
    cos = (torch.cos(ang) * m)[None, :, None, :]
    sin = (torch.sin(ang) * m)[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def scores_scale(cfg) -> float:
    yarn = cfg["yarn"]
    m = yarn_mscale(yarn["factor"], yarn["mscale_all_dim"])
    return 1.0 / math.sqrt(cfg["nope_dim"] + cfg["rope_dim"]) * m * m


def mla(p, x, cfg, table, act, cast):
    """x (B, S, D) in ``act`` -> the block's output in ``act``."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg["n_heads"], cfg["nope_dim"], cfg["rope_dim"],
                     cfg["v_dim"])
    eps = cfg["norm_eps"]
    x2 = x.reshape(b * s, -1)

    def mm(a, name):
        return approx_matmul(a, p[name], table, cast)

    cq = rms_norm(mm(x2, "wdq").reshape(b, s, -1), p["qn"], eps)
    cq2 = cq.reshape(b * s, -1)
    q_n = mm(cq2, "wuq").reshape(b, s, h, dn)
    q_r = mm(cq2, "wqr").reshape(b, s, h, dr)
    ckv = rms_norm(mm(x2, "wdkv").reshape(b, s, -1), p["kvn"], eps)
    kr = mm(x2, "wkr").reshape(b, s, 1, dr)
    pos = torch.arange(s, device=x.device)
    q_r = rope(q_r, pos, cfg).to(act)
    kr = rope(kr, pos, cfg)[:, :, 0].to(act)
    ckv2 = ckv.reshape(b * s, -1)
    k_n = mm(ckv2, "wuk").reshape(b, s, h, dn).to(act)
    v = mm(ckv2, "wuv").reshape(b, s, h, dv).to(act)
    q_n = q_n.to(act)
    f32 = torch.float32
    s_n = torch.einsum("bshd,bthd->bhst", q_n.to(f32), k_n.to(f32))
    s_r = torch.einsum("bshd,btd->bhst", q_r.to(f32), kr.to(f32))
    keys = torch.arange(s, device=x.device)
    scores = (s_n + s_r) * scores_scale(cfg) + torch.where(
        keys[None, :] <= keys[:, None], 0.0, -1e30)
    probs = torch.softmax(scores, dim=-1).to(act).to(f32)
    out = torch.einsum("bhst,bthd->bshd", probs, v.to(f32))
    return mm(out.reshape(b * s, h * dv), "wo").reshape(b, s, -1).to(act)


def swiglu(p, x2, table, act, cast):
    """One SwiGLU FFN of x2 (T, D) -> (T, D) in ``act``."""
    hid = approx_matmul(x2, p["wi"], table, cast)
    gate = approx_matmul(x2, p["wg"], table, cast)
    hid = (torch.nn.functional.silu(gate) * hid).to(act)
    return approx_matmul(hid.to(torch.float32), p["wo"], table,
                         cast).to(act)


def allowed_experts(probs, cfg):
    """(T, E) bool: the experts of each token's ``topk_group`` best
    groups."""
    t, e = probs.shape
    g = cfg["n_group"]
    group_score = probs.reshape(t, g, e // g).max(dim=-1).values
    best = torch.topk(group_score, cfg["topk_group"], dim=-1).indices
    allowed = torch.zeros((t, g), dtype=torch.bool, device=probs.device)
    allowed[torch.arange(t, device=probs.device)[:, None], best] = True
    return allowed.repeat_interleave(e // g, dim=1)


def moe(p, x, cfg, table, act, cast):
    """x (B, S, D) in ``act`` -> (the held experts' part of the routed
    output plus the shared experts', in ``act``; aux)."""
    b, s, d = x.shape
    e, k = cfg["n_experts"], cfg["top_k"]
    first, held = cfg["held_first"], cfg["held"]
    t = b * s
    cap = int(min(t * k, max(math.ceil(t * k / e * cfg["capacity_factor"]),
                             4)))
    xf = x.reshape(t, d)
    logits = torch.matmul(xf.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    masked = torch.where(allowed_experts(probs, cfg), probs, 0.0)
    top_w, top_ids = torch.topk(masked, k, dim=-1)
    if cfg["norm_topk_prob"]:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    top_w = top_w * cfg["routed_scaling"]
    flat_e = top_ids.reshape(-1)                      # slot j = token j // k
    routed = torch.bincount(flat_e, minlength=e).to(torch.float32) / (t * k)
    aux = e * torch.sum(probs.mean(dim=0) * routed)
    # each expert's slots in slot order; the first `cap` are kept
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    slot_pos = torch.empty_like(flat_e)
    slot_pos[order] = torch.arange(t * k, device=x.device) - starts[
        flat_e[order]]
    out = torch.zeros((t * k, d), dtype=torch.float32, device=x.device)
    for ex in range(first, first + held):
        mine = torch.nonzero((flat_e == ex) & (slot_pos < cap)).reshape(-1)
        buf = torch.zeros((cap, d), dtype=x.dtype, device=x.device)
        buf[slot_pos[mine]] = xf[mine // k]
        xe = buf.to(torch.float32)
        w = {name: p[name][ex - first] for name in ("wi", "wg", "wo")}
        hid = approx_matmul(xe, w["wi"], table, cast)
        gate = approx_matmul(xe, w["wg"], table, cast)
        hid = (torch.nn.functional.silu(gate) * hid).to(act)
        if mine.numel():
            out[mine] = approx_matmul(hid.to(torch.float32), w["wo"], table,
                                      cast, rows=slot_pos[mine])
    y = (out.reshape(t, k, d) * top_w[..., None]).sum(dim=1)
    shared = swiglu(p["shared"], xf, table, act, cast)
    return (y + shared.to(torch.float32)).to(act).reshape(b, s, d), aux


def loss(params, tokens, targets, cfg, table, act=torch.bfloat16,
         cast=torch.float32):
    """The mean next-token cross-entropy of ``tokens`` (B, S) against
    ``targets`` plus ``cfg["aux_loss_coef"]`` x the load-balance loss,
    every projection through the product table ``table``.  ``act``:
    the residual stream's type; ``cast``: the type the datapath's float
    parts are rounded to (f32, or lower for the control)."""
    h = params["embed"][tokens.long()].to(act)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    eps = cfg["norm_eps"]
    layers = ([(params["dense_blocks"], g, False)
               for g in range(cfg["first_dense"])]
              + [(params["blocks"], g, True)
                 for g in range(cfg["n_layers"] - cfg["first_dense"])])
    for blocks, g, is_moe in layers:
        lp = {key: v[g] for key, v in blocks["mixer_0"].items()}
        h = h + mla(lp, rms_norm(h, blocks["norm1_0"][g], eps), cfg, table,
                    act, cast)
        fp = {key: (v[g] if torch.is_tensor(v) else
                    {kk: vv[g] for kk, vv in v.items()})
              for key, v in blocks["ffn_0"].items()}
        x = rms_norm(h, blocks["norm2_0"][g], eps)
        if is_moe:
            y, a = moe(fp, x, cfg, table, act, cast)
            aux = aux + a
        else:
            b, s, d = x.shape
            y = swiglu(fp, x.reshape(b * s, d), table, act,
                       cast).reshape(b, s, d)
        h = h + y
    x = rms_norm(h, params["final_norm"], eps).to(torch.float32)
    logits = torch.matmul(x, params["unembed"].T)     # (B, S, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold) + cfg["aux_loss_coef"] * aux
