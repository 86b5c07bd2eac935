"""A Qwen3-MoE decoder's training loss in plain PyTorch, every projection
through the emulated datapath (``datapath.approx_matmul``).

The model (hf:Qwen/Qwen3-30B-A3B): token embedding; per layer a pre-norm
GQA attention block (RMSNorm; q, k, v projections; per-head RMSNorm of q
and k; RoPE on the whole head, halves rotated; causal softmax attention;
output projection) and a pre-norm MoE block (router softmax over the
experts, top-k renormalised, the routed slots dispatched to each expert
in token order up to its capacity ``ceil(T k / E * capacity_factor)``,
the rest dropped; SwiGLU experts; the outputs weighted back); a final
RMSNorm, the unembedding and the mean cross-entropy, plus
``aux_loss_coef`` times the layers' Switch load-balance loss ``E *
sum_e mean_prob_e * routed_share_e``.

Precision, as the configuration states it: weights and every reduction
in f32; the residual stream, q/k/v and the attention probabilities
rounded to ``act`` (bfloat16) where the model stores them.  Each
expert's capacity buffer, zero rows included, is one operand of its
projection, calibrated on its own.  The control lowers ``cast`` to
bfloat16 and runs the float32 matmuls in TF32 (``drivers/lm_bank``).

One multiplier table a call: one lane at a time.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .datapath import approx_matmul


def rms_norm(x, gamma, eps):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def rope(x, positions, theta):
    """x (B, S, H, D) f32, halves rotated (f32 frequencies from a float64
    power, as the model's RoPE tables)."""
    d = x.shape[-1]
    expo = np.arange(0, d, 2, dtype=np.float32) / np.float32(d)
    inv = (1.0 / np.power(np.float64(theta), expo.astype(np.float64))
           ).astype(np.float32)
    ang = positions.to(torch.float32)[:, None] * torch.from_numpy(inv).to(
        x.device)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :,
                                                                None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, cfg, table, act, cast):
    b, s, _ = x.shape
    h, hk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    x2 = x.reshape(b * s, -1)
    q = approx_matmul(x2, p["wq"], table, cast).reshape(b, s, h,
                                                                  hd)
    k = approx_matmul(x2, p["wk"], table, cast).reshape(b, s, hk,
                                                                  hd)
    v = approx_matmul(x2, p["wv"], table, cast).reshape(b, s, hk,
                                                                  hd)
    q = rms_norm(q, p["qnorm"], cfg["norm_eps"])
    k = rms_norm(k, p["knorm"], cfg["norm_eps"])
    pos = torch.arange(s, device=x.device)
    q = rope(q, pos, cfg["rope_theta"]).to(act)
    k = rope(k, pos, cfg["rope_theta"]).to(act)
    v = v.to(act)
    g = h // hk
    qf = q.reshape(b, s, hk, g, hd).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.to(torch.float32))
    scores = scores / math.sqrt(hd)
    keys = torch.arange(s, device=x.device)
    scores = scores + torch.where(keys[None, :] <= keys[:, None], 0.0,
                                  -1e30)
    probs = torch.softmax(scores, dim=-1).to(act).to(torch.float32)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    out = out.reshape(b * s, h * hd)
    return approx_matmul(out, p["wo"], table, cast).reshape(
        b, s, -1).to(act)


def moe(p, x, cfg, table, act, cast):
    """x (B, S, D) in ``act`` -> (the block's output in ``act``, aux)."""
    b, s, d = x.shape
    e, k = cfg["n_experts"], cfg["top_k"]
    t = b * s
    cap = int(min(t * k, max(math.ceil(t * k / e * cfg["capacity_factor"]),
                             4)))
    xf = x.reshape(t, d)
    logits = torch.matmul(xf.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
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
    kept = slot_pos < cap
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    slots = torch.nonzero(kept).reshape(-1)
    buf[flat_e[slots], slot_pos[slots]] = xf[slots // k]
    out = torch.zeros((t * k, d), dtype=torch.float32, device=x.device)
    for ex in range(e):
        xe = buf[ex].to(torch.float32)
        hid = approx_matmul(xe, p["wi"][ex], table, cast)
        gate = approx_matmul(xe, p["wg"][ex], table, cast)
        hid = (torch.nn.functional.silu(gate) * hid).to(act)
        mine = slots[flat_e[slots] == ex]
        if mine.numel() == 0:
            continue
        y = approx_matmul(hid.to(torch.float32), p["wo"][ex],
                          table, cast, rows=slot_pos[mine])
        out[mine] = y
    y = (out.reshape(t, k, d) * top_w[..., None]).sum(dim=1)
    return y.to(act).reshape(b, s, d), aux


def loss(params, tokens, targets, cfg, table, act=torch.bfloat16,
         cast=torch.float32):
    """The mean next-token cross-entropy of ``tokens`` (B, S) against
    ``targets`` plus ``cfg["aux_loss_coef"]`` x the load-balance loss,
    every projection through the product table ``table``.  ``act``:
    the residual stream's type; ``cast``: the type the datapath's float
    parts are rounded to (f32, or lower for the control)."""
    h = params["embed"][tokens.long()].to(act)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    blocks = params["blocks"]
    for g in range(cfg["n_layers"]):
        lp = {key: v[g] for key, v in blocks["mixer_0"].items()}
        h = h + attention(lp, rms_norm(h, blocks["norm1_0"][g],
                                       cfg["norm_eps"]), cfg, table, act,
                          cast)
        fp = {key: v[g] for key, v in blocks["ffn_0"].items()}
        y, a = moe(fp, rms_norm(h, blocks["norm2_0"][g], cfg["norm_eps"]),
                   cfg, table, act, cast)
        h = h + y
        aux = aux + a
    x = rms_norm(h, params["final_norm"], cfg["norm_eps"]).to(torch.float32)
    logits = torch.matmul(x, params["unembed"].T)     # (B, S, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold) + cfg["aux_loss_coef"] * aux
