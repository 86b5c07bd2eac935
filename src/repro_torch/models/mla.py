"""Multi-head Latent Attention (port of ``repro.models.mla``; DeepSeek-V2,
arXiv:2405.04434).

Queries and keys/values are produced through low-rank compressions:
  c_q  = x W_dq                (q_lora)
  q    = RMSNorm(c_q) W_uq     per-head [d_nope | d_rope]
  c_kv = x W_dkv               (kv_lora)   <- THIS is the KV cache
  k_nope, v = RMSNorm(c_kv) W_uk / W_uv
  k_rope = x W_kr              single shared rope head
The decode cache stores only (c_kv, k_rope).

As in the reference, a cached call writes the new latents into the cache
and expands the WHOLE cache, ``max_len`` rows with the empty ones at
zero, through ``wuk``/``wuv``: those zero rows enter each call's
calibration, so the quantized keys and values equal the reference's only
at that shape — and every decode step re-expands all ``max_len`` rows in
every layer.

Differences from the reference, none of which changes a value: the
cache's ``pos`` is a host int and the latents are written in place (as
``common.attention`` does); under a banked policy every projection
(``wdq``, ``wuq``, ``wqr``, ``wdkv``, ``wkr``, ``wuk``, ``wuv``, ``wo``)
is one banked call for all lanes, the two norms and the attention core
run lane by lane (``common.each_lane``), and the cache takes a bank lane
axis as the attention cache does.

The continuous engine's decode step (``lane_mla_attention``) runs the
six projections of the new token once for all running requests, writes
each request's latent row into its paged slot, and expands every
request's whole ``total_len``-row latent view in one banked call a
projection: the views are zero-padded to the longest, which leaves each
lane's rows as its own expansion gives them (rows are independent, and
zero rows do not move a lane's calibration, which clamps lo <= 0 <= hi).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..approx.layers import ApproxPolicy
from ..launch.mesh import sharded_einsum, sharded_reshape
from .. import obs
from .common import (LMConfig, apply_rope, causal_bias, dense_init,
                     each_lane, lane_rms_norm, lanes_of, rms_norm_lanes,
                     rope_tables, yarn_mscale)


def init_mla(gen: torch.Generator, cfg: LMConfig, lead: tuple = ()) -> dict:
    """MLA weights, with ``lead`` stacked leading dims (layer groups)."""
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    dev = gen.device
    return {
        "wdq": dense_init(gen, (*lead, d, cfg.q_lora)),
        "wuq": dense_init(gen, (*lead, cfg.q_lora, h * dn)),
        "wqr": dense_init(gen, (*lead, cfg.q_lora, h * dr)),
        "wdkv": dense_init(gen, (*lead, d, cfg.kv_lora)),
        "wuk": dense_init(gen, (*lead, cfg.kv_lora, h * dn)),
        "wuv": dense_init(gen, (*lead, cfg.kv_lora, h * dv)),
        "wkr": dense_init(gen, (*lead, d, dr)),
        "wo": dense_init(gen, (*lead, h * dv, d)),
        "qn": torch.ones((*lead, cfg.q_lora), device=dev),
        "kvn": torch.ones((*lead, cfg.kv_lora), device=dev),
    }


def _scale(cfg: LMConfig) -> float:
    """Scores scale: the nope and rope dims together; under YaRN times
    ``mscale(factor, mscale_all_dim) ** 2``."""
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_head_dim)
    yarn = cfg.rope_scaling
    if yarn is not None and yarn.mscale_all_dim:
        m = yarn_mscale(yarn.factor, yarn.mscale_all_dim)
        scale = scale * m * m
    return scale


def _mla_core(q_n, q_r, k_n, k_r, v, mask_bias, cfg: LMConfig
              ) -> torch.Tensor:
    """q_n:(B,S,H,dn) q_r:(B,S,H,dr) k_n:(B,T,H,dn) k_r:(B,T,dr)
    v:(B,T,H,dv) -> (B,S,H,dv) f32; operands in the working dtype,
    products and sums in f32."""
    f32 = torch.float32
    s_n = sharded_einsum("bshd,bthd->bhst", q_n.to(f32), k_n.to(f32))
    s_r = sharded_einsum("bshd,btd->bhst", q_r.to(f32), k_r.to(f32))
    scores = (s_n + s_r) * _scale(cfg) + mask_bias
    probs = torch.softmax(scores, dim=-1)
    return sharded_einsum("bhst,bthd->bshd", probs.to(v.dtype).to(f32),
                        v.to(f32))


def _mla_core_chunked(q_n, q_r, k_n, k_r, v, q_pos0: int, t_valid: int,
                      cfg: LMConfig) -> torch.Tensor:
    """Flash-style MLA: online softmax over T chunks of ``cfg.kv_chunk``
    keys (the reference's ``lax.scan`` as a loop), never building the
    (H,S,T) scores; masking as ``common._chunked_grouped_attention``."""
    f32 = torch.float32
    b, s, h, _dn = q_n.shape
    t, dv = k_n.shape[1], v.shape[-1]
    dev = q_n.device
    c = min(cfg.kv_chunk, t)
    pad = (-t) % c
    if pad:
        k_n = torch.nn.functional.pad(k_n, (0, 0, 0, 0, 0, pad))
        k_r = torch.nn.functional.pad(k_r, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    q_n, q_r = q_n.to(f32), q_r.to(f32)
    q_pos = q_pos0 + torch.arange(s, device=dev)
    m = torch.full((b, h, s), -1e30, dtype=f32, device=dev)
    l = torch.zeros((b, h, s), dtype=f32, device=dev)
    acc = torch.zeros((b, h, s, dv), dtype=f32, device=dev)
    for i0 in range(0, k_n.shape[1], c):
        vc = v[:, i0:i0 + c]
        sc = sharded_einsum("bshd,bchd->bhsc", q_n, k_n[:, i0:i0 + c].to(f32))
        sc = sc + sharded_einsum("bshd,bcd->bhsc", q_r,
                               k_r[:, i0:i0 + c].to(f32))
        sc = sc * _scale(cfg)
        key_pos = i0 + torch.arange(c, device=dev)
        valid = ((key_pos[None, :] <= q_pos[:, None])
                 & (key_pos[None, :] < t_valid))
        sc = torch.where(valid, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.where(valid, torch.exp(sc - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = sharded_einsum("bhsc,bchd->bhsd", p.to(vc.dtype).to(f32),
                          vc.to(f32))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2)                  # (B,S,H,dv)


def _write(buf: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """``new`` (B,S,R), or (n,B,S,R), written into the (B,T,R) cache
    ``buf`` at ``pos`` in place; a cache without the new rows' bank lane
    axis is first copied to every lane."""
    if new.ndim == 4 and buf.ndim == 3:
        buf = buf.expand(new.shape[0], *buf.shape).clone()
    buf[..., pos:pos + new.shape[-2], :] = new.to(buf.dtype)
    return buf


def mla_attention(params, x, cfg: LMConfig, policy: ApproxPolicy, *,
                  positions: torch.Tensor, cache: Optional[dict] = None,
                  layer_tag: str = "mla", lanes: bool = False
                  ) -> tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,D), or (n,B,S,D) with a bank lane axis.  cache: {"ckv":
    (B,T,kv_lora), "kr": (B,T,dr), "pos": int}.  Returns the output in
    the working dtype and the new cache (None without one).  ``lanes``:
    x's batch axis is a bank lane axis (the continuous engine's B=1
    prefill).  Span ``model.mla`` holds the whole call, so its self time
    is the exact part (norms, RoPE, the core lane by lane) and the
    projections' ``datapath`` spans are its children."""
    with obs.span("model.mla"):
        return _mla_attention(params, x, cfg, policy, positions, cache,
                              layer_tag, lanes)


def _mla_attention(params, x, cfg: LMConfig, policy: ApproxPolicy,
                   positions: torch.Tensor, cache: Optional[dict],
                   layer_tag: str, lanes: bool
                   ) -> tuple[torch.Tensor, Optional[dict]]:
    h = cfg.n_heads
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    eps = cfg.norm_eps

    def mm(name, a):
        return policy.matmul(f"{layer_tag}.{name}", a, params[name],
                             lanes=lanes or a.ndim == 4)

    s = x.shape[-2]
    cq = rms_norm_lanes(mm("wdq", x), params["qn"], eps)
    q_n = mm("wuq", cq)
    q_r = mm("wqr", cq)
    q_n = sharded_reshape(q_n, (*q_n.shape[:-1], h, dn))
    q_r = sharded_reshape(q_r, (*q_r.shape[:-1], h, dr))
    ckv = rms_norm_lanes(mm("wdkv", x), params["kvn"], eps)
    kr = mm("wkr", x)                               # (B,S,dr)

    cos, sin = rope_tables(positions, dr, cfg.rope_theta, cfg.rope_scaling)
    q_r = apply_rope(q_r, cos, sin)
    kr = apply_rope(kr[..., None, :], cos, sin)[..., 0, :]

    if cache is not None:
        pos = cache["pos"]
        ckv_all = _write(cache["ckv"], ckv, pos)
        kr_all = _write(cache["kr"], kr, pos)
        new_cache = {"ckv": ckv_all, "kr": kr_all, "pos": pos + s}
        q_pos0, t_valid = pos, pos + s
    else:
        ckv_all, kr_all = ckv, kr
        new_cache = None
        q_pos0, t_valid = 0, s
    t_len = ckv_all.shape[-2]

    # expand the compressed cache, all of it, to per-head keys/values
    k_n = mm("wuk", ckv_all)
    v = mm("wuv", ckv_all)
    k_n = sharded_reshape(k_n, (*k_n.shape[:-1], h, dn))
    v = sharded_reshape(v, (*v.shape[:-1], h, dv))

    dt = cfg.dtype
    if cfg.attn_impl == "chunked":
        def core(qn_, qr_, kn_, v_, kr_):
            return _mla_core_chunked(qn_, qr_, kn_, kr_, v_, q_pos0,
                                     t_valid, cfg)
    else:
        bias = causal_bias(q_pos0, s, t_len, x.device)

        def core(qn_, qr_, kn_, v_, kr_):
            return _mla_core(qn_, qr_, kn_, kr_, v_, bias, cfg)
    # the shared rope key gains a unit head axis, so that every operand
    # of the core has (B,T,H,D)'s rank and a bank lane axis in front
    ops = (q_n.to(dt), q_r.to(dt), k_n.to(dt), v.to(dt),
           kr_all.to(dt)[..., None, :])
    out = each_lane(lambda qn_, qr_, kn_, v_, kr_: core(
        qn_, qr_, kn_, v_, kr_[..., 0, :]), lanes_of(4, *ops), 4, *ops)
    out = sharded_reshape(out, (*out.shape[:-2], h * dv))
    return mm("wo", out).to(dt), new_cache


def lane_mla_attention(params, x, cfg: LMConfig, policy: ApproxPolicy, *,
                       positions: torch.Tensor, cache, at: tuple,
                       layer_tag: str = "mla") -> torch.Tensor:
    """One decode step of n requests, each a bank lane: x (n,1,D),
    positions (n,1).  ``wdq``, ``wuq``, ``wqr``, ``wdkv``, ``wkr`` and
    ``wo`` run once for all lanes, RoPE at each lane's position; each
    lane's new ``ckv``/``kr`` row goes to its slot of ``cache``
    (``serve.kv_cache.LaneCaches``, leaves ``at = (prefix, g)``), and
    ``wuk``/``wuv`` expand every lane's whole view in one banked call
    each, the views zero-padded to the longest.  The norms and the core
    run lane by lane at B=1 over the lane's T_i rows, so each lane
    equals a sequential B=1 decode over a T_i-row cache bit for bit."""
    n, h = x.shape[0], cfg.n_heads
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    eps, dt = cfg.norm_eps, cfg.dtype

    def mm(name, a):
        return policy.matmul(f"{layer_tag}.{name}", a, params[name],
                             lanes=True)

    cq = lane_rms_norm(mm("wdq", x), params["qn"], eps)
    q_n = mm("wuq", cq).reshape(n, 1, h, dn)
    q_r = mm("wqr", cq).reshape(n, 1, h, dr)
    ckv = lane_rms_norm(mm("wdkv", x), params["kvn"], eps)
    kr = mm("wkr", x)                               # (n,1,dr)
    cos, sin = rope_tables(positions, dr, cfg.rope_theta, cfg.rope_scaling)
    q_r = apply_rope(q_r, cos, sin)
    kr = apply_rope(kr[..., None, :], cos, sin)[..., 0, :]
    views = cache.rows_of(*at, {"ckv": ckv, "kr": kr})

    # every lane's latent view, zero rows past its length
    lens = [v["ckv"].shape[1] for v in views]
    lat = views[0]["ckv"].new_zeros((n, max(lens), cfg.kv_lora))
    for i, v in enumerate(views):
        lat[i, :lens[i]] = v["ckv"][0]
    k_n, v_all = mm("wuk", lat), mm("wuv", lat)

    outs = []
    for i, (view, t) in enumerate(zip(views, lens)):
        ops = (q_n[i:i + 1].to(dt).clone(), q_r[i:i + 1].to(dt).clone(),
               k_n[i:i + 1, :t].reshape(1, t, h, dn).to(dt).clone(),
               view["kr"].to(dt),
               v_all[i:i + 1, :t].reshape(1, t, h, dv).to(dt).clone())
        if cfg.attn_impl == "chunked":
            p = cache.pos[i]
            outs.append(_mla_core_chunked(*ops, p, p + 1, cfg))
        else:
            outs.append(_mla_core(*ops, cache.bias(i), cfg))
    out = torch.cat(outs).reshape(n, 1, h * dv)
    return mm("wo", out).to(dt)


def init_mla_cache(cfg: LMConfig, batch: int, max_len: int, device=None,
                   lead: tuple = ()) -> dict:
    return {
        "ckv": torch.zeros((*lead, batch, max_len, cfg.kv_lora),
                           dtype=cfg.dtype, device=device),
        "kr": torch.zeros((*lead, batch, max_len, cfg.rope_head_dim),
                          dtype=cfg.dtype, device=device),
        "pos": 0,
    }
