"""Mamba-2 SSD block (port of ``repro.models.mamba2``; state-space
duality, arXiv:2405.21060).

Chunked quadratic-within / linear-across implementation:
  * intra-chunk term: (C Bᵀ ⊙ L) x̄  with L the causal decay matrix,
  * inter-chunk term: a sequential pass over per-chunk states (the
    reference's ``lax.scan``, a Python loop here),
  * O(1)-state decode step.

Projections flow through the ApproxPolicy; the conv, the SSD einsums,
the gating and the norm stay exact f32 (they are the data-dependent
"attention" of the SSM; ``approx.modules.EXACT_FAMILIES``).  Under a
banked backend ``in_proj`` and ``out_proj`` are one banked call each for
all lanes, and everything between them runs lane by lane at the
sequential shapes (``_mix``).  The continuous engine's decode step
(``lane_mamba_block``) does the same for its running requests, each on
its own slot's conv and SSM state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..approx.layers import ApproxPolicy
from .common import LMConfig, dense_init, randn, rms_norm


def ssm_dims(cfg: LMConfig) -> dict:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n            # x + B + C (single group)
    return dict(d_inner=d_inner, n_heads=n_heads, n=n, conv_dim=conv_dim)


def init_mamba(gen: torch.Generator, cfg: LMConfig, lead: tuple = ()
               ) -> dict:
    """Mamba weights with ``lead`` stacked leading dims (layer groups).
    ``a_log``, ``d_skip``, ``dt_bias`` and ``norm`` are deterministic, as
    in the reference; the rest is drawn from ``gen``."""
    dd = ssm_dims(cfg)
    d_in = cfg.d_model
    d_proj = 2 * dd["d_inner"] + 2 * dd["n"] + dd["n_heads"]
    dev = gen.device
    h = dd["n_heads"]
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=dev))
    return {
        "in_proj": dense_init(gen, (*lead, d_in, d_proj)),
        "out_proj": dense_init(gen, (*lead, dd["d_inner"], d_in)),
        "conv_w": (randn(gen, (*lead, cfg.conv_width, dd["conv_dim"]))
                   / np.sqrt(cfg.conv_width)),
        "a_log": a_log.expand(*lead, h).clone(),
        "d_skip": torch.ones((*lead, h), device=dev),
        "dt_bias": torch.zeros((*lead, h), device=dev),
        "norm": torch.ones((*lead, dd["d_inner"]), device=dev),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. xbc: (B,S,C); w: (W,C).
    state: (B,W-1,C) previous inputs for decode continuity.
    Returns (y, new_state)."""
    b, s, c = xbc.shape
    wlen = w.shape[0]
    if state is None:
        state = torch.zeros((b, wlen - 1, c), dtype=xbc.dtype,
                            device=xbc.device)
    full = torch.cat([state, xbc], dim=1)               # (B, S+W-1, C)
    y = torch.zeros((b, s, c), dtype=torch.float32, device=xbc.device)
    for i in range(wlen):  # W is tiny (4): unrolled shifts, as the reference
        y = y + full[:, i:i + s, :].to(torch.float32) * w[i]
    new_state = full[:, -(wlen - 1):, :]
    return F.silu(y).to(xbc.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in its own formula."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int,
                 init_state: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x: (B,S,H,P); dt: (B,S,H) (post-softplus);
    a: (H,) negative; b_mat/c_mat: (B,S,N).  Returns y: (B,S,H,P) and
    final state (B,H,P,N)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, "seq must divide chunk"
    nc = s // q

    la = dt * a[None, None, :]                       # (B,S,H) log-decay
    xbar = x * dt[..., None]                         # (B,S,H,P)

    la_c = la.reshape(bsz, nc, q, h)
    cum = torch.cumsum(la_c, dim=2)                  # (B,NC,Q,H)
    x_c = xbar.reshape(bsz, nc, q, h, p)
    b_c = b_mat.reshape(bsz, nc, q, n)
    c_c = c_mat.reshape(bsz, nc, q, n)

    # intra-chunk: M[i,j] = exp(cum_i - cum_j) * (c_i . b_j), i >= j;
    # masked inside the exponent, as in the reference
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,NC,Q,Q,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    l_mat = torch.exp(torch.where(causal, diff, -1e30))
    cb = torch.einsum("bcin,bcjn->bcij", c_c, b_c)
    m = cb[..., None] * l_mat                               # (B,NC,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, x_c)

    # per-chunk input state: S_c = sum_j exp(cum_last - cum_j) b_j (x) x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (B,NC,Q,H)
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchpn",
                           decay_to_end, b_c, x_c)

    # inter-chunk: sequential state pass (the state BEFORE each chunk)
    chunk_decay = torch.exp(torch.sum(la_c, dim=2))         # (B,NC,H)
    state = (init_state if init_state is not None else
             torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = (state * chunk_decay[:, c, :, None, None]
                 + s_chunk[:, c])
    prev_states = torch.stack(prev, dim=1)                  # (B,NC,H,P,N)

    # y_inter[i] = exp(cum_i) * c_i . state_{c-1}
    y_inter = torch.einsum("bcih,bcin,bchpn->bcihp",
                           torch.exp(cum), c_c, prev_states)

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, state


def _mix(params, proj, cfg: LMConfig, cache: Optional[dict]
         ) -> tuple[torch.Tensor, Optional[dict]]:
    """Everything between the two projections, for one lane: proj
    (B,S,d_proj) -> (y (B,S,d_inner) normed, new cache)."""
    bsz, s, _ = proj.shape
    dd = ssm_dims(cfg)
    di, h, n, p = dd["d_inner"], dd["n_heads"], dd["n"], cfg.ssm_head_dim
    z, xs, b_mat, c_mat, dt = torch.split(proj, [di, di, n, n, h], dim=-1)

    xbc = torch.cat([xs, b_mat, c_mat], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], conv_state)
    xs, b_mat, c_mat = torch.split(xbc, [di, n, n], dim=-1)

    dt = _softplus(dt.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    xs_h = xs.reshape(bsz, s, h, p).to(torch.float32)
    b32 = b_mat.to(torch.float32)
    c32 = c_mat.to(torch.float32)

    if cache is None:
        y, _final = _ssd_chunked(xs_h, dt, a, b32, c32, cfg.ssm_chunk)
        new_cache = None
    elif s == 1:
        state = cache["state"]                       # (B,H,P,N)
        dtl = dt[:, 0, :]                            # (B,H)
        dec = torch.exp(dtl * a[None, :])
        upd = torch.einsum("bh,bhp,bn->bhpn", dtl, xs_h[:, 0], b32[:, 0])
        state = state * dec[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", c32[:, 0], state)[:, None]
        new_cache = {"conv": new_conv, "state": state}
    else:  # prefill with cache carry-out
        y, final = _ssd_chunked(xs_h, dt, a, b32, c32, cfg.ssm_chunk)
        new_cache = {"conv": new_conv, "state": final}

    y = y + xs_h * params["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = y * F.silu(z.to(torch.float32))
    return rms_norm(y.to(cfg.dtype), params["norm"], cfg.norm_eps), new_cache


def mamba_block(params, x, cfg: LMConfig, policy: ApproxPolicy, *,
                cache: Optional[dict] = None, layer_tag: str = "mamba",
                lanes: bool = False) -> tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,D), or (n,B,S,D) with a bank lane axis.  cache =
    {"conv": (B,W-1,C), "state": (B,H,P,N)} (each with the lane axis in
    front when a banked call made one) for O(1) decode; None for a
    full-sequence prefill from zero.  ``lanes``: x's batch axis is a
    bank lane axis (the continuous engine's B=1 prefill)."""
    proj = policy.matmul(f"{layer_tag}.in_proj", x, params["in_proj"],
                         lanes=lanes or x.ndim == 4)
    n = proj.shape[0] if proj.ndim == 4 else None
    if n is None:
        y, new_cache = _mix(params, proj, cfg, cache)
    else:
        ys, caches = [], []
        for i in range(n):
            sub = cache
            if cache is not None and cache["state"].ndim == 5:
                sub = {k: v[i] for k, v in cache.items()}
            y_i, c_i = _mix(params, proj[i].clone(), cfg, sub)
            ys.append(y_i)
            caches.append(c_i)
        y = torch.stack(ys)
        new_cache = (None if caches[0] is None else
                     {k: torch.stack([c[k] for c in caches])
                      for k in caches[0]})
    out = policy.matmul(f"{layer_tag}.out_proj", y, params["out_proj"],
                        lanes=lanes or y.ndim == 4)
    return out.to(cfg.dtype), new_cache


def lane_mamba_block(params, x, cfg: LMConfig, policy: ApproxPolicy, *,
                     cache, at: tuple, layer_tag: str = "mamba"
                     ) -> torch.Tensor:
    """One decode step of n requests, each a bank lane: x (n,1,D).
    ``in_proj`` and ``out_proj`` run once for all lanes; ``_mix`` runs
    lane by lane at B=1 on the lane's own ``conv``/``state`` rows of the
    leaves ``at = (prefix, g)`` of ``cache`` (``serve.kv_cache.
    LaneCaches``), whose new rows go back to it, as a sequential B=1
    ``forward_decode`` runs it."""
    proj = policy.matmul(f"{layer_tag}.in_proj", x, params["in_proj"],
                         lanes=True)
    ys, new = [], []
    for i, state in enumerate(cache.state(*at, ("conv", "state"))):
        y_i, new_i = _mix(params, proj[i:i + 1].clone(), cfg, state)
        ys.append(y_i)
        new.append(new_i)
    cache.update(*at, new)
    out = policy.matmul(f"{layer_tag}.out_proj", torch.cat(ys),
                        params["out_proj"], lanes=True)
    return out.to(cfg.dtype)


def init_mamba_cache(cfg: LMConfig, batch: int, device=None,
                     lead: tuple = ()) -> dict:
    dd = ssm_dims(cfg)
    return {
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1,
                             dd["conv_dim"]), dtype=cfg.dtype,
                            device=device),
        "state": torch.zeros((*lead, batch, dd["n_heads"],
                              cfg.ssm_head_dim, dd["n"]),
                             dtype=torch.float32, device=device),
    }
