"""Mixture-of-Experts layer with sort-based, capacity-bounded dispatch
(port of ``repro.models.moe``).

Dispatch builds an (E, C, d) buffer by a stable sort of the routed
slots (O(T·k) memory, no (T, E) one-hot), each expert runs its own
capacity buffer through the approximate datapath, and the combine
gathers back with the routing weights.  Slots past the capacity
``C = min(T·k, max(ceil(T·k/E · capacity_factor), 4))`` are dropped
(GShard-style).  Shared experts (DeepSeek-V2) are a dense FFN over all
tokens, added to the routed output.

Differences from the reference, none of which changes a value:
  * ``_expert_matmul`` calls the datapath once per expert and
    projection where the reference ``vmap``s it over experts; each
    expert calibrates and quantizes its own (C, d) buffer (zero-padded
    capacity rows included) and its own (d, f) weight, as each ``vmap``
    lane does;
  * the dispatch writes only the slots inside the capacity: a dropped
    slot's write goes to one spare row past the buffer (the reference's
    ``mode="drop"``), so every shape is known before the data and the
    prefill runs on the ``meta`` device;
  * under a banked backend every bank lane routes its own tokens, as the
    reference's ``vmap`` over lanes does: routing, top-k, dispatch and
    combine run lane by lane at the sequential shapes, and each expert's
    projection is ONE banked call over all lanes (K2/K4 with ``C`` rows
    a lane) — in the continuous engine's decode step too, where each
    running request routes its one token alone (``capacity(cfg, 1)``
    rows a lane).
The reference's ``_moe_blocked`` is called by nothing in the reference
and is not ported.

Without block-local dispatch (``moe_blocks <= 1``) the expert buffer is
hinted onto the ``model`` axis (expert parallelism) under an ambient
mesh, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..approx.layers import ApproxPolicy
from ..launch.mesh import sharded_reshape
from .common import (LMConfig, activation, dense_init, ffn, hint_axis,
                     init_ffn)


def init_moe(gen: torch.Generator, cfg: LMConfig, lead: tuple = ()
             ) -> dict:
    """Router, stacked (E, d, f) expert weights and shared experts, with
    ``lead`` stacked leading dims (layer groups)."""
    e, d = cfg.n_experts, cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": dense_init(gen, (*lead, d, e), scale=0.02),
        "wi": dense_init(gen, (*lead, e, d, f)),
        "wo": dense_init(gen, (*lead, e, f, d)),
    }
    if cfg.act == "silu":
        p["wg"] = dense_init(gen, (*lead, e, d, f))
    if cfg.n_shared_experts > 0:
        p["shared"] = init_ffn(gen, cfg, d_ff=f * cfg.n_shared_experts,
                               lead=lead)
    return p


def capacity(cfg: LMConfig, t: int) -> int:
    """Slots an expert keeps for ``t`` tokens: a floor of 4 and a
    ceiling of t·k (tiny decode batches would otherwise drop tokens a
    full forward keeps)."""
    k = cfg.top_k
    return int(min(t * k, max(math.ceil(t * k / cfg.n_experts
                                        * cfg.capacity_factor), 4)))


@dataclass
class Route:
    """One lane's routing of its (T, D) tokens."""
    top_w: torch.Tensor        # (T, k) f32, renormalised
    order: torch.Tensor        # (T·k,) stable sort of the slots by expert
    sorted_e: torch.Tensor     # (T·k,) expert of each sorted slot
    pos_in_e: torch.Tensor     # (T·k,) its position in that expert
    aux: torch.Tensor          # () f32 load-balance loss


def route(params, xf: torch.Tensor, cfg: LMConfig) -> Route:
    """Routing and the sort-based dispatch plan of xf (T, D)."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.matmul(xf.to(torch.float32),
                          params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, k, dim=-1)         # (T, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    # aux loss (Switch-style): E * sum_e f_e * p_e
    flat_e = sharded_reshape(top_ids, (-1,))             # (T·k,)
    me = torch.mean(probs, dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=xf.device)
    ce = ce.index_add(0, flat_e, torch.full(flat_e.shape, 1.0 / (t * k),
                                            device=xf.device))
    aux = e * torch.sum(me * ce)

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros((e,), dtype=torch.int64, device=xf.device)
    counts = counts.index_add(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=0) - counts
    pos_in_e = torch.arange(t * k, device=xf.device) - starts[sorted_e]
    return Route(top_w, order, sorted_e, pos_in_e, aux)


def dispatch(xf: torch.Tensor, r: Route, cfg: LMConfig) -> torch.Tensor:
    """The (E, C, D) expert buffers of xf (T, D): each kept slot's token
    at (expert, position), zeros elsewhere; a dropped slot writes the
    spare row past the buffer."""
    t, d = xf.shape
    e, k, cap = cfg.n_experts, cfg.top_k, capacity(cfg, t)
    row = torch.where(r.pos_in_e < cap, r.sorted_e * cap + r.pos_in_e,
                      e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_put((row,), xf[r.order // k])
    return sharded_reshape(buf[:e * cap], (e, cap, d))


def combine(out_buf: torch.Tensor, r: Route, cfg: LMConfig
            ) -> torch.Tensor:
    """(E, C, D) expert outputs -> (T, D): each slot's row weighted by
    its routing weight, dropped slots zero."""
    cap = out_buf.shape[1]
    t, k = r.top_w.shape
    gathered = out_buf[r.sorted_e, torch.clamp_max(r.pos_in_e, cap - 1)]
    gathered = torch.where((r.pos_in_e < cap)[:, None], gathered, 0.0)
    slot_out = torch.zeros((t * k, out_buf.shape[-1]), dtype=out_buf.dtype,
                           device=out_buf.device)
    slot_out = slot_out.index_put((r.order,), gathered)
    slot_out = sharded_reshape(slot_out, (t, k, -1))
    return torch.sum(slot_out * r.top_w[..., None].to(slot_out.dtype),
                     dim=1)


def _expert_matmul(policy: ApproxPolicy, name: str, x: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """x: (E,C,d) @ w: (E,d,f) -> (E,C,f), one datapath call an expert
    (``policy.matmul``, so a counting policy sees each); x (n,E,C,d)
    with a bank lane axis, or a banked backend, gives (n,E,C,f)."""
    lanes = x.ndim == 4
    return torch.stack([
        policy.matmul(name, x[:, j].contiguous() if lanes else x[j], w[j],
                      lanes=lanes)
        for j in range(w.shape[0])], dim=-3)


def moe_ffn(params, x, cfg: LMConfig, policy: ApproxPolicy,
            layer_tag: str = "moe", lanes: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D), or (n,B,S,D) with a bank lane axis -> the same shape,
    and the aux load-balance loss (scalar f32, or (n,) under lanes).
    ``lanes``: x's batch axis is a bank lane axis (the continuous
    engine's prefill and decode step): each batch row routes its own S
    tokens alone, as (n,1,S,D) does.

    With ``cfg.moe_blocks > 1`` dispatch runs block-locally (capacity
    per block), as the reference's ``vmap`` over token blocks."""
    if lanes:
        y, aux = moe_ffn(params, x[:, None], cfg, policy, layer_tag)
        return y[:, 0], aux
    b, s, d = x.shape[-3:]
    lead = x.shape[:-3]
    t = b * s
    nb = cfg.moe_blocks
    if nb > 1 and t % nb == 0 and t // nb >= cfg.top_k:
        xb = sharded_reshape(x, (*lead, nb, t // nb, d))
        outs = [_moe_tokens(params, xb[..., j, :, :], cfg, policy,
                            layer_tag) for j in range(nb)]
        y = torch.stack([o[0] for o in outs], dim=-3)
        aux = torch.mean(torch.stack([o[1] for o in outs], dim=-1), dim=-1)
        return (sharded_reshape(y, (*y.shape[:-3], b, s, d)).to(x.dtype),
                aux)
    y, aux = _moe_tokens(params, sharded_reshape(x, (*lead, t, d)), cfg,
                         policy, layer_tag)
    return sharded_reshape(y, (*y.shape[:-2], b, s, d)).to(x.dtype), aux


def _moe_tokens(params, xf, cfg: LMConfig, policy: ApproxPolicy,
                layer_tag: str = "moe") -> tuple[torch.Tensor, torch.Tensor]:
    """xf: (T,D), or (n,T,D) with a bank lane axis -> the same, aux."""
    lanes = xf.ndim == 3
    xs = [xf[i].clone() for i in range(xf.shape[0])] if lanes else [xf]
    routes = [route(params, x, cfg) for x in xs]
    bufs = [dispatch(x, r, cfg) for x, r in zip(xs, routes)]
    buf = torch.stack(bufs) if lanes else bufs[0]
    if cfg.moe_blocks <= 1 and not lanes:
        buf = hint_axis(buf, 0, "model")   # EP: expert dim on 'model'

    hidden = _expert_matmul(policy, f"{layer_tag}.wi", buf, params["wi"])
    if cfg.act == "silu":
        gate = _expert_matmul(policy, f"{layer_tag}.wg", buf, params["wg"])
        hidden = F.silu(gate) * hidden
    else:
        hidden = activation(hidden, cfg.act)
    out_buf = _expert_matmul(policy, f"{layer_tag}.wo",
                             hidden.to(xf.dtype), params["wo"])

    if out_buf.ndim == 4:               # lanes, from xf or a banked backend
        y = torch.stack([
            combine(out_buf[i].clone(), routes[i if lanes else 0], cfg)
            for i in range(out_buf.shape[0])])
    else:
        y = combine(out_buf, routes[0], cfg)
    aux = torch.stack([r.aux for r in routes]) if lanes else routes[0].aux

    if cfg.n_shared_experts > 0:
        y = y + ffn(params["shared"], xf, cfg, policy,
                    layer_tag=f"{layer_tag}.shared",
                    lanes=lanes).to(y.dtype)
    return y.to(xf.dtype), aux
