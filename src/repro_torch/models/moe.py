"""Mixture-of-Experts layer with sort-based, capacity-bounded dispatch
(port of ``repro.models.moe``).

Dispatch builds an (E, C, d) buffer by a stable sort of the routed
slots (O(T·k) memory, no (T, E) one-hot), each expert runs its own
capacity buffer through the approximate datapath, and the combine
gathers back with the routing weights.  Slots past the capacity
``C = min(T·k, max(ceil(T·k/E · capacity_factor), 4))`` are dropped
(GShard-style).  Shared experts (DeepSeek-V2) are a dense FFN over all
tokens, added to the routed output.

``_expert_matmul`` makes ONE datapath call a projection for all the
experts (``policy.matmul(experts=True)``), as the reference's ``vmap``
over experts hands its kernel the batched weights, in every mode: under
``lut`` with ``variant="pallas"`` (``"fused"``) one K1/K2 or K5/K6
(K3/K4 or K7/K8) launch for every expert and bank lane, under
``lowrank``/``pallas`` one K9 launch, ``int8`` one exact batched
product, ``f32``/``bf16`` one batched matmul and prepared ``lowrank``
weights one batched product; each expert calibrates and quantizes its
own (C, d) buffer (zero-padded capacity rows and a starved expert's
all-zero buffer included) and its own (d, f) weight, as each ``vmap``
lane does.  Only a quantized backend under autograd (the STE) runs one
call an expert inside that call.

Differences from the reference, none of which changes a value:
  * the dispatch writes only the slots inside the capacity: a dropped
    slot's write goes to one spare row past the buffer (the reference's
    ``mode="drop"``), so every shape is known before the data and the
    prefill runs on the ``meta`` device;
  * under a banked backend every bank lane routes its own tokens, as the
    reference's ``vmap`` over lanes does: routing, top-k, dispatch and
    combine run lane by lane at the sequential shapes, and each
    projection is ONE banked call over all lanes and experts (K2/K4 with
    ``C`` rows a (lane, expert) pair) — in the continuous engine's
    decode step too, where each running request routes its one token
    alone (``capacity(cfg, 1)`` rows a pair);
  * block-local dispatch (``moe_blocks > 1``, the reference's ``vmap``
    over token blocks) routes and dispatches block by block and puts
    the blocks' expert buffers one after another on the expert axis, so
    a projection is still one call (the shared experts run block by
    block, each block calibrated on its own).
The reference's ``_moe_blocked`` is called by nothing in the reference
and is not ported.

Beyond the reference, for DeepSeek-V2 as published (``LMConfig``'s own
fields, whose defaults leave every path above as it was):
  * group-limited routing (``n_group``, ``topk_group``): a group's score
    is its largest routing probability, a token picks its top-k among
    the experts of its ``topk_group`` best groups; the weights are
    times ``routed_scaling``, renormalised only with ``norm_topk_prob``;
  * a chip's share of the experts (``expert_first``, ``experts_held``),
    as expert parallelism holds them: routing, the capacity and the aux
    loss stay over all ``n_experts``, while the buffers, weights and
    projections exist for the held experts alone and only slots on them
    are combined, so the chip's output is its experts' part of the
    layer's (the shared experts run whole on every chip).  The counters
    ``moe.held_slots`` (slots kept on held experts) and
    ``moe.capacity_rows`` (held experts x capacity, a lane) give the
    share of the expert projections' rows that carry a token.

Without block-local dispatch (``moe_blocks <= 1``) the expert buffer is
hinted onto the ``model`` axis (expert parallelism) under an ambient
mesh, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import obs
from ..approx.layers import ApproxPolicy
from ..launch.mesh import sharded_reshape
from .common import (LMConfig, activation, dense_init, ffn, hint_axis,
                     init_ffn)


def init_moe(gen: torch.Generator, cfg: LMConfig, lead: tuple = ()
             ) -> dict:
    """Router (over all ``n_experts``), the held experts' stacked
    (E_held, d, f) weights and shared experts, with ``lead`` stacked
    leading dims (layer groups)."""
    e, d = len(cfg.held_experts), cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": dense_init(gen, (*lead, d, cfg.n_experts), scale=0.02),
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
    top_w: torch.Tensor        # (T, k) f32 routing weights
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
    top_w, top_ids = torch.topk(_group_limited(probs, cfg), k, dim=-1)
    if cfg.norm_topk_prob:
        top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    if cfg.routed_scaling != 1.0:
        top_w = top_w * cfg.routed_scaling

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


def _group_limited(probs: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """``probs`` (T, E) with the experts outside each token's
    ``topk_group`` best groups zeroed (a group's score: its largest
    probability); ``probs`` itself without groups."""
    g = cfg.n_group
    if g <= 1:
        return probs
    t, e = probs.shape
    best = probs.view(t, g, e // g).amax(dim=-1)          # (T, groups)
    keep = torch.zeros_like(best, dtype=torch.bool)
    keep.scatter_(1, torch.topk(best, cfg.topk_group, dim=-1).indices,
                  True)
    keep = keep[:, :, None].expand(t, g, e // g).reshape(t, e)
    return probs.masked_fill(~keep, 0.0)


def _held_slots(r: Route, cfg: LMConfig, cap: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(each sorted slot's held expert, counted from the first held and
    clamped to the held ones; whether the slot is kept: inside the
    capacity and, for a share, on a held expert)."""
    kept = r.pos_in_e < cap
    held = cfg.held_experts
    if len(held) == cfg.n_experts:
        return r.sorted_e, kept
    local = r.sorted_e - held.start
    kept = kept & (local >= 0) & (local < len(held))
    return torch.clamp(local, 0, len(held) - 1), kept


def dispatch(xf: torch.Tensor, r: Route, cfg: LMConfig) -> torch.Tensor:
    """The (E_held, C, D) expert buffers of xf (T, D): each kept slot's
    token at (held expert, position), zeros elsewhere; a dropped slot,
    or one on an expert held elsewhere, writes the spare row past the
    buffer."""
    t, d = xf.shape
    e, k, cap = len(cfg.held_experts), cfg.top_k, capacity(cfg, t)
    local, kept = _held_slots(r, cfg, cap)
    obs.count("moe.held_slots", kept)
    obs.count("moe.capacity_rows", e * cap)
    row = torch.where(kept, local * cap + r.pos_in_e, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_put((row,), xf[r.order // k])
    return sharded_reshape(buf[:e * cap], (e, cap, d))


def combine(out_buf: torch.Tensor, r: Route, cfg: LMConfig
            ) -> torch.Tensor:
    """(E_held, C, D) expert outputs -> (T, D): each slot's row weighted
    by its routing weight, dropped slots and slots on experts held
    elsewhere zero."""
    cap = out_buf.shape[1]
    t, k = r.top_w.shape
    local, kept = _held_slots(r, cfg, cap)
    gathered = out_buf[local, torch.clamp_max(r.pos_in_e, cap - 1)]
    gathered = torch.where(kept[:, None], gathered, 0.0)
    slot_out = torch.zeros((t * k, out_buf.shape[-1]), dtype=out_buf.dtype,
                           device=out_buf.device)
    slot_out = slot_out.index_put((r.order,), gathered)
    slot_out = sharded_reshape(slot_out, (t, k, -1))
    return torch.sum(slot_out * r.top_w[..., None].to(slot_out.dtype),
                     dim=1)


def _expert_matmul(policy: ApproxPolicy, name: str, x: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """x: (X,C,d) @ w: (E,d,f) -> (X,C,f), buffer s against expert s % E
    (X = E, or token blocks' buffers one after another): ONE datapath
    call for every expert (``policy.matmul(experts=True)``, so a
    counting policy sees one); x (n,X,C,d) with a bank lane axis, or a
    banked backend, gives (n,X,C,f)."""
    return policy.matmul(name, x, w, lanes=x.ndim == 4, experts=True)


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
    if not (nb > 1 and t % nb == 0 and t // nb >= cfg.top_k):
        nb = 1
    y, aux = _moe_tokens(params, sharded_reshape(x, (*lead, t, d)), cfg,
                         policy, layer_tag, nb)
    return sharded_reshape(y, (*y.shape[:-2], b, s, d)).to(x.dtype), aux


def _moe_tokens(params, xf, cfg: LMConfig, policy: ApproxPolicy,
                layer_tag: str = "moe", blocks: int = 1
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """xf: (T,D), or (n,T,D) with a bank lane axis -> the same, aux.
    ``blocks`` > 1: dispatch block-locally over that many contiguous
    token blocks (capacity a block), their buffers one after another on
    the expert axis; aux is the blocks' mean."""
    lanes = xf.ndim == 3
    xs = [xf[i].clone() for i in range(xf.shape[0])] if lanes else [xf]
    tb = xf.shape[-2] // blocks
    # lane-major, block-minor (a lane's blocks follow one another)
    parts = ([x[j * tb:(j + 1) * tb] for x in xs for j in range(blocks)]
             if blocks > 1 else xs)
    with obs.span("model.moe.route"):
        routes = [route(params, x, cfg) for x in parts]
    with obs.span("model.moe.dispatch"):
        bufs = [dispatch(x, r, cfg) for x, r in zip(parts, routes)]
    if lanes or blocks > 1:             # (n,) blocks x E buffers
        buf = torch.stack(bufs)
        e, cap, d = buf.shape[-3:]
        buf = sharded_reshape(buf, ((len(xs),) if lanes else ())
                              + (blocks * e, cap, d))
    else:
        buf = bufs[0]
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

    # one combine a (lane, block): a banked backend on unbanked tokens
    # gives every lane its own buffers over the one routing
    n_out = out_buf.shape[0] if out_buf.ndim == 4 else 1
    per = out_buf.reshape(n_out * blocks, -1, *out_buf.shape[-2:])
    with obs.span("model.moe.combine"):
        ys = [combine(per[i].clone() if out_buf.ndim == 4 else per[i],
                      routes[i if lanes else i % blocks], cfg)
              for i in range(n_out * blocks)]
    if blocks > 1:
        ys = [torch.cat(ys[i:i + blocks]) for i in range(0, len(ys), blocks)]
    y = torch.stack(ys) if out_buf.ndim == 4 else ys[0]
    auxes = [r.aux for r in routes]
    if lanes:
        auxes = [torch.stack(auxes[j::blocks]) for j in range(blocks)]
    aux = (torch.mean(torch.stack(auxes, dim=-1), dim=-1) if blocks > 1
           else auxes[0])

    if cfg.n_shared_experts > 0:
        y = y + _shared(params["shared"], xf, cfg, policy, layer_tag,
                        lanes, blocks).to(y.dtype)
    return y.to(xf.dtype), aux


def _shared(params, xf, cfg: LMConfig, policy: ApproxPolicy,
            layer_tag: str, lanes: bool, blocks: int) -> torch.Tensor:
    """The shared experts' FFN over xf, block by block when dispatch is
    block-local (each block calibrated on its own, as under the
    reference's ``vmap`` over blocks)."""
    tag = f"{layer_tag}.shared"
    if blocks <= 1:
        return ffn(params, xf, cfg, policy, layer_tag=tag, lanes=lanes)
    tb = xf.shape[-2] // blocks
    return torch.cat([ffn(params, xf[..., j * tb:(j + 1) * tb, :], cfg,
                          policy, layer_tag=tag, lanes=lanes)
                      for j in range(blocks)], dim=-2)
