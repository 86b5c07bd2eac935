"""The work a pass needs, counted from its shapes alone, for the cells
whose projections ``counts.py`` does not list: a latent-attention
decoder with DeepSeekMoE layers and one chip's share of the routed
experts, and a sweep that banks one layer at a time.  The conventions
are ``counts.py``'s (``Projection``, ``pass_work``)."""
from __future__ import annotations

from perfbench.counts import Projection, pass_work


def mla_moe_projections(tokens: int, n_layers: int, first_dense: int,
                        d_model: int, n_heads: int, q_lora: int,
                        kv_lora: int, nope_dim: int, rope_dim: int,
                        v_dim: int, dense_width: int, expert_width: int,
                        shared_width: int, top_k: int, n_experts: int,
                        held: int) -> list[Projection]:
    """Every layer's eight latent-attention projections at ``tokens``
    rows; the leading dense layers' SwiGLU (``dense_width``) and the MoE
    layers' shared experts (``shared_width``) at ``tokens`` rows; the
    held experts' wi, wg, wo at the routed slots that fall on them on
    average, ``tokens * top_k * held / n_experts`` (the slots, not the
    capacity rows a dispatch pads them to)."""
    slots = tokens * top_k * held // n_experts
    out = []
    for g in range(n_layers):
        t = f"l{g}"
        out += [Projection(f"{t}.mla.wdq", tokens, d_model, q_lora),
                Projection(f"{t}.mla.wuq", tokens, q_lora,
                           n_heads * nope_dim),
                Projection(f"{t}.mla.wqr", tokens, q_lora,
                           n_heads * rope_dim),
                Projection(f"{t}.mla.wdkv", tokens, d_model, kv_lora),
                Projection(f"{t}.mla.wkr", tokens, d_model, rope_dim),
                Projection(f"{t}.mla.wuk", tokens, kv_lora,
                           n_heads * nope_dim),
                Projection(f"{t}.mla.wuv", tokens, kv_lora, n_heads * v_dim),
                Projection(f"{t}.mla.wo", tokens, n_heads * v_dim, d_model)]
        if g < first_dense:
            out += [Projection(f"{t}.ffn.wi", tokens, d_model, dense_width),
                    Projection(f"{t}.ffn.wg", tokens, d_model, dense_width),
                    Projection(f"{t}.ffn.wo", tokens, dense_width, d_model)]
            continue
        out += [Projection(f"{t}.moe.shared.wi", tokens, d_model,
                           shared_width),
                Projection(f"{t}.moe.shared.wg", tokens, d_model,
                           shared_width),
                Projection(f"{t}.moe.shared.wo", tokens, shared_width,
                           d_model),
                Projection(f"{t}.moe.wi", slots, d_model, expert_width,
                           weight_copies=held),
                Projection(f"{t}.moe.wg", slots, d_model, expert_width,
                           weight_copies=held),
                Projection(f"{t}.moe.wo", slots, expert_width, d_model,
                           weight_copies=held)]
    return out


def one_layer_at_a_time(projections, lanes: int) -> dict:
    """Lookups and least bytes of a sweep that banks each of
    ``projections`` alone in turn (the rest exact and unbanked), so each
    banked layer's input is one for all lanes: ``pass_work`` of each
    with its input shared, summed."""
    total = {"lookups": 0, "bytes": 0}
    for p in projections:
        w = pass_work([p], lanes, shared_input=p.name)
        total = {k: total[k] + w[k] for k in total}
    return total
