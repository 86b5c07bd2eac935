"""The work a pass needs, counted from its shapes alone.

Each approximated projection is ``(rows, K, N)``: ``rows * K * N`` table
lookups a bank lane.  Bytes are the least a projection moves: its float
operands read once and its f32 result written once.  The MoE experts
count the routed slots (tokens x experts per token) and not the capacity
rows a dispatch pads them to: the same count whatever implements it.
"""
from __future__ import annotations

from typing import NamedTuple


class Projection(NamedTuple):
    name: str
    rows: int
    k: int
    n: int
    weight_copies: int = 1   # weight matrices read (experts)

    @property
    def lookups(self) -> int:
        return self.rows * self.k * self.n


def resnet_projections(batch: int, image_size: int, widths, n_classes: int,
                       n_blocks: int = 1) -> list[Projection]:
    """The convolutions (im2col rows) and the head of a CIFAR ResNet."""
    out = [Projection("conv_init", batch * image_size ** 2, 27, widths[0])]
    cin, side = widths[0], image_size
    for s, width in enumerate(widths):
        for b in range(n_blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            side = -(-side // stride)
            rows = batch * side * side
            out.append(Projection(f"s{s}_b{b}_conv1", rows, 9 * cin, width))
            out.append(Projection(f"s{s}_b{b}_conv2", rows, 9 * width,
                                  width))
            if cin != width:
                out.append(Projection(f"s{s}_b{b}_proj", rows, cin, width))
            cin = width
    out.append(Projection("head", batch, widths[-1], n_classes))
    return out


def moe_decoder_projections(tokens: int, n_layers: int, d_model: int,
                            n_heads: int, n_kv_heads: int, head_dim: int,
                            n_experts: int, top_k: int, expert_width: int
                            ) -> list[Projection]:
    """An MoE decoder's projections for ``tokens`` tokens: attention q, k,
    v, o and the routed experts' wi, wg, wo (``tokens * top_k`` slots)."""
    out = []
    slots = tokens * top_k
    for g in range(n_layers):
        out += [Projection(f"l{g}.attn.wq", tokens, d_model,
                           n_heads * head_dim),
                Projection(f"l{g}.attn.wk", tokens, d_model,
                           n_kv_heads * head_dim),
                Projection(f"l{g}.attn.wv", tokens, d_model,
                           n_kv_heads * head_dim),
                Projection(f"l{g}.attn.wo", tokens, n_heads * head_dim,
                           d_model),
                Projection(f"l{g}.moe.wi", slots, d_model, expert_width,
                           weight_copies=n_experts),
                Projection(f"l{g}.moe.wg", slots, d_model, expert_width,
                           weight_copies=n_experts),
                Projection(f"l{g}.moe.wo", slots, expert_width, d_model,
                           weight_copies=n_experts)]
    return out


def pass_work(projections, lanes: int, shared_input: str = "") -> dict:
    """Lookups and least bytes of one banked pass over ``lanes`` lanes:
    each projection's activations per lane (4 bytes an element; the one
    named ``shared_input`` read once for all lanes), its weights once,
    its f32 result per lane."""
    lookups = nbytes = 0
    for p in projections:
        lookups += lanes * p.lookups
        acts = p.rows * p.k * 4
        nbytes += acts if p.name == shared_input else lanes * acts
        nbytes += p.weight_copies * p.k * p.n * 4
        nbytes += lanes * p.rows * p.n * 4
    return {"lookups": lookups, "bytes": nbytes}
