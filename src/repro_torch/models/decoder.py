"""Decoder-only LM (port of ``repro.models.decoder``), dense pattern.

The reference covers the dense / moe / ssm / hybrid / vlm families with
one per-period block pattern; the port has the dense one,
``[attn + ffn]`` with period 1.  Parameters keep the reference's layout:
``params["blocks"]`` holds every layer's weights stacked on a leading
``(n_groups, ...)`` axis, so the two parameter trees map one to one
(``models.weights.lm_params_from_numpy``), and ``_run_stack`` loops over
that axis where the reference scans it.

The other families, MLA and ``forward_train`` raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..approx.layers import EXACT_POLICY, ApproxPolicy
from .common import (TRAIN_ITEM, ZOO_ITEM, LMConfig, attention, dense_init,
                     ffn, init_attention, init_attention_cache, init_ffn,
                     lane_attention, lane_rms_norm, logits_from_hidden,
                     rms_norm)


def block_pattern(cfg: LMConfig) -> list[tuple[str, Optional[str]]]:
    """Returns [(mixer, ffn_kind)] per period slot."""
    if cfg.family != "dense" or cfg.use_mla:
        what = "MLA" if cfg.use_mla else f"the {cfg.family!r} family"
        raise NotImplementedError(f"{what} is not ported yet ({ZOO_ITEM})")
    return [("attn", "ffn")]


def init_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    """Random f32 parameters from ``gen`` on its device, in the
    reference's tree layout (stacked layer groups)."""
    pattern = block_pattern(cfg)
    period = len(pattern)
    if cfg.n_layers % period:
        raise ValueError("n_layers must divide the block period")
    lead = (cfg.n_layers // period,)
    dev = gen.device
    params: dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02),
        "final_norm": torch.ones((cfg.d_model,), device=dev),
        "unembed": dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02),
    }
    blocks = {}
    for j, _ in enumerate(pattern):
        blocks[f"mixer_{j}"] = init_attention(gen, cfg, lead)
        blocks[f"norm1_{j}"] = torch.ones((*lead, cfg.d_model), device=dev)
        blocks[f"ffn_{j}"] = init_ffn(gen, cfg, lead=lead)
        blocks[f"norm2_{j}"] = torch.ones((*lead, cfg.d_model), device=dev)
    params["blocks"] = blocks
    return params


def _index(tree, g: int):
    """Group ``g`` of a stacked tree (tensors sliced on their leading
    axis; host ints, such as a cache's ``pos``, shared)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g] if isinstance(tree, torch.Tensor) else tree


def _group_body(h, positions, gparams, gcache, cfg: LMConfig,
                policy: ApproxPolicy, pattern, lanes: bool = False):
    """One layer group: (h, new_gcache)."""
    new_cache: dict[str, Any] = {}
    for j, (_mixer, _ffn) in enumerate(pattern):
        hin = rms_norm(h, gparams[f"norm1_{j}"], cfg.norm_eps)
        sub_cache = None if gcache is None else gcache[f"mixer_{j}"]
        y, nc = attention(gparams[f"mixer_{j}"], hin, cfg, policy,
                          positions=positions, cache=sub_cache,
                          layer_tag="attn", lanes=lanes)
        if nc is not None:
            new_cache[f"mixer_{j}"] = nc
        h = h + y
        hin = rms_norm(h, gparams[f"norm2_{j}"], cfg.norm_eps)
        h = h + ffn(gparams[f"ffn_{j}"], hin, cfg, policy, lanes=lanes)
    return h, (new_cache or None)


def _run_stack(params, h, positions, cfg: LMConfig, policy: ApproxPolicy,
               caches=None, lanes: bool = False):
    """Run the layer groups in order.  ``caches``: the stacked cache
    (or None); each group writes its slice in place.  Returns (h,
    new_caches) — the same tensors with ``pos`` advanced."""
    pattern = block_pattern(cfg)
    n_groups = cfg.n_layers // len(pattern)
    new_caches = None
    for g in range(n_groups):
        gcache = None if caches is None else _index(caches, g)
        h, nc = _group_body(h, positions, _index(params["blocks"], g),
                            gcache, cfg, policy, pattern, lanes)
        if nc is not None:
            new_caches = {name: {"k": caches[name]["k"],
                                 "v": caches[name]["v"],
                                 "pos": sub["pos"]}
                          for name, sub in nc.items()}
    return h, new_caches


def _embed_inputs(params, batch, cfg: LMConfig):
    """Token embeddings and positions (token-only families)."""
    tokens = batch["tokens"]
    h = params["embed"][tokens.long()].to(cfg.dtype)
    positions = torch.arange(h.shape[1], dtype=torch.int32,
                             device=h.device)
    return h, positions


# ----------------------------------------------------------------------
# Public steps
# ----------------------------------------------------------------------
def forward_train(params, batch, cfg: LMConfig,
                  policy: ApproxPolicy = EXACT_POLICY):
    raise NotImplementedError(f"forward_train is not ported yet "
                              f"({TRAIN_ITEM})")


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None):
    """Stacked (n_groups, ...) cache tree; ``pos`` is a host int."""
    pattern = block_pattern(cfg)
    lead = (cfg.n_layers // len(pattern),)
    return {f"mixer_{j}": init_attention_cache(cfg, batch, max_len,
                                               device, lead)
            for j, _ in enumerate(pattern)}


def forward_prefill(params, batch, cache, cfg: LMConfig,
                    policy: ApproxPolicy = EXACT_POLICY,
                    lanes: bool = False):
    """Fill the cache from a prompt; returns (last_logits, new_cache).
    ``lanes``: each prompt row is a lane of the policy's banked
    backends (the continuous engine's B=1 prefill)."""
    h, positions = _embed_inputs(params, batch, cfg)
    h, new_caches = _run_stack(params, h, positions, cfg, policy,
                               caches=cache, lanes=lanes)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(h[:, -1, :], params["unembed"]), new_caches


def forward_decode(params, token, cache, cfg: LMConfig,
                   policy: ApproxPolicy = EXACT_POLICY):
    """One decode step. token: (B,) int. Returns (logits, new_cache)."""
    pos = _cache_pos(cache, cfg)
    h = params["embed"][token.long()[:, None]].to(cfg.dtype)
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    h, new_caches = _run_stack(params, h, positions, cfg, policy,
                               caches=cache)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(h[:, 0, :], params["unembed"]), new_caches


def forward_decode_lanes(params, tokens, positions, kv, biases,
                         cfg: LMConfig, policy: ApproxPolicy) -> list:
    """One decode step of n requests of a continuous batch, each a lane
    of the policy's banked backends.  tokens (n,) int, positions (n,)
    int (each lane's cache row); ``kv(mixer, g, k, v)`` stores each
    lane's new key/value rows of layer group ``g`` and returns each
    lane's cache view, and ``biases[i]`` is lane i's attention mask
    (``common.lane_attention``).  The projections run once for all
    lanes; the norms, attention and unembedding run lane by lane at the
    shapes a sequential B=1 ``forward_decode`` gives them, so each
    lane's logits equal that decode's bit for bit.  Returns the n
    (1, vocab) logits rows."""
    pattern = block_pattern(cfg)
    n_groups = cfg.n_layers // len(pattern)
    h = params["embed"][tokens.long()[:, None]].to(cfg.dtype)
    positions = positions.to(torch.int32)[:, None]
    for g in range(n_groups):
        gparams = _index(params["blocks"], g)
        for j, _ in enumerate(pattern):
            mixer = f"mixer_{j}"
            hin = lane_rms_norm(h, gparams[f"norm1_{j}"], cfg.norm_eps)
            h = h + lane_attention(
                gparams[mixer], hin, cfg, policy, positions=positions,
                kv=lambda k, v, _m=mixer, _g=g: kv(_m, _g, k, v),
                biases=biases, layer_tag="attn")
            hin = lane_rms_norm(h, gparams[f"norm2_{j}"], cfg.norm_eps)
            h = h + ffn(gparams[f"ffn_{j}"], hin, cfg, policy, lanes=True)
    h = lane_rms_norm(h, params["final_norm"], cfg.norm_eps)
    return [logits_from_hidden(h[i:i + 1, 0, :], params["unembed"])
            for i in range(h.shape[0])]


def _cache_pos(cache, cfg: LMConfig) -> int:
    """Current position (a host int) from the first attention cache."""
    for j, (mixer, _f) in enumerate(block_pattern(cfg)):
        if mixer == "attn":
            return cache[f"mixer_{j}"]["pos"]
    return 0
