"""Decoder-only LM (port of ``repro.models.decoder``) covering the
dense / moe / ssm / hybrid / vlm families via a per-period block pattern.

Block pattern per family:
  dense  : period 1,  [attn + ffn]   (``mla`` in place of ``attn`` with
           ``use_mla``: DeepSeek-V2's latent attention)
  moe    : period 1,  [attn + moe]   (likewise)
  ssm    : period 1,  [mamba]
  hybrid : period = attn_period (jamba: 8), attention at slot
           ``period//2``, MoE on odd slots (1:7 attn:mamba, alternating
           MoE, per the Jamba paper)
  vlm    : dense pattern; image patch embeddings (stub frontend) are
           projected (``img_proj``) and prepended to the token
           embeddings, and the positions cover both.

Parameters keep the reference's layout: ``params["blocks"]`` holds every
slot's weights stacked on a leading ``(n_groups, ...)`` axis, so the two
parameter trees map one to one (``models.weights.lm_params_from_numpy``),
and ``_run_stack`` loops over that axis where the reference scans it.

Under a banked policy (``approx.layers.policy_bank_eval``) the hidden
state gains a bank lane axis, (n,B,S,D), at the first banked projection;
the norms, the unembedding and every mixer's exact part then run lane by
lane (``common.each_lane``), so each lane equals its sequential
evaluation bit for bit.

``forward_train`` is the training loss of every pattern: chunked
cross-entropy after the final norm, plus ``AUX_LOSS_COEF`` times the MoE
layers' load-balance loss; ``cfg.remat`` recomputes each layer group in
the backward pass (``torch.utils.checkpoint``).  Under a banked policy
the loss is one value a lane, each reduced alone.

``forward_decode_lanes`` is the continuous engine's decode step for
every pattern: each running request a bank lane, each mixer (``attn``,
``mla``, ``mamba``) and FFN (``ffn``, ``moe``) in its lane form.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..approx.layers import EXACT_POLICY, ApproxPolicy
from ..launch.mesh import embedding_rows
from .common import (LMConfig, attention, chunked_cross_entropy,
                     dense_init, each_lane, ffn, hint_batch, init_attention,
                     init_attention_cache, init_ffn, lane_attention,
                     lane_rms_norm, lanes_of, logits_from_hidden, rms_norm,
                     rms_norm_lanes)
from .mamba2 import (init_mamba, init_mamba_cache, lane_mamba_block,
                     mamba_block)
from .mla import init_mla, init_mla_cache, lane_mla_attention, mla_attention
from .moe import init_moe, moe_ffn

AUX_LOSS_COEF = 0.01


def block_pattern(cfg: LMConfig) -> list[tuple[str, Optional[str]]]:
    """Returns [(mixer, ffn_kind)] per period slot."""
    if cfg.family == "ssm":
        return [("mamba", None)]
    if cfg.family == "hybrid":
        period = cfg.attn_period
        return [("attn" if j == period // 2 else "mamba",
                 "moe" if (j % 2 == 1 and cfg.n_experts > 0) else "ffn")
                for j in range(period)]
    # dense / moe / vlm (and the decoder side of others)
    return [("mla" if cfg.use_mla else "attn",
             "moe" if cfg.family == "moe" else "ffn")]


def _init_mixer(gen, kind: str, cfg: LMConfig, lead: tuple) -> dict:
    if kind == "attn":
        return init_attention(gen, cfg, lead)
    if kind == "mla":
        return init_mla(gen, cfg, lead)
    if kind == "mamba":
        return init_mamba(gen, cfg, lead)
    raise ValueError(kind)


def _init_ffn(gen, kind: Optional[str], cfg: LMConfig, lead: tuple
              ) -> Optional[dict]:
    if kind is None:
        return None
    if kind == "ffn":
        return init_ffn(gen, cfg, lead=lead)
    if kind == "moe":
        return init_moe(gen, cfg, lead)
    raise ValueError(kind)


def init_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    """Random f32 parameters from ``gen`` on its device, in the
    reference's tree layout (stacked layer groups; an ``ssm`` slot has
    no ``ffn_j``/``norm2_j``; a vlm has ``img_proj``).  A
    ``common.MetaGenerator`` gives the shapes only, on the ``meta``
    device."""
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
    if cfg.family == "vlm":
        params["img_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model))
    blocks = {}
    for j, (mixer, ffn_kind) in enumerate(pattern):
        blocks[f"mixer_{j}"] = _init_mixer(gen, mixer, cfg, lead)
        blocks[f"norm1_{j}"] = torch.ones((*lead, cfg.d_model), device=dev)
        f = _init_ffn(gen, ffn_kind, cfg, lead)
        if f is not None:
            blocks[f"ffn_{j}"] = f
            blocks[f"norm2_{j}"] = torch.ones((*lead, cfg.d_model),
                                              device=dev)
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
    """One layer group: (h, aux, new_gcache); aux is the MoE layers'
    load-balance loss (0.0 without one).  ``lanes``: the batch axis is a
    bank lane axis (the continuous engine's prefill)."""
    aux = 0.0
    new_cache: dict[str, Any] = {}
    for j, (mixer, ffn_kind) in enumerate(pattern):
        hin = rms_norm_lanes(h, gparams[f"norm1_{j}"], cfg.norm_eps)
        sub_cache = None if gcache is None else gcache[f"mixer_{j}"]
        if mixer == "attn":
            y, nc = attention(gparams[f"mixer_{j}"], hin, cfg, policy,
                              positions=positions, cache=sub_cache,
                              layer_tag="attn", lanes=lanes)
        elif mixer == "mla":
            y, nc = mla_attention(gparams[f"mixer_{j}"], hin, cfg, policy,
                                  positions=positions, cache=sub_cache,
                                  layer_tag="mla", lanes=lanes)
        else:
            y, nc = mamba_block(gparams[f"mixer_{j}"], hin, cfg, policy,
                                cache=sub_cache, layer_tag="mamba",
                                lanes=lanes)
        if nc is not None:
            new_cache[f"mixer_{j}"] = nc
        h = h + y
        if ffn_kind is not None:
            hin = rms_norm_lanes(h, gparams[f"norm2_{j}"], cfg.norm_eps)
            if ffn_kind == "moe":
                y, a = moe_ffn(gparams[f"ffn_{j}"], hin, cfg, policy,
                               lanes=lanes)
                aux = aux + a
            else:
                y = ffn(gparams[f"ffn_{j}"], hin, cfg, policy,
                        lanes=lanes or hin.ndim == 4)
            h = h + y
    return h, aux, (new_cache or None)


def _restack(old, groups: list):
    """The layer groups' new caches as one stacked tree.  A leaf every
    group wrote in place into its slice of ``old`` stays ``old``; any
    other (a mamba state, a cache that gained a bank lane axis) is
    stacked anew.  Host ints (``pos``) are shared."""
    first = groups[0]
    if isinstance(first, dict):
        return {k: _restack(None if old is None else old.get(k),
                            [g[k] for g in groups]) for k in first}
    if not isinstance(first, torch.Tensor):
        return first
    if (old is not None and old.shape[1:] == first.shape
            and old.device.type != "meta"
            and all(t.data_ptr() == old[g].data_ptr()
                    for g, t in enumerate(groups))):
        return old
    return torch.stack(groups)


def _run_stack(params, h, positions, cfg: LMConfig, policy: ApproxPolicy,
               caches=None, lanes: bool = False, remat: bool = False):
    """Run the layer groups in order.  ``caches``: the stacked cache
    (or None); attention writes each group's slice in place.  ``remat``
    (training, no cache): each group's activations are recomputed in the
    backward pass.  Returns (h, aux_total, new_caches)."""
    from torch.utils.checkpoint import checkpoint

    pattern = block_pattern(cfg)
    n_groups = cfg.n_layers // len(pattern)
    aux = 0.0
    new = []
    for g in range(n_groups):
        gcache = None if caches is None else _index(caches, g)
        args = (h, positions, _index(params["blocks"], g), gcache, cfg,
                policy, pattern, lanes)
        if remat and caches is None and torch.is_grad_enabled():
            h, a, nc = checkpoint(_group_body, *args, use_reentrant=False)
        else:
            h, a, nc = _group_body(*args)
        h = hint_batch(h)
        aux = aux + a
        new.append(nc)
    new_caches = None if new[0] is None else _restack(caches, new)
    return h, aux, new_caches


def _embed_inputs(params, batch, cfg: LMConfig, policy: ApproxPolicy,
                  lanes: bool = False):
    """Token embeddings and positions.  A vlm's image embeddings
    (``batch["img_embeds"]``, (B,S_img,D)) are projected through
    ``img_proj`` and prepended, and the positions cover both; under a
    banked ``img_proj`` the projection gains a bank lane axis, and the
    token embeddings are copied to every lane (with ``lanes`` the batch
    axis is that lane axis)."""
    tokens = batch["tokens"]
    h = embedding_rows(params["embed"], tokens.long()).to(cfg.dtype)
    if cfg.family == "vlm" and "img_embeds" in batch:
        img = policy.matmul("img_proj", batch["img_embeds"].to(cfg.dtype),
                            params["img_proj"], lanes=lanes).to(cfg.dtype)
        h = torch.cat([img, h.expand(*img.shape[:-2], *h.shape[-2:])],
                      dim=-2)
    positions = torch.arange(h.shape[-2], dtype=torch.int32,
                             device=h.device)
    return hint_batch(h), positions


# ----------------------------------------------------------------------
# Public steps
# ----------------------------------------------------------------------
def lm_loss(params, h, targets, cfg: LMConfig, n_img: int, norm: str
            ) -> torch.Tensor:
    """Final norm (``params[norm]``) and chunked cross-entropy of h
    (B,S,D) against targets (B,S - n_img); the ``n_img`` image rows in
    front carry mask 0 and front-padded targets.  One loss a lane when
    h carries a bank lane axis, each lane reduced alone."""
    mask = None
    if n_img:
        b, s = targets.shape
        mask = torch.cat([torch.zeros((b, n_img), device=h.device),
                          torch.ones((b, s), device=h.device)], dim=1)
        targets = torch.nn.functional.pad(targets, (n_img, 0))

    def one(x):
        x = rms_norm(x, params[norm], cfg.norm_eps)
        return chunked_cross_entropy(x, params["unembed"], targets,
                                     cfg.loss_chunk, mask)
    return each_lane(one, lanes_of(3, h), 3, h)


def forward_train(params, batch, cfg: LMConfig,
                  policy: ApproxPolicy = EXACT_POLICY) -> torch.Tensor:
    """batch: tokens (B,S), targets (B,S) (a vlm also ``img_embeds``,
    whose rows carry no LM loss) -> scalar loss, or (n,) under a banked
    policy."""
    h, positions = _embed_inputs(params, batch, cfg, policy)
    h, aux, _ = _run_stack(params, h, positions, cfg, policy,
                           remat=cfg.remat)
    n_img = h.shape[-2] - batch["tokens"].shape[-1]    # a vlm's image
    loss = lm_loss(params, h, batch["targets"], cfg, n_img, "final_norm")
    return loss + AUX_LOSS_COEF * aux


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None):
    """Stacked (n_groups, ...) cache tree per mixer slot: attention
    {"k", "v", "pos"} (``pos`` a host int), MLA {"ckv", "kr", "pos"},
    mamba {"conv", "state"}."""
    pattern = block_pattern(cfg)
    lead = (cfg.n_layers // len(pattern),)
    init = {"attn": lambda: init_attention_cache(cfg, batch, max_len,
                                                 device, lead),
            "mla": lambda: init_mla_cache(cfg, batch, max_len, device,
                                          lead),
            "mamba": lambda: init_mamba_cache(cfg, batch, device, lead)}
    return {f"mixer_{j}": init[mixer]()
            for j, (mixer, _f) in enumerate(pattern)}


def _logits(params, h: torch.Tensor, row: int, cfg: LMConfig
            ) -> torch.Tensor:
    """Final norm and unembedding of position ``row``, lane by lane
    when h carries a bank lane axis."""
    def one(x):
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return logits_from_hidden(x[:, row, :], params["unembed"])
    return each_lane(one, lanes_of(3, h), 3, h)


def forward_prefill(params, batch, cache, cfg: LMConfig,
                    policy: ApproxPolicy = EXACT_POLICY,
                    lanes: bool = False):
    """Fill the cache from a prompt; returns (last_logits, new_cache).
    ``lanes``: each prompt row is a lane of the policy's banked
    backends (the continuous engine's B=1 prefill).  The MoE aux loss
    is discarded, as in the reference."""
    h, positions = _embed_inputs(params, batch, cfg, policy, lanes)
    h, _aux, new_caches = _run_stack(params, h, positions, cfg, policy,
                                     caches=cache, lanes=lanes)
    return _logits(params, h, -1, cfg), new_caches


def forward_decode(params, token, cache, cfg: LMConfig,
                   policy: ApproxPolicy = EXACT_POLICY):
    """One decode step. token: (B,) int. Returns (logits, new_cache)."""
    pos = _cache_pos(cache, cfg)
    h = hint_batch(embedding_rows(params["embed"], token.long()[:, None])
                   .to(cfg.dtype))
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    h, _aux, new_caches = _run_stack(params, h, positions, cfg, policy,
                                     caches=cache)
    return _logits(params, h, 0, cfg), new_caches


def forward_decode_lanes(params, tokens, positions, cache, cfg: LMConfig,
                         policy: ApproxPolicy) -> list:
    """One decode step of n requests of a continuous batch, each a lane
    of the policy's banked backends.  tokens (n,) int, positions (n,)
    int (each lane's cache row; a vlm's image rows lie before its
    first token's); ``cache`` (``serve.kv_cache.LaneCaches``) holds each
    lane's slot: attention k/v and MLA's latent rows in pages, a mamba
    slot's conv and SSM state in dense rows.  Every mixer and FFN of
    ``block_pattern`` runs its lane form: the projections once for all
    lanes (an MoE layer one banked call an expert and projection, each
    lane routing its token alone), the norms, attention, the SSM step,
    the routing and the unembedding lane by lane at the shapes a
    sequential B=1 ``forward_decode`` gives them, so each lane's logits
    equal that decode's bit for bit.  Returns the n (1, vocab) logits
    rows."""
    pattern = block_pattern(cfg)
    n_groups = cfg.n_layers // len(pattern)
    lane_mixer = {"attn": lane_attention, "mla": lane_mla_attention}
    h = params["embed"][tokens.long()[:, None]].to(cfg.dtype)
    positions = positions.to(torch.int32)[:, None]
    for g in range(n_groups):
        gparams = _index(params["blocks"], g)
        for j, (mixer, ffn_kind) in enumerate(pattern):
            name = f"mixer_{j}"
            hin = lane_rms_norm(h, gparams[f"norm1_{j}"], cfg.norm_eps)
            if mixer == "mamba":
                y = lane_mamba_block(gparams[name], hin, cfg, policy,
                                     cache=cache, at=((name,), g))
            else:
                y = lane_mixer[mixer](gparams[name], hin, cfg, policy,
                                      positions=positions, cache=cache,
                                      at=((name,), g), layer_tag=mixer)
            h = h + y
            if ffn_kind is None:
                continue
            hin = lane_rms_norm(h, gparams[f"norm2_{j}"], cfg.norm_eps)
            if ffn_kind == "moe":
                y, _aux = moe_ffn(gparams[f"ffn_{j}"], hin, cfg, policy,
                                  lanes=True)
            else:
                y = ffn(gparams[f"ffn_{j}"], hin, cfg, policy, lanes=True)
            h = h + y
    h = lane_rms_norm(h, params["final_norm"], cfg.norm_eps)
    return [logits_from_hidden(h[i:i + 1, 0, :], params["unembed"])
            for i in range(h.shape[0])]


def _cache_pos(cache, cfg: LMConfig) -> int:
    """Current position (a host int) from the first attention or MLA
    cache; 0 for pure SSM (no RoPE, the position does not matter)."""
    for j, (mixer, _f) in enumerate(block_pattern(cfg)):
        if mixer in ("attn", "mla"):
            return cache[f"mixer_{j}"]["pos"]
    return 0
