"""Encoder-decoder backbone (port of ``repro.models.encdec``;
Whisper-large-v3 shape).

The audio frontend (mel + conv downsampling) is a stub, as in the
reference: the prefill takes precomputed frame embeddings
``batch["frames"]`` (B, enc_frames, d_model).  The backbone is complete:
an encoder, a causal decoder with per-layer cross-attention, sinusoidal
absolute positions (``use_rope=False``), and self- and cross-KV caches
for serving.  Norms are RMS, as in the reference.

The encoder is CAUSAL, as the reference's code runs it: its comment says
"bidirectional: zero mask bias", but it calls ``attention(...,
cache=None)``, which masks causally.  The port matches the code.

Differences from the reference, none of which changes a value: the layer
stacks are loops over the stacked ``(n_layers, ...)`` parameters (the
reference scans them); the self caches' ``pos`` is a host int; the
cross-KV ``{"k", "v"}`` is (n_layers, B, enc_frames, H, hd), built once
at the prefill and carried unchanged by the decode steps.  Under a banked
policy every projection (``enc.attn.*``, ``enc.ffn.*``, ``xattn.wk/wv``
over the frames, ``dec.attn.*``, ``xattn.wq/wo``, ``dec.ffn.*`` over the
tokens) is one banked call for all lanes, and the encoder output, the
cross-KV and the decoder stream carry a bank lane axis; attention,
cross-attention's scores, the norms and the unembedding run lane by lane
(``common.each_lane``).

The continuous engine serves it too: its B=1 prefill (``lanes=True``)
leaves the cross-KV in the slot's dense rows, and ``forward_decode_lanes``
runs each decode step's projections once for all running requests, each
request's self-attention over its paged view and its cross-attention
over its own cross-KV rows.
"""
from __future__ import annotations

from typing import Any

import torch

from ..approx.layers import EXACT_POLICY, ApproxPolicy
from .common import (LMConfig, _grouped_attention, _inv_freq_on,
                     attention, dense_init, each_lane, ffn, init_attention,
                     init_attention_cache, init_ffn, lane_attention,
                     lane_rms_norm, lanes_of, logits_from_hidden,
                     rms_norm_lanes)
from .decoder import _index, _restack, lm_loss


def sinusoidal_positions(seq: int, dim: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """(seq, dim) f32: sin then cos of positions offset..offset+seq-1
    times the inverse frequencies ``1 / 10000 ** (arange/dim)``, which
    equal the reference's f32 ones element for element (the RoPE
    tables' ``common.rope_inv_freq``)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    ang = pos[:, None] * _inv_freq_on(dim, 10000.0, pos.device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_cross_attention(gen: torch.Generator, cfg: LMConfig,
                         lead: tuple = ()) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"wq": dense_init(gen, (*lead, d, h * hd)),
            "wk": dense_init(gen, (*lead, d, h * hd)),
            "wv": dense_init(gen, (*lead, d, h * hd)),
            "wo": dense_init(gen, (*lead, h * hd, d))}


def cross_attention(params, x, enc_kv, cfg: LMConfig, policy: ApproxPolicy,
                    layer_tag: str = "xattn", lanes: bool = False
                    ) -> torch.Tensor:
    """x: (B,S,D); enc_kv: {"k": (B,F,H,hd), "v": ...}, the cross-KV
    from the encoder output.  Any of them may carry a bank lane axis.
    ``lanes``: x's batch axis is a bank lane axis, and ``enc_kv`` may
    then be a list of each lane's {"k", "v"} (1,F,H,hd) (the continuous
    engine's decode step): the scores run lane by lane at B=1."""
    h, hd = cfg.n_heads, cfg.head_dim
    q = policy.matmul(f"{layer_tag}.wq", x, params["wq"],
                      lanes=lanes or x.ndim == 4)
    q = q.reshape(*q.shape[:-1], h, hd).to(cfg.dtype)
    if isinstance(enc_kv, list):
        out = torch.cat([
            _grouped_attention(q[i:i + 1].clone(), kv["k"], kv["v"], 0.0)
            for i, kv in enumerate(enc_kv)])
    else:
        k, v = enc_kv["k"], enc_kv["v"]
        out = each_lane(lambda q_, k_, v_: _grouped_attention(q_, k_, v_,
                                                              0.0),
                        lanes_of(4, q, k, v), 4, q, k, v)
    out = out.reshape(*out.shape[:-2], h * hd)
    return policy.matmul(f"{layer_tag}.wo", out, params["wo"],
                         lanes=lanes or out.ndim == 4).to(cfg.dtype)


def encode_cross_kv(params, enc_out, cfg: LMConfig, policy: ApproxPolicy,
                    layer_tag: str = "xattn", lanes: bool = False) -> dict:
    h, hd = cfg.n_heads, cfg.head_dim

    def proj(name):
        y = policy.matmul(f"{layer_tag}.{name}", enc_out, params[name],
                          lanes=lanes or enc_out.ndim == 4)
        return y.reshape(*y.shape[:-1], h, hd).to(cfg.dtype)
    return {"k": proj("wk"), "v": proj("wv")}


def init_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    """Random f32 parameters from ``gen`` on its device, in the
    reference's tree layout (``enc_blocks``/``dec_blocks`` stacked on a
    leading layer axis)."""
    dev = gen.device
    d = cfg.d_model

    def ones(lead):
        return torch.ones((*lead, d), device=dev)
    params: dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab, d), scale=0.02),
        "unembed": dense_init(gen, (cfg.vocab, d), scale=0.02),
        "enc_norm": ones(()),
        "dec_norm": ones(()),
    }
    enc = (cfg.n_enc_layers,)
    params["enc_blocks"] = {"attn": init_attention(gen, cfg, enc),
                            "ffn": init_ffn(gen, cfg, lead=enc),
                            "norm1": ones(enc), "norm2": ones(enc)}
    dec = (cfg.n_layers,)
    params["dec_blocks"] = {"attn": init_attention(gen, cfg, dec),
                            "xattn": init_cross_attention(gen, cfg, dec),
                            "ffn": init_ffn(gen, cfg, lead=dec),
                            "norm1": ones(dec), "norm2": ones(dec),
                            "norm3": ones(dec)}
    return params


def encode(params, frames, cfg: LMConfig, policy: ApproxPolicy,
           lanes: bool = False) -> torch.Tensor:
    """frames: (B,F,D) stub embeddings -> encoder hidden (B,F,D), or
    (n,B,F,D) under a banked policy (with ``lanes``, the batch axis is
    that lane axis).  Causal, as the reference's code."""
    f, d = frames.shape[-2:]
    dev = frames.device
    h = (frames.to(cfg.dtype)
         + sinusoidal_positions(f, d, device=dev).to(cfg.dtype))
    positions = torch.arange(f, dtype=torch.int32, device=dev)
    for layer in range(cfg.n_enc_layers):
        lp = _index(params["enc_blocks"], layer)
        hin = rms_norm_lanes(h, lp["norm1"], cfg.norm_eps)
        y, _ = attention(lp["attn"], hin, cfg, policy, positions=positions,
                         cache=None, layer_tag="enc.attn", lanes=lanes)
        h = h + y
        hin = rms_norm_lanes(h, lp["norm2"], cfg.norm_eps)
        h = h + ffn(lp["ffn"], hin, cfg, policy, layer_tag="enc.ffn",
                    lanes=lanes or hin.ndim == 4)
    return rms_norm_lanes(h, params["enc_norm"], cfg.norm_eps)


def _decode_stack(params, h, positions, cfg: LMConfig, policy: ApproxPolicy,
                  self_caches, cross_kvs, lanes: bool = False):
    """The decoder layers over h (B,S,D): self-attention with its cache
    (written in place), cross-attention over layer l's cross-KV, FFN.
    Returns (normed h, new self caches)."""
    new = []
    for layer in range(cfg.n_layers):
        lp = _index(params["dec_blocks"], layer)
        hin = rms_norm_lanes(h, lp["norm1"], cfg.norm_eps)
        y, nc = attention(lp["attn"], hin, cfg, policy, positions=positions,
                          cache=_index(self_caches, layer),
                          layer_tag="dec.attn", lanes=lanes)
        new.append(nc)
        h = h + y
        hin = rms_norm_lanes(h, lp["norm2"], cfg.norm_eps)
        h = h + cross_attention(lp["xattn"], hin,
                                _index(cross_kvs, layer), cfg, policy,
                                lanes=lanes)
        hin = rms_norm_lanes(h, lp["norm3"], cfg.norm_eps)
        h = h + ffn(lp["ffn"], hin, cfg, policy, layer_tag="dec.ffn",
                    lanes=lanes or hin.ndim == 4)
    return (rms_norm_lanes(h, params["dec_norm"], cfg.norm_eps),
            _restack(self_caches, new))


def _embed_tokens(params, tokens, cfg: LMConfig, offset=0) -> torch.Tensor:
    """Token embeddings plus sinusoidal positions from ``offset``: an
    int, or one int a batch row (the continuous engine's lanes, each
    row's table made alone at a B=1 call's shape)."""
    h = params["embed"][tokens.long()].to(cfg.dtype)
    s, d = tokens.shape[1], cfg.d_model
    if isinstance(offset, int):
        pos = sinusoidal_positions(s, d, offset, device=h.device)
    else:
        pos = torch.stack([sinusoidal_positions(s, d, int(o),
                                                device=h.device)
                           for o in offset])
    return h + pos.to(cfg.dtype)


def _last_logits(params, h: torch.Tensor, row: int) -> torch.Tensor:
    """Unembedding of position ``row``, lane by lane under a bank."""
    return each_lane(lambda x: logits_from_hidden(x[:, row, :],
                                                  params["unembed"]),
                     lanes_of(3, h), 3, h)


def _train_layer(h, lp, xkv, positions, cfg: LMConfig,
                 policy: ApproxPolicy) -> torch.Tensor:
    """One decoder layer without a self cache (causal over h)."""
    hin = rms_norm_lanes(h, lp["norm1"], cfg.norm_eps)
    y, _ = attention(lp["attn"], hin, cfg, policy, positions=positions,
                     layer_tag="dec.attn")
    h = h + y
    hin = rms_norm_lanes(h, lp["norm2"], cfg.norm_eps)
    h = h + cross_attention(lp["xattn"], hin, xkv, cfg, policy)
    hin = rms_norm_lanes(h, lp["norm3"], cfg.norm_eps)
    return h + ffn(lp["ffn"], hin, cfg, policy, layer_tag="dec.ffn",
                   lanes=hin.ndim == 4)


def forward_train(params, batch, cfg: LMConfig,
                  policy: ApproxPolicy = EXACT_POLICY) -> torch.Tensor:
    """batch: frames (B,F,D), tokens (B,S), targets (B,S) -> scalar
    loss, or (n,) under a banked policy: the (causal) encoder, one
    cross-KV a decoder layer, the causal decoder without a cache, the
    final norm and chunked cross-entropy.  ``cfg.remat`` recomputes each
    decoder layer in the backward pass."""
    from torch.utils.checkpoint import checkpoint

    enc_out = encode(params, batch["frames"], cfg, policy)
    h = _embed_tokens(params, batch["tokens"], cfg)
    positions = torch.arange(h.shape[-2], dtype=torch.int32,
                             device=h.device)
    for layer in range(cfg.n_layers):
        lp = _index(params["dec_blocks"], layer)
        xkv = encode_cross_kv(lp["xattn"], enc_out, cfg, policy)
        args = (h, lp, xkv, positions, cfg, policy)
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(_train_layer, *args, use_reentrant=False)
        else:
            h = _train_layer(*args)
    return lm_loss(params, h, batch["targets"], cfg, 0, "dec_norm")


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None
               ) -> dict:
    """Self-attention caches of all decoder layers, stacked (``pos`` a
    host int), and the cross-KV slots (zeros until the prefill)."""
    shape = (cfg.n_layers, batch, cfg.enc_frames, cfg.n_heads, cfg.head_dim)
    return {"self": init_attention_cache(cfg, batch, max_len, device,
                                         lead=(cfg.n_layers,)),
            "cross": {k: torch.zeros(shape, dtype=cfg.dtype, device=device)
                      for k in ("k", "v")}}


def forward_prefill(params, batch, cache, cfg: LMConfig,
                    policy: ApproxPolicy = EXACT_POLICY,
                    lanes: bool = False):
    """Encode the frames, build each decoder layer's cross-KV, run the
    prompt through the decoder; returns (last_logits, new_cache).
    ``lanes``: each batch row is a lane of the policy's banked backends
    (the continuous engine's B=1 prefill)."""
    enc_out = encode(params, batch["frames"], cfg, policy, lanes)
    kvs = [encode_cross_kv(_index(params["dec_blocks"], layer)["xattn"],
                           enc_out, cfg, policy, lanes=lanes)
           for layer in range(cfg.n_layers)]
    cross = {k: torch.stack([kv[k] for kv in kvs]) for k in ("k", "v")}
    h = _embed_tokens(params, batch["tokens"], cfg)
    positions = torch.arange(h.shape[-2], dtype=torch.int32,
                             device=h.device)
    h, new_self = _decode_stack(params, h, positions, cfg, policy,
                                cache["self"], cross, lanes)
    return _last_logits(params, h, -1), {"self": new_self, "cross": cross}


def forward_decode(params, token, cache, cfg: LMConfig,
                   policy: ApproxPolicy = EXACT_POLICY):
    """One decode step at the self caches' position.  token: (B,) int."""
    pos = cache["self"]["pos"]
    h = _embed_tokens(params, token[:, None], cfg, pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    h, new_self = _decode_stack(params, h, positions, cfg, policy,
                                cache["self"], cache["cross"])
    return _last_logits(params, h, 0), {"self": new_self,
                                        "cross": cache["cross"]}


def forward_decode_lanes(params, tokens, positions, cache, cfg: LMConfig,
                         policy: ApproxPolicy) -> list:
    """One decode step of n requests of a continuous batch, each a lane
    of the policy's banked backends (``decoder.forward_decode_lanes``'s
    contract): each lane's token embedded at its own sinusoidal offset,
    then every decoder layer's self-attention over the lane's paged
    ``("self", ...)`` view, cross-attention (``wq``/``wo`` once for all
    lanes) over the lane's own ``("cross", ...)`` rows of ``cache``
    (``serve.kv_cache.LaneCaches``) and the FFN.  Returns the n (1,
    vocab) logits rows, each equal to a sequential B=1
    ``forward_decode``'s bit for bit."""
    h = _embed_tokens(params, tokens[:, None], cfg, cache.pos)
    positions = positions.to(torch.int32)[:, None]
    for layer in range(cfg.n_layers):
        lp = _index(params["dec_blocks"], layer)
        hin = lane_rms_norm(h, lp["norm1"], cfg.norm_eps)
        h = h + lane_attention(lp["attn"], hin, cfg, policy,
                               positions=positions, cache=cache,
                               at=(("self",), layer), layer_tag="dec.attn")
        hin = lane_rms_norm(h, lp["norm2"], cfg.norm_eps)
        h = h + cross_attention(lp["xattn"], hin,
                                cache.state(("cross",), layer, ("k", "v")),
                                cfg, policy, lanes=True)
        hin = lane_rms_norm(h, lp["norm3"], cfg.norm_eps)
        h = h + ffn(lp["ffn"], hin, cfg, policy, layer_tag="dec.ffn",
                    lanes=True)
    h = lane_rms_norm(h, params["dec_norm"], cfg.norm_eps)
    return [logits_from_hidden(h[i:i + 1, 0, :], params["unembed"])
            for i in range(h.shape[0])]
