"""Shared LM substrate (port of ``repro.models.common``): config, norms,
RoPE, grouped attention with a KV cache, FFN, parameter init.

All projection matmuls route through an ``ApproxPolicy``, so any layer
can run on the emulated approximate-multiplier datapath.  Attention
score/value products, norms and the unembedding stay exact, as in the
reference (the paper's scope: multipliers inside projection MACs).

Differences from the reference, none of which changes a value:
  * parameters are nested dicts of tensors, initialised from an explicit
    ``torch.Generator`` (its stream is not ``jax.random``'s; the tests
    carry the reference's parameters across with
    ``models.weights.lm_params_from_numpy``);
  * the KV cache's ``pos`` is a host int, and ``attention`` writes the
    new keys and values into the cache tensors in place (JAX returns
    updated copies) — a device scalar would sync the stream every step;
  * bf16 operands of the attention products are upcast to f32 and
    multiplied there: products of bf16 values are exact in f32, which is
    what the reference's ``preferred_element_type=f32`` computes.

``lane_attention`` and ``lane_rms_norm`` serve the continuous engine's
decode step, where each running request is a bank lane: the
projections run once for all lanes, and every float reduction whose
order may depend on the batch size or the cache length runs per lane at
the shape a sequential B=1 decode gives it.

Not ported yet, each raising where a config asks for it: the sharding
hints (``hint_*``: no mesh on one card), ``layer_norm`` (encdec),
``_chunked_grouped_attention`` (``attn_impl="chunked"``) — ROADMAP.md
Queue 1, "LM model zoo and module profiles" — and
``chunked_cross_entropy`` (Queue 1, "Training").
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..approx.layers import ApproxPolicy

#: The ROADMAP.md items that port what this module does not have yet,
#: named by title so that a renumbering leaves them true.
ZOO_ITEM = 'ROADMAP.md Queue 1, "LM model zoo and module profiles"'
TRAIN_ITEM = 'ROADMAP.md Queue 1, "Training"'


@dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig``, field for field; ``dtype`` is a
    torch dtype."""
    name: str
    family: str              # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    act: str = "silu"        # silu | relu2 | gelu
    use_rope: bool = True
    attn_impl: str = "vanilla"   # vanilla | chunked (not ported)
    kv_chunk: int = 1024
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_blocks: int = 0
    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- SSM (mamba2 / jamba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    attn_period: int = 0
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # --- vlm (llava) ---
    n_img_tokens: int = 0
    # --- training ---
    remat: bool = True
    loss_chunk: int = 1024
    dtype: Any = torch.bfloat16
    scan_unroll: bool = False

    @property
    def kv_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def reduced(self, **overrides) -> "LMConfig":
        """Smoke-test-sized variant of the same family (the reference's
        sizes, f32)."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 64),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 128) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=min(self.head_dim, 16),
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_d_ff=min(self.moe_d_ff, 32) if self.moe_d_ff else 0,
            kv_lora=min(self.kv_lora, 32),
            q_lora=min(self.q_lora, 32),
            rope_head_dim=min(self.rope_head_dim, 8),
            v_head_dim=min(self.v_head_dim, 16),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=min(self.ssm_head_dim, 8),
            ssm_chunk=min(self.ssm_chunk, 16),
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_frames=min(self.enc_frames, 24),
            n_img_tokens=min(self.n_img_tokens, 8),
            loss_chunk=64,
            remat=False,
            dtype=torch.float32,
            capacity_factor=8.0,
        )
        if self.attn_period:
            small["attn_period"] = min(self.attn_period,
                                       small["n_layers"])
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ----------------------------------------------------------------------
# Initialization
# ----------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal f32 weights scaled by 1/sqrt(fan_in) (fan_in = shape[-2],
    so a stacked (groups, K, N) weight scales as each (K, N) slice), on
    the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * s


# ----------------------------------------------------------------------
# Norms / activations / RoPE
# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def lane_rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
                  ) -> torch.Tensor:
    """``rms_norm`` of each leading-axis row alone, at that row's shape
    with a batch axis of one: a reduction kernel may sum in another order
    when it has more rows (on the GPU the threads a row gets depend on
    the number of rows), and a request served in a batch must see the
    bits it would see alone."""
    return torch.cat([rms_norm(x[i:i + 1], gamma, eps)
                      for i in range(x.shape[0])])


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "relu2":  # squared ReLU (nemotron-4)
        r = F.relu(x)
        return r * r
    if kind == "gelu":   # jax.nn.gelu's default is the tanh form
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def rope_inv_freq(dim: int, theta: float) -> np.ndarray:
    """(dim/2,) f32 inverse frequencies ``1 / theta ** (arange/dim)``,
    computed in float64 from the f32 exponents and rounded once."""
    expo = np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim)
    return (1.0 / np.power(np.float64(theta), expo.astype(np.float64))
            ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inv_freq_on(dim: int, theta: float, device: torch.device
                 ) -> torch.Tensor:
    """``rope_inv_freq`` on ``device``, copied once: a copy from host
    memory every layer would wait for the stream each time."""
    return torch.from_numpy(rope_inv_freq(dim, theta)).to(device)


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin (..., dim/2) f32.  The inverse
    frequencies (``rope_inv_freq``) equal the reference's f32 ones
    element for element (``tests/test_torch_lm.py``)."""
    inv = _inv_freq_on(dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B,S,H,D); cos/sin: (S,D/2) or (B,S,D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------------
# Attention (GQA, optional qk-norm / bias, optional KV cache)
# ----------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: LMConfig, lead: tuple = ()
                   ) -> dict:
    """Attention weights, with ``lead`` stacked leading dims (layer
    groups)."""
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (*lead, d, h * hd)),
        "wk": dense_init(gen, (*lead, d, hk * hd)),
        "wv": dense_init(gen, (*lead, d, hk * hd)),
        "wo": dense_init(gen, (*lead, h * hd, d)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", hk * hd),
                            ("bv", hk * hd)):
            p[name] = torch.zeros((*lead, width), device=dev)
    if cfg.qk_norm:
        p["qnorm"] = torch.ones((*lead, hd), device=dev)
        p["knorm"] = torch.ones((*lead, hd), device=dev)
    return p


def _grouped_attention(q, k, v, mask_bias) -> torch.Tensor:
    """q: (B,S,H,D) k/v: (B,T,Hkv,D); returns (B,S,H,D) f32.  Grouped
    einsum — never materializes repeated KV heads.  Operands in the
    working dtype, products and sums in f32; the probabilities are
    rounded to v's dtype first, as in the reference."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    f32 = torch.float32
    q = q.reshape(b, s, hk, g, d).to(f32)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k.to(f32))
    scores = scores / math.sqrt(d)
    scores = scores + mask_bias  # (.., S, T) broadcast
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd",
                       probs.to(v.dtype).to(f32), v.to(f32))
    return out.reshape(b, s, h, d)


def _project_qkv(params, x, cfg: LMConfig, policy: ApproxPolicy,
                 positions: torch.Tensor, layer_tag: str, lanes: bool):
    """q (B,S,H,D), k/v (B,S,Hkv,D) in the working dtype: the three
    projections, bias, qk-norm and RoPE.  ``lanes``: each batch row is a
    bank lane of the policy's banked backends (calibrated on its own)
    and qk-norm reduces each row alone."""
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = policy.matmul(f"{layer_tag}.wq", x, params["wq"], lanes=lanes)
    k = policy.matmul(f"{layer_tag}.wk", x, params["wk"], lanes=lanes)
    v = policy.matmul(f"{layer_tag}.wv", x, params["wv"], lanes=lanes)
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hk, hd)
    v = v.reshape(b, s, hk, hd)
    if cfg.qk_norm:
        norm = lane_rms_norm if lanes else rms_norm
        q = norm(q, params["qnorm"], cfg.norm_eps)
        k = norm(k, params["knorm"], cfg.norm_eps)
    if cfg.use_rope:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q.to(cfg.dtype), k.to(cfg.dtype), v.to(cfg.dtype)


def _project_out(params, out, cfg: LMConfig, policy: ApproxPolicy,
                 layer_tag: str, lanes: bool) -> torch.Tensor:
    b, s = out.shape[:2]
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    out = policy.matmul(f"{layer_tag}.wo", out, params["wo"], lanes=lanes)
    return out.to(cfg.dtype)


def causal_bias(first: int, s: int, t: int, device) -> torch.Tensor:
    """(s, t) mask of queries at rows first..first+s-1 over t keys: 0
    where the key's position is at most the query's row, -1e30 after."""
    keys = torch.arange(t, device=device)
    rows = torch.arange(first, first + s, device=device)
    return torch.where(keys[None, :] <= rows[:, None], 0.0, -1e30)


def attention(params, x, cfg: LMConfig, policy: ApproxPolicy, *,
              positions: torch.Tensor, cache: Optional[dict] = None,
              layer_tag: str = "attn", lanes: bool = False
              ) -> tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,D).  cache: {"k": (B,T,Hkv,D), "v": ..., "pos": int} —
    the new keys and values are written into the cache at ``pos`` (in
    place) and the queries attend over the whole cache, later slots
    masked by a -1e30 bias as in the reference.  Without a cache, causal
    self-attention over x.  ``lanes``: the batch axis is a bank lane
    axis (``_project_qkv``)."""
    if cfg.attn_impl == "chunked":
        raise NotImplementedError(
            f"attn_impl='chunked' (_chunked_grouped_attention) is not "
            f"ported yet ({ZOO_ITEM})")
    s = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, policy, positions, layer_tag,
                           lanes)
    if cache is None:
        out = _grouped_attention(q, k, v, causal_bias(0, s, s, x.device))
        new_cache = None
    else:
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        ck[:, pos:pos + s] = k
        cv[:, pos:pos + s] = v
        out = _grouped_attention(q, ck, cv, causal_bias(
            pos, s, ck.shape[1], x.device))
        new_cache = {"k": ck, "v": cv, "pos": pos + s}
    return _project_out(params, out, cfg, policy, layer_tag,
                        lanes), new_cache


def lane_attention(params, x, cfg: LMConfig, policy: ApproxPolicy, *,
                   positions: torch.Tensor, kv, biases: list,
                   layer_tag: str = "attn") -> torch.Tensor:
    """One decode step of n requests, each a bank lane: x (n,1,D),
    positions (n,1) (each lane's cache row).  The projections run once
    for all lanes (``lanes=True``); ``kv(k, v)`` stores each lane's new
    key and value rows (n,1,Hkv,D) and returns each lane's cache view
    ``(k_i, v_i)``, (1,T_i,Hkv,D) with the new row at its position, and
    ``biases[i]`` is lane i's (1,T_i) mask.  Attention runs lane by lane
    at B=1 over exactly that view, so its float reductions see the
    shapes a sequential B=1 decode with a T_i-row cache gives them."""
    q, k, v = _project_qkv(params, x, cfg, policy, positions, layer_tag,
                           True)
    out = torch.cat([
        _grouped_attention(q[i:i + 1].clone(), ki, vi, biases[i])
        for i, (ki, vi) in enumerate(kv(k, v))])
    return _project_out(params, out, cfg, policy, layer_tag, True)


def init_attention_cache(cfg: LMConfig, batch: int, max_len: int,
                         device=None, lead: tuple = ()) -> dict:
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}


# ----------------------------------------------------------------------
# FFN
# ----------------------------------------------------------------------
def init_ffn(gen: torch.Generator, cfg: LMConfig,
             d_ff: Optional[int] = None, lead: tuple = ()) -> dict:
    d_ff = d_ff or cfg.d_ff
    p = {"wi": dense_init(gen, (*lead, cfg.d_model, d_ff)),
         "wo": dense_init(gen, (*lead, d_ff, cfg.d_model))}
    if cfg.act == "silu":  # gated
        p["wg"] = dense_init(gen, (*lead, cfg.d_model, d_ff))
    return p


def ffn(params, x, cfg: LMConfig, policy: ApproxPolicy,
        layer_tag: str = "ffn", lanes: bool = False) -> torch.Tensor:
    """``lanes``: x's batch axis is a bank lane axis."""
    hidden = policy.matmul(f"{layer_tag}.wi", x, params["wi"], lanes=lanes)
    if cfg.act == "silu":
        gate = policy.matmul(f"{layer_tag}.wg", x, params["wg"],
                             lanes=lanes)
        hidden = F.silu(gate) * hidden
    else:
        hidden = activation(hidden, cfg.act)
    return policy.matmul(f"{layer_tag}.wo", hidden.to(cfg.dtype),
                         params["wo"], lanes=lanes).to(cfg.dtype)


def logits_from_hidden(hidden: torch.Tensor, w_unembed: torch.Tensor
                       ) -> torch.Tensor:
    return torch.matmul(hidden.to(torch.float32),
                        w_unembed.to(torch.float32).T)
