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
the shape a sequential B=1 decode gives it.  The engine's
``serve.kv_cache.LaneCaches`` holds each lane's cache view.

The batched sweeps (``approx.layers.policy_bank_eval``) give the
activations a *bank lane* axis in front instead: a banked backend turns
(B,S,D) into (n,B,S,D).  ``attention`` and ``ffn`` take such inputs as
they come — the projections run once for all lanes, and the attention
products run lane by lane (``each_lane``) — so each lane equals its
sequential evaluation bit for bit.

``chunked_cross_entropy`` is the training loss: each chunk of the
sequence goes through ``torch.utils.checkpoint``, as the reference's
``jax.checkpoint``, so memory stays about ``B * chunk * V``.

The sharding hints (``hint_batch``, ``hint_axis``, ``hint_spec``) are
the counterpart of the reference's ``with_sharding_constraint``
anchors: under an ambient ``DeviceMesh`` (``ambient_mesh``, which the
dry run installs) a DTensor is redistributed to the spec's placements;
without one, or for a plain tensor, each returns its input object.  A
hint changes placement, never a value.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..approx.layers import ApproxPolicy
from ..launch.mesh import NamedSharding, sharded_einsum, sharded_reshape


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
    attn_impl: str = "vanilla"   # vanilla | chunked (flash-style)
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
# Sharding hints (ambient-mesh aware; no-ops without a mesh)
# ----------------------------------------------------------------------
_AMBIENT: list = []


@contextlib.contextmanager
def ambient_mesh(device_mesh):
    """Make ``device_mesh`` (a ``torch.distributed`` ``DeviceMesh`` with
    ``mesh_dim_names``) the mesh the hints place DTensors on, for the
    block (the reference's ``with mesh:``)."""
    _AMBIENT.append(device_mesh)
    try:
        yield device_mesh
    finally:
        _AMBIENT.pop()


def _ambient_mesh():
    return _AMBIENT[-1] if _AMBIENT else None


def hint_batch(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Constrain dim to the data-parallel axes (('pod','data') ∩ mesh).
    Anchors activation sharding so the batch is not replicated, e.g.
    after vocab-sharded embedding gathers."""
    return hint_spec(x, {dim: "batch"})


def hint_axis(x: torch.Tensor, dim: int, axis: str = "model"
              ) -> torch.Tensor:
    """Constrain one dim to a named mesh axis (e.g. experts on 'model')."""
    return hint_spec(x, {dim: axis})


def hint_pspec(shape, dims: dict, axis_names, sizes) -> Optional[tuple]:
    """The spec ``hint_spec`` constrains a ``shape`` to on a mesh of
    ``sizes`` along ``axis_names``: 'batch' expands to the data-parallel
    axes, dims that don't divide are dropped; None when no dim is set."""
    size_of = dict(zip(axis_names, sizes))
    spec: list = [None] * len(shape)
    for dim, axis in dims.items():
        if axis == "batch":
            axes = tuple(a for a in ("pod", "data") if a in size_of)
            if axes and shape[dim] % math.prod(
                    size_of[a] for a in axes) == 0:
                spec[dim] = axes if len(axes) > 1 else axes[0]
        elif axis in size_of and shape[dim] % size_of[axis] == 0:
            spec[dim] = axis
    return None if all(e is None for e in spec) else tuple(spec)


def hint_spec(x: torch.Tensor, dims: dict) -> torch.Tensor:
    """Constrain several dims at once: {dim: 'model' | 'batch'} (the
    spec ``hint_pspec`` builds; the mesh axes it does not name
    replicate).  Returns ``x`` itself without an ambient mesh, for a
    plain tensor, or when no dim divides."""
    m = _ambient_mesh()
    if m is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = hint_pspec(tuple(x.shape), dims, m.mesh_dim_names, m.shape)
    if spec is None:
        return x
    return x.redistribute(m, NamedSharding(m, spec).placements(m))


# ----------------------------------------------------------------------
# Initialization
# ----------------------------------------------------------------------
class MetaGenerator:
    """Stands in for a ``torch.Generator`` where only shapes matter: the
    init functions then draw every parameter on the ``meta`` device (no
    memory, no values), as the reference's ``jax.eval_shape`` does."""
    device = torch.device("meta")


def randn(gen, shape) -> torch.Tensor:
    """Standard normal f32 draws from ``gen`` on its device."""
    meta = gen.device.type == "meta"
    return torch.randn(shape, generator=None if meta else gen,
                       dtype=torch.float32, device=gen.device)


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal f32 weights scaled by 1/sqrt(fan_in) (fan_in = shape[-2],
    so a stacked (groups, K, N) weight scales as each (K, N) slice), on
    the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return randn(gen, shape) * s


# ----------------------------------------------------------------------
# Bank lanes of the batched sweeps
# ----------------------------------------------------------------------
def each_lane(fn, n: Optional[int], ndim: int, *xs):
    """``fn(*xs)`` when ``n`` is None; else ``fn`` over each of ``n``
    bank lanes alone, stacked on a new leading axis.  An ``x`` with
    ``ndim + 1`` dims carries the lane axis in front, one with ``ndim``
    dims is shared by every lane.  Each lane's slice is copied, so its
    float reductions run at the sequential evaluation's shapes on a
    fresh allocation and agree with it bit for bit."""
    if n is None:
        return fn(*xs)
    return torch.stack([
        fn(*(x[i].clone() if x.ndim == ndim + 1 else x for x in xs))
        for i in range(n)])


def lanes_of(ndim: int, *xs) -> Optional[int]:
    """The bank lane count of the first ``x`` with ``ndim + 1`` dims
    (None when none carries a lane axis)."""
    for x in xs:
        if x.ndim == ndim + 1:
            return x.shape[0]
    return None


# ----------------------------------------------------------------------
# Norms / activations / RoPE
# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def rms_norm_lanes(h: torch.Tensor, gamma: torch.Tensor, eps: float
                   ) -> torch.Tensor:
    """``rms_norm`` of a (B,S,D) activation, lane by lane when it carries
    a bank lane axis in front (``each_lane``)."""
    return each_lane(lambda x: rms_norm(x, gamma, eps), lanes_of(3, h), 3,
                     h)


def lane_rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
                  ) -> torch.Tensor:
    """``rms_norm`` of each leading-axis row alone, at that row's shape
    with a batch axis of one: a reduction kernel may sum in another order
    when it has more rows (on the GPU the threads a row gets depend on
    the number of rows), and a request served in a batch must see the
    bits it would see alone."""
    return torch.cat([rms_norm(x[i:i + 1], gamma, eps)
                      for i in range(x.shape[0])])


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32.  Nothing in the reference
    calls it (its encoder-decoder uses ``rms_norm``); it is ported with
    its parity test all the same."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


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
    q = sharded_reshape(q, (b, s, hk, g, d)).to(f32)
    scores = sharded_einsum("bskgd,btkd->bkgst", q, k.to(f32))
    scores = scores / math.sqrt(d)
    scores = scores + mask_bias  # (.., S, T) broadcast
    probs = torch.softmax(scores, dim=-1)
    out = sharded_einsum("bkgst,btkd->bskgd",
                       probs.to(v.dtype).to(f32), v.to(f32))
    return sharded_reshape(out, (b, s, h, d))


def _chunked_grouped_attention(q, k, v, q_pos0: int, t_valid: int,
                               kv_chunk: int) -> torch.Tensor:
    """Flash-style online-softmax attention over KV chunks (the
    reference's ``lax.scan`` as a loop).  q: (B,S,H,D); k/v: (B,T,Hkv,D);
    ``q_pos0`` is the position of q[0] (causal mask: key_pos <= q_pos0 +
    i) and ``t_valid`` the number of real keys (the rest, and the pad of
    the last chunk, masked).  Never builds the (S,T) scores: the working
    set is (S, kv_chunk) a step.  Returns (B,S,H,D) f32."""
    b, s, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = h // hk
    f32 = torch.float32
    qg = (sharded_reshape(q, (b, s, hk, g, d))
          / math.sqrt(d)).to(q.dtype).to(f32)
    c = min(kv_chunk, t)
    pad = (-t) % c
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = q_pos0 + torch.arange(s, device=q.device)
    m = torch.full((b, hk, g, s), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((b, hk, g, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, hk, g, s, d), dtype=f32, device=q.device)
    for i0 in range(0, k.shape[1], c):
        kc, vc = k[:, i0:i0 + c].to(f32), v[:, i0:i0 + c]
        scores = sharded_einsum("bskgd,bckd->bkgsc", qg, kc)
        key_pos = i0 + torch.arange(c, device=q.device)
        valid = ((key_pos[None, :] <= q_pos[:, None])
                 & (key_pos[None, :] < t_valid))
        scores = torch.where(valid, scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.where(valid, torch.exp(scores - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = sharded_einsum("bkgsc,bckd->bkgsd", p.to(vc.dtype).to(f32),
                          vc.to(f32))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]       # (b,hk,g,s,d)
    return sharded_reshape(out.permute(0, 3, 1, 2, 4), (b, s, h, d))


def _project_qkv(params, x, cfg: LMConfig, policy: ApproxPolicy,
                 positions: torch.Tensor, layer_tag: str, lanes: bool):
    """q (B,S,H,D), k/v (B,S,Hkv,D) in the working dtype: the three
    projections, bias, qk-norm and RoPE.  ``lanes``: each batch row is a
    bank lane of the policy's banked backends (calibrated on its own)
    and qk-norm reduces each row alone."""
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mm_lanes = lanes or x.ndim == 4          # a bank lane axis in front
    q = policy.matmul(f"{layer_tag}.wq", x, params["wq"], lanes=mm_lanes)
    k = policy.matmul(f"{layer_tag}.wk", x, params["wk"], lanes=mm_lanes)
    v = policy.matmul(f"{layer_tag}.wv", x, params["wv"], lanes=mm_lanes)
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = sharded_reshape(q, (*q.shape[:-1], h, hd))
    k = sharded_reshape(k, (*k.shape[:-1], hk, hd))
    v = sharded_reshape(v, (*v.shape[:-1], hk, hd))
    if cfg.qk_norm:
        def norm(t, gamma):
            if lanes:
                return lane_rms_norm(t, gamma, cfg.norm_eps)
            return each_lane(lambda u: rms_norm(u, gamma, cfg.norm_eps),
                             lanes_of(4, t), 4, t)
        q = norm(q, params["qnorm"])
        k = norm(k, params["knorm"])
    if cfg.use_rope:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q.to(cfg.dtype), k.to(cfg.dtype), v.to(cfg.dtype)


def _project_out(params, out, cfg: LMConfig, policy: ApproxPolicy,
                 layer_tag: str, lanes: bool) -> torch.Tensor:
    lanes = lanes or out.ndim == 5
    out = sharded_reshape(out, (*out.shape[:-2],
                                cfg.n_heads * cfg.head_dim))
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
    axis (``_project_qkv``).  Under a banked backend q/k/v gain a bank
    lane axis in front: the cache then takes one too (a copy, each lane
    writing its own keys and values) and attention runs lane by lane
    (``each_lane``).  ``cfg.attn_impl == "chunked"`` runs the
    flash-style ``_chunked_grouped_attention`` over the same keys."""
    s = x.shape[-2]
    q, k, v = _project_qkv(params, x, cfg, policy, positions, layer_tag,
                           lanes)
    n = lanes_of(4, q, k, v)
    first, t_valid = 0, s
    if cache is None:
        new_cache = None
    else:
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        if n is not None and ck.ndim == 4:
            ck = ck.expand(n, *ck.shape).clone()
            cv = cv.expand(n, *cv.shape).clone()
        ck[..., pos:pos + s, :, :] = k
        cv[..., pos:pos + s, :, :] = v
        k, v = ck, cv
        first, t_valid = pos, pos + s
        new_cache = {"k": ck, "v": cv, "pos": pos + s}
    if cfg.attn_impl == "chunked":
        def core(q_, k_, v_):
            return _chunked_grouped_attention(q_, k_, v_, first, t_valid,
                                              cfg.kv_chunk)
    else:
        bias = causal_bias(first, s, k.shape[-3], x.device)

        def core(q_, k_, v_):
            return _grouped_attention(q_, k_, v_, bias)
    out = each_lane(core, n, 4, q, k, v)
    return _project_out(params, out, cfg, policy, layer_tag,
                        lanes), new_cache


def lane_attention(params, x, cfg: LMConfig, policy: ApproxPolicy, *,
                   positions: torch.Tensor, cache, at: tuple,
                   layer_tag: str = "attn") -> torch.Tensor:
    """One decode step of n requests, each a bank lane: x (n,1,D),
    positions (n,1) (each lane's cache row).  The projections run once
    for all lanes (``lanes=True``); ``cache`` (``serve.kv_cache.
    LaneCaches``) stores each lane's new key and value rows in the
    leaves ``at = (prefix, g)`` and gives each lane's view (1,T_i,Hkv,D)
    with the new row at its position.  Attention runs lane by lane at
    B=1 over exactly that view, masked by the lane's causal bias, or
    under ``cfg.attn_impl == "chunked"`` in KV chunks from its position,
    so its float reductions see the shapes a sequential B=1 decode with
    a T_i-row cache gives them."""
    q, k, v = _project_qkv(params, x, cfg, policy, positions, layer_tag,
                           True)
    outs = []
    for i, view in enumerate(cache.rows_of(*at, {"k": k, "v": v})):
        q_i = q[i:i + 1].clone()
        if cfg.attn_impl == "chunked":
            p = cache.pos[i]
            outs.append(_chunked_grouped_attention(
                q_i, view["k"], view["v"], p, p + 1, cfg.kv_chunk))
        else:
            outs.append(_grouped_attention(q_i, view["k"], view["v"],
                                           cache.bias(i)))
    return _project_out(params, torch.cat(outs), cfg, policy, layer_tag,
                        True)


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
    """``lanes``: x's leading axis is a bank lane axis.  A banked
    backend gives the hidden activations one when x has none."""
    hidden = policy.matmul(f"{layer_tag}.wi", x, params["wi"], lanes=lanes)
    if cfg.act == "silu":
        gate = policy.matmul(f"{layer_tag}.wg", x, params["wg"],
                             lanes=lanes)
        hidden = F.silu(gate) * hidden
    else:
        hidden = activation(hidden, cfg.act)
    return policy.matmul(f"{layer_tag}.wo", hidden.to(cfg.dtype),
                         params["wo"],
                         lanes=lanes or hidden.ndim > x.ndim
                         ).to(cfg.dtype)


# ----------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------
def _chunk_loss(h, t, m, w_unembed):
    """Summed masked CE of one (B, chunk) slice, and its mask count."""
    logits = torch.matmul(h.to(torch.float32),
                          w_unembed.to(torch.float32).T)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    if hasattr(logits, "placements"):
        # a DTensor (the dry run): pick the target column by a compare,
        # which a vocab-sharded DTensor runs shard by shard; its gather
        # goes through a masked-partial placement that some torch
        # releases cannot run on meta shards.  The same value: one
        # logit plus zeros.
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(vocab == t.long()[..., None], logits,
                           0.0).sum(dim=-1, keepdim=True)
    else:
        gold = torch.gather(logits, -1, t.long()[..., None])
    return torch.sum((lse - gold)[..., 0] * m), torch.sum(m)


def chunked_cross_entropy(hidden: torch.Tensor, w_unembed: torch.Tensor,
                          targets: torch.Tensor, chunk: int,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean CE over (B,S) without materializing (B,S,V) logits: the
    sequence is padded to a multiple of ``chunk`` (pad rows masked out)
    and processed chunk by chunk, each chunk's logits recomputed in the
    backward pass (``torch.utils.checkpoint``) when gradients are
    recorded.  The chunk sums add up in order, as the reference's
    scan."""
    from torch.utils.checkpoint import checkpoint

    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i0 in range(0, hidden.shape[1], chunk):
        args = (hidden[:, i0:i0 + chunk], targets[:, i0:i0 + chunk],
                mask[:, i0:i0 + chunk], w_unembed)
        if torch.is_grad_enabled():
            l, n = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            l, n = _chunk_loss(*args)
        total = total + l
        count = count + n
    return total / torch.clamp_min(count, 1.0)


def logits_from_hidden(hidden: torch.Tensor, w_unembed: torch.Tensor
                       ) -> torch.Tensor:
    return torch.matmul(hidden.to(torch.float32),
                        w_unembed.to(torch.float32).T)
