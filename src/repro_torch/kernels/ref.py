"""Plain-PyTorch versions of the CUDA kernels (port of
``repro.kernels.ref``).

They repeat each kernel's arithmetic with ordinary tensor ops — the
``lut`` datapath's blocked gather — so the CPU tests can compare them
with the JAX reference and ``chip_smoke.py`` can compare each kernel
with its plain version on the card.  The fused versions take the
scalars packed (``fused_matmul.pack_scalars``) and the composed codes
(``pack_codes``) and return the kernels' integer outputs; the f32 result
is ``fused_matmul.dequant`` of them (``dequant_lanes`` in
``kernels.ops``, the same ops on the unpacked scalars).  The
composed versions on codes return the kernels' int32 limbs, the bitsim
versions int32 words holding the uint32 bit patterns.  They are no
yardstick of speed.
"""
from __future__ import annotations

import torch

from ..approx.quant import clip_codes
from ..core.gates import GATE_ARITY
from ..approx.registry import (composed_forward, composed_limbs,
                               lowrank_gather, lut_gather)


def _rows(qw: torch.Tensor) -> int:
    """Rows per gather block: each (rows, K, N) temporary near 2^17
    elements on the CPU, so it stays in a core's cache, and 2^24 on the
    card, where a block is a round of kernel launches."""
    k, n = qw.shape[-2:]
    return max(1, (1 << (24 if qw.is_cuda else 17)) // max(1, k * n))


def approx_matmul_lut_ref(qa: torch.Tensor, qw: torch.Tensor,
                          lut: torch.Tensor) -> torch.Tensor:
    """Σ_k LUT[qa[m,k], qw[k,n]] with int32 accumulation.
    qa: (M,K) int32 codes in [0,255]; qw: (K,N); lut: (256,256)."""
    return lut_gather(qa, qw, lut, _rows(qw))


def approx_matmul_lut_bank_ref(qa: torch.Tensor, qw: torch.Tensor,
                               luts: torch.Tensor) -> torch.Tensor:
    """Banked version: out[b] = Σ_k luts[b][qa_b, qw] with int32
    accumulation.  qa: (M,K) shared codes or (n,M,K) banked codes;
    qw: (K,N); luts: (n,256,256) -> (n,M,N) int32."""
    return torch.stack([
        approx_matmul_lut_ref(qa if qa.ndim == 2 else qa[b], qw, luts[b])
        for b in range(luts.shape[0])])


def approx_matmul_lut_experts_ref(qa: torch.Tensor, qw: torch.Tensor,
                                  lut: torch.Tensor) -> torch.Tensor:
    """The expert form of K1's plain version: qa (X,M,K) codes, qw
    (E,K,N) with E dividing X, lut (256,256) -> (X,M,N) int32, slice s
    equal to ``approx_matmul_lut_ref(qa[s], qw[s % E], lut)``."""
    e = qw.shape[0]
    return torch.stack([approx_matmul_lut_ref(qa[s], qw[s % e], lut)
                        for s in range(qa.shape[0])])


def approx_matmul_lut_bank_experts_ref(qa: torch.Tensor, qw: torch.Tensor,
                                       luts: torch.Tensor) -> torch.Tensor:
    """The expert form of K2's plain version: qa (X,M,K) shared or
    (n,X,M,K) banked codes, qw (E,K,N), luts (n,256,256) -> (n,X,M,N)
    int32, lane l's slice s equal to ``approx_matmul_lut_ref(qa_l[s],
    qw[s % E], luts[l])``."""
    return torch.stack([
        approx_matmul_lut_experts_ref(qa if qa.ndim == 3 else qa[b], qw,
                                      luts[b])
        for b in range(luts.shape[0])])


def composed_matmul_ref(qa: torch.Tensor, qw: torch.Tensor,
                        lut: torch.Tensor, mask,
                        reduce: tuple = ("exact", 0)) -> torch.Tensor:
    """Composed wide (12/16-bit) matmul on codes: digit products through
    the 256x256 tile LUT, the static ``reduce`` tree, the 2W-bit
    ``mask`` (0 = narrow lane), exact int32 limbs recombined in f32 —
    (M,K) x (K,N) -> (M,N) f32 (the ``lut`` datapath's composed core)."""
    return composed_forward(qa, qw, lut, mask, reduce, _rows(qw))


def _quant(v: torch.Tensor, scale, zp, qmax) -> torch.Tensor:
    """The kernels' in-register quantize, op for op: round, + zero point
    in f32, clip to [0, qmax], cast."""
    q = torch.round(v.to(torch.float32) / scale) + zp
    return clip_codes(q, qmax).to(torch.int32)


def _lane_codes(x, w, b, fp, ip):
    qa = _quant(x if x.ndim == 2 else x[b], fp[b, 0], ip[b, 0], fp[b, 2])
    qw = _quant(w, fp[b, 1], ip[b, 1], fp[b, 2])
    return qa, qw


def _stack(per_lane: list) -> tuple:
    return tuple(torch.stack(ts) for ts in zip(*per_lane))


def _sums(qa, qw) -> tuple:
    return (torch.sum(qa, dim=1, dtype=torch.int32),
            torch.sum(qw, dim=0, dtype=torch.int32))


def fused_matmul_bank_ref(x: torch.Tensor, w: torch.Tensor,
                          luts: torch.Tensor, fp: torch.Tensor,
                          ip: torch.Tensor) -> tuple:
    """K4's plain version: x (M,K) shared or (n,M,K) banked f32, w (K,N),
    luts (n,256,256), fp (n,3) = (sa, sw, qmax), ip (n,2) = (za, zw) ->
    acc (n,M,N), row (n,M), col (n,N) int32."""
    out = []
    for b in range(luts.shape[0]):
        qa, qw = _lane_codes(x, w, b, fp, ip)
        out.append((approx_matmul_lut_ref(qa, qw, luts[b]),
                    *_sums(qa, qw)))
    return _stack(out)


def fused_matmul_ref(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor,
                     fp: torch.Tensor, ip: torch.Tensor) -> tuple:
    """K3's plain version: x (M,K), w (K,N) f32, lut (256,256), fp (1,3),
    ip (1,2) -> acc (M,N), row (M,), col (N,) int32."""
    return tuple(t[0] for t in fused_matmul_bank_ref(x, w, lut[None], fp,
                                                     ip))


def fused_matmul_bank_experts_ref(x: torch.Tensor, w: torch.Tensor,
                                  luts: torch.Tensor, fp: torch.Tensor,
                                  ip: torch.Tensor) -> tuple:
    """The expert form of K4's plain version: x (X,M,K) shared or
    (n,X,M,K) banked f32, w (E,K,N) with E dividing X, luts (n,256,256),
    fp (n X, 3) and ip (n X, 2) the scalars of each (lane, slice) pair,
    lane-major -> acc (n,X,M,N), row (n,X,M), col (n,X,N) int32: pair
    p = l X + s is ``fused_matmul_ref`` of x_l[s] and w[s % E] under
    luts[l] with pair p's scalars."""
    xs, e = x.shape[-3], w.shape[0]
    out = []
    for b in range(luts.shape[0]):
        xl = x if x.ndim == 3 else x[b]
        out.append(_stack([
            fused_matmul_ref(xl[s], w[s % e], luts[b], fp[b * xs + s][None],
                             ip[b * xs + s][None]) for s in range(xs)]))
    return _stack(out)


def fused_matmul_experts_ref(x: torch.Tensor, w: torch.Tensor,
                             lut: torch.Tensor, fp: torch.Tensor,
                             ip: torch.Tensor) -> tuple:
    """The expert form of K3's plain version: x (X,M,K), w (E,K,N), lut
    (256,256), fp (X,3), ip (X,2) -> acc (X,M,N), row (X,M), col (X,N)
    int32 (``fused_matmul_bank_experts_ref`` with one lane)."""
    return tuple(t[0] for t in fused_matmul_bank_experts_ref(
        x, w, lut[None], fp, ip))


def _composed_limbs(qa, qw, lut, mask: int, kind: int, k: int) -> tuple:
    """(lo, hi) int32 limb sums of the composed product under the reduce
    code (kind, k); a narrow lane (mask 0) sums the low-digit products
    and its hi limb is 0."""
    return composed_limbs(qa, qw, lut.reshape(-1).to(torch.int32), mask,
                          kind, k, _rows(qw))


def fused_composed_matmul_bank_ref(x: torch.Tensor, w: torch.Tensor,
                                   luts: torch.Tensor, masks: torch.Tensor,
                                   rcodes: torch.Tensor, fp: torch.Tensor,
                                   ip: torch.Tensor) -> tuple:
    """K8's plain version: as ``fused_matmul_bank_ref`` plus masks (n,)
    int64 (uint32 values, 0 = narrow lane) and rcodes (n,2) int32
    ``encode_reduce`` codes -> lo, hi (n,M,N), row (n,M), col (n,N)
    int32."""
    out = []
    # per-lane codes read on the host: each lane computes its own tree
    # family only (reduce_apply_dyn's host-code path, same values)
    for b, (mask, (kind, k)) in enumerate(zip(masks.tolist(),
                                              rcodes.tolist())):
        qa, qw = _lane_codes(x, w, b, fp, ip)
        out.append((*_composed_limbs(qa, qw, luts[b], mask, kind, k),
                    *_sums(qa, qw)))
    return _stack(out)


def fused_composed_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                              lut: torch.Tensor, masks: torch.Tensor,
                              rcodes: torch.Tensor, fp: torch.Tensor,
                              ip: torch.Tensor) -> tuple:
    """K7's plain version: masks (1,), rcodes (1,2), fp (1,3), ip (1,2)
    -> lo, hi (M,N), row (M,), col (N,) int32."""
    return tuple(t[0] for t in fused_composed_matmul_bank_ref(
        x, w, lut[None], masks, rcodes, fp, ip))


def composed_matmul_bank_ref(qa: torch.Tensor, qw: torch.Tensor,
                             luts: torch.Tensor, masks: torch.Tensor,
                             rcodes: torch.Tensor) -> tuple:
    """K6's plain version: qa (M,K) shared or (n,M,K) banked int32 W-bit
    codes, qw (K,N) shared or (n,K,N) banked, luts (n,256,256) tile LUTs,
    masks (n,) int64 (uint32 values, 0 = narrow lane), rcodes (n,2) int32
    ``encode_reduce`` codes -> lo, hi (n,M,N) int32 limbs."""
    return _stack([
        _composed_limbs(qa if qa.ndim == 2 else qa[b],
                        qw if qw.ndim == 2 else qw[b], luts[b], mask, kind,
                        k)
        for b, (mask, (kind, k)) in enumerate(zip(masks.tolist(),
                                                  rcodes.tolist()))])


def composed_matmul_limbs_ref(qa: torch.Tensor, qw: torch.Tensor,
                              lut: torch.Tensor, masks: torch.Tensor,
                              rcodes: torch.Tensor) -> tuple:
    """K5's plain version: masks (1,), rcodes (1,2) -> lo, hi (M,N) int32
    limbs (``composed_matmul_ref`` is their f32 recombination)."""
    return tuple(t[0] for t in composed_matmul_bank_ref(
        qa, qw, lut[None], masks, rcodes))


def composed_matmul_bank_experts_ref(qa: torch.Tensor, qw: torch.Tensor,
                                     luts: torch.Tensor, masks: torch.Tensor,
                                     rcodes: torch.Tensor) -> tuple:
    """The expert form of K6's plain version: qa (X,M,K) shared or
    (n,X,M,K) banked codes, qw (E,K,N) shared or (n,E,K,N) banked, E
    dividing X -> lo, hi (n,X,M,N), lane b's slice s equal to
    ``composed_matmul_bank_ref`` of qa_b[s] and qw_b[s % E] under lane b's
    table, mask and code."""
    xs, e = qa.shape[-3], qw.shape[-3]
    return _stack([_stack([
        _composed_limbs(qa[s] if qa.ndim == 3 else qa[b, s],
                        qw[s % e] if qw.ndim == 3 else qw[b, s % e],
                        luts[b], mask, kind, k) for s in range(xs)])
        for b, (mask, (kind, k)) in enumerate(zip(masks.tolist(),
                                                  rcodes.tolist()))])


def composed_matmul_limbs_experts_ref(qa: torch.Tensor, qw: torch.Tensor,
                                      lut: torch.Tensor, masks: torch.Tensor,
                                      rcodes: torch.Tensor) -> tuple:
    """The expert form of K5's plain version: qa (X,M,K), qw (E,K,N) ->
    lo, hi (X,M,N)."""
    return tuple(t[0] for t in composed_matmul_bank_experts_ref(
        qa, qw, lut[None], masks, rcodes))


def fused_composed_matmul_bank_experts_ref(
        x: torch.Tensor, w: torch.Tensor, luts: torch.Tensor,
        masks: torch.Tensor, rcodes: torch.Tensor, fp: torch.Tensor,
        ip: torch.Tensor) -> tuple:
    """The expert form of K8's plain version: x (X,M,K) shared or
    (n,X,M,K) banked f32, w (E,K,N), masks (n,), rcodes (n,2), fp (n X,
    3) and ip (n X, 2) the scalars of each (lane, slice) pair, lane-major
    -> lo, hi (n,X,M,N), row (n,X,M), col (n,X,N) int32: pair p = l X +
    s is ``fused_composed_matmul_ref`` of x_l[s] and w[s % E] under lane
    l's table, mask and code with pair p's scalars."""
    xs, e = x.shape[-3], w.shape[0]
    out = []
    for b in range(luts.shape[0]):
        xl = x if x.ndim == 3 else x[b]
        out.append(_stack([
            fused_composed_matmul_ref(
                xl[s], w[s % e], luts[b], masks[b:b + 1], rcodes[b:b + 1],
                fp[b * xs + s][None], ip[b * xs + s][None])
            for s in range(xs)]))
    return _stack(out)


def fused_composed_matmul_experts_ref(x: torch.Tensor, w: torch.Tensor,
                                      lut: torch.Tensor, masks: torch.Tensor,
                                      rcodes: torch.Tensor, fp: torch.Tensor,
                                      ip: torch.Tensor) -> tuple:
    """The expert form of K7's plain version: x (X,M,K), w (E,K,N), fp
    (X,3), ip (X,2) -> lo, hi (X,M,N), row (X,M), col (X,N) int32."""
    return tuple(t[0] for t in fused_composed_matmul_bank_experts_ref(
        x, w, lut[None], masks, rcodes, fp, ip))


# the ten gate functions of core/gates.py on int32 words (uint32 bit
# patterns): identity, not, and, or, xor, nand, nor, xnor, const0, const1
_GATES = (lambda a, b: a, lambda a, b: ~a, lambda a, b: a & b,
          lambda a, b: a | b, lambda a, b: a ^ b, lambda a, b: ~(a & b),
          lambda a, b: ~(a | b), lambda a, b: ~(a ^ b),
          lambda a, b: torch.zeros_like(a), lambda a, b: ~torch.zeros_like(a))


def bitsim_ref(funcs: torch.Tensor, in0: torch.Tensor, in1: torch.Tensor,
               outs: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """K10's plain version: a gate netlist on bit-planes, gate by gate.
    funcs/in0/in1 (n_nodes,), outs (n_o,) int32; planes (n_i, W) int32
    words (uint32 bit patterns) -> (n_o, W) int32 words.  A gate reads
    only the inputs its arity uses, as ``Netlist.eval_words`` does."""
    zeros = planes.new_zeros(planes.shape[1])
    sigs = list(planes.unbind(0))
    for f, a, b in zip(funcs.tolist(), in0.tolist(), in1.tolist()):
        arity = int(GATE_ARITY[f])
        sigs.append(_GATES[f](sigs[a] if arity >= 1 else zeros,
                              sigs[b] if arity >= 2 else zeros))
    return torch.stack([sigs[o] for o in outs.tolist()])


def bitsim_pop_ref(funcs: torch.Tensor, in0: torch.Tensor,
                   in1: torch.Tensor, outs: torch.Tensor,
                   planes: torch.Tensor) -> torch.Tensor:
    """K11's plain version: ``bitsim_ref`` per candidate, stacked.
    funcs/in0/in1 (P, n_nodes), outs (P, n_o); planes (n_i, W) shared ->
    (P, n_o, W) int32 words."""
    return torch.stack([bitsim_ref(funcs[p], in0[p], in1[p], outs[p],
                                   planes)
                        for p in range(funcs.shape[0])])


def lowrank_matmul_ref(qa: torch.Tensor, qw: torch.Tensor, u: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Σ_r tableU_r(qa) @ tableV_r(qw) in f32: the ``lowrank``
    datapath's gathers and contraction.  qa (M,K), qw (K,N) int32 codes
    in [0,255]; u, v (R,256) f32 -> (M,N) f32."""
    return lowrank_gather(qa, qw, u, v)


def lowrank_matmul_experts_ref(qa: torch.Tensor, qw: torch.Tensor,
                               u: torch.Tensor, v: torch.Tensor
                               ) -> torch.Tensor:
    """The expert form of K9's plain version: qa (X,M,K), qw (E,K,N) with
    E dividing X -> (X,M,N) f32, slice s equal to
    ``lowrank_matmul_ref(qa[s], qw[s % E], u, v)``."""
    e = qw.shape[0]
    return torch.stack([lowrank_matmul_ref(qa[s], qw[s % e], u, v)
                        for s in range(qa.shape[0])])


def lowrank_bound(qa: torch.Tensor, qw: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The error bound every f32 evaluation of ``lowrank_matmul_ref``'s
    sum is held to, whatever its order: ``(y64, tol)`` with ``y64`` the
    same sum in float64 and ``tol = 2 (K R + 1) 2^-24 S``, ``S =
    Σ_r |U_r(qa)| @ |V_r(qw)|`` in float64 — a recursive f32 sum of
    K·R products errs by at most (K R) u S with u = 2^-24, so a result
    ``y`` passes when ``|y - y64| <= tol`` elementwise."""
    ua = u.to(torch.float64)[:, qa.long()]
    vw = v.to(torch.float64)[:, qw.long()]
    y64 = torch.einsum("rmk,rkn->mn", ua, vw)
    s = torch.einsum("rmk,rkn->mn", ua.abs(), vw.abs())
    k, r = qa.shape[1], u.shape[0]
    return y64, 2.0 * (k * r + 1) * 2.0 ** -24 * s


def lowrank_bound_experts(qa: torch.Tensor, qw: torch.Tensor,
                          u: torch.Tensor, v: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lowrank_bound`` per slice of the expert form: qa (X,M,K), qw
    (E,K,N) -> ``(y64, tol)``, each (X,M,N), slice s the bound of
    ``lowrank_matmul_ref(qa[s], qw[s % E], u, v)``."""
    e = qw.shape[0]
    per = [lowrank_bound(qa[s], qw[s % e], u, v)
           for s in range(qa.shape[0])]
    return torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per])
