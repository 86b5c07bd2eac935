"""CUDA kernel K9: rank-R factored approximate matmul.

``lowrank_matmul(qa, qw, u, v)`` launches ``csrc/lowrank_matmul.cu`` —
the Hopper counterpart of the reference's TPU kernel
``lowrank_matmul_pallas`` (``repro/kernels/lowrank_matmul.py``):
``out[m,n] = Σ_r Σ_k U[r, qa[m,k]] · V[r, qw[k,n]]`` in f32.  Both
factor tables sit in shared memory and the operand tiles are gathered
through them chunk by chunk; see the source for the design.

Callers go through ``repro_torch.kernels.ops.lowrank_matmul``, which
validates the operands and sends CPU tensors to the plain version
(``kernels.ref.lowrank_matmul_ref``).  ``lowrank_matmul.launches``
counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: Largest rank the kernel takes: 2 x 16 x 256 f32 tables (32 KB) in
#: shared memory beside the operand tiles (``csrc/lowrank_matmul.cu``
#: ``kMaxRank``).
MAX_RANK = 16


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("lowrank_matmul").lowrank_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lowrank_matmul(qa: torch.Tensor, qw: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Launch K9 on the current stream.  qa (M,K) int32, qw (K,N) int32,
    u, v (R,256) f32 with 1 <= R <= ``MAX_RANK``, all contiguous on one
    CUDA device (checked by ``ops.lowrank_matmul``) -> (M,N) f32."""
    m, k = qa.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=qa.device)
    if m == 0 or n == 0:
        return out
    err = _launcher()(
        _ptr(qa), _ptr(qw), _ptr(u), _ptr(v), _ptr(out), m, k, n,
        u.shape[0],
        ctypes.c_void_p(torch.cuda.current_stream(qa.device).cuda_stream))
    build.check("lowrank_matmul", err)
    lowrank_matmul.launches += 1
    return out


lowrank_matmul.launches = 0
