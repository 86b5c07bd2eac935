"""Plain-PyTorch versions of the CUDA kernels (port of
``repro.kernels.ref``).

They repeat each kernel's arithmetic with ordinary tensor ops — the
``lut`` datapath's blocked gather — so the CPU tests can compare them
with the JAX reference and ``chip_smoke.py`` can compare each kernel
with its plain version on the card.  They are no yardstick of speed.
"""
from __future__ import annotations

import torch

from ..approx.registry import lut_gather

# gather block: keeps the (rows, K, N) int64 index tensor near 2^24
# elements whatever the shape
_BLOCK_ELEMS = 1 << 24


def approx_matmul_lut_ref(qa: torch.Tensor, qw: torch.Tensor,
                          lut: torch.Tensor) -> torch.Tensor:
    """Σ_k LUT[qa[m,k], qw[k,n]] with int32 accumulation.
    qa: (M,K) int32 codes in [0,255]; qw: (K,N); lut: (256,256)."""
    k, n = qw.shape
    return lut_gather(qa, qw, lut, max(1, _BLOCK_ELEMS // max(1, k * n)))


def approx_matmul_lut_bank_ref(qa: torch.Tensor, qw: torch.Tensor,
                               luts: torch.Tensor) -> torch.Tensor:
    """Banked version: out[b] = Σ_k luts[b][qa_b, qw] with int32
    accumulation.  qa: (M,K) shared codes or (n,M,K) banked codes;
    qw: (K,N); luts: (n,256,256) -> (n,M,N) int32."""
    return torch.stack([
        approx_matmul_lut_ref(qa if qa.ndim == 2 else qa[b], qw, luts[b])
        for b in range(luts.shape[0])])
