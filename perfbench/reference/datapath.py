"""The emulated accelerator datapath, written out plainly.

An approximate unsigned 8-bit multiplier is emulated bit for bit by its
256 x 256 product table.  Both operands of a projection are quantized
asymmetrically to [0, 255]:

    scale = max((max(hi, 0) - min(lo, 0)) * fl32(1/255), 1e-8)
    zp    = clip(round(-min(lo, 0) / scale), 0, 255)
    q     = clip(round(x / scale) + zp, 0, 255)

over the whole operand (one bank lane's activation; one weight matrix;
one expert's capacity buffer).  Only ``qa * qw`` goes through the table;
the zero-point corrections are exact code sums, and the f32 epilogue
rounds each correction on its own:

    y = (S - trunc(zw R) - trunc(za C) + trunc(K za zw)) * (sa sw)

with ``S = sum_k T[qa, qw]``, ``R`` the row sums of ``qa`` and ``C`` the
column sums of ``qw``.  ``fl32(1/255)`` is the multiply by the rounded
reciprocal that the datapath specifies (a compiler's rewrite of the
division by the constant 255).

``work_dtype`` lowers the float parts for the control run: the operands
are rounded to it before they are quantized, and the result after the
epilogue.  Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np
import torch

RECIP255 = float(np.float32(1.0 / 255.0))
QMAX = 255.0
#: gathered products held at once (int32): 2^24 of them, 64 MB
GATHER_BLOCK = 1 << 24


def calibrate(x: torch.Tensor, dims=None):
    """Scale and zero point of ``x`` over ``dims`` (all when None),
    kept as broadcastable f32 tensors."""
    if dims is None:
        lo, hi = torch.amin(x), torch.amax(x)
    else:
        lo = torch.amin(x, dim=dims, keepdim=True)
        hi = torch.amax(x, dim=dims, keepdim=True)
    lo = torch.clamp_max(lo, 0.0).to(torch.float32)
    hi = torch.clamp_min(hi, 0.0).to(torch.float32)
    scale = torch.clamp_min((hi - lo) * RECIP255, 1e-8)
    zp = torch.clamp(torch.round(-lo / scale), 0.0, QMAX)
    return scale, zp


def quantize(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor
             ) -> torch.Tensor:
    q = torch.round(x.to(torch.float32) / scale) + zp
    return torch.clamp(q, 0.0, QMAX).to(torch.int32)


def table_sums(qa: torch.Tensor, qw: torch.Tensor, table: torch.Tensor
               ) -> torch.Tensor:
    """sum_k T[qa[m, k], qw[k, n]] exactly in int32: qa (M, K), qw (K, N)
    codes, table (256, 256) int32, a block of rows at a time."""
    m, k = qa.shape
    n = qw.shape[1]
    flat = table.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=qa.device)
    rows = max(1, GATHER_BLOCK // max(1, k * n))
    for r0 in range(0, m, rows):
        a = qa[r0:r0 + rows]
        idx = (a << 8)[:, :, None] + qw[None, :, :]
        prods = torch.index_select(flat, 0, idx.reshape(-1))
        out[r0:r0 + rows] = prods.view(idx.shape).sum(dim=1,
                                                      dtype=torch.int32)
    return out


def epilogue(s, row, col, sa, za, sw, zw, k: int) -> torch.Tensor:
    """The f32 correction and dequant, each product rounded alone."""
    t_row = torch.trunc(zw * row.to(torch.float32))
    t_col = torch.trunc(za * col.to(torch.float32))
    t_k = torch.trunc(k * za * zw)
    return (s.to(torch.float32) - t_row - t_col + t_k) * (sa * sw)


def exact_epilogue(qa, qw, row, col, sa, za, sw, zw) -> torch.Tensor:
    """The exact datapath: sum (qa - za)(qw - zw) in integers (products
    in float64, exact below 2^53), one rounding to f32, times sa sw."""
    s = torch.matmul(qa.to(torch.float64), qw.to(torch.float64))
    za, zw = za.to(torch.int64), zw.to(torch.int64)
    acc = (s.to(torch.int64) - zw * row - za * col
           + qa.shape[1] * za * zw)
    return acc.to(torch.float32) * (sa * sw)


def approx_matmul(x: torch.Tensor, w: torch.Tensor, table,
                  work_dtype=torch.float32, rows=None) -> torch.Tensor:
    """x (M, K) @ w (K, N) through the table -> (M, N) f32, each operand
    calibrated over the whole of it.  ``rows`` (a row index): only those
    output rows are computed (the calibration still sees all of x).
    ``table`` None: the exact 8-bit datapath, whose correction stays in
    integers and is rounded once (``exact_epilogue``)."""
    x = x.to(work_dtype).to(torch.float32)
    w = w.to(work_dtype).to(torch.float32)
    sa, za = calibrate(x)
    sw, zw = calibrate(w)
    if rows is not None:
        x = x[rows]
    qa, qw = quantize(x, sa, za), quantize(w, sw, zw)
    row = qa.sum(dim=1, dtype=torch.int32)[:, None]
    col = qw.sum(dim=0, dtype=torch.int32)[None, :]
    if table is None:
        y = exact_epilogue(qa, qw, row, col, sa, za, sw, zw)
    else:
        y = epilogue(table_sums(qa, qw, table), row, col, sa, za, sw, zw,
                     x.shape[1])
    return y.to(work_dtype).to(torch.float32)
