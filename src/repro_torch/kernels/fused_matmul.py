"""CUDA kernels K3, K4, K7, K8: the fused quantize → LUT-gather →
accumulate datapath, at 8 bits and at composed 12/16 bits.

Hopper counterparts of the reference's TPU kernels in
``repro/kernels/fused_matmul.py``:

  * K3 ``fused_matmul`` (``csrc/fused_matmul.cu``) — f32 x (M,K), w (K,N)
    quantized in the kernel with scalar params, one LUT gather per
    product: int32 ``acc`` (M,N), ``row`` (M,), ``col`` (N,) code sums;
  * K4 ``fused_matmul_bank`` (``csrc/fused_matmul_bank.cu``) — K3 over a
    bank of n tables with per-lane scalars, x shared or banked:
    (n,M,N), (n,M), (n,N);
  * K7 ``fused_composed_matmul`` (``csrc/fused_composed_matmul.cu``) —
    12/16-bit codes as base-256 digits, four tile-LUT gathers, the
    shift/add tree named by a runtime reduce code, 2W-bit mask: int32
    limbs ``lo``, ``hi`` (M,N) and the code sums;
  * K8 ``fused_composed_matmul_bank`` (``csrc/fused_composed_matmul_bank
    .cu``) — K7 over a bank mixing widths (mask 0 = narrow lane) and
    reduce trees.

All four also take the expert axis (an MoE projection's experts, for
every lane, in one launch, as the reference's ``pallas_call`` batched
over lanes and experts): x (X,M,K), or (n,X,M,K) for K4/K8, against w
(E,K,N), slice ``s`` against ``w[s % E]``, each (lane, slice) pair
quantized with its own scalars (``lane_scalars`` of ``n X`` pairs); K7/K8
keep one mask and reduce code a lane.

The quantization scalars go in as the caller holds them
(``lane_scalars``: a tensor on the device through its own pointer and
lane stride, a number by value), so a K3 or K4 call queues its kernel
and nothing else (and one memset of its outputs, which lie in one
allocation, where K is split); the plain versions take them packed
(``pack_scalars``).  Per-lane composed codes travel as device tensors
(``pack_codes``), so no launch waits on the host.  The composed kernels
split their (lane, row tile, column tile) items over the persistent
blocks by cost, a wide lane's item weighing ``WIDE_COST`` and a narrow
one's ``NARROW_COST`` (``split_starts`` mirrors the device's formula).
Every kernel of the shared body (K1-K8) cuts K into ranges where its
items are fewer than the blocks (``k_split`` mirrors the plan).  K3/K4
pick their tile from M as well as N (``quant8_tile``), so an MoE
expert's capacity buffer gathers no padded rows.  The
kernels return integers only; the f32 limb recombination and the
zero-point correction and dequant (``dequant``, the reference's
``_dequant`` and ``_bank_dequant`` at once) run as eager PyTorch ops in
the caller, each rounded on its own, as the reference leaves them to its
jitted caller.

Callers go through ``repro_torch.kernels.ops``, which validates the
operands and sends CPU tensors to the plain versions (``kernels.ref``).
Each launcher's ``.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..approx.quant import dequant_sums
from . import build
from .approx_matmul import enter_device, leave_device, sm_count


class Scalars(ctypes.Structure):
    """``fusedmm::Scalars`` of ``csrc/fused_gather.cuh``: sa, za, sw, zw,
    qmax, each read at ``ptr[i] + lane * stride[i]`` on the device, or
    ``value[i]`` where ``ptr[i]`` is null."""
    _fields_ = [("ptr", ctypes.c_void_p * 5),
                ("stride", ctypes.c_longlong * 5),
                ("value", ctypes.c_float * 5)]


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the expert forms' launch functions (``<name>_experts_launch``)
_EXPERT_ARGTYPES = {
    "fused_matmul": [_P] * 3 + [Scalars, _P] + [_I] * 6 + [_P],
    "fused_matmul_bank": ([_P, _L] + [_P] * 2 + [Scalars, _P] + [_I] * 7
                          + [_P]),
    "fused_composed_matmul": [_P] * 5 + [Scalars, _P] + [_I] * 6 + [_P],
    "fused_composed_matmul_bank": ([_P, _L] + [_P] * 4 + [Scalars, _P]
                                   + [_I] * 7 + [_P]),
}
_ARGTYPES = {
    "fused_matmul": [_P] * 3 + [Scalars, _P] + [_I] * 4 + [_P],
    "fused_matmul_bank": ([_P, _L] + [_P] * 2 + [Scalars, _P] + [_I] * 5
                          + [_P]),
    "fused_composed_matmul": [_P] * 5 + [Scalars, _P] + [_I] * 4 + [_P],
    "fused_composed_matmul_bank": ([_P, _L] + [_P] * 4 + [Scalars, _P]
                                   + [_I] * 5 + [_P]),
}


#: Split weights of a wide and a narrow lane's item in the composed
#: kernels: ``kWideCost`` and ``kNarrowCost`` of ``csrc/fused_gather.cuh``.
WIDE_COST, NARROW_COST = 5, 2


def split_starts(costs, per_lane: int, grid: int) -> list[int]:
    """The composed kernels' split of ``len(costs) * per_lane`` items,
    lane-major, over ``grid`` persistent blocks, as
    ``fused_gather.cuh::range_start`` computes it on the device: block
    ``b`` walks items ``[starts[b], starts[b + 1])``, the items whose
    cost summed from item 0 through themselves lies in ``(b / grid, (b +
    1) / grid]`` of the total.  ``costs``: each lane's item cost (of the
    expert form: each (lane, slice) pair's, its lane's, lane-major)."""
    total = sum(costs) * per_lane
    starts = []
    for b in range(grid + 1):
        start = before = 0
        for c in costs:
            n = min(max((b * total - grid * before) // (grid * c), 0),
                    per_lane)
            start += n
            if n < per_lane:
                break
            before += per_lane * c
        starts.append(start)
    return starts


#: Threads a block, outputs a thread along N and the K chunk of
#: ``csrc/fused_gather.cuh`` (``kThreads``, ``kNT``, ``kKC``).
THREADS, NT, KC = 512, 8, 32


def threads_across_n(n: int) -> int:
    """Threads across N of the shared body's tile
    (``fused_gather.cuh::threads_across_n``): the column tile is that
    many times ``NT`` wide."""
    return 1 if n <= 8 else 2 if n <= 16 else 4 if n <= 32 else 8


class Tile(NamedTuple):
    """A launch's tile (``fused_gather.cuh::Tile``): ``tn`` threads
    across N, each gathering ``rows`` rows of ``NT`` columns; thread
    ``t`` gathers rows ``t // tn + i * THREADS // tn`` (i < rows) of
    columns ``(t % tn) * NT`` to ``+ NT``."""
    tn: int
    rows: int

    @property
    def tm(self) -> int:
        return THREADS // self.tn * self.rows

    @property
    def tile_n(self) -> int:
        return self.tn * NT

    def slots(self, m: int, n: int) -> int:
        """(Row, column) slots the tiles of one (lane, slice) pair
        gather at M x N, padded edges included."""
        return -(-m // self.tm) * self.tm * -(-n // self.tile_n) * self.tile_n


def gather_tile(n: int) -> Tile:
    """The tile of every kernel of the shared body but K3/K4's
    ``quant8_kernel``: one row a thread, the column tile sized to N."""
    return Tile(threads_across_n(n), 1)


#: ``quant8_kernel``'s compiled tiles ``(tn, rows)``, in the order its plan
#: prefers them on a tie; tn 0 is ``gather_tile(n)``
#: (``fused_gather.cuh::kQuant8Tiles``).
QUANT8_TILES = ((0, 1), (32, 5), (32, 1))


def quant8_tile(m: int, n: int) -> Tile:
    """K3/K4's tile at M x N (``fused_gather.cuh::quant8_tile``): of
    ``QUANT8_TILES``, the one whose tiles gather the fewest slots, the
    first listed on a tie (so ``gather_tile(n)`` wherever it pads no more
    than the others)."""
    tiles = [Tile(tn, rows) if tn else gather_tile(n)
             for tn, rows in QUANT8_TILES]
    return min(tiles, key=lambda t: t.slots(m, n))


def quant8_lookups(pairs: int, m: int, k: int, n: int) -> tuple[int, int]:
    """Table lookups the tiles of one K3/K4 launch gather over ``pairs``
    (lane, slice) pairs at M x K x N, and how many of them lie on padded
    rows or columns."""
    gathered = pairs * quant8_tile(m, n).slots(m, n) * k
    return gathered, gathered - pairs * m * n * k


class KSplit(NamedTuple):
    """A launch's work units as the shared body walks them: ``lanes`` x
    ``tiles`` (row tile, column tile) items of ``tile``, each item's
    ``chunks`` KC chunks of K cut into ``splits`` ranges."""
    lanes: int
    tiles: int
    chunks: int
    splits: int
    tile: Tile

    @property
    def items(self) -> int:
        return self.lanes * self.tiles

    def unit(self, u: int) -> tuple[int, int, range]:
        """Unit ``u``'s lane, tile and KC chunks, decoded as the kernel
        decodes it (lane-major, then tile, then K range)."""
        lane, rem = divmod(u, self.tiles * self.splits)
        tile, part = divmod(rem, self.splits)
        return lane, tile, range(part * self.chunks // self.splits,
                                 (part + 1) * self.chunks // self.splits)


def k_split(n_lanes: int, m: int, k: int, n: int, grid: int,
            quant8: bool = False) -> KSplit:
    """The K split of one launch of the shared body
    (``fused_gather.cuh::k_splits``) at its tile (``quant8``: K3/K4's,
    ``quant8_tile``; else ``gather_tile``): 1 when there are at least as
    many items as blocks; else the range count s in [1, chunks] whose
    busiest block sums the fewest chunks, ceil(items s / grid) units of
    at most ceil(chunks / s) chunks each, the smallest s on a tie (so 1
    wherever a split would not shorten the busiest block)."""
    tile = quant8_tile(m, n) if quant8 else gather_tile(n)
    tiles = -(-m // tile.tm) * -(-n // tile.tile_n)
    chunks = -(-k // KC)
    items = n_lanes * tiles
    splits = min(range(1, chunks + 1),
                 key=lambda s: -(-items * s // grid) * -(-chunks // s),
                 default=1) if items < grid else 1
    return KSplit(n_lanes, tiles, chunks, splits, tile)


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _experts_launcher(name: str):
    fn = getattr(build.load(name), f"{name}_experts_launch")
    fn.argtypes = _EXPERT_ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _lane_vec(v, n: int, dtype, device) -> torch.Tensor:
    """``v`` (a number, or a tensor of one or ``n`` values) as ``(n,)``
    on ``device``; a number is filled on the device (no host copy)."""
    if not isinstance(v, torch.Tensor):
        return torch.full((n,), v, dtype=dtype, device=device)
    v = v.to(device=device, dtype=dtype).reshape(-1)
    if v.numel() == 1:
        return v.expand(n)
    if v.numel() != n:
        raise ValueError(f"per-lane value has {v.numel()} entries, the "
                         f"bank {n} lanes")
    return v


def pack_scalars(n: int, device, sa, za, sw, zw, qmax) -> tuple:
    """Per-lane quantization scalars as the kernels read them:
    ``fp`` (n, 3) f32 = (sa, sw, qmax), ``ip`` (n, 2) int32 = (za, zw).
    Each input is a number, a one-value tensor or an ``(n,)`` tensor."""
    fp = torch.stack([_lane_vec(v, n, torch.float32, device)
                      for v in (sa, sw, qmax)], dim=1)
    ip = torch.stack([_lane_vec(v, n, torch.int32, device)
                      for v in (za, zw)], dim=1)
    return fp, ip


# the dtype of each scalar on the device, in the order the kernels read
# them: sa, za, sw, zw, qmax
_SCALAR_DTYPES = (torch.float32, torch.int32, torch.float32, torch.int32,
                  torch.float32)


class LaneScalars(NamedTuple):
    """The five quantization scalars as a call hands them to a kernel:
    ``values``, each a tensor of one or n values on the device or a
    number, and ``struct``, the kernels' ``Scalars`` argument, which
    points into those tensors (``values`` keeps them alive)."""
    values: tuple
    struct: Scalars


def lane_scalars(n: int, device, sa, za, sw, zw, qmax) -> LaneScalars:
    """The five scalars as the kernels read them: a tensor of one or
    ``n`` values on ``device`` through its pointer, with lane stride 0
    when the lanes share it (else 1), or a number by value (``za``,
    ``zw`` as ints).  A contiguous tensor already of its dtype on
    ``device`` (the calibration's, on the datapath) goes as it is and
    queues no device work; another is copied there first."""
    # the device as Tensor.get_device() names it (-1: the host)
    index = (-1 if device.type == "cpu" else device.index
             if device.index is not None or device.type != "cuda"
             else torch.cuda.current_device())
    values, ptrs, strides, by_value = [], [], [], []
    for v, dtype in zip((sa, za, sw, zw, qmax), _SCALAR_DTYPES):
        if not isinstance(v, torch.Tensor):
            v = int(v) if dtype is torch.int32 else float(v)
            values.append(v)
            ptrs.append(None)
            strides.append(0)
            by_value.append(v)
            continue
        if (index is None or v.get_device() != index or v.dtype is not dtype
                or not v.is_contiguous()):
            v = v.to(device=device, dtype=dtype).contiguous()
        count = v.numel()
        if count != 1 and count != n:
            raise ValueError(f"per-lane value has {count} entries, the "
                             f"bank {n} lanes")
        values.append(v)
        ptrs.append(v.data_ptr())
        strides.append(0 if count == 1 else 1)
        by_value.append(0.0)
    return LaneScalars(tuple(values),
                       Scalars(tuple(ptrs), tuple(strides), tuple(by_value)))


def pack_codes(n: int, device, mask, rcode) -> tuple:
    """Per-lane composed descriptors: ``masks`` (n,) int64 holding the
    uint32 2W-bit product masks (0 = narrow lane) and ``rcodes`` (n, 2)
    int32 ``encode_reduce`` codes (one code, (2,) or (1, 2), is shared
    by every lane).  One host code, a ``(kind, k)`` pair of ints, is
    filled on the device, so no launch waits for a host copy."""
    masks = _lane_vec(mask, n, torch.int64, device)
    if isinstance(rcode, tuple) and len(rcode) == 2 \
            and all(isinstance(c, int) for c in rcode):
        rcodes = torch.empty((1, 2), dtype=torch.int32, device=device)
        rcodes[0, 0], rcodes[0, 1] = rcode
    else:
        rcodes = torch.as_tensor(rcode, dtype=torch.int32).to(device)
    rcodes = rcodes.reshape(-1, 2)
    if rcodes.shape[0] not in (1, n):
        raise ValueError(f"{rcodes.shape[0]} reduce codes for {n} lanes")
    return masks, rcodes.expand(n, 2)


def dequant(s: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
            fp: torch.Tensor, ip: torch.Tensor, k: int) -> torch.Tensor:
    """Caller-side f32 correction and dequant of the kernels' outputs
    (``approx.quant.dequant_sums``): ``s`` (M,N) or (n,M,N) f32 sums,
    ``row``/``col`` the kernel's code sums, ``fp``/``ip`` the packed
    scalars.  The same ops per element as the unfused backend, so the
    fused and two-step datapaths agree bit for bit."""
    lane = (-1, 1, 1) if s.ndim == 3 else ()
    return dequant_sums(s, row[..., :, None], col[..., None, :],
                        ip[:, 0].reshape(lane), ip[:, 1].reshape(lane),
                        fp[:, 0].reshape(lane), fp[:, 1].reshape(lane), k)


def dequant_lanes(s: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                  sc: LaneScalars, k: int) -> torch.Tensor:
    """``dequant`` on ``lane_scalars``: the same ops per element, each
    scalar as it came (a number as a host 0-d tensor of its dtype, which
    queues no device work)."""
    lane = (-1, 1, 1) if s.ndim == 3 else ()

    def at(i):
        v = sc.values[i]
        if not isinstance(v, torch.Tensor):
            return torch.tensor(v, dtype=_SCALAR_DTYPES[i])
        return v.reshape(lane) if v.numel() > 1 else v.reshape(())

    return dequant_sums(s, row[..., :, None], col[..., None, :], at(1),
                        at(3), at(0), at(2), k)


def limbs_to_f32(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``lo + 65536 * hi`` in f32 (the multiply is exact, so one
    rounding, whatever contracts)."""
    return lo.to(torch.float32) + 65536.0 * hi.to(torch.float32)


def _mask_bits(masks: torch.Tensor) -> torch.Tensor:
    """int64 masks in [0, 2^32) as the int32 bit patterns the kernels
    read as uint32."""
    return torch.where(masks >= 1 << 31, masks - (1 << 32),
                       masks).to(torch.int32).contiguous()


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as a raw handle: about
    0.1 us a call, where ``torch.cuda.current_stream()`` builds a Stream
    object in about 5 us (the host of an H100 machine), which K3's small
    calls feel."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _launch(name: str, fn, x, w, luts16, sc, codes=()):
    """Launch one fused kernel; returns its int32 outputs (accumulator or
    limbs, row sums, column sums; with a lane axis for the banked
    kernels, then a slice axis for the expert form: w (E,K,N)), views of
    the one allocation the kernel takes, in the order
    ``fused_gather.cuh::launch_quant`` lays them out.  ``sc``:
    ``lane_scalars``; ``codes`` = (masks, rcodes) for the composed
    kernels."""
    banked = name.endswith("_bank")
    experts = w.ndim == 3
    lanes = luts16.shape[0] if banked else 1
    slices = x.shape[-3] if experts else 1
    m, k = x.shape[-2], x.shape[-1]
    n = w.shape[-1]
    pairs = lanes * slices
    limbs = 2 if codes else 1
    sizes = [pairs * m * n] * limbs + [pairs * m, pairs * n]
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=x.device)
    parts = buf.split_with_sizes(sizes)
    lead = ((lanes,) if banked else ()) + ((slices,) if experts else ())
    shapes = [(*lead, m, n)] * limbs + [(*lead, m), (*lead, n)]
    outs = tuple(t.view(shape) for t, shape in zip(parts, shapes))
    if m == 0 or n == 0 or pairs == 0:
        # nothing to gather; a kernel that walks no tile writes no sum
        buf.zero_()
        return outs
    # every operand stays referenced here until the launch is queued:
    # a temporary freed earlier could be handed to the next allocation
    # and overwritten before the kernel reads it (sc holds the scalars)
    ins = [w.data_ptr(), luts16.data_ptr()]
    if codes:
        masks, rcodes = _mask_bits(codes[0]), codes[1].contiguous()
        ins += [masks.data_ptr(), rcodes.data_ptr()]
    # banked activations: one lane's slices apart; shared: stride 0
    stride = slices * m * k if x.ndim == 3 + experts else 0
    first = (x.data_ptr(), stride) if banked else (x.data_ptr(),)
    dims = ((lanes,) if banked else ()) + (
        (slices, w.shape[0]) if experts else ()) + (m, k, n)
    launcher = _experts_launcher if experts else _launcher
    dev = x.get_device()
    prev = enter_device(dev)
    try:
        err = launcher(name)(
            *first, *ins, sc.struct, buf.data_ptr(), *dims, sm_count(dev),
            torch._C._cuda_getCurrentRawStream(dev))
    finally:
        leave_device(prev)
    build.check(name, err)
    fn.launches += 1
    return outs


def fused_matmul(x, w, lut16, sc) -> tuple:
    """Launch K3.  x (M,K), w (K,N) f32, lut16 (256,256) uint16, all
    contiguous on one CUDA device (checked by ``ops.fused_matmul_lut``),
    sc the ``lane_scalars`` of one lane -> acc (M,N), row (M,), col (N,)
    int32.  The expert form: x (X,M,K), w (E,K,N), sc of X slices ->
    (X,M,N), (X,M), (X,N)."""
    return _launch("fused_matmul", fused_matmul, x, w, lut16, sc)


def fused_matmul_bank(x, w, luts16, sc) -> tuple:
    """Launch K4.  x (M,K) shared or (n,M,K) banked, luts16 (n,256,256),
    sc the ``lane_scalars`` of n lanes -> acc (n,M,N), row (n,M), col
    (n,N) int32.  The expert form: x (X,M,K) shared or (n,X,M,K), w
    (E,K,N), sc of n X pairs -> (n,X,M,N), (n,X,M), (n,X,N)."""
    return _launch("fused_matmul_bank", fused_matmul_bank, x, w, luts16, sc)


def fused_composed_matmul(x, w, lut16, masks, rcodes, sc) -> tuple:
    """Launch K7.  As K3 plus masks (1,) int64 and rcodes (1,2) int32
    -> lo, hi (M,N), row (M,), col (N,) int32.  The expert form: x
    (X,M,K), w (E,K,N), sc of X slices -> (X,M,N) x 2, (X,M), (X,N)."""
    return _launch("fused_composed_matmul", fused_composed_matmul, x, w,
                   lut16, sc, (masks, rcodes))


def fused_composed_matmul_bank(x, w, luts16, masks, rcodes, sc) -> tuple:
    """Launch K8.  As K4 plus masks (n,) int64 and rcodes (n,2) int32
    -> lo, hi (n,M,N), row (n,M), col (n,N) int32.  The expert form: x
    (X,M,K) or (n,X,M,K), w (E,K,N), sc of n X pairs -> (n,X,M,N) x 2,
    (n,X,M), (n,X,N)."""
    return _launch("fused_composed_matmul_bank", fused_composed_matmul_bank,
                   x, w, luts16, sc, (masks, rcodes))


for _fn in (fused_matmul, fused_matmul_bank, fused_composed_matmul,
            fused_composed_matmul_bank):
    _fn.launches = 0
