"""Op-stream analysis: per-device flops, bytes and collective bytes for
the roofline (counterpart of ``repro.launch.hlo_analysis``).

The reference parses the compiled HLO module's text.  The port has no
HLO: the program it analyses is the stream of aten and
``_c10d_functional`` ops that a ``TorchDispatchMode`` (``OpTrace``) sees
while a step runs.  Over DTensors the mode declines the DTensor-level op
(it returns ``NotImplemented``), so DTensor's dispatch runs and the mode
then sees the ops on the LOCAL shards — the per-device program, as the
reference's SPMD module is — including the collectives that
redistribution issues.  The shape-only ops of DTensor's sharding
propagation run under a ``FakeTensorMode`` and are not counted.

  * flops: ``torch.utils.flop_counter``'s formulas (matmul, conv,
    attention), per local op;
  * bytes accessed: operand + result bytes of every op that moves data
    (views, which alias their input, move none).  The ops are unfused,
    so this sits above XLA's fused "bytes accessed";
  * collectives: the *operand* bytes each device contributes, per kind
    (``collective_bytes``), as the reference counts them
    (``hlo_analysis.py:97``).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: Bytes an element of each torch dtype (sub-byte types take a byte, as
#: the reference's ``s4``/``u4``).
DTYPE_BYTES = {d: d.itemsize for d in
               (getattr(torch, n) for n in dir(torch))
               if isinstance(d, torch.dtype)}

#: The reference's (XLA's) name of each torch dtype that has one (the
#: dtypes this torch lacks are left out).
XLA_NAMES = {getattr(torch, t): x for t, x in (
    ("bool", "pred"), ("int8", "s8"), ("uint8", "u8"), ("int16", "s16"),
    ("uint16", "u16"), ("float16", "f16"), ("bfloat16", "bf16"),
    ("int32", "s32"), ("uint32", "u32"), ("float32", "f32"),
    ("int64", "s64"), ("uint64", "u64"), ("float64", "f64"),
    ("complex64", "c64"), ("complex128", "c128"),
    ("float8_e4m3fn", "f8e4m3fn"), ("float8_e5m2", "f8e5m2"),
    ("float8_e5m2fnuz", "f8e5m2fnuz"), ("int4", "s4"), ("uint4", "u4"))
    if hasattr(torch, t)}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

#: ``_c10d_functional`` op -> the reference's collective kind.
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}


def tensor_bytes(t) -> int:
    """Bytes of a tensor's elements (a DTensor's local shard)."""
    local = getattr(t, "_local_tensor", t)
    return local.numel() * DTYPE_BYTES[local.dtype]


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    """Every result aliases an input without writing it (a view)."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


class OpTrace(TorchDispatchMode):
    """Counts, per op name: calls, flops, bytes accessed and result
    bytes; per collective kind: operand bytes and calls.  ``keep_ops``
    also keeps one ``(op, flops, bytes)`` row a call, in order (the dump
    ``dryrun --save-hlo`` writes)."""

    def __init__(self, keep_ops: bool = False):
        super().__init__()
        self.ops: dict = defaultdict(lambda: [0, 0.0, 0, 0])
        self.collectives: dict = defaultdict(lambda: {"bytes": 0,
                                                      "count": 0})
        self.rows: Optional[list] = [] if keep_ops else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in ins):
            return NotImplemented       # DTensor runs the local ops
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out                  # sharding propagation's shapes
        self._record(func, args, kwargs, ins, out)
        return out

    def _record(self, func, args, kwargs, ins, out) -> None:
        from torch.utils.flop_counter import flop_registry
        name = f"{func.namespace}.{func._opname}"
        kind = (_COLLECTIVE_KIND.get(func._opname)
                if func.namespace == "_c10d_functional" else None)
        outs = _tensors(out)
        if kind is not None:
            c = self.collectives[kind]
            c["bytes"] += sum(tensor_bytes(t) for t in ins)
            c["count"] += 1
        flops = 0
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
        res = sum(tensor_bytes(t) for t in outs)
        moved = 0 if _is_view(func) else (
            sum(tensor_bytes(t) for t in ins) + res)
        row = self.ops[name]
        row[0] += 1
        row[1] += flops
        row[2] += moved
        row[3] += res
        if self.rows is not None:
            self.rows.append((name, flops, moved))

    # -- totals -----------------------------------------------------------
    @property
    def flops(self) -> float:
        return float(sum(r[1] for r in self.ops.values()))

    @property
    def bytes_accessed(self) -> float:
        return float(sum(r[2] for r in self.ops.values()))


def collective_bytes(trace: OpTrace) -> dict:
    """``{kind: {"bytes": per-device operand bytes, "count": n},
    "total_bytes": ...}`` over the trace, as the reference's."""
    result = {k: dict(v) for k, v in trace.collectives.items()}
    result["total_bytes"] = sum(v["bytes"] for v in
                                trace.collectives.values())
    return result


def op_histogram(trace: OpTrace, top: int = 20) -> list[tuple[str, int]]:
    """Op-count histogram (spots recompute and layout storms)."""
    counts = [(op, r[0]) for op, r in trace.ops.items()]
    return sorted(counts, key=lambda kv: -kv[1])[:top]


def bytes_by_op(trace: OpTrace, top: int = 15
                ) -> list[tuple[str, float, int]]:
    """Result bytes aggregated per op (profiling aid)."""
    rows = [(op, r[3], r[0]) for op, r in trace.ops.items()]
    return sorted(rows, key=lambda r: -r[1])[:top]


def dump(trace: OpTrace) -> str:
    """The trace as text: one line an op call when kept, then the
    per-op totals and the collectives."""
    lines = []
    for name, flops, moved in trace.rows or ():
        lines.append(f"{name} flops={flops} bytes={moved}")
    lines.append("# op calls flops bytes result_bytes")
    for op, (n, f, b, r) in sorted(trace.ops.items(),
                                   key=lambda kv: -kv[1][2]):
        lines.append(f"{op} {n} {f} {b} {r}")
    lines.append(f"# collectives {collective_bytes(trace)}")
    return "\n".join(lines) + "\n"
