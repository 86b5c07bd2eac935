"""CGP netlist representation and bit-parallel evaluation.

A candidate circuit is an integer netlist (the CGP *chromosome*,
Sec. II-B of the paper): ``N`` two-input nodes laid out in a single row
with full levels-back connectivity (equivalent to an ``n_c x n_r`` grid
with levels-back = n_c), ``n_i`` primary inputs and ``n_o`` primary
outputs.  Node ``j`` may read from any primary input or any node with a
smaller index (feed-forward constraint).

Evaluation is *bit-parallel*: each signal holds one bit per simulated
input vector, packed 64 vectors to a uint64 word.  Exhaustive simulation
of an 8x8-bit multiplier (65 536 vectors) therefore touches 1024 words
per signal and runs the whole ~450-gate netlist in well under a
millisecond — this is the same trick the TPU `bitsim` Pallas kernel uses
with 32-bit lanes (DESIGN.md §4.3).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from . import gates

_ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclass(frozen=True)
class Netlist:
    """Immutable CGP genome.

    funcs  : (N,)  int32 gate function codes (gates.IDENTITY..CONST1)
    in0/in1: (N,)  int32 signal indices; signal s < n_i is primary input s,
             otherwise node (s - n_i).  Must satisfy s < n_i + node_index.
    outputs: (n_o,) int32 signal indices feeding the primary outputs.
    """

    n_i: int
    n_o: int
    funcs: np.ndarray
    in0: np.ndarray
    in1: np.ndarray
    outputs: np.ndarray
    name: str = ""

    @property
    def n_nodes(self) -> int:
        return int(self.funcs.shape[0])

    def __post_init__(self):
        for arr_name in ("funcs", "in0", "in1", "outputs"):
            arr = getattr(self, arr_name)
            object.__setattr__(self, arr_name, np.asarray(arr, dtype=np.int32))

    def validate(self) -> None:
        n, n_i = self.n_nodes, self.n_i
        if self.in0.shape != (n,) or self.in1.shape != (n,):
            raise ValueError("input arrays must match node count")
        if np.any(self.funcs < 0) or np.any(self.funcs >= gates.N_FUNCS):
            raise ValueError("invalid function code")
        limit = n_i + np.arange(n, dtype=np.int64)
        if np.any(self.in0 < 0) or np.any(self.in0 >= limit):
            raise ValueError("in0 violates feed-forward constraint")
        if np.any(self.in1 < 0) or np.any(self.in1 >= limit):
            raise ValueError("in1 violates feed-forward constraint")
        if np.any(self.outputs < 0) or np.any(self.outputs >= n_i + n):
            raise ValueError("output index out of range")

    # ------------------------------------------------------------------
    # Structure
    # ------------------------------------------------------------------
    def active_mask(self) -> np.ndarray:
        """Boolean mask over nodes reachable from the primary outputs."""
        n, n_i = self.n_nodes, self.n_i
        active = np.zeros(n, dtype=bool)
        stack = [int(s) - n_i for s in self.outputs if int(s) >= n_i]
        while stack:
            j = stack.pop()
            if j < 0 or active[j]:
                continue
            active[j] = True
            arity = gates.GATE_ARITY[self.funcs[j]]
            if arity >= 1:
                s = int(self.in0[j])
                if s >= n_i:
                    stack.append(s - n_i)
            if arity >= 2:
                s = int(self.in1[j])
                if s >= n_i:
                    stack.append(s - n_i)
        return active

    def n_active(self) -> int:
        mask = self.active_mask()
        arity = gates.GATE_ARITY[self.funcs]
        # identity buffers and constants are free wires in the cost model,
        # but we still count them as "active nodes" for structure reports.
        return int(mask.sum())

    def gate_histogram(self) -> np.ndarray:
        """Active-node counts per gate function code, shape (N_FUNCS,).

        Only nodes reachable from the primary outputs are counted —
        padding/junk genes carry no information about the circuit's
        arithmetic structure.  This is the composition term of the
        surrogate feature vector (DESIGN.md §2.11).
        """
        mask = self.active_mask()
        hist = np.bincount(self.funcs[mask], minlength=gates.N_FUNCS)
        return hist.astype(np.int64)

    def logic_depth(self) -> int:
        """Longest gate-count path from any primary input (or constant
        source) to any primary output, counting only active non-identity,
        non-constant gates — a proxy for the critical-path delay that the
        cost model derives from gate delays.  0 for wire-only circuits.
        """
        n, n_i = self.n_nodes, self.n_i
        active = self.active_mask()
        depth = np.zeros(n_i + n, dtype=np.int64)
        for j in range(n):
            if not active[j]:
                continue
            f = int(self.funcs[j])
            arity = gates.GATE_ARITY[f]
            d = 0
            if arity >= 1:
                d = int(depth[int(self.in0[j])])
            if arity >= 2:
                d = max(d, int(depth[int(self.in1[j])]))
            counts = f not in (gates.IDENTITY, gates.CONST0, gates.CONST1)
            depth[n_i + j] = d + (1 if counts else 0)
        if self.outputs.size == 0:
            return 0
        return int(max(int(depth[int(s)]) for s in self.outputs))

    def compact(self) -> "Netlist":
        """Drop inactive nodes, remapping indices (for storage)."""
        mask = self.active_mask()
        n_i = self.n_i
        old_idx = np.nonzero(mask)[0]
        remap = {int(o) + n_i: i + n_i for i, o in enumerate(old_idx)}

        def m(sig: int) -> int:
            return remap.get(int(sig), int(sig)) if int(sig) >= n_i else int(sig)

        in0 = np.array([m(self.in0[j]) for j in old_idx], dtype=np.int32)
        in1 = np.array([m(self.in1[j]) for j in old_idx], dtype=np.int32)
        outs = np.array([m(s) for s in self.outputs], dtype=np.int32)
        return Netlist(
            n_i=self.n_i,
            n_o=self.n_o,
            funcs=self.funcs[old_idx].copy(),
            in0=in0,
            in1=in1,
            outputs=outs,
            name=self.name,
        )

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------
    def eval_words(self, input_words: np.ndarray) -> np.ndarray:
        """Bit-parallel evaluation.

        input_words: (n_i, W) uint64 — bit ``k`` of word ``w`` of row ``i``
        is the value of primary input ``i`` for vector ``64*w + k``.
        Returns (n_o, W) uint64 output bit-planes.
        """
        if input_words.shape[0] != self.n_i:
            raise ValueError("input plane count mismatch")
        W = input_words.shape[1]
        n, n_i = self.n_nodes, self.n_i
        signals = np.empty((n_i + n, W), dtype=np.uint64)
        signals[:n_i] = input_words
        active = self.active_mask()
        zeros = np.zeros(W, dtype=np.uint64)
        for j in range(n):
            if not active[j]:
                continue
            f = int(self.funcs[j])
            a = signals[int(self.in0[j])] if gates.GATE_ARITY[f] >= 1 else zeros
            b = signals[int(self.in1[j])] if gates.GATE_ARITY[f] >= 2 else zeros
            signals[n_i + j] = gates.eval_gate_words(f, a, b)
        out = np.empty((self.n_o, W), dtype=np.uint64)
        for k, s in enumerate(self.outputs):
            out[k] = signals[int(s)]
        return out

    def eval_ints(self, *operands: np.ndarray, widths: Optional[list] = None) -> np.ndarray:
        """Evaluate on integer operands; returns unsigned integer outputs.

        ``operands`` are 1-D integer arrays; ``widths`` gives each operand's
        bit width (defaults to an even split of n_i).  Operand bits are
        little-endian: input 0 is bit 0 of operand 0.
        """
        if widths is None:
            if len(operands) == 0:
                raise ValueError("need operands")
            w = self.n_i // len(operands)
            widths = [w] * len(operands)
        if sum(widths) != self.n_i:
            raise ValueError("operand widths must sum to n_i")
        num = int(np.asarray(operands[0]).shape[0])
        planes = pack_operands(list(operands), widths)
        out_planes = self.eval_words(planes)
        return unpack_outputs(out_planes, self.n_o, num)

    def to_dict(self) -> dict:
        return {
            "n_i": self.n_i,
            "n_o": self.n_o,
            "funcs": self.funcs.tolist(),
            "in0": self.in0.tolist(),
            "in1": self.in1.tolist(),
            "outputs": self.outputs.tolist(),
            "name": self.name,
        }

    @staticmethod
    def from_dict(d: dict) -> "Netlist":
        return Netlist(
            n_i=int(d["n_i"]),
            n_o=int(d["n_o"]),
            funcs=np.asarray(d["funcs"], dtype=np.int32),
            in0=np.asarray(d["in0"], dtype=np.int32),
            in1=np.asarray(d["in1"], dtype=np.int32),
            outputs=np.asarray(d["outputs"], dtype=np.int32),
            name=d.get("name", ""),
        )


def stack_netlists(netlists: list, n_nodes: Optional[int] = None):
    """Stack same-interface netlists into flat population arrays.

    Pads every genome up to ``n_nodes`` (default: the population max)
    with inactive ``const0`` nodes — appended past every referenced
    index, so no output can change — and returns
    ``(funcs, in0, in1, outs)`` int32 arrays of shapes
    ``(P, n_nodes)``/``(P, n_o)``, the layout the population bitsim
    kernel consumes (DESIGN.md §2.9).
    """
    if not netlists:
        raise ValueError("need at least one netlist")
    n_i, n_o = netlists[0].n_i, netlists[0].n_o
    for nl in netlists:
        if nl.n_i != n_i or nl.n_o != n_o:
            raise ValueError("population interfaces must match")
    if n_nodes is None:
        n_nodes = max(nl.n_nodes for nl in netlists)
    if any(nl.n_nodes > n_nodes for nl in netlists):
        raise ValueError("n_nodes smaller than a population member")
    p = len(netlists)
    funcs = np.full((p, n_nodes), gates.CONST0, dtype=np.int32)
    in0 = np.zeros((p, n_nodes), dtype=np.int32)
    in1 = np.zeros((p, n_nodes), dtype=np.int32)
    outs = np.zeros((p, n_o), dtype=np.int32)
    for k, nl in enumerate(netlists):
        n = nl.n_nodes
        funcs[k, :n] = nl.funcs
        in0[k, :n] = nl.in0
        in1[k, :n] = nl.in1
        outs[k] = nl.outputs
    return funcs, in0, in1, outs


# ----------------------------------------------------------------------
# Bit packing helpers
# ----------------------------------------------------------------------
def pack_operands(operands: list, widths: list) -> np.ndarray:
    """Pack integer operand arrays into (sum(widths), W) uint64 bit planes."""
    num = int(np.asarray(operands[0]).shape[0])
    W = (num + 63) // 64
    n_i = sum(widths)
    planes = np.zeros((n_i, W), dtype=np.uint64)
    row = 0
    for op, width in zip(operands, widths):
        vals = np.asarray(op, dtype=np.uint64)
        for b in range(width):
            bits = (vals >> np.uint64(b)) & np.uint64(1)
            padded = np.zeros(W * 64, dtype=np.uint64)
            padded[:num] = bits
            words = padded.reshape(W, 64)
            shifts = np.arange(64, dtype=np.uint64)
            planes[row + b] = (words << shifts).sum(axis=1, dtype=np.uint64)
        row += width
    return planes


def unpack_outputs(planes: np.ndarray, n_o: int, num: int) -> np.ndarray:
    """Inverse of pack_operands for output planes -> (num,) uint64 ints."""
    W = planes.shape[1]
    vals = np.zeros(num, dtype=np.uint64)
    for b in range(n_o):
        words = planes[b]
        bits = ((words[:, None] >> np.arange(64, dtype=np.uint64)[None, :])
                & np.uint64(1)).reshape(-1)[:num]
        vals |= bits << np.uint64(b)
    return vals


def unpack_outputs_object(planes: np.ndarray, n_o: int, num: int) -> np.ndarray:
    """Like unpack_outputs but returns exact Python ints (object dtype),
    supporting arbitrary output widths (e.g. 129-bit adder outputs)."""
    vals = np.array([0] * num, dtype=object)
    for b in range(n_o):
        words = planes[b]
        bits = ((words[:, None] >> np.arange(64, dtype=np.uint64)[None, :])
                & np.uint64(1)).reshape(-1)[:num].astype(np.int64)
        vals += bits.astype(object) << b
    return vals


def random_input_planes(
    n_i: int, num: int, rng: np.random.Generator
) -> np.ndarray:
    """Uniform random bit-planes over the full 2^n_i input space — used
    for sampled evaluation of wide (>20 input bit) circuits."""
    W = (num + 63) // 64
    planes = rng.integers(0, 1 << 63, size=(n_i, W), dtype=np.uint64)
    planes |= rng.integers(0, 2, size=(n_i, W), dtype=np.uint64) << np.uint64(63)
    rem = num % 64
    if rem:
        mask = np.uint64((1 << rem) - 1)
        planes[:, -1] &= mask
    return planes


def exhaustive_inputs(n_i: int) -> np.ndarray:
    """All 2^n_i input vectors as (n_i, 2^n_i/64) uint64 bit planes.

    Vector v assigns bit i of v to primary input i — so for a circuit with
    two w-bit operands, operand A is the low w bits of v and operand B the
    high w bits, matching ``pack_operands`` with a meshgrid ordering.
    """
    if n_i > 24:
        raise ValueError("exhaustive evaluation capped at 24 input bits")
    num = 1 << n_i
    v = np.arange(num, dtype=np.uint64)
    ops = [v]
    return pack_operands(ops, [n_i])
