"""Exact seed circuits for CGP (Sec. III: "we seeded CGP with
conventional implementations of target arithmetic circuits").

Generators produce gate-level ``Netlist``s for:
  * ripple-carry adders (n-bit + n-bit -> (n+1)-bit)
  * unsigned array multipliers (n-bit x n-bit -> 2n-bit)

Both are built from AND/XOR/OR full-adder cells, the classic structures
the EvoApprox library evolves from.
"""
from __future__ import annotations

import numpy as np

from . import gates
from .netlist import Netlist


class _Builder:
    """Append-only netlist builder; returns signal indices."""

    def __init__(self, n_i: int):
        self.n_i = n_i
        self.funcs: list[int] = []
        self.in0: list[int] = []
        self.in1: list[int] = []

    def inp(self, i: int) -> int:
        assert 0 <= i < self.n_i
        return i

    def gate(self, func: int, a: int, b: int = 0) -> int:
        idx = self.n_i + len(self.funcs)
        assert a < idx and b < idx, "feed-forward violation"
        self.funcs.append(func)
        self.in0.append(a)
        self.in1.append(b)
        return idx

    def const0(self) -> int:
        return self.gate(gates.CONST0, 0, 0)

    def half_adder(self, a: int, b: int) -> tuple[int, int]:
        s = self.gate(gates.XOR, a, b)
        c = self.gate(gates.AND, a, b)
        return s, c

    def full_adder(self, a: int, b: int, cin: int) -> tuple[int, int]:
        s1 = self.gate(gates.XOR, a, b)
        s = self.gate(gates.XOR, s1, cin)
        c1 = self.gate(gates.AND, a, b)
        c2 = self.gate(gates.AND, s1, cin)
        c = self.gate(gates.OR, c1, c2)
        return s, c

    def finish(self, outputs: list[int], n_o: int, name: str) -> Netlist:
        nl = Netlist(
            n_i=self.n_i,
            n_o=n_o,
            funcs=np.asarray(self.funcs, dtype=np.int32),
            in0=np.asarray(self.in0, dtype=np.int32),
            in1=np.asarray(self.in1, dtype=np.int32),
            outputs=np.asarray(outputs, dtype=np.int32),
            name=name,
        )
        nl.validate()
        return nl


def ripple_carry_adder(width: int) -> Netlist:
    """Exact ripple-carry adder: inputs a[0..w-1], b[0..w-1] (little-endian),
    outputs s[0..w] (w+1 bits including carry-out)."""
    b = _Builder(2 * width)
    outs: list[int] = []
    s, c = b.half_adder(b.inp(0), b.inp(width))
    outs.append(s)
    for i in range(1, width):
        s, c = b.full_adder(b.inp(i), b.inp(width + i), c)
        outs.append(s)
    outs.append(c)
    return b.finish(outs, width + 1, f"add{width}_rca_exact")


def array_multiplier(width: int) -> Netlist:
    """Exact unsigned array multiplier (carry-save rows + ripple finish):
    inputs a[0..w-1], b[0..w-1], outputs p[0..2w-1]."""
    w = width
    b = _Builder(2 * w)
    # partial products pp[i][j] = a_j & b_i
    pp = [[b.gate(gates.AND, b.inp(j), b.inp(w + i)) for j in range(w)]
          for i in range(w)]
    outs: list[int] = [pp[0][0]]
    # running row: bits of the accumulated sum above the already-final bits
    row = pp[0][1:]  # w-1 bits, weight 1..w-1 relative to current row base
    for i in range(1, w):
        nxt: list[int] = []
        carry = None
        for j in range(w):
            acc = row[j - 0] if j < len(row) else None
            p = pp[i][j]
            if acc is None and carry is None:
                s, c = p, None
            elif acc is None:
                s, c = b.half_adder(p, carry)
            elif carry is None:
                s, c = b.half_adder(p, acc)
            else:
                s, c = b.full_adder(p, acc, carry)
            if j == 0:
                outs.append(s)
            else:
                nxt.append(s)
            carry = c
        if carry is not None:
            nxt.append(carry)
        row = nxt
    outs.extend(row)
    while len(outs) < 2 * w:
        outs.append(b.const0())
    return b.finish(outs[: 2 * w], 2 * w, f"mul{w}u_array_exact")


def exact_circuit(kind: str, width: int) -> Netlist:
    if kind == "adder":
        return ripple_carry_adder(width)
    if kind == "multiplier":
        return array_multiplier(width)
    raise ValueError(f"unknown circuit kind {kind!r}")
