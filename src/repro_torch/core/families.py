"""Analytic (manually-designed) approximate circuit families.

These are the classic ad-hoc designs the paper benchmarks its evolved
circuits against (Sec. IV, Table II):

  * truncated multipliers  — drop the k LSBs of both operands
  * BAM multipliers        — broken-array multiplier [Mahdiani et al.],
                             horizontal break h (drop first h partial-
                             product rows) + vertical break v (drop all
                             partial products of weight < v)
  * LOA adders             — lower-part OR adder: low k bits are OR'd,
                             upper part is an exact adder seeded with
                             the AND of the top low-part bits
  * truncated adders       — drop the k LSBs entirely

All are generated as gate-level netlists so they flow through the same
cost/error pipeline as the evolved circuits.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from . import gates
from .netlist import Netlist
from .seeds import _Builder


def masked_array_multiplier(
    width: int, keep: Callable[[int, int], bool], name: str
) -> Netlist:
    """Array multiplier generating only the partial products for which
    ``keep(i, j)`` is true (row i = bit i of operand B, column j = bit j
    of operand A; weight = i + j). Dropped products contribute 0."""
    w = width
    b = _Builder(2 * w)

    def pp(i: int, j: int):
        if keep(i, j):
            return b.gate(gates.AND, b.inp(j), b.inp(w + i))
        return None

    zero = None

    def z():
        nonlocal zero
        if zero is None:
            zero = b.const0()
        return zero

    rows = [[pp(i, j) for j in range(w)] for i in range(w)]
    outs: list = [rows[0][0] if rows[0][0] is not None else z()]
    row = rows[0][1:]
    for i in range(1, w):
        nxt: list = []
        carry = None
        for j in range(w):
            acc = row[j] if j < len(row) else None
            p = rows[i][j]
            terms = [t for t in (p, acc, carry) if t is not None]
            if len(terms) == 0:
                s, c = None, None
            elif len(terms) == 1:
                s, c = terms[0], None
            elif len(terms) == 2:
                s, c = b.half_adder(terms[0], terms[1])
            else:
                s, c = b.full_adder(terms[0], terms[1], terms[2])
            if j == 0:
                outs.append(s if s is not None else z())
            else:
                nxt.append(s)
            carry = c
        nxt.append(carry)  # may be None; padded below
        row = nxt
    for s in row:
        outs.append(s if s is not None else z())
    outs = [o for o in outs]
    while len(outs) < 2 * w:
        outs.append(z())
    nl = b.finish(outs[: 2 * w], 2 * w, name)
    return nl.compact()


def truncated_multiplier(width: int, k: int) -> Netlist:
    """Truncate k LSBs of both operands (paper's 'Truncated (width-k)-bit')."""
    return masked_array_multiplier(
        width, lambda i, j: i >= k and j >= k, f"mul{width}u_trunc{width - k}"
    )


def bam_multiplier(width: int, h: int, v: int) -> Netlist:
    """Broken-array multiplier with horizontal break h, vertical break v."""
    return masked_array_multiplier(
        width, lambda i, j: i >= h and (i + j) >= v, f"mul{width}u_bam_h{h}_v{v}"
    )


def loa_adder(width: int, k: int) -> Netlist:
    """Lower-part OR adder: s_i = a_i | b_i for i < k; carry into the
    upper exact ripple part is a_{k-1} & b_{k-1}."""
    if not 0 < k < width:
        raise ValueError("0 < k < width required")
    b = _Builder(2 * width)
    outs: list[int] = []
    for i in range(k):
        outs.append(b.gate(gates.OR, b.inp(i), b.inp(width + i)))
    carry = b.gate(gates.AND, b.inp(k - 1), b.inp(width + k - 1))
    for i in range(k, width):
        s, carry = b.full_adder(b.inp(i), b.inp(width + i), carry)
        outs.append(s)
    outs.append(carry)
    return b.finish(outs, width + 1, f"add{width}u_loa{k}")


def truncated_adder(width: int, k: int) -> Netlist:
    """Drop the k LSBs entirely (outputs 0), exact ripple above."""
    if not 0 < k < width:
        raise ValueError("0 < k < width required")
    b = _Builder(2 * width)
    zero = b.const0()
    outs: list[int] = [zero] * k
    s, carry = b.half_adder(b.inp(k), b.inp(width + k))
    outs.append(s)
    for i in range(k + 1, width):
        s, carry = b.full_adder(b.inp(i), b.inp(width + i), carry)
        outs.append(s)
    outs.append(carry)
    return b.finish(outs, width + 1, f"add{width}u_trunc{k}")


# ----------------------------------------------------------------------
# Composed wide multipliers (tiled 8x8 partial products, DESIGN.md §2.6)
# ----------------------------------------------------------------------
#: Operand width of the partial-product tile every composed multiplier
#: is built from — the library's 8-bit LUT machinery executes it.
TILE_BITS = 8

REDUCE_KINDS = ("exact", "loa", "trunc")


def parse_reduce(token: str) -> tuple[str, int]:
    """Normalize a reduction-adder descriptor to ``(kind, k)``.

    Accepted forms: ``"exact"``, ``"loa4"``/``"trunc3"`` (family + low
    part width), or a library adder entry name like ``"add32u_loa4"``
    (the width prefix is the tree node's width, chosen by the builder,
    so only the family suffix matters here).
    """
    t = token.strip().lower()
    if t.startswith("add") and "_" in t:
        t = t.split("_", 1)[1]
    if t == "exact":
        return ("exact", 0)
    for kind in ("loa", "trunc"):
        if t.startswith(kind):
            digits = t[len(kind):]
            if digits.isdigit() and int(digits) > 0:
                return (kind, int(digits))
    raise ValueError(
        f"unknown reduction adder {token!r}; expected 'exact', "
        "'loa<k>', 'trunc<k>' or a library adder name like "
        "'add32u_loa4'")


def reduce_tag(token: str) -> str:
    """Canonical short tag of a reduction descriptor ('exact', 'loa4')."""
    kind, k = parse_reduce(token)
    return kind if kind == "exact" else f"{kind}{k}"


def _embed(b: _Builder, nl: Netlist, inputs: list) -> list:
    """Append ``nl``'s gates to builder ``b`` with its primary inputs
    wired to the given builder signals; returns builder signals for
    ``nl``'s outputs.  The embedded copy is gate-for-gate identical to
    the stand-alone netlist, so composed circuits inherit the tile's
    exact cost and function.

    Operand reads respect gate arity (like ``Netlist.eval_words``):
    compacted CGP netlists keep stale indices in UNUSED operand slots
    (e.g. a NOT gate's ``in1`` pointing at a dropped node), which must
    not be dereferenced."""
    if len(inputs) != nl.n_i:
        raise ValueError(f"{nl.name or 'netlist'} wants {nl.n_i} inputs, "
                         f"got {len(inputs)}")
    node_sig: list = []

    def src(s: int) -> int:
        s = int(s)
        return inputs[s] if s < nl.n_i else node_sig[s - nl.n_i]

    for j in range(nl.n_nodes):
        f = int(nl.funcs[j])
        arity = int(gates.GATE_ARITY[f])
        a = src(nl.in0[j]) if arity >= 1 else 0
        bb = src(nl.in1[j]) if arity >= 2 else 0
        node_sig.append(b.gate(f, a, bb))
    return [src(s) for s in nl.outputs]


def _reduce_adder_netlist(width: int, kind: str, k: int) -> Netlist:
    from .seeds import ripple_carry_adder
    if kind == "exact":
        return ripple_carry_adder(width)
    if kind == "loa":
        return loa_adder(width, k)
    if kind == "trunc":
        return truncated_adder(width, k)
    raise ValueError(f"unknown reduction adder kind {kind!r}")


def composed_multiplier(tile: Netlist, width: int,
                        reduce: str = "exact",
                        name: str = "") -> Netlist:
    """W-bit multiplier composed from 8x8 ``tile`` partial products.

    Operands split into base-256 digits ``a = a0 + 256*a1`` (the high
    digit has ``width - 8`` bits; the tile's upper input bits are tied
    to 0).  The four digit products ``pp_ij = tile(a_i, b_j)`` reduce
    through a shift/add tree whose every node is a ``reduce``-family
    adder (exact ripple / LOA / truncated — the same generators the
    library characterizes):

        s1 = ADD(pp01, pp10)            # 16-bit node
        s2 = ADD(pp00, s1 << 8)         # 25-bit node
        p  = ADD(s2, pp11 << 16)        # 32-bit node, low 2W bits kept

    This is the gate-level ground truth of the composed datapath: the
    executable engine (``repro.kernels.composed_matmul``) must be
    bit-identical to ``bitsim`` of this netlist on every operand pair
    (DESIGN.md §2.6).
    """
    if tile.n_i != 2 * TILE_BITS or tile.n_o != 2 * TILE_BITS:
        raise ValueError(
            f"composition tile must be an {TILE_BITS}x{TILE_BITS} "
            f"multiplier (16 in / 16 out); got {tile.n_i} in / "
            f"{tile.n_o} out ({tile.name!r})")
    if not TILE_BITS < width <= 2 * TILE_BITS:
        raise ValueError(
            f"composed width must be in ({TILE_BITS}, {2 * TILE_BITS}]; "
            f"got {width}")
    kind, k = parse_reduce(reduce)
    if kind != "exact" and not 0 < k < 2 * TILE_BITS:
        # the narrowest tree node is the 16-bit s1 adder: k must fit
        # EVERY node or the vectorized engine semantics would diverge
        raise ValueError(
            f"reduction adder low part k={k} must be in "
            f"(0, {2 * TILE_BITS}) to fit every tree node")
    b = _Builder(2 * width)
    zero = b.const0()
    hi_w = width - TILE_BITS

    def digits(base: int) -> tuple[list, list]:
        lo = [b.inp(base + t) for t in range(TILE_BITS)]
        hi = ([b.inp(base + TILE_BITS + t) for t in range(hi_w)]
              + [zero] * (TILE_BITS - hi_w))
        return lo, hi

    a0, a1 = digits(0)
    b0, b1 = digits(width)
    pp00 = _embed(b, tile, a0 + b0)
    pp01 = _embed(b, tile, a0 + b1)
    pp10 = _embed(b, tile, a1 + b0)
    pp11 = _embed(b, tile, a1 + b1)

    def add(x: list, y: list) -> list:
        w = max(len(x), len(y))
        x = x + [zero] * (w - len(x))
        y = y + [zero] * (w - len(y))
        return _embed(b, _reduce_adder_netlist(w, kind, k), x + y)

    s1 = add(pp01, pp10)                          # 17 bits
    s2 = add(pp00, [zero] * TILE_BITS + s1)       # 26 bits
    p = add(s2, [zero] * (2 * TILE_BITS) + pp11)  # 33 bits; top bits 0
    outs = (p + [zero] * (2 * width))[: 2 * width]
    name = name or (f"mul{width}u_c_{tile.name or 'tile'}_"
                    f"{reduce_tag(reduce)}")
    return b.finish(outs, 2 * width, name).compact()
