"""Gate set and 45 nm technology cost tables.

The CGP function set Γ used throughout the library matches the paper
(Sec. II-B, Fig. 1): identity, not, and, or, xor, nand, nor, xnor,
const0, const1.  Each gate carries an (area, leakage+dynamic power at a
reference activity, delay) triple loosely modeled on a 45 nm standard-cell
library (NanGate45-like relative magnitudes).  The paper reports circuit
power *relative to the exact multiplier*, so only the relative magnitudes
of these numbers matter for the methodology; we document them here as the
framework's deterministic cost model (DESIGN.md §4.4).
"""
from __future__ import annotations

import numpy as np

# Function codes (match the paper's Fig. 1 ordering).
IDENTITY = 0
NOT = 1
AND = 2
OR = 3
XOR = 4
NAND = 5
NOR = 6
XNOR = 7
CONST0 = 8
CONST1 = 9

N_FUNCS = 10

GATE_NAMES = {
    IDENTITY: "buf",
    NOT: "inv",
    AND: "and2",
    OR: "or2",
    XOR: "xor2",
    NAND: "nand2",
    NOR: "nor2",
    XNOR: "xnor2",
    CONST0: "tie0",
    CONST1: "tie1",
}

# 45 nm-style relative cost model.
#   area  : um^2 (NanGate45-like)
#   power : uW at reference activity (switching + leakage)
#   delay : ps typical corner
GATE_AREA = np.array(
    [1.064, 0.532, 1.064, 1.064, 1.596, 0.798, 0.798, 1.596, 0.0, 0.0]
)
GATE_POWER = np.array(
    [0.72, 0.55, 0.92, 0.98, 1.78, 0.68, 0.70, 1.70, 0.0, 0.0]
)
GATE_DELAY = np.array(
    [28.0, 14.0, 36.0, 38.0, 52.0, 22.0, 24.0, 54.0, 0.0, 0.0]
)

# Number of inputs actually consumed by each function (arity for cost/
# connectivity purposes; the genome always stores two input fields).
GATE_ARITY = np.array([1, 1, 2, 2, 2, 2, 2, 2, 0, 0])


def eval_gate_words(func: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Evaluate one gate on bit-packed uint64 word arrays (bit-parallel).

    ``a`` and ``b`` hold one bit per simulated input vector, packed 64 to a
    word.  Constants use all-zeros / all-ones words.
    """
    if func == IDENTITY:
        return a
    if func == NOT:
        return ~a
    if func == AND:
        return a & b
    if func == OR:
        return a | b
    if func == XOR:
        return a ^ b
    if func == NAND:
        return ~(a & b)
    if func == NOR:
        return ~(a | b)
    if func == XNOR:
        return ~(a ^ b)
    if func == CONST0:
        return np.zeros_like(a)
    if func == CONST1:
        return np.full_like(a, np.uint64(0xFFFFFFFFFFFFFFFF))
    raise ValueError(f"unknown gate function {func}")
