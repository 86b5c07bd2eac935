"""Hardware cost estimation for CGP netlists.

"The cost is estimated as the sum of weighted areas of the gates used in
the circuit" (paper Sec. III).  We implement exactly that, plus a power
estimate (sum of per-gate reference powers over *active* gates) and a
critical-path delay estimate (longest weighted path), using the 45 nm
tables in ``gates.py``.  The paper's tables report power relative to the
exact circuit; `relative_power` provides that directly.
"""
from __future__ import annotations

from dataclasses import dataclass, asdict

import numpy as np

from . import gates
from .netlist import Netlist


@dataclass(frozen=True)
class CostReport:
    area: float        # um^2, sum of active gate areas
    power: float       # uW at reference activity
    delay: float       # ps, critical path
    n_gates: int       # active non-trivial gates (excl. wires/constants)

    def as_dict(self) -> dict:
        return asdict(self)


def evaluate_cost(nl: Netlist) -> CostReport:
    active = nl.active_mask()
    funcs = nl.funcs[active]
    area = float(gates.GATE_AREA[funcs].sum())
    power = float(gates.GATE_POWER[funcs].sum())
    nontrivial = np.isin(
        funcs, [gates.AND, gates.OR, gates.XOR, gates.NAND, gates.NOR,
                gates.XNOR, gates.NOT]
    )
    n_gates = int(nontrivial.sum())

    # critical path: longest accumulated delay from any primary input
    n, n_i = nl.n_nodes, nl.n_i
    arrival = np.zeros(n_i + n, dtype=np.float64)
    for j in range(n):
        if not active[j]:
            continue
        f = int(nl.funcs[j])
        t = 0.0
        if gates.GATE_ARITY[f] >= 1:
            t = max(t, arrival[int(nl.in0[j])])
        if gates.GATE_ARITY[f] >= 2:
            t = max(t, arrival[int(nl.in1[j])])
        arrival[n_i + j] = t + float(gates.GATE_DELAY[f])
    delay = float(max((arrival[int(s)] for s in nl.outputs), default=0.0))
    return CostReport(area=area, power=power, delay=delay, n_gates=n_gates)


def relative_power(nl: Netlist, reference: Netlist) -> float:
    """Power of ``nl`` relative to ``reference`` (1.0 = same power)."""
    ref = evaluate_cost(reference).power
    if ref <= 0:
        return 0.0
    return evaluate_cost(nl).power / ref
