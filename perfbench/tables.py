"""The frozen multiplier tables: ``data/mult8.npz`` holds the names and
the 256 x 256 product tables (uint16) of every 8-bit multiplier of the
port's default library, as ``data/mult8.json`` records; a run never
builds the library."""
from __future__ import annotations

import numpy as np

TABLES = "perfbench/data/mult8.npz"


def load(root, lanes="all"):
    """(names, tables (n, 256, 256) int32) of ``lanes``: "all" in the
    frozen order, or a list of names in its own order."""
    with np.load(root / TABLES) as z:
        names = [str(n) for n in z["names"]]
        tabs = z["tables"].astype(np.int32)
    if lanes == "all":
        return names, tabs
    index = {n: i for i, n in enumerate(names)}
    missing = [n for n in lanes if n not in index]
    if missing:
        raise KeyError(f"not among the frozen tables: {missing}")
    return list(lanes), np.ascontiguousarray(tabs[[index[n] for n in lanes]])
