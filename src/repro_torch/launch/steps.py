"""Serving and training policies (port of the policy helpers of
``repro.launch.steps``).

The reference's cell functions (``build_cell`` and the dry-run step
functions) lower JAX programs and have no counterpart here; the port
keeps the three policy helpers its serve path uses.
"""
from __future__ import annotations

import functools
from typing import Optional

from ..approx.layers import ApproxPolicy
from ..approx.specs import BackendSpec


def train_policy() -> ApproxPolicy:
    return ApproxPolicy(default=BackendSpec(mode="bf16").materialize())


def pick_case_multiplier(library=None) -> str:
    """Deterministic pick: the Pareto(power x MAE) multiplier nearest 75%
    relative power — the paper's 'interesting' regime (Table II).
    Memoized for the default library."""
    if library is None:
        return _pick_default_case_multiplier()
    return _pick_case_multiplier(library)


@functools.lru_cache(maxsize=1)
def _pick_default_case_multiplier() -> str:
    from ..core.library import get_default_library
    return _pick_case_multiplier(get_default_library())


def _pick_case_multiplier(lib) -> str:
    front = lib.pareto_front("multiplier", 8, "mae")
    cands = [e for e in front if e.source != "exact"]
    if not cands:
        return "mul8u_exact"
    return min(cands, key=lambda e: abs(e.rel_power - 0.75)).name


def serve_policy(multiplier: str = "auto", mode: str = "lowrank",
                 rank: Optional[int] = 4,
                 variant: str = "pallas") -> ApproxPolicy:
    """The serve path's policy: every projection on the approximate
    ``multiplier`` (``"auto"``: ``pick_case_multiplier``) under ``mode``,
    rank 4 by default.  ``variant="pallas"`` (the default, as in
    ``case_study.run``) runs the CUDA kernels — K9 for ``lowrank``;
    ``"ref"`` the plain PyTorch datapath.  bf16 and int8 ignore the
    multiplier."""
    if mode in ("bf16", "int8"):
        return ApproxPolicy(default=BackendSpec(mode=mode).materialize())
    name = pick_case_multiplier() if multiplier == "auto" else multiplier
    spec = BackendSpec(mode=mode, multiplier=name, rank=rank,
                       variant=variant)
    return ApproxPolicy(default=spec.materialize())
