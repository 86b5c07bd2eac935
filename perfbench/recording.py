"""The program's own spans and counters over the traced window, for the
per-layer readers in ``metrics/``.

The port records spans (``repro_torch.obs``) while the profiler records,
so its last recording holds the traced passes: ``bank_eval`` around a
pass, ``bank.pack`` and ``bank.upload`` (counter ``bytes_to_device``)
for the bank, ``datapath`` a projection with ``datapath.calibrate`` and
``datapath.epilogue`` inside it, ``model.bn`` and
``model.moe.route``/``.dispatch``/``.combine``.  A span's self ms is the
device stream's time inside it less its children's, idle included, so
the self ms of every span of a pass add up to its ``bank_eval``'s.
"""
from __future__ import annotations


def _read(ctx, fn):
    """``fn(recorder, snapshot)`` a pass over the traced passes, or None
    where the window holds no device kernel (a CPU run), the program has
    no recorder, or its recording holds no ``bank_eval`` span.  Never
    raises."""
    t = ctx.trace
    if t is None or not t.kernels or not t.passes:
        return None
    try:
        from repro_torch import obs
        snap = obs.snapshot()
        if not snap or not any(s["name"] == "bank_eval"
                               for s in snap["spans"]):
            return None
        return fn(obs, snap) / t.passes
    except Exception:
        return None


def self_ms(ctx, *names):
    """The self ms of the spans ``names`` a pass."""
    return _read(ctx, lambda obs, snap: sum(
        obs.self_ms(snap).get(n, 0.0) for n in names))


def counter(ctx, name):
    """Counter ``name`` summed over every span, a pass."""
    return _read(ctx, lambda obs, snap: obs.total(snap, name))
