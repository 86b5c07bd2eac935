"""Spans and counters inside the port's own layers, recorded while
``torch.profiler`` records.

    with obs.span("datapath", layer="conv_init"):
        ...
        obs.count("bytes_to_device", n)

A span is live only while the profiler records
(``torch.autograd._profiler_enabled()``): an operator gets the spans by
profiling, and nothing else switches them on.  With the profiler off,
``span`` returns one shared do-nothing context and ``count`` returns at
once: nothing is allocated beyond the call's own arguments, no CUDA call
is made and nothing is recorded.

With it on, a span opens a host range of its name in the profiler's own
event list (``_RecordFunctionFast``: a host event only, never a device
annotation, on the clock that also times the device kernels there) and
records its name, parent, attributes, host start and end, and counters;
where the process uses CUDA (``torch.cuda.is_initialized()`` as the
recording starts) it also records a timing event on the current stream
as it opens and as it closes.  A span's *stream ms* is the time between
its two events: the device time of everything queued inside it, plus the
idle the host's slowness there left (the host duration without CUDA).
Its *self ms* is that minus its children's.  Events are read only by
``snapshot``, after the work: nothing here synchronises.

A *recording* is one profiling session's spans: the first span entered
with the profiler on starts one, the first entered with it off ends it,
and the next entered with it on replaces it.  ``snapshot`` reads the last
recording, with the kernel launches (``kernels.ops.launch_counts``) and
kernel builds and loads (``kernels.build.EVENTS``) made while it was
open.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

_on = torch.autograd._profiler_enabled


class _Off:
    """The span while the profiler is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recording:
    """The spans of one profiling session and the tallies at its ends."""

    def __init__(self):
        from .kernels import build, ops
        self.spans: list = []
        self.stack: list = []
        self.cuda = torch.cuda.is_initialized()
        self.launches = (ops.launch_counts(), None)
        self.events = (len(build.EVENTS), None)
        self.open = True

    def close(self) -> None:
        from .kernels import build, ops
        self.launches = (self.launches[0], ops.launch_counts())
        self.events = (self.events[0], len(build.EVENTS))
        self.open = False


_rec: Optional[_Recording] = None


class _Span:
    __slots__ = ("rec", "name", "attrs", "parent", "counters", "t0", "t1",
                 "ev0", "ev1", "range")

    def __init__(self, rec: _Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.counters: dict = {}
        self.t1 = self.ev0 = self.ev1 = None

    def __enter__(self):
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        rec = self.rec
        self.parent = rec.stack[-1] if rec.stack else None
        rec.spans.append(self)
        rec.stack.append(self)
        if rec.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        self.rec.stack.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager that records the work inside it as span
    ``name`` while the profiler records; nothing otherwise."""
    global _rec
    if not _on():
        if _rec is not None and _rec.open:
            _rec.close()
        return _OFF
    if _rec is None or not _rec.open:
        _rec = _Recording()
    return _Span(_rec, name, attrs)


def counting() -> bool:
    """Whether ``count`` records now (the profiler records and a span is
    open): a caller whose count takes work to make checks this first."""
    return bool(_on() and _rec is not None and _rec.open and _rec.stack)


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (while
    the profiler records and a span is open).  ``n`` is an int or a
    device tensor whose elements add to the counter; a tensor is kept
    and summed only by ``snapshot``, so counting launches no kernel and
    makes the host wait for nothing."""
    if counting():
        top = _rec.stack[-1].counters
        top.setdefault(name, []).append(n)


def _total(parts: list) -> int:
    return sum(int(p.sum()) if isinstance(p, torch.Tensor) else int(p)
               for p in parts)


def _stream_ms(s: _Span) -> float:
    if s.ev1 is not None:
        s.ev1.synchronize()
        return s.ev0.elapsed_time(s.ev1)
    return (s.t1 - s.t0) / 1e6


def snapshot() -> Optional[dict]:
    """The last recording, or None: ``spans`` in the order they opened,
    each a dict of ``name``, ``parent`` (an index into ``spans``, or
    None), ``attrs``, ``host_ms``, ``stream_ms``, ``self_ms`` and
    ``counters`` (spans still open are left out); ``clock`` ("cuda" for
    stream ms from device events, "host" for host durations);
    ``launches`` (kernel launches by kernel, nonzero only) and ``builds``
    (``kernels.build.EVENTS`` entries) made while it was open."""
    from .kernels import build, ops
    rec = _rec
    if rec is None:
        return None
    done = [s for s in rec.spans if s.t1 is not None]
    index = {id(s): i for i, s in enumerate(done)}
    out = [{"name": s.name,
            "parent": None if s.parent is None else index.get(id(s.parent)),
            "attrs": dict(s.attrs), "host_ms": (s.t1 - s.t0) / 1e6,
            "stream_ms": _stream_ms(s),
            "counters": {k: _total(v) for k, v in s.counters.items()}}
           for s in done]
    for o in out:
        o["self_ms"] = o["stream_ms"]
    for o in out:
        if o["parent"] is not None:
            out[o["parent"]]["self_ms"] -= o["stream_ms"]
    before, after = rec.launches
    after = after if after is not None else ops.launch_counts()
    first, last = rec.events
    last = last if last is not None else len(build.EVENTS)
    return {"spans": out, "clock": "cuda" if rec.cuda else "host",
            "launches": {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)},
            "builds": list(build.EVENTS[first:last])}


def self_ms(snap: dict) -> dict:
    """Self ms summed by span name."""
    out: dict = {}
    for s in snap["spans"]:
        out[s["name"]] = out.get(s["name"], 0.0) + s["self_ms"]
    return out


def stream_ms_by(snap: dict, name: str, attr: str) -> dict:
    """Stream ms of the spans named ``name``, summed by attribute
    ``attr``."""
    out: dict = {}
    for s in snap["spans"]:
        if s["name"] == name:
            key = s["attrs"].get(attr)
            out[key] = out.get(key, 0.0) + s["stream_ms"]
    return out


def total(snap: dict, counter: str) -> int:
    """Counter ``counter`` summed over every span."""
    return sum(s["counters"].get(counter, 0) for s in snap["spans"])
