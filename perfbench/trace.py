"""The traced window: ``torch.profiler`` over a few passes, bracketed by
marker kernels, reduced to what the per-layer readers take.

A window's first kernel records can be lost while tracing starts and its
last ones can arrive after it stops, so the window opens and closes with
two marker kernels each (``torch.cuda._sleep``'s spin kernel, which the
program never queues); the markers are left out of every count.  Spans
are ``record_function`` ranges the benchmark opens around its calls
into the program (``pb.*``); an idle gap of the device is named by the
innermost span open on the host when it began.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

MARKER = "spin_kernel"
SPAN_PREFIX = "pb."


@dataclass
class Kernel:
    name: str
    start_us: float
    end_us: float

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) / 1e6


@dataclass
class Trace:
    """The device work of ``passes`` traced passes over ``window_s``
    seconds of host time."""
    kernels: list
    spans: list                    # (name, start_us, end_us)
    passes: int
    window_s: float

    @property
    def busy_s(self) -> float:
        return sum(k.seconds for k in self.kernels)

    def by_name(self, width: int = 200) -> dict:
        """Device seconds by kernel name, names cut to ``width``."""
        out: dict = {}
        for k in self.kernels:
            name = k.name[:width]
            out[name] = out.get(name, 0.0) + k.seconds
        return out

    def idle_gaps(self) -> dict:
        """Seconds the device sat idle between kernels, summed by the
        innermost benchmark span open on the host as each gap began
        ("none" outside every span)."""
        ks = sorted(self.kernels, key=lambda k: k.start_us)
        spans = sorted(self.spans, key=lambda s: s[1])
        out: dict = {}
        end = None
        for k in ks:
            if end is not None and k.start_us > end:
                name = "none"
                for s in spans:          # the latest-opened span wins
                    if s[1] > end:
                        break
                    if s[2] >= end:
                        name = s[0]
                out[name] = out.get(name, 0.0) + (k.start_us - end) / 1e6
            end = k.end_us if end is None else max(end, k.end_us)
        return out


def _device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


@contextlib.contextmanager
def traced():
    """Profile the body between marker kernels; yields a dict that holds
    the ``kernels`` and ``spans`` once the body has ended."""
    from torch.profiler import ProfilerActivity, profile
    got: dict = {}
    cuda = torch.cuda.is_available()     # the CPU tests trace spans only
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])

    def markers():
        if cuda:
            for _ in range(2):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    markers()
    with profile(activities=activities) as prof:
        markers()
        yield got
        markers()
    kernels, spans = [], []
    for e in prof.events():
        if e.name.startswith(SPAN_PREFIX):
            # a span's device-side range (a user annotation) is no kernel
            if not _device(e):
                spans.append((e.name, e.time_range.start,
                              e.time_range.end))
        elif _device(e) and MARKER not in e.name:
            kernels.append(Kernel(e.name, e.time_range.start,
                                  e.time_range.end))
    got["kernels"], got["spans"] = kernels, spans


def is_memory_op(name: str) -> bool:
    return name.startswith(("Memset", "Memcpy", "memset", "memcpy"))
