"""Build hygiene: the kernel build cache and a build audit (counterpart
of ``repro.launch.compile_cache``, DESIGN.md §2.10).

The port's compiled programs are its CUDA kernels: each builds once
with ``nvcc`` into ``kernels/build.BUILD_DIR`` (named by a hash of the
sources and flags) and later runs load the built library.
``enable_compile_cache`` points that directory somewhere else, so
repeated invocations (CI re-runs, benchmark sweeps, serve restarts)
share one cache:

    from repro_torch.launch.compile_cache import enable_compile_cache
    enable_compile_cache()            # kernels/_build
    enable_compile_cache("/tmp/cc")   # explicit directory

``REPRO_TORCH_KERNEL_CACHE_DIR`` in the environment wins over both the
argument and the default, as ``JAX_COMPILATION_CACHE_DIR`` does for the
reference, so operators can redirect the cache without touching code.

``trace_audit`` is the measurement side: a context manager that counts
the kernel libraries a block made ready — fresh ``nvcc`` builds, and
loads of an already-built library (the cache hits) — by delta-counting
against ``kernels.build.EVENTS``, the one process-wide tally.

``xla_flags_env`` has no torch meaning.  Its counterpart here,
``bench_threads``, pins torch's intra-op thread pool for CPU timing,
which is what the reference's ``XLA_BENCH_FLAGS``
(``--xla_cpu_multi_thread_eigen=false``) pins for XLA.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from pathlib import Path

import torch

from ..kernels import build

CACHE_ENV = "REPRO_TORCH_KERNEL_CACHE_DIR"
_DEFAULT_DIR = Path(build.__file__).parent / "_build"

#: Intra-op threads for reproducible CPU timing (the reference's
#: ``XLA_BENCH_FLAGS`` turn XLA's multi-threaded Eigen off).
BENCH_THREADS = 1


@contextlib.contextmanager
def bench_threads(n: int = BENCH_THREADS):
    """Run the block with ``n`` intra-op threads, then restore."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield n
    finally:
        torch.set_num_threads(old)


def enable_compile_cache(cache_dir: str | None = None) -> str:
    """Point the kernel build directory at the cache and return its
    path.  Resolution order: ``REPRO_TORCH_KERNEL_CACHE_DIR``, then
    ``cache_dir``, then ``kernels/_build``.  A library already loaded in
    this process stays loaded; the next kernel loads (or builds) there."""
    d = os.environ.get(CACHE_ENV) or cache_dir or str(_DEFAULT_DIR)
    os.makedirs(d, exist_ok=True)
    build.BUILD_DIR = Path(d)
    return d


@dataclass
class TraceCounts:
    """Mutable tally filled in while a ``trace_audit`` block runs."""

    compiles: int = 0
    cache_hits: int = 0
    compile_secs: float = 0.0
    events: list = field(default_factory=list)

    @property
    def traced_programs(self) -> int:
        """Kernel libraries made ready in the block: one load each,
        whether it built fresh or found the library in the cache (a hit
        additionally bumps ``cache_hits``)."""
        return self.compiles

    @property
    def fresh_compiles(self) -> int:
        """Libraries ``nvcc`` actually built (not found in the cache)."""
        return self.compiles - self.cache_hits


@contextlib.contextmanager
def trace_audit():
    """Count kernel builds and cache loads in a block.

    >>> with trace_audit() as counts:
    ...     ops.lowrank_matmul(qa, qw, u, v)    # on a CUDA tensor
    >>> counts.fresh_compiles, counts.cache_hits
    (1, 0)

    ``compile_secs`` sums the block's fresh ``nvcc`` builds (those
    ``build_all`` started count too)."""
    start = len(build.EVENTS)
    counts = TraceCounts()
    try:
        yield counts
    finally:
        new = build.EVENTS[start:]
        loads = [e for e in new if e[0] == "load"]
        counts.compiles = len(loads)
        counts.cache_hits = sum(1 for e in loads if not e[3])
        counts.compile_secs = float(sum(e[2] for e in new
                                        if e[0] == "build"))
        counts.events = list(new)
