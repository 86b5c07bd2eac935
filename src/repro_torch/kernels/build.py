"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` (H100)
into a shared library with a plain C interface, loaded with ``ctypes``.
Builds land in ``_build/`` next to this file (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads as it is.  Nothing is compiled at import:
``load`` builds on first use, ``build_all`` builds every kernel at once
(one ``nvcc`` per source, all started together).

``EVENTS`` is the process-wide tally of what happened: ``("build",
name, seconds)`` for each fresh ``nvcc`` build and ``("load", name,
seconds, fresh)`` for each library loaded (``fresh``: built by that
call); ``launch.compile_cache.trace_audit`` counts it by delta.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
KERNELS = ("lut_matmul", "lut_matmul_bank", "fused_matmul",
           "fused_matmul_bank", "fused_composed_matmul",
           "fused_composed_matmul_bank", "composed_matmul",
           "composed_matmul_bank", "bitsim", "bitsim_pop", "lowrank_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
EVENTS: list[tuple] = []


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are compiled from csrc/ at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def _start(name: str):
    """Start ``nvcc`` for one kernel; None when it is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, t0


def _finish(name: str, started) -> str:
    """Wait for one build; returns nvcc's output (register report)."""
    if started is None:
        return ""
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    EVENTS.append(("build", name, time.perf_counter() - t0))
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> dict[str, str]:
    """Build every kernel in parallel; returns each one's nvcc output."""
    started = {name: _start(name) for name in KERNELS}
    return {name: _finish(name, s) for name, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        t0 = time.perf_counter()
        started = _start(name)
        _finish(name, started)
        lib = ctypes.CDLL(str(library_path(name)))
        lib.lutmm_error_string.argtypes = [ctypes.c_int]
        lib.lutmm_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
        EVENTS.append(("load", name, time.perf_counter() - t0,
                       started is not None))
    return lib


def check(name: str, err: int) -> None:
    """Raise when kernel ``name``'s launch function returned a CUDA
    error."""
    if err != 0:
        msg = load(name).lutmm_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({msg})")
