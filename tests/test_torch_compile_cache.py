"""The kernel build cache and build audit
(``repro_torch.launch.compile_cache``), the counterpart of the
reference's ``repro.launch.compile_cache``.

  * ``enable_compile_cache``: the environment variable wins over the
    argument, the argument over the default, and the build directory
    follows;
  * ``trace_audit`` counts one fresh build, then one load of the built
    library (a cache hit) in a second block — on the CPU with ``nvcc``
    stood in by a script that writes its output file and ``ctypes``
    loading stood in; a ``gpu``-marked case does the real ``nvcc``
    build and load of K9;
  * ``bench_threads`` pins and restores torch's intra-op threads.
"""
import os
import stat
import sys

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.launch import compile_cache
from repro_torch.launch.compile_cache import (CACHE_ENV, bench_threads,
                                              enable_compile_cache,
                                              trace_audit)


@pytest.fixture
def restore_build_dir():
    old = build.BUILD_DIR
    yield
    build.BUILD_DIR = old


def test_resolution_order(tmp_path, monkeypatch, restore_build_dir):
    monkeypatch.delenv(CACHE_ENV, raising=False)
    arg = str(tmp_path / "arg")
    assert enable_compile_cache(arg) == arg
    assert str(build.BUILD_DIR) == arg and os.path.isdir(arg)
    env = str(tmp_path / "env")
    monkeypatch.setenv(CACHE_ENV, env)
    assert enable_compile_cache(arg) == env
    assert str(build.BUILD_DIR) == env
    monkeypatch.delenv(CACHE_ENV)
    default = enable_compile_cache()
    assert default == str(compile_cache._DEFAULT_DIR)
    assert default.endswith(os.path.join("kernels", "_build"))


class _FakeLib:
    """What ``build.load`` sets on a loaded library."""

    def __init__(self, path):
        self.path = path
        self.lutmm_error_string = type("F", (), {})()


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch, restore_build_dir):
    """An ``nvcc`` that writes its ``-o`` file, and a ``ctypes.CDLL``
    that only records the path."""
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'so')\n"
        "print('ptxas info: 0 registers')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.delenv(CACHE_ENV, raising=False)
    enable_compile_cache(str(tmp_path / "cache"))
    return tmp_path


def test_trace_audit_counts_a_fresh_build_then_a_cache_hit(fake_nvcc):
    with trace_audit() as first:
        lib = build.load("lowrank_matmul")
    assert first.fresh_compiles == 1 and first.cache_hits == 0
    assert first.traced_programs == 1 and first.compile_secs > 0
    assert os.path.exists(lib.path)
    assert str(build.library_path("lowrank_matmul")) == lib.path
    # a loaded library is not loaded again
    with trace_audit() as again:
        assert build.load("lowrank_matmul") is lib
    assert again.traced_programs == 0
    # a new process (here: the loaded table cleared) finds it built
    build._LOADED.clear()
    with trace_audit() as second:
        build.load("lowrank_matmul")
    assert second.fresh_compiles == 0 and second.cache_hits == 1
    assert second.traced_programs == 1 and second.compile_secs == 0.0
    # nested audits count by delta against the one tally
    build._LOADED.clear()
    with trace_audit() as outer:
        build.load("bitsim")
        with trace_audit() as inner:
            build.load("lowrank_matmul")
    assert inner.cache_hits == 1 and inner.fresh_compiles == 0
    assert outer.fresh_compiles == 1 and outer.cache_hits == 1


def test_bench_threads_pins_and_restores():
    before = torch.get_num_threads()
    with bench_threads() as n:
        assert n == compile_cache.BENCH_THREADS
        assert torch.get_num_threads() == compile_cache.BENCH_THREADS
    assert torch.get_num_threads() == before


@pytest.mark.gpu
def test_real_build_and_load_on_a_card(tmp_path, monkeypatch,
                                       restore_build_dir):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    monkeypatch.delenv(CACHE_ENV, raising=False)
    monkeypatch.setattr(build, "_LOADED", {})
    enable_compile_cache(str(tmp_path / "cache"))
    with trace_audit() as first:
        build.load("lowrank_matmul")
    assert first.fresh_compiles == 1 and first.compile_secs > 0
    build._LOADED.clear()
    with trace_audit() as second:
        build.load("lowrank_matmul")
    assert second.cache_hits == 1 and second.fresh_compiles == 0
