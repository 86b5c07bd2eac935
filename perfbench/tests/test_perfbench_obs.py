"""The readers of the program's own spans and counters
(``perfbench/recording.py``, ``metrics/bank_ms.py`` and the rest) on
the tiny cells, whose runs go through the kernels' plain versions on the
CPU.  A CPU run traces no device kernel, so the readers stay silent in
the run's line; here they read the run's recording beside a stand-in
kernel."""
import sys

import pytest

from perfbench.harness import Context, cell_metrics, load_manifest, \
    read_metric
from perfbench.tests.helpers import LANES, run_tiny
from perfbench.trace import Kernel, Trace

NEW = {"tiny.resnet": ("bank_ms", "const_upload_mb", "calib_ms",
                       "epilogue_ms", "bn_ms", "model_ms"),
       "tiny.moe": ("bank_ms", "const_upload_mb", "calib_ms",
                    "epilogue_ms", "moe_route_ms", "model_ms")}
SUFFIX = {"tiny.resnet": "images", "tiny.moe": "tokens"}


def _ctx(kernels) -> Context:
    return Context(trace=Trace(kernels=kernels, spans=[], passes=1,
                               window_s=1.0))


def _stand_in():
    return [Kernel("stand-in", 0.0, 1.0)]


@pytest.mark.parametrize("cell", sorted(NEW))
def test_readers_on_the_tiny_cells(tiny_root, cell):
    manifest = load_manifest(tiny_root / "BENCHMARK.json")
    names = [f"{n}.{SUFFIX[cell]}" for n in NEW[cell]]
    listed = {m["name"] for m in cell_metrics(manifest, cell, "per_layer")}
    assert set(names) <= listed
    r = run_tiny(tiny_root, cell, trace=True)
    assert r["correct"] is True
    assert not set(names) & set(r["metrics"])   # no device kernel: silent
    for name in names:
        assert read_metric(name, _ctx([]), tiny_root) is None
    got = {n: read_metric(n, _ctx(_stand_in()), tiny_root) for n in names}
    for name, value in got.items():
        assert value > 0, (name, value)
    # the 3 lanes' int32 tables and their uint16 copies, once a pass
    assert got[f"const_upload_mb.{SUFFIX[cell]}"] == pytest.approx(
        len(LANES) * 65536 * 6 / 1e6)


def test_readers_without_a_recording(tiny_root, monkeypatch):
    from repro_torch import obs
    monkeypatch.setattr(obs, "_rec", None)
    assert read_metric("bank_ms.images", _ctx(_stand_in()),
                       tiny_root) is None
    import repro_torch                  # a program without the recorder
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    for name in ("model_ms.images", "const_upload_mb.tokens"):
        assert read_metric(name, _ctx(_stand_in()), tiny_root) is None
