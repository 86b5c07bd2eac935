"""The reader of K3/K4's padded-lookup counters (``metrics/
tile_pad_share.py``) on the tiny cells, whose runs go through the
kernels' plain versions on the CPU (which count the plan the kernels
would take): silent without a device kernel in the trace, as in the
run's line; beside a stand-in kernel, the share of the recording's
counters; silent for a program that counts neither."""
import pytest

from perfbench.harness import Context, cell_metrics, load_manifest, \
    read_metric
from perfbench.tests.helpers import run_tiny
from perfbench.trace import Kernel, Trace

SUFFIX = {"tiny.resnet": "images", "tiny.moe": "tokens"}


def _ctx(kernels) -> Context:
    return Context(trace=Trace(kernels=kernels, spans=[], passes=1,
                               window_s=1.0))


@pytest.mark.parametrize("cell", sorted(SUFFIX))
def test_tile_pad_share_on_the_tiny_cells(tiny_root, cell):
    from repro_torch import obs
    name = f"tile_pad_share.{SUFFIX[cell]}"
    manifest = load_manifest(tiny_root / "BENCHMARK.json")
    assert name in {m["name"] for m in cell_metrics(manifest, cell,
                                                    "per_layer")}
    r = run_tiny(tiny_root, cell, trace=True)
    assert r["correct"] is True
    assert name not in r["metrics"]             # no device kernel: silent
    assert read_metric(name, _ctx([]), tiny_root) is None
    got = read_metric(name, _ctx([Kernel("stand-in", 0.0, 1.0)]), tiny_root)
    snap = obs.snapshot()
    looked = obs.total(snap, "gather.lookups")
    pad = obs.total(snap, "gather.pad_lookups")
    assert looked > 0 and 0 <= pad < looked
    assert got == pytest.approx(100.0 * pad / looked)


def test_tile_pad_share_without_the_counters(tiny_root, monkeypatch):
    from repro_torch import obs
    run_tiny(tiny_root, "tiny.resnet", trace=True)
    monkeypatch.setattr(obs, "total", lambda snap, counter: 0)
    assert read_metric("tile_pad_share.images",
                       _ctx([Kernel("stand-in", 0.0, 1.0)]),
                       tiny_root) is None
