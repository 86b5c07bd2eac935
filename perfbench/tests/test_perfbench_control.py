"""What decides ``correct`` has to fail: the control (the reference one
precision down in the program's place) and the faults a cell can have,
each planted under the timed path, at a tiny size on the CPU.

The control at the cells' own sizes runs on the card
(``tools/limits.py``; ``test_control_at_size`` under ``-m gpu``)."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench.harness import find, import_file, load_manifest

from perfbench.tests.helpers import ROOT, run_tiny

CELLS = ["tiny.resnet", "tiny.moe"]


def build_cell(root, cell, seed=2 ** 32 + 7):
    manifest = load_manifest(root / "BENCHMARK.json")
    entry = find(manifest, "workloads", cell)
    spec = json.loads((root / "perfbench" / "workloads"
                       / f"{cell}.json").read_text())
    config = json.loads((root / find(manifest, "configs", entry["config"])
                         ["file"]).read_text())
    driver = import_file(root / "perfbench" / "drivers"
                         / f"{spec['driver']}.py")
    return driver.build(spec, config, seed, torch.device("cpu"), root), spec


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(tiny_root, cell):
    run, spec = build_cell(tiny_root, cell)
    got = run.run_pass(0)
    for name, value in run.numbers_of(got, 0).items():
        assert value <= spec["limits"][name]
    for name, value in run.control(0).items():
        assert value > spec["limits"][name], (name, value)


def _half_batch_bn(monkeypatch):
    """BN statistics over the first half of the batch only."""
    from repro_torch.models import resnet

    def bn(x, g, b, eps):
        half = x[..., : x.shape[-4] // 2, :, :, :]
        dims = tuple(range(x.ndim - 4, x.ndim - 1))
        mu = torch.mean(half, dim=dims, keepdim=True)
        var = torch.var(half, dim=dims, keepdim=True, correction=0)
        return (x - mu) * torch.rsqrt(var + eps) * g + b
    monkeypatch.setattr(resnet, "_bn", bn)


def _half_batch_loss(monkeypatch):
    """The loss's mean over the first half of the sequences only."""
    from repro_torch.models import decoder
    plain = decoder.chunked_cross_entropy

    def half(hidden, w, targets, chunk, mask=None):
        b = hidden.shape[0] // 2
        return plain(hidden[:b], w, targets[:b], chunk,
                     None if mask is None else mask[:b])
    monkeypatch.setattr(decoder, "chunked_cross_entropy", half)


def _altered_product(monkeypatch):
    """One product sum of lane 0 off by one where the kernel makes it."""
    from repro_torch.kernels import datapaths
    plain = datapaths.fused_matmul_lut_bank

    def altered(*args, **kw):
        y = plain(*args, **kw).clone()
        y.view(-1)[0] += 1.0
        return y
    monkeypatch.setattr(datapaths, "fused_matmul_lut_bank", altered)


FAULTS = {("tiny.resnet", "half_batch"): _half_batch_bn,
          ("tiny.moe", "half_batch"): _half_batch_loss,
          ("tiny.resnet", "altered_answer"): _altered_product,
          ("tiny.moe", "altered_answer"): _altered_product}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(tiny_root, monkeypatch, cell, fault):
    FAULTS[cell, fault](monkeypatch)
    r = run_tiny(tiny_root, cell)
    assert r["correct"] is False, r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["resnet8.table2_fused",
                                  "qwen3moe.ppl_fused"])
def test_control_at_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control at the cell's own size")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "tools" / "limits.py"),
         "--workload", cell, "--seeds", "77", "--control-seeds", "77"],
        capture_output=True, text=True, check=True, timeout=900)
    row = json.loads(out.stdout.strip().splitlines()[-1])
    limits = json.loads((ROOT / "perfbench" / "workloads" / f"{cell}.json")
                        .read_text())["limits"]
    for name, limit in limits.items():
        assert max(r[name] for r in row["program"]) <= limit
        assert min(r[name] for r in row["control"]) > limit
