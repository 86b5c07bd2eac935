"""Helpers of the benchmark's CPU tests.

    python -m pytest perfbench/tests -q

``make_tiny_root`` makes a checkout of the benchmark beside this one that gains
two cells the way a later change adds one, by new files and manifest
entries only: ``tiny.resnet`` (the ResNet-8 configuration, 3 lanes, 2
batches of 4 images a pass) and ``tiny.moe`` (a new configuration: the qwen3-moe file
at toy widths, 3 lanes, 2 x 16 tokens a pass).  Their runs go through
the kernels' plain versions on the CPU.
"""
import json
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

LANES = ["mul8u_exact", "mul8u_trunc5", "mul8u_bam_h1_v4"]
TINY_MOE = {"name": "tiny-moe", "num_hidden_layers": 2, "hidden_size": 64,
            "moe_intermediate_size": 32, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 16, "num_experts": 8,
            "num_experts_per_tok": 2, "vocab_size": 512}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_tiny_root(base: Path) -> Path:
    bench = base / "perfbench"
    bench.mkdir(parents=True)
    for d in ("drivers", "metrics", "data", "reference"):
        os.symlink(ROOT / "perfbench" / d, bench / d)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    real = ROOT / "perfbench"
    for sub in ("configs", "workloads"):
        for f in (real / sub).iterdir():
            _write(bench / sub / f.name, json.loads(f.read_text()))
    moe = json.loads((real / "configs" / "qwen3-moe-30b-a3b.json")
                     .read_text())
    moe.update(TINY_MOE)
    _write(bench / "configs" / "tiny-moe.json", moe)
    res = json.loads((real / "workloads" / "resnet8.table2_fused.json")
                     .read_text())
    res.update(lanes=LANES, batch=4, eval_batches=2, pool_sets=2,
               check_passes=1, trace_passes=1)
    _write(bench / "workloads" / "tiny.resnet.json", res)
    lm = json.loads((real / "workloads" / "qwen3moe.ppl_fused.json")
                    .read_text())
    lm.update(config="tiny-moe", lanes=LANES, seq_len=16, pool_batches=2,
              check_passes=2, trace_passes=1)
    _write(bench / "workloads" / "tiny.moe.json", lm)
    manifest["configs"].append({
        "name": "tiny-moe", "source": "the qwen3-moe file at toy widths",
        "file": "perfbench/configs/tiny-moe.json", "reduced": [],
        "why": "CPU tests"})
    manifest["workloads"] += [
        {"name": "tiny.resnet", "config": "resnet8-cifar10",
         "traffic": "tiny", "chips": 1, "why": "CPU tests"},
        {"name": "tiny.moe", "config": "tiny-moe", "traffic": "tiny",
         "chips": 1, "why": "CPU tests"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        cells = m.get("workloads", [])
        if "resnet8.table2_fused" in cells:
            cells.append("tiny.resnet")
        if "qwen3moe.ppl_fused" in cells:
            cells.append("tiny.moe")
    _write(base / "BENCHMARK.json", manifest)
    return base


def run_tiny(root: Path, cell: str, seed: int = 2 ** 33 + 5,
             trace: bool = False, seconds: float = 0.2,
             overrides: dict | None = None) -> dict:
    import time

    from perfbench.harness import run
    return run(cell, seed, seconds, trace, t_start=time.perf_counter(),
               manifest_path=root / "BENCHMARK.json", device="cpu",
               overrides=overrides, log=lambda s: None)
