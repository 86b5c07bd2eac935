#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size.

    python3 perfbench/tools/limits.py --workload resnet8.table2_fused \\
        --seeds 11 12 13 --control-seeds 11 12 13 --passes 2

For each seed: the cell is built as a run builds it, ``passes`` passes
run through the program (the timed path), then the compared numbers are
read twice: the program's passes against the reference (the lower
reading), and the control, the reference one precision down put in the
program's place, against the reference (the upper reading).  One JSON
line a seed on standard output.  Needs the card; the benchmark's own
runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--passes", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = harness.load_manifest(ROOT / "BENCHMARK.json")
    cell = harness.find(manifest, "workloads", args.workload)
    spec = json.loads((ROOT / "perfbench" / "workloads"
                       / f"{args.workload}.json").read_text())
    config = json.loads((ROOT / harness.find(
        manifest, "configs", cell["config"])["file"]).read_text())
    driver = harness.import_file(ROOT / "perfbench" / "drivers"
                                 / f"{spec['driver']}.py")
    dev = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = driver.build(spec, config, seed, dev, ROOT)
        outs = {i: run.run_pass(i) for i in range(args.passes)}
        torch.cuda.synchronize()
        run.free_program()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        program = [run.numbers_of(got, i) for i, got in outs.items()]
        t2 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed, "program": program,
               "program_s": t2 - t1}
        if seed in args.control_seeds:
            row["control"] = [run.control(i) for i in outs]
            row["control_s"] = time.perf_counter() - t2
        row["total_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del run, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
