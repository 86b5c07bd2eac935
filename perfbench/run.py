#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port on one H100.

    python3 perfbench/run.py --workload resnet8.table2_fused --seed 7 \\
        --seconds 20 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks`` comes last, each number compared with its
limit, as do the last lines of standard error.  Exits nonzero with no
result when there is no CUDA device, when the cell needs more devices
than there are, or when JAX or the JAX package is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _finite(obj):
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".perfbench_cache"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".perfbench_cache" / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.harness import RunError, run
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start=T_START)
    except RunError as e:
        print(f"[run] no result: {e}", file=sys.stderr, flush=True)
        return 2
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
