"""Where K9's tensor-core (prefill) regime spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.lowrank_ablation

Builds copies of ``csrc/lowrank_matmul.cu`` with one part of the mma
regime taken out at a time (into ``_build/ablation/``), runs each at the
serve path's prefill shapes (M = 128, rank 4) with the plan the wrapper
gives them, and prints each copy's device time per call (``torch.profiler``,
20 launches after 3 warm-up).  The copies compute wrong results: the
point is the time each removed part cost.

  base            the kernel as it is
  no_mma          each mma.sync replaced by one ALU op on its operands
                  (fragment loads and 3xTF32 splits kept)
  no_mma_loop     the whole fragment-load / split / mma loop removed
  no_gather       the table lookups and operand-tile stores removed
  no_gather_loop  both of the last two removed (copies, tables, syncs,
                  epilogue and split-K reduction left)
  no_reduce       the split-K reduction (counter, last block's sum)
                  removed
"""
from __future__ import annotations

import ctypes
import subprocess

import torch

from . import build
from . import lowrank_matmul as lm

SHAPES = ((128, 1024, 1024), (128, 1024, 2816), (128, 2816, 1024))
RANK = 4


def _edits(src: str) -> dict[str, list[tuple[str, str]]]:
    mma = src[src.index('  asm volatile(\n      "mma.sync'):
              src.index('"r"(b[0]), "r"(b[1]));')
              + len('"r"(b[0]), "r"(b[1]));')]
    loop = ("    for (int r = 0; r < R; ++r) {\n      const float* A = s_a",
            "    for (int r = 0; r < 0; ++r) {\n      const float* A = s_a")
    gather = [("if (r0 + q < R) s_a[", "if (r0 + q < 0) s_a["),
              ("if (r0 + q < R) s_b[", "if (r0 + q < 0) s_b[")]
    return {
        "base": [],
        "no_mma": [(mma, "d[0] += __uint_as_float(a[0] ^ b[0]); "
                         "d[1] += __uint_as_float(a[1] ^ b[1]);")],
        "no_mma_loop": [loop],
        "no_gather": gather,
        "no_gather_loop": gather + [loop],
        "no_reduce": [("  if (splits == 1) return;\n  if (!arrive_last("
                       "counters + blockIdx.y",
                       "  return;\n  if (!arrive_last(counters + blockIdx.y")],
    }


def _build() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC / "lowrank_matmul.cu").read_text()
    out = build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in _edits(src).items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: edit target not found once")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).lowrank_matmul_launch
        fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
        libs[name] = fn
    return libs


def _device_ms(fn, reps: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0) or 0
                for e in prof.key_averages() if "kernel" in e.key)
    return total / 1e3 / reps


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    libs = _build()
    counters = torch.zeros(4096, dtype=torch.int32, device=dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"[ablation] {card}; device ms per call at rank {RANK}")
    for m, k, n in SHAPES:
        qa = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.int32,
                           device=dev)
        qw = torch.randint(0, 256, (k, n), generator=gen, dtype=torch.int32,
                           device=dev)
        u = torch.randn((RANK, 256), generator=gen, device=dev)
        v = torch.randn((RANK, 256), generator=gen, device=dev)
        p = lm.plan(m, k, n, RANK)
        out = torch.empty((m, n), device=dev)
        ws = torch.empty((p.splits, m, n), device=dev)
        args = lm._ARGS.pack(
            qa.data_ptr(), qw.data_ptr(), u.data_ptr(), v.data_ptr(),
            out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
            counters.numel(), m, k, n, RANK, p.k_per_split, p.splits, 1, 1,
            torch.cuda.current_stream().cuda_stream)

        def call(fn):
            build.check("lowrank_matmul", fn(args))

        row = {name: round(_device_ms(lambda: call(fn)), 4)
               for name, fn in libs.items()}
        print(f"[ablation] {(m, k, n)} {p.regime}, {p.blocks} blocks, "
              f"{p.splits} K slices: {row}", flush=True)


if __name__ == "__main__":
    main()
