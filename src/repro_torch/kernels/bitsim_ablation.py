"""What each part of the bitsim kernels' design (K10, K11) is worth, on
the card.

    PYTHONPATH=src python -m repro_torch.kernels.bitsim_ablation \\
        [--parent DIR] [--rounds 5]

Times, in one process and in turns (every copy once a round, ``rounds``
rounds, the median kept), the four cases ``chip_smoke.py`` times: K11 on
one CGP generation of each family (32 candidates x 256 words, the
mutants ``chip_smoke.py`` makes) and K10 on the exact 8-bit multiplier
and adder over exhaustive planes (2048 words).  Each copy's output is
checked against the plain version first.  The copies:

  base                the kernels as they are (``walk_plan``'s walk)
  serial              the serial walk (one warp a word column, gates in
                      index order, staged descriptors, forwarding)
  serial_global       the serial walk reading each gate from
                      funcs/in0/in1 through __ldg (the kernel's walk for
                      netlists too large to stage) in place of the
                      staged descriptors
  level_g2/g4/g8      the level walk with 2, 4 or 8 warps a word column
  branchy             ``gate_eval`` as a switch on the truth table (the
                      earlier body's branch tree) in place of the masks
  single              the level walk taking one gate a warp at a time
                      (the kernels take two, their loads together)
  parent              ``DIR/src/repro_torch/kernels/csrc``'s kernels
                      as they are (``--parent``, e.g. the parent
                      commit's ``git archive`` unpacked under ``_proof/``;
                      its launch takes no walk and no warps)

``serial``, ``serial_global`` and ``level_g*`` run the base build with
the walk forced; ``branchy`` and ``single`` are copies of
``csrc/bitsim.cuh`` with one part replaced (built into
``_build/ablation_bitsim/``, one nvcc per copy, all started together),
each with the base's walk.  A copy the shape cannot take (the launch
refuses it, e.g. 1024 threads past the registers) is recorded as
refused.  Prints each case's device ms per call (``torch.profiler``,
kernels only) and launch-alone ms (CUDA events), and writes
``chiprun_out/bitsim_ablation.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import bitsim as kb
from . import build, ops, ref
from .approx_matmul import _ptr, sm_count
from .fused_matmul import _stream

ROOT = Path(__file__).resolve().parents[3]
OUT = build.BUILD_DIR / "ablation_bitsim"
NAMES = ("bitsim", "bitsim_pop")


def _edits(src: str) -> dict[str, list[tuple[str, str]]]:
    ev = src[src.index("  const unsigned x1 = (b & t.x) | (~b & t.y);\n"):
             src.index("  return (a & x1) | (~a & x0);\n")
             + len("  return (a & x1) | (~a & x0);\n")]
    branchy = """  switch (t.x >> 28) {
    case 12: return a;             // buf
    case 3: return ~a;             // inv
    case 8: return a & b;          // and
    case 14: return a | b;         // or
    case 6: return a ^ b;          // xor
    case 7: return ~(a & b);       // nand
    case 1: return ~(a | b);       // nor
    case 9: return ~(a ^ b);       // xnor
    case 0: return 0u;             // tie0
    default: return 0xFFFFFFFFu;   // tie1
  }
"""
    walk = src[src.index("    // the walk: level by level"):
               src.index("  } else if (walk == kSerial) {")]
    single = """    int s = 0;
    for (int L = 0; L < depth; ++L) {
      const int e = loff[L + 1];
      for (int i = s + y; i < e; i += G) {
        const Rec g0 = rec[i];
        word(smem, g0.at.z + x4) = gate_eval(
            g0.t, word(smem, g0.at.x + x4), word(smem, g0.at.y + x4));
      }
      s = e;
      __syncthreads();
    }
"""
    return {
        # the descriptor kept whole in t.x, the gate a switch on its table
        "branchy": [("  return make_uint4((unsigned)((int)d >> 31),",
                     "  return make_uint4(d,"), (ev, branchy)],
        "single": [(walk, single)],
    }


def _nvcc(src_dir: Path, name: str, out: Path):
    return subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
         str(src_dir / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _build(parent: Path | None) -> dict[str, dict]:
    """{copy: {name: launch function}} of the built copies (base loads
    through ``build``)."""
    src = (build.CSRC / "bitsim.cuh").read_text()
    procs = {}
    dirs = {}
    for copy, edits in _edits(src).items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{copy}: edit target not found once")
            text = text.replace(old, new)
        d = OUT / copy
        d.mkdir(parents=True, exist_ok=True)
        (d / "bitsim.cuh").write_text(text)
        for name in NAMES:
            shutil.copy(build.CSRC / f"{name}.cu", d / f"{name}.cu")
        dirs[copy] = d
    if parent is not None:
        dirs["parent"] = parent / "src/repro_torch/kernels/csrc"
    for copy, d in dirs.items():
        (OUT / copy).mkdir(parents=True, exist_ok=True)
        for name in NAMES:
            procs[copy, name] = _nvcc(d, name, OUT / copy / f"{name}.so")
    libs = {"base": {name: kb._launcher(name) for name in NAMES}}
    for (copy, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {copy}/{name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(OUT / copy / f"{name}.so")),
                     f"{name}_launch")
        new_abi = copy != "parent"
        fn.argtypes = kb._ARGTYPES[name] if new_abi else (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * (6 if name ==
                                                      "bitsim_pop" else 5)
            + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs.setdefault(copy, {})[name] = fn
    return libs


def cases(device) -> dict:
    """The four cases: (kernel name, tensors, words) each."""
    from ..core.cgp import CgpParams, mutate
    from ..core.evolve_pop import PopEvaluator
    from ..core.netlist import exhaustive_inputs, stack_netlists
    from ..core.seeds import array_multiplier, ripple_carry_adder
    out = {}
    for name, exact, seed in (("mul8", array_multiplier(8), 1234),
                              ("add8", ripple_carry_adder(8), 4321)):
        ev = PopEvaluator(exact, CgpParams(metric="mae", seed=seed),
                          engine="device", device=device)
        rng = np.random.default_rng(seed)
        pop = [mutate(exact, rng, 4) for _ in range(32)]
        out[f"{name} generation"] = ("bitsim_pop", ops.netlist_tensors(
            stack_netlists(pop), exact.n_i, device), ev.planes32)
    for name, nl in (("mul8 exact", array_multiplier(8)),
                     ("add8 exact", ripple_carry_adder(8))):
        words = ops.words_to_device(ops.split_planes64(
            exhaustive_inputs(nl.n_i)), device)
        out[name] = ("bitsim", ops.netlist_tensors(
            (nl.funcs, nl.in0, nl.in1, nl.outputs), nl.n_i, device), words)
    return out


def _caller(copy: str, fn, name: str, tens, words):
    """A zero-argument launch of ``copy`` on one case, and its output."""
    pop = name == "bitsim_pop"
    funcs, outs = tens[0], tens[3]
    p = funcs.shape[0] if pop else 1
    n_nodes, n_o = funcs.shape[-1], outs.shape[-1]
    n_i, w = words.shape
    wp = kb.walk_plan(n_i, n_nodes, p, w, sm_count(words.get_device()))
    walk, warps = {"serial": ("serial", 1),
                   "serial_global": ("serial_global", 1),
                   "level_g2": ("level", 2),
                   "level_g4": ("level", 4), "level_g8": ("level", 8)
                   }.get(copy, (wp.walk, wp.warps))
    out = torch.empty((p, n_o, w), dtype=torch.int32, device=words.device)
    dims = (n_nodes, n_i, n_o, w, wp.wb)
    if copy != "parent":
        dims += (kb.WALKS.index(walk), warps)
    args = [_ptr(t) for t in tens] + [_ptr(words), _ptr(out),
                                      *((p,) + dims if pop else dims),
                                      ctypes.c_void_p(_stream(words))]

    def call():
        build.check(name, fn(*args))
    return call, out


def _device_ms(call, reps: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0) or 0
                for e in prof.key_averages() if "bitsim" in e.key)
    return total / 1e3 / reps


def _event_ms(call, reps: int = 50) -> float:
    for _ in range(3):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    libs = _build(args.parent)
    copies = ["base", "serial", "serial_global", "level_g2", "level_g4",
              "level_g8", *[c for c in libs if c != "base"]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"[ablation] {card}; {args.rounds} rounds in turns, medians",
          flush=True)
    calls, refused = {}, {}
    for label, (name, tens, words) in cases(dev).items():
        want = ref.bitsim_pop_ref(*tens, words) if name == "bitsim_pop" \
            else ref.bitsim_ref(*tens, words)[None]
        for copy in copies:
            fn = libs.get(copy, libs["base"])[name]
            call, out = _caller(copy, fn, name, tens, words)
            try:
                call()
            except RuntimeError as err:
                refused[f"{label} / {copy}"] = str(err)
                continue
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{copy} != plain on {label}")
            calls[label, copy] = call
    runs = {key: {"device_ms": [], "launch_ms": []} for key in calls}
    for _ in range(args.rounds):
        for key, call in calls.items():
            runs[key]["device_ms"].append(_device_ms(call))
            runs[key]["launch_ms"].append(_event_ms(call))
    result = {"card": card, "rounds": args.rounds, "cases": {},
              "refused": refused}
    for (label, copy), r in runs.items():
        row = {k: statistics.median(v) for k, v in r.items()}
        row["runs"] = r
        result["cases"].setdefault(label, {})[copy] = row
    for label, rows in result["cases"].items():
        print(f"[ablation] {label}: " + ", ".join(
            f"{c} {r['device_ms']:.4f}/{r['launch_ms']:.4f}"
            for c, r in rows.items()) + "  (device / launch-alone ms)",
            flush=True)
    for key, msg in refused.items():
        print(f"[ablation] refused: {key}: {msg}")
    out = ROOT / "chiprun_out" / "bitsim_ablation.json"
    os.makedirs(out.parent, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
