"""Where the gather body of K1-K8 (``csrc/fused_gather.cuh``) spends its
time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.gather_ablation \
        [--parent DIR]

Builds copies of ``fused_gather.cuh`` with one part changed at a time
(into ``_build/ablation/gather/<copy>/``, one ``nvcc`` per kernel, all
started together) and times each copy's K8 and K6 at the ten layer
shapes of a 64-image ResNet-8 forward on the wide study's 12-lane bank
(7 narrow lanes first, then 5 wide ``loa4`` lanes), and K8 on the 5-lane
all-wide bank; ``base``, ``no_swizzle``, ``parent_design``,
``no_ksplit`` and ``threads1024`` also time K3, K4, K5 and K7, and
``base``, ``no_swizzle``, ``no_lookup``, ``broadcast_index``,
``no_loads``, ``no_ksplit`` and ``threads1024`` K1 and K2 (the operands
``chip_smoke.py``'s timing phase gives them: K2 and K4 the 17-lane
case-study bank, activations shared at conv_init and banked after).
``single_buffer``, ``no_prefetch``, ``sums_in_loop``, ``no_quant``,
``tile_gather``, ``tile_32x1`` and ``rows_unroll2`` time K3 and K4 only
(their ``quant8_kernel``).  Every copy that builds K4 also times its expert form
at qwen3-moe-30b-a3b's expert projections as the benchmark's
``qwen3moe.ppl_fused`` cell runs them (8 lanes x 128 experts, C = 80
capacity rows a pair: wi/wg 2048 -> 768, wo 768 -> 2048), beside the
ResNet shapes.  ``--parent DIR`` adds the
copy ``parent``: the eight kernels built from the sources in DIR (another
tree's ``csrc/``; fused kernels that take packed scalars, ``fp`` (n, 3)
and ``ip`` (n, 2), and four output pointers, as before
``fusedmm::Scalars``, are called so).  Times are ten-shape sums
of CUDA-event means.  The copies that remove a part compute wrong
results: the point is the time the part cost.

  base             the body as it is
  even_split       every block takes an equal count of items (wide cost 1)
  dyn_tree         every wide lane on the runtime-kind guarded tree
  no_swizzle       the row-major table
  parent_design    even_split + dyn_tree + no_swizzle: the body before
                   its redesign (even split, runtime-kind tree, row-major
                   table)
  no_tree          the tree replaced by one add of the digit products
  no_lookup        the table addresses used in place of the table reads
  broadcast_index  every lane of a warp reads one table address (no bank
                   conflicts; one shift more per lookup)
  no_loads         the staged operands hashed from their indices in place
                   of device-memory loads (the quantize and stores kept)
  batch32          32 staged loads in flight per thread in place of 8
  cost2, cost3     a wide lane's item weighs 2 or 3 narrow ones' in place
                   of 5 / 2
  no_ksplit        K never split into ranges (one unit per item)
  threads1024      1024-thread blocks (64 registers a thread) with a K
                   chunk of 16 (the row tile's staging fits beside the
                   table); not K3/K4, whose staged pass (36 operands a
                   thread) would not fit 64 registers
  single_buffer    K3/K4 with one operand buffer: stage, barrier, gather,
                   barrier (the parent's two-barrier staging)
  no_prefetch      K3/K4 staging chunk c + 1 (loads and quantize) before
                   gathering chunk c, its loads' latency not hidden
  sums_in_loop     K3/K4's code sums kept by the gathering threads in their
                   loop (row sums by column group 0, column sums by row 0,
                   every unit), as the parent body keeps them
  no_quant         K3/K4's codes cut from the f32 bits in place of the
                   IEEE division and rint (timing only: not bit-exact)
  tile_gather      K3/K4 always on the tile of the other kernels (one row
                   a thread, 64 rows at N > 32): the tile before
                   quant8_tile
  tile_32x1        K3/K4 always on the 16 x 256 tile (one row a thread,
                   32 threads across N); base takes 80 x 256 at C = 80
  rows_unroll2     the several-row gather loop unrolled twice, as the
                   one-row loop is (more registers at five rows)

``no_swizzle`` + ``no_ksplit`` on K1/K2 stands for the earlier K1/K2
body's table and grid.

Prints one line per copy, then the instruction mix of each inner loop
of ``base``'s K6 and K4 (``cuobjdump -sass``: the loops with table
lookups, opcodes counted per loop body) and ptxas's registers and spills
of each ``quant8_kernel`` tile of ``base``; writes ``chiprun_out/
gather_ablation.json`` and the SASS (``gather_ablation_sass.txt``,
``gather_ablation_sass_k4.txt``).
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import approx_matmul as am
from . import build
from . import composed_matmul as cm
from . import fused_matmul as fm
from . import lut_bank as lb

HEADER = "fused_gather.cuh"
COMPOSED = ("fused_composed_matmul_bank", "composed_matmul_bank")
LUT = ("lut_matmul", "lut_matmul_bank")
QUANT8 = ("fused_matmul", "fused_matmul_bank")
ALL = QUANT8 + ("fused_composed_matmul", "composed_matmul") + COMPOSED
# the copies that time K3/K4 alone (quant8_kernel's parts)
QUANT8_COPIES = ("single_buffer", "no_prefetch", "sums_in_loop", "no_quant",
                 "tile_gather", "tile_32x1", "rows_unroll2")
BATCH = 64
#: qwen3-moe-30b-a3b's expert projections in the benchmark's cell: lanes,
#: experts, capacity rows C, K, N
QWEN_EXPERTS = {"qwen wi/wg": (8, 128, 80, 2048, 768),
                "qwen wo": (8, 128, 80, 768, 2048)}
OUT_DIR = "chiprun_out"


def _edits() -> dict[str, list[tuple[str, str]]]:
    cost = "constexpr int kWideCost = 5;\nconstexpr int kNarrowCost = 2;"
    even = (cost, "constexpr int kWideCost = 1;\nconstexpr int kNarrowCost = 1;")
    dyn = ("t.path = mask == 0u ? kNarrow : wide;",
           "t.path = mask == 0u ? kNarrow : kDyn;")
    rowmajor = ("constexpr unsigned kSwizzle = 31u;",
                "constexpr unsigned kSwizzle = 0u;")
    lookup = "  return *reinterpret_cast<const uint16_t*>(lut + addr);"
    pick = "inline int quant8_tile(int M, int N) {\n"

    def fake(i, j):
        # an operand hashed from its indices (random digits, so the
        # lookups keep their bank conflicts): 16-bit codes, or floats in
        # [-2, 2) that quantize over the whole code range
        h = (f"((((unsigned)({i}) * 0x9E3779B1u) ^ ((unsigned)({j}) "
             f"* 0x85EBCA77u)) >> 16)")
        return (f"(std::is_same<In, float>::value ? In({h} * (1.0f / 16384)"
                f" - 2.0f) : In({h}))")
    return {
        "base": [],
        "even_split": [even],
        "dyn_tree": [dyn],
        "no_swizzle": [rowmajor],
        "parent_design": [even, dyn, rowmajor],
        "no_tree": [("                                         const Tree& t) {\n"
                     "  if (kPath == kExact)",
                     "                                         const Tree& t) {\n"
                     "  return p00 + p01 + p10 + p11;\n"
                     "  if (kPath == kExact)")],
        "no_lookup": [(lookup, "  return addr;")],
        "broadcast_index": [(lookup, "  return *reinterpret_cast<const "
                                     "uint16_t*>(lut + (addr >> 17));")],
        "no_loads": [("? x_lane[(size_t)m * K + k0 + kk] : In(0);",
                      f"? {fake('m', 'kk')} : In(0);"),
                     ("? w_lane[(size_t)(k0 + kk) * N + n] : In(0);",
                      f"? {fake('k0 + kk', 'n')} : In(0);")],
        "batch32": [("constexpr int kBatch = 8;",
                     "constexpr int kBatch = 32;")],
        "cost2": [(cost, "constexpr int kWideCost = 2;\n"
                         "constexpr int kNarrowCost = 1;")],
        "cost3": [(cost, "constexpr int kWideCost = 3;\n"
                         "constexpr int kNarrowCost = 1;")],
        "no_ksplit": [("  return k_splits(gather_items(",
                       "  return 1 + 0 * k_splits(gather_items(")],
        "threads1024": [("constexpr int kThreads = 512;",
                         "constexpr int kThreads = 1024;"),
                        ("constexpr int kKC = 32;", "constexpr int kKC = 16;")],
        "single_buffer": [("constexpr int kStages = 2;",
                           "constexpr int kStages = 1;")],
        "sums_in_loop": [("constexpr bool kSumsInLoop = false;",
                          "constexpr bool kSumsInLoop = true;")],
        "no_quant": [("  const float q = rintf(__fdiv_rn(v, scale)) + zp;",
                      "  const float q = (float)((__float_as_uint(v) >> 15)"
                      " & 255u);")],
        "no_prefetch": [("constexpr bool kPrefetch = true;",
                         "constexpr bool kPrefetch = false;")],
        "tile_gather": [(pick, pick + "  return 0;\n")],
        "tile_32x1": [(pick, pick + "  return 2;\n")],
        "rows_unroll2": [("#pragma unroll (kR == 1 ? 2 : 1)",
                          "#pragma unroll 2")],
    }


def _kernels(copy: str) -> tuple:
    if copy in ("base", "no_swizzle", "no_ksplit", "parent"):
        return LUT + ALL
    if copy == "threads1024":
        return LUT + tuple(k for k in ALL if k not in QUANT8)
    if copy in QUANT8_COPIES:
        return QUANT8
    if copy in ("no_lookup", "broadcast_index", "no_loads"):
        return LUT + COMPOSED
    return ALL if copy == "parent_design" else COMPOSED


def _write_sources(root: Path, parent: Path | None,
                   names: list) -> dict[str, tuple]:
    """The sources of the copies ``names`` under ``root/<copy>/``; copy ->
    its kernels.  ``parent``: a ``csrc/`` directory copied as it is, as
    the copy ``parent``."""
    src = (build.CSRC / HEADER).read_text()
    copies = {c: e for c, e in _edits().items() if c in names}
    if parent is not None:
        copies["parent"] = None
    for copy, edits in copies.items():
        out = root / copy
        out.mkdir(parents=True, exist_ok=True)
        if edits is None:                  # another tree's sources
            for f in parent.iterdir():
                shutil.copy(f, out / f.name)
            continue
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{copy}: edit target not found once")
            text = text.replace(old, new)
        (out / HEADER).write_text(text)
        for name in _kernels(copy):
            shutil.copy(build.CSRC / f"{name}.cu", out / f"{name}.cu")
    return {copy: _kernels(copy) for copy in copies}


def _packed_abi(parent: Path | None) -> bool:
    """Whether the parent's fused kernels take packed scalars (fp, ip)."""
    return parent is not None and "Scalars" not in (
        parent / "fused_matmul.cu").read_text()


def _build(parent: Path | None,
           copies: list) -> dict[tuple[str, str], ctypes._CFuncPtr]:
    """Every copy's kernels, built in parallel (as many nvcc at a time as
    the host has cores); (copy, kernel) -> the launch function, typed as
    the wrappers type it (the parent's packed-scalar kernels as the
    parent's wrappers typed them)."""
    root = build.BUILD_DIR / "ablation" / "gather"
    packed = _packed_abi(parent)
    jobs = [(copy, name) for copy, names in
            _write_sources(root, parent, copies).items() for name in names]

    def nvcc(job):
        out = root / job[0] / job[1]
        return subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out.with_suffix(".so")), str(out.with_suffix(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        done = dict(zip(jobs, pool.map(nvcc, jobs)))
    fns = {}
    for (copy, name), proc in done.items():
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {copy}/{name}:\n"
                               f"{proc.stdout}")
        lib = ctypes.CDLL(str(root / copy / f"{name}.so"))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = (_PACKED_ARGTYPES[name]
                       if packed and copy == "parent"
                       and name in _PACKED_ARGTYPES else _argtypes(name))
        fn.restype = ctypes.c_int
        fns[copy, name] = fn
        if name == "fused_matmul_bank" and not (packed and copy == "parent"):
            ex = getattr(lib, f"{name}_experts_launch")
            ex.argtypes = fm._EXPERT_ARGTYPES[name]
            ex.restype = ctypes.c_int
            fns[copy, name, "experts"] = ex
        (root / copy / f"{name}.log").write_text(proc.stdout)
    return fns


def _ptxas(log: str) -> list[dict]:
    """ptxas's registers and spills of each ``quant8_kernel``
    instantiation in an ``nvcc -Xptxas -v`` log (a function's spill line
    comes before its register line)."""
    out: dict = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        if name is None or "quant8_kernel" not in name:
            continue
        entry = out.setdefault(name, {"function": name})
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_stores"] = int(m.group(1))
            entry["spill_loads"] = int(m.group(2))
    return list(out.values())


def _sass(path, out_path) -> list[dict]:
    """Write ``cuobjdump -sass`` of a kernel library; returns each loop
    body that reads shared memory (a branch back to an earlier address)
    with its opcode counts."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(path)],
                          capture_output=True, text=True).stdout
    with open(out_path, "w") as f:
        f.write(text)
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);",
        text)]
    loops = []
    for end, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and target and int(target.group(1), 16) < end:
            start = int(target.group(1), 16)
            ops = collections.Counter(o.split(".")[0] for a, o, _ in ins
                                      if start <= a <= end)
            if ops["LDS"] >= 8 and sum(ops.values()) < 1000:
                loops.append({"start": hex(start), "end": hex(end),
                              "instructions": sum(ops.values()),
                              "opcodes": dict(ops.most_common())})
    return loops


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the launch functions' argument types, as the wrappers set them
_LUT_ARGTYPES = {"lut_matmul": [_P] * 4 + [_I] * 4 + [_P],
                 "lut_matmul_bank": [_P, _L] + [_P] * 3 + [_I] * 5 + [_P]}
# the fused kernels of a tree from before fusedmm::Scalars, for --parent
# only (drop with _launch_packed once no tree to compare takes them):
# packed scalars, fp (n, 3) = (sa, sw, qmax) and ip (n, 2) = (za, zw)
# pointers after the table (and composed codes), then one pointer an
# output
_PACKED_ARGTYPES = {
    "fused_matmul": [_P] * 8 + [_I] * 4 + [_P],
    "fused_matmul_bank": [_P, _L] + [_P] * 7 + [_I] * 5 + [_P],
    "fused_composed_matmul": [_P] * 11 + [_I] * 4 + [_P],
    "fused_composed_matmul_bank": [_P, _L] + [_P] * 10 + [_I] * 5 + [_P],
}


def _argtypes(name: str) -> list:
    if name in LUT:
        return _LUT_ARGTYPES[name]
    return (cm._ARGTYPES if name.startswith("composed")
            else fm._ARGTYPES)[name]


class _Uncounted:
    """Stands in for a wrapper's launch counter: these launches are not
    the main path's."""
    launches = 0


def _operands(device) -> tuple[dict, dict]:
    """Per layer shape: the operands each timed kernel takes (as
    ``chip_smoke.py``'s timing phase builds them: K2/K4/K8 banked
    activations after conv_init; K1/K2 random 8-bit codes; K5/K6 the
    codes the two-step datapath makes of K7's/K8's operands), and the
    fused kernels' scalars packed (fp, ip)."""
    import numpy as np
    from ..approx.quant import calibrate, quantize, scalar_params
    from ..approx.specs import bank_for
    from ..core.library import get_default_library
    from ..launch.case_study import case_study_names, main_path_shapes
    from ..launch.wide_pareto import wide_names
    from ..models import resnet
    lib = get_default_library()
    gen = torch.Generator(device=device).manual_seed(1)

    def tables(names):
        bank = bank_for(names, lib)
        return {"luts": torch.from_numpy(bank.luts.astype(np.uint16)).to(
                    device),
                "bits": torch.from_numpy(bank.lane_bits).to(device),
                "masks": torch.from_numpy(bank.lane_masks.astype(
                    np.int64)).to(device),
                "codes": torch.from_numpy(bank.lane_reduce_codes).to(device)}

    case = case_study_names(lib)
    luts8 = torch.from_numpy(np.stack([lib.lut(n) for n in case]).astype(
        np.uint16)).to(device)
    banks = {"wide12": tables(case_study_names(lib, 6) + wide_names(lib)),
             "wide5": tables(wide_names(lib))}
    shapes = main_path_shapes(resnet.resnet_config(8), BATCH)
    out, packed = {}, {}
    for label, (m, k, n) in shapes.items():
        shared = label == "conv_init"
        w = torch.randn((k, n), generator=gen, device=device) * 0.2

        def xs(lanes):
            shape = (m, k) if shared or lanes == 1 else (lanes, m, k)
            return torch.randn(shape, generator=gen, device=device)

        def fused(x, bits, lanes):
            sp = scalar_params(calibrate(x, bits, lanes=x.ndim == 3),
                               calibrate(w, bits))
            packs.append(fm.pack_scalars(lanes, device, *sp))
            return (fm.lane_scalars(lanes, device, *sp),)

        cases, packs = {}, []
        qa = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.int32,
                           device=device)
        qw = torch.randint(0, 256, (k, n), generator=gen, dtype=torch.int32,
                           device=device)
        cases["lut_matmul"] = (qa, qw, luts8[0])
        qab = qa if shared else torch.randint(
            0, 256, (luts8.shape[0], m, k), generator=gen, dtype=torch.int32,
            device=device)
        cases["lut_matmul_bank"] = (qab, qw, luts8)
        x1 = xs(1)
        cases["fused_matmul"] = (x1, w, luts8[0], *fused(x1, 8, 1), ())
        x17 = xs(luts8.shape[0])
        cases["fused_matmul_bank"] = (x17, w, luts8,
                                      *fused(x17, 8, luts8.shape[0]), ())
        wb = banks["wide12"]
        one = (wb["masks"][-5:-4], wb["codes"][-5:-4])
        cases["fused_composed_matmul"] = (x1, w, wb["luts"][-5],
                                          *fused(x1, 16, 1), one)
        qa, qw = (quantize(v, calibrate(v, 16)) for v in (x1, w))
        cases["composed_matmul"] = (qa, qw, wb["luts"][-5:-4], *one)
        for bank_name, b in banks.items():
            lanes = b["luts"].shape[0]
            xb = xs(lanes)
            cases[f"fused_composed_matmul_bank {bank_name}"] = (
                xb, w, b["luts"], *fused(xb, b["bits"], lanes),
                (b["masks"], b["codes"]))
            if bank_name == "wide12":
                qab = quantize(xb, calibrate(xb, b["bits"],
                                             lanes=xb.ndim == 3))
                qwb = quantize(w, calibrate(w, b["bits"]))
                cases["composed_matmul_bank wide12"] = (
                    qab, qwb, b["luts"], b["masks"], b["codes"])
        out[label] = cases
        fused_keys = [key for key in cases if key.startswith("fused")]
        packed[label] = dict(zip(fused_keys, packs))
    return out, packed


def _launch_packed(name: str, fn, x, w, luts16, packed, codes=()):
    """One launch of a fused kernel that takes packed scalars and an
    allocation an output (``_PACKED_ARGTYPES``), with the outputs and
    arguments its wrapper gave it."""
    banked = name.endswith("_bank")
    n_lanes = luts16.shape[0] if banked else 1
    m, k = x.shape[-2:]
    n = w.shape[1]
    outs = [torch.empty((n_lanes, m, n), dtype=torch.int32, device=x.device)
            for _ in range(2 if codes else 1)]
    outs += [torch.empty((n_lanes, m), dtype=torch.int32, device=x.device),
             torch.empty((n_lanes, n), dtype=torch.int32, device=x.device)]
    ins = [w, luts16]
    if codes:
        ins += [fm._mask_bits(codes[0]), codes[1].contiguous()]
    ins += [*packed, *outs]
    lead = ((am._ptr(x), m * k if x.ndim == 3 else 0) if banked
            else (am._ptr(x),))
    dims = (n_lanes, m, k, n) if banked else (m, k, n)
    build.check(name, fn(*lead, *(am._ptr(t) for t in ins), *dims,
                         am.sm_count(x.device.index or 0), fm._stream(x)))
    return outs


def _call(name: str, fn, args, packed=None, experts=None):
    """One launch of a copy's kernel ``fn`` through its wrapper (the same
    arguments), the wrapper's launch function swapped for ``fn`` during
    the call and its launch count left as it was; ``packed``: the
    scalars packed, for a kernel that takes them so; ``experts``: the
    copy's expert-form launch function, for stacked weights."""
    if packed is not None:
        return _launch_packed(name, fn, *args[:3], packed, *args[4:])
    if name in LUT:
        mod = am if name == "lut_matmul" else lb
        wrapper = getattr(mod, name)
        own, launches = mod._launcher, wrapper.launches
        mod._launcher = lambda: fn
        try:
            return wrapper(*args)
        finally:
            mod._launcher, wrapper.launches = own, launches
    mod = cm if name.startswith("composed") else fm
    own = mod._launcher
    mod._launcher = lambda *_name: fn       # cm's takes (name, experts)
    own_ex = getattr(mod, "_experts_launcher", None)
    if experts is not None:
        mod._experts_launcher = lambda _name: experts
    try:
        return mod._launch(name, _Uncounted, *args)
    finally:
        mod._launcher = own
        if own_ex is not None:
            mod._experts_launcher = own_ex


def _qwen_operands(device, luts8) -> dict:
    """K4's expert-form operands at ``QWEN_EXPERTS``: banked activations
    (lanes, experts, C, K), stacked weights (E, K, N), the first lanes'
    tables, and each (lane, expert) pair's scalars."""
    from ..approx.quant import calibrate_slices, pair_scalars
    gen = torch.Generator(device=device).manual_seed(2)
    out = {}
    for label, (lanes, e, m, k, n) in QWEN_EXPERTS.items():
        x = torch.randn((lanes, e, m, k), generator=gen, device=device)
        w = torch.randn((e, k, n), generator=gen, device=device) * 0.05
        sp = pair_scalars(calibrate_slices(x), calibrate_slices(w), lanes,
                          e)
        out[label] = (x, w, luts8[:lanes].contiguous(),
                      fm.lane_scalars(lanes * e, device, *sp), ())
    return out


def _ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree's csrc/ directory, built and timed "
                         "as the copy 'parent'")
    ap.add_argument("--copies", default=None,
                    help="comma-separated copies to build and time "
                         "(default: all; 'base' is always built)")
    args = ap.parse_args()
    copies = [c for c in _edits() if args.copies is None
              or c == "base" or c in args.copies.split(",")]
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    fns = _build(args.parent, copies)
    os.makedirs(OUT_DIR, exist_ok=True)
    base = build.BUILD_DIR / "ablation" / "gather" / "base"
    loops = _sass(base / "composed_matmul_bank.so",
                  os.path.join(OUT_DIR, "gather_ablation_sass.txt"))
    k4_loops = _sass(base / "fused_matmul_bank.so",
                     os.path.join(OUT_DIR, "gather_ablation_sass_k4.txt"))
    ptxas = _ptxas((base / "fused_matmul_bank.log").read_text())
    for p in ptxas:
        print(f"[ablation] ptxas {p}")
    ops, packed = _operands(dev)
    qwen = _qwen_operands(dev, ops["conv_init"]["fused_matmul_bank"][2])
    packed_parent = _packed_abi(args.parent)
    print(f"[ablation] {card}; ten-shape sums of ms per call "
          f"(ResNet-8, batch {BATCH}); K4's expert form at "
          f"{QWEN_EXPERTS} (lanes, experts, C, K, N), ms a call")
    result = {"card": card, "ms": {}, "qwen_ms": {}, "k6_loops": loops,
              "k4_loops": k4_loops, "ptxas": ptxas}
    for copy in copies + (["parent"] if args.parent else []):
        row = {}
        for key in ops["conv_init"]:
            name = key.split()[0]
            if name not in _kernels(copy):
                continue
            fn = fns[copy, name]

            old_abi = (packed_parent and copy == "parent"
                       and name in _PACKED_ARGTYPES)

            def call(s):
                return _call(name, fn, ops[s][key],
                             packed[s][key] if old_abi else None)
            row[key] = sum(_ms(lambda: call(s)) for s in ops)
        result["ms"][copy] = row
        print(f"[ablation] {copy:16s} "
              + ", ".join(f"{k} {v:.3f}" for k, v in row.items()),
              flush=True)
        ex = fns.get((copy, "fused_matmul_bank", "experts"))
        if ex is not None:
            qrow = {label: _ms(lambda: _call(
                        "fused_matmul_bank", fns[copy, "fused_matmul_bank"],
                        args_, experts=ex), reps=3, warmup=1)
                    for label, args_ in qwen.items()}
            result["qwen_ms"][copy] = qrow
            print(f"[ablation] {copy:16s} K4 experts "
                  + ", ".join(f"{k} {v:.3f}" for k, v in qrow.items()),
                  flush=True)
    for what, found in (("K6", loops), ("K4", k4_loops)):
        for loop in found:
            print(f"[ablation] {what} loop {loop['start']}-{loop['end']}: "
                  f"{loop['instructions']} instructions {loop['opcodes']}")
    with open(os.path.join(OUT_DIR, "gather_ablation.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
