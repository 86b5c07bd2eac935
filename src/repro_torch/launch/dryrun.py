"""Multi-device dry run: trace every (architecture x input shape) cell on
the production meshes and record memory, cost and collective analysis
for the roofline (counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
        --shape train_4k [--multi-pod] [--out chiprun_out/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers each cell with XLA on 512 placeholder host
devices.  Here a ``"fake"`` ``torch.distributed`` process group whose
world size is the mesh's (256, or 512 with ``--multi-pod``) backs a
``DeviceMesh`` named like the mesh's axes, and every parameter,
optimizer state, batch and cache leaf becomes a DTensor over ``meta``
local shards, placed by ``launch.mesh``'s rules
(``NamedSharding.placements``).  A step then runs in one process with
no memory: DTensor propagates the shardings op by op, issues the
collectives its redistributions need, and runs the local ops on the
shards; the sharding hints (``models.common.hint_*``) are active.  The
group is set up inside ``run_cell`` and destroyed on every exit; nothing
happens at import.

Per cell:
  * ``lower_s``: the full-depth step traced on ``meta`` tensors at
    global shapes; without probes on a multi-device mesh, on the
    DTensors instead (the per-device program at full depth, which costs
    about a millisecond an op on a CPU — hours for an MoE cell, whose
    port loops over experts);
  * ``memory``: per-device argument, output and aliased (donated) bytes,
    exact from the placements (each leaf's shard shape x itemsize);
  * ``flops_per_device``, ``bytes_per_device`` and ``collectives`` from
    the shallow probes (``steps.build_probes``: one and two block
    periods, and the optimizer for train) run on the DTensors under
    ``op_analysis.OpTrace``, extrapolated to full depth by
    ``_combine_linear`` exactly as the reference does (train:
    n_microbatches x stack + opt);
  * ``roofline``: compute / memory / collective seconds on one NVIDIA
    H100's published peaks, the bottleneck, the model flops and the
    useful-flops ratio.

The traced steps run the plain datapath (``variant="ref"``): the
kernel wrappers launch or raise off the CPU, and their plain versions
compute the same function op for op.  On a one-device mesh every
placement is whole: the probes run on plain tensors with no process
group.  Given a mesh whose one device is a card
(``launch.mesh.Mesh(("data", "model"), (1, 1), (torch.device("cuda",
0),))``), ``run_cell`` also realizes each probe there — the counterpart
of ``compile()`` + ``memory_analysis()``, which torch has only by
running: random tensors from ``seed``, a first run under
``compile_cache.trace_audit`` (``compile_s``: the first run, kernel
builds included), then a timed run with its wall, peak memory
(``torch.cuda.max_memory_allocated``) and kernel launches.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from ..configs import ARCHS, all_cells
from ..configs.shapes import SHAPES
from ..models.common import ambient_mesh
from ..models.registry import model_fns
from ..train.optimizer import OptState, init_opt_state
from . import op_analysis
from .compile_cache import trace_audit
from .mesh import (Mesh, NamedSharding, axis_size, batch_shardings,
                   cache_shardings, data_axes, make_production_mesh,
                   params_shardings, pspec, replicated)
from .steps import (CellSpec, ProbeSpec, apply_overrides, block_period,
                    build_cell, build_probes, model_flops)

DEFAULT_OUT = os.path.join(os.path.dirname(__file__),
                           "../../../chiprun_out/dryrun")

# One NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit: NVIDIA's
# published dense peaks.
CARD = "NVIDIA H100 80GB HBM3 (SXM), 700 W"
PEAK_FLOPS = 989e12       # bf16 dense
HBM_BW = 3.35e12          # bytes/s
LINK_BW = 50e9            # bytes/s a GPU across hosts (400 Gb/s IB)
NVLINK_BW = 450e9         # bytes/s a GPU each way inside one host
HOST_GPUS = 8             # GPUs one NVLink host holds


def link_bw(n_chips: int) -> float:
    """A mesh inside one 8-GPU host talks over NVLink; the production
    meshes (both axes of 16) cross hosts over InfiniBand."""
    return NVLINK_BW if n_chips <= HOST_GPUS else LINK_BW


# ----------------------------------------------------------------------
# Shardings
# ----------------------------------------------------------------------
def cell_shardings(cell: CellSpec, mesh):
    """in/out sharding trees for this cell's step function."""
    long_ctx = cell.shape.name == "long_500k"
    if cell.kind == "train":
        params_sds, opt_sds, bspecs = cell.args_sds
        p_sh = params_shardings(params_sds, mesh)
        opt_sh = OptState(step=replicated(mesh), m=p_sh, v=p_sh)
        b_sh = batch_shardings(bspecs, mesh, microbatched=True)
        return (p_sh, opt_sh, b_sh), (p_sh, opt_sh, replicated(mesh))
    dp = data_axes(mesh)
    if cell.kind == "prefill":
        params_sds, bspecs, cache_sds = cell.args_sds
        p_sh = params_shardings(params_sds, mesh)
        b_sh = batch_shardings(bspecs, mesh)
        c_sh = cache_shardings(cache_sds, mesh, long_ctx)
        logits_sh = NamedSharding(mesh, pspec(dp, None))
        return (p_sh, b_sh, c_sh), (logits_sh, c_sh)
    # decode
    params_sds, token_sds, cache_sds = cell.args_sds
    p_sh = params_shardings(params_sds, mesh)
    c_sh = cache_shardings(cache_sds, mesh, long_ctx)
    fits = cell.shape.global_batch % axis_size(mesh, dp) == 0
    tok_sh = NamedSharding(mesh, pspec(dp) if fits else ())
    logits_sh = NamedSharding(mesh, pspec(dp, None) if fits else ())
    return (p_sh, tok_sh, c_sh), (logits_sh, c_sh)


def probe_shardings(probe: ProbeSpec, mesh):
    """in-shardings for an analysis probe."""
    cell = probe.cell
    if probe.name == "opt":
        params_sds, grads_sds, opt_sds = probe.args_sds
        p_sh = params_shardings(params_sds, mesh)
        return (p_sh, p_sh, OptState(step=replicated(mesh), m=p_sh,
                                     v=p_sh))
    if cell.kind == "train":
        params_sds, mb_specs = probe.args_sds
        return (params_shardings(params_sds, mesh),
                batch_shardings(mb_specs, mesh))
    in_sh, _ = cell_shardings(cell, mesh)
    return in_sh


def _zip_map(fn, tree, shardings):
    """``fn(leaf, sharding)`` over ``tree``; one ``NamedSharding`` (or
    None) over a subtree applies to each of its leaves; non-tensor leaves
    (a cache's host ``pos``) pass through."""
    def sub(key):
        if shardings is None or isinstance(shardings, NamedSharding):
            return shardings
        return shardings[key]
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        subs = [_zip_map(fn, v, sub(i)) for i, v in enumerate(tree)]
        return type(tree)(*subs) if hasattr(tree, "_fields") \
            else type(tree)(subs)
    if isinstance(tree, torch.Tensor):
        return fn(tree, shardings)
    return tree


def shard_shape(shape, sharding: NamedSharding) -> tuple:
    """The per-device shape of a leaf (the reference's
    ``NamedSharding.shard_shape``)."""
    out = list(shape)
    for d, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        n = axis_size(sharding.mesh, entry)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {entry}")
        out[d] //= n
    return tuple(out)


def _leaf_bytes(tree, shardings) -> list:
    rows = []
    _zip_map(lambda t, sh: rows.append(
        (math.prod(shard_shape(t.shape, sh)), t.dtype)), tree, shardings)
    return [(n * op_analysis.DTYPE_BYTES[dt], n, dt) for n, dt in rows]


def per_device_bytes(tree, shardings) -> int:
    """Σ shard shape x itemsize over a tree's tensor leaves."""
    return sum(b for b, _, _ in _leaf_bytes(tree, shardings))


def alias_bytes(out_tree, out_sh, donated: list) -> int:
    """Bytes of the outputs that can reuse a donated argument's buffer:
    each output leaf paired with one unused donated leaf of the same
    per-device element count and dtype, as XLA pairs donations."""
    pool: dict = {}
    for tree, sh in donated:
        for b, n, dt in _leaf_bytes(tree, sh):
            pool[(n, dt)] = pool.get((n, dt), 0) + 1
    total = 0
    for b, n, dt in _leaf_bytes(out_tree, out_sh):
        if pool.get((n, dt), 0):
            pool[(n, dt)] -= 1
            total += b
    return total


# ----------------------------------------------------------------------
# The fake process group and placing trees on it
# ----------------------------------------------------------------------
@contextlib.contextmanager
def fake_mesh(mesh):
    """A ``"fake"`` process group of the mesh's size and a
    ``DeviceMesh`` named like its axes, destroyed on exit.  Raises when
    a process group is already up (the dry run never joins a real
    one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry run sets up its own fake group")
    n = math.prod(mesh.sizes)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(mesh.sizes),
                         mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def _place(tree, shardings, device_mesh):
    """Meta leaves (global shapes) -> DTensors over meta local shards."""
    from torch.distributed.tensor import DTensor

    def one(t, sh):
        local = torch.empty(shard_shape(t.shape, sh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, device_mesh,
                                  sh.placements(device_mesh),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return _zip_map(one, tree, shardings)


def _grad_mode(kind: str):
    return contextlib.nullcontext() if kind == "train" else torch.no_grad()


def _trace(step_fn, args, kind: str, device_mesh=None, keep_ops=False):
    """Run ``step_fn(*args)`` under an ``OpTrace``; (out, seconds,
    trace).  Over DTensors: plain tensors the step makes count as
    replicated, and the hints see ``device_mesh``."""
    tr = op_analysis.OpTrace(keep_ops=keep_ops)
    ctx = contextlib.ExitStack()
    if device_mesh is not None:
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        ctx.enter_context(implicit_replication())
        ctx.enter_context(ambient_mesh(device_mesh))
    t0 = time.perf_counter()
    with ctx, _grad_mode(kind), tr:
        out = step_fn(*args)
    return out, time.perf_counter() - t0, tr


# ----------------------------------------------------------------------
# Realizing a probe on a device
# ----------------------------------------------------------------------
def _fill(tree, gen, device, vocab: int):
    """Random tensors like a meta tree's: integers in [0, vocab), floats
    standard normal, from ``gen``; host ints as they are."""
    def one(t):
        if t.dtype.is_floating_point:       # drawn in place, no f32 copy
            return torch.randn(t.shape, generator=gen, device=device,
                               dtype=t.dtype)
        return torch.randint(0, vocab, t.shape, generator=gen,
                             device=device, dtype=t.dtype)
    return _zip_map(lambda t, _sh: one(t), tree, None)


def _real_params(probe: ProbeSpec, gen, device):
    """The model's initialization from ``gen`` on ``device``, prepared
    for ``lowrank`` serving when the probe's tree is."""
    cfg = probe.cell.cfg
    params = model_fns(cfg).init_params(gen, cfg)
    if probe.cell.prepared_with is not None:
        from ..approx.backend import prepare_tree
        params = prepare_tree(params, probe.cell.prepared_with)
    return params


def realize_args(probe: ProbeSpec, device, seed: int = 0) -> tuple:
    """The probe's arguments as real tensors on ``device`` from
    ``seed``: the model's initialization, random tokens and inputs, a
    random cache (its host ``pos`` kept), small random gradients and a
    zero optimizer state."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = probe.cell.cfg
    params = _real_params(probe, gen, device)
    if probe.name == "opt":
        grads = _fill(probe.args_sds[1], gen, device, cfg.vocab)
        grads = _zip_map(lambda t, _sh: t * 1e-3, grads, None)
        return (params, grads, init_opt_state(params))
    rest = tuple(_fill(a, gen, device, cfg.vocab)
                 for a in probe.args_sds[1:])
    return (params,) + rest


def _realize(probe: ProbeSpec, device, seed: int) -> dict:
    from ..kernels.ops import KERNELS
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    args = realize_args(probe, device, seed)
    with trace_audit() as tc, _grad_mode(probe.cell.kind):
        t0 = time.perf_counter()
        probe.step_fn(*args)
        sync()
        first = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = {k: fn.launches for k, fn in KERNELS.items()}
    with _grad_mode(probe.cell.kind):
        t0 = time.perf_counter()
        out = probe.step_fn(*args)
        sync()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches - before[k] for k, fn in KERNELS.items()
                if fn.launches != before[k]}
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    # the first run loads (or builds, counted in fresh_builds) the
    # kernels it launches, so its wall is the compile time
    return {"out": out, "compile_s": first,
            "fresh_builds": tc.fresh_compiles, "wall_s": wall,
            "peak_bytes": peak, "launches": launches}


# ----------------------------------------------------------------------
# Probes and cells
# ----------------------------------------------------------------------
def _combine_linear(m1: dict, m2: dict, g_full: float) -> dict:
    """Depth extrapolation: probe d1 = fixed + slope, d2 = fixed +
    2*slope; step(L) = fixed + slope*g_full (clamped at >= 0)."""
    out = {}
    for key in m1:
        slope = m2[key] - m1[key]
        fixed = m1[key] - slope
        out[key] = max(0.0, fixed + slope * g_full)
    return out


def _bound_s(flops: float, byts: float, coll: float, n_chips: int
             ) -> float:
    return max(flops / PEAK_FLOPS, byts / HBM_BW, coll / link_bw(n_chips))


def run_probes(arch, shape_name, mesh, serve_mult, serve_mode,
               overrides=None, serve_rank: int = 4, *,
               variant: str = "pallas", device_mesh=None,
               realize=None, seed: int = 0,
               probe_outputs: Optional[dict] = None) -> dict:
    """Run the shallow probes on the mesh (DTensors over
    ``device_mesh``, or plain ``meta`` tensors on a one-device mesh)
    under ``OpTrace``; extrapolate to full depth.  ``realize``: a device
    on which each probe also runs for real (``_realize``);
    ``probe_outputs`` then receives each probe's first output by name (a
    serve step's logits)."""
    from ..configs import get_config
    dp = axis_size(mesh, data_axes(mesh))
    n_chips = math.prod(mesh.sizes)
    # the analysis runs the plain datapath: on meta (or DTensor) shards a
    # kernel wrapper would raise, and its plain version is the same
    # computation; a realized probe runs ``variant``
    probes = build_probes(arch, shape_name, dp, serve_mult, serve_mode,
                          overrides, serve_rank, "ref")
    real = (build_probes(arch, shape_name, dp, serve_mult, serve_mode,
                         overrides, serve_rank, variant)
            if realize is not None else [None] * len(probes))
    # the overridden depth (the reference extrapolates to the arch's own)
    base_cfg = apply_overrides(get_config(arch), overrides)
    period = block_period(base_cfg)
    g_full = base_cfg.n_layers / period

    raw: dict[str, dict] = {}
    coll_raw: dict[str, dict] = {}
    details = []
    n_mb = 1
    for probe, real_probe in zip(probes, real):
        args = probe.args_sds
        if device_mesh is not None:
            args = _place(args, probe_shardings(probe, mesh), device_mesh)
        _out, secs, tr = _trace(probe.step_fn, args, probe.cell.kind,
                                device_mesh)
        del _out, args
        coll = op_analysis.collective_bytes(tr)
        f, b = tr.flops, tr.bytes_accessed
        raw[probe.name] = {"flops": f, "bytes": b,
                           "coll": float(coll["total_bytes"])}
        coll_raw[probe.name] = {k: v["bytes"] for k, v in coll.items()
                                if k != "total_bytes"}
        n_mb = max(n_mb, probe.cell.microbatches)
        row = {"probe": probe.name, "depth": probe.depth, "flops": f,
               "bytes": b, "collective_bytes": raw[probe.name]["coll"],
               "trace_s": round(secs, 2),
               "bound_s": _bound_s(f, b, raw[probe.name]["coll"],
                                   n_chips)}
        if real_probe is not None:
            rec = _realize(real_probe, realize, seed)
            if probe_outputs is not None:     # not the cache it wrote
                probe_outputs[probe.name] = rec["out"][0]
            del rec["out"]
            row.update(rec)
            if torch.device(realize).type == "cuda":
                torch.cuda.empty_cache()
        details.append(row)

    step = _combine_linear(raw["stack_d1"], raw["stack_d2"], g_full)
    kinds = set(coll_raw["stack_d1"]) | set(coll_raw["stack_d2"])
    coll_kinds = _combine_linear(
        {k: coll_raw["stack_d1"].get(k, 0.0) for k in kinds},
        {k: coll_raw["stack_d2"].get(k, 0.0) for k in kinds}, g_full)

    if "opt" in raw:  # train: n_mb * stack + optimizer
        flops = n_mb * step["flops"] + raw["opt"]["flops"]
        byts = n_mb * step["bytes"] + raw["opt"]["bytes"]
        coll_kinds = {k: n_mb * v for k, v in coll_kinds.items()}
        for k, v in coll_raw["opt"].items():
            coll_kinds[k] = coll_kinds.get(k, 0.0) + v
    else:
        flops, byts = step["flops"], step["bytes"]

    coll_by_kind = {k: {"bytes": v, "count": -1}
                    for k, v in coll_kinds.items()}
    coll_by_kind["total_bytes"] = sum(coll_kinds.values())
    return {"flops_per_device": flops, "bytes_per_device": byts,
            "collectives": coll_by_kind, "probes": details,
            "extrapolation": {"period": period, "groups": g_full,
                              "microbatches": n_mb}}


def _redistribute_to(out, out_sh, device_mesh):
    """Outputs onto their out-shardings (the reference's jit
    ``out_shardings``)."""
    def one(t, sh):
        if not hasattr(t, "placements"):
            return t
        return t.redistribute(device_mesh, sh.placements(device_mesh))
    return _zip_map(one, out, out_sh)


def _mesh_name(mesh) -> str:
    return "x".join(f"{k}={v}" for k, v in mesh.shape.items())


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             serve_mult: str = "auto", serve_mode: str = "lowrank",
             save_hlo: bool = False, out_dir: str = DEFAULT_OUT,
             probes: bool = True, overrides=None, tag_suffix: str = "",
             serve_rank: int = 4, *, mesh: Optional[Mesh] = None,
             variant: str = "pallas", lower: bool = True,
             seed: int = 0, probe_outputs: Optional[dict] = None
             ) -> dict:
    """Trace one cell on ``mesh`` (default: the production mesh) and
    return its record.  ``lower``: trace the full-depth step (on ``meta``
    tensors at global shapes; on the DTensors when there are no probes
    on a multi-device mesh, whose per-device counts then come from it).
    A mesh whose one device is real realizes each probe there."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = math.prod(mesh.sizes)
    devices = tuple(getattr(mesh, "devices", ()))
    if devices and n_chips != 1:
        raise ValueError("run_cell realizes probes on a one-device mesh "
                         "only; describe a larger mesh without devices")
    realize = devices[0] if devices else None
    distributed = n_chips > 1
    on_dtensors = distributed and not probes
    if on_dtensors:
        lower = True
    dp = axis_size(mesh, data_axes(mesh))
    cell = build_cell(arch, shape_name, dp, serve_mult, serve_mode,
                      overrides, serve_rank, "ref")    # traced on meta
    in_sh, out_sh = cell_shardings(cell, mesh)
    arg_bytes = per_device_bytes(cell.args_sds, in_sh)

    group = fake_mesh(mesh) if distributed else contextlib.nullcontext()
    with group as device_mesh:
        t_lower = out_bytes = alias = None
        full_trace = None
        if lower:
            args, dmesh = cell.args_sds, None
            if on_dtensors:
                args, dmesh = _place(args, in_sh, device_mesh), device_mesh
            out, t_lower, full_trace = _trace(
                cell.step_fn, args, cell.kind, dmesh, keep_ops=save_hlo)
            if dmesh is not None:
                out = _redistribute_to(out, out_sh, dmesh)
            out_bytes = per_device_bytes(out, out_sh)
            alias = alias_bytes(out, out_sh, [
                (cell.args_sds[i], in_sh[i]) for i in cell.donate])
            del out, args
        probe_info = None
        if probes:
            probe_info = run_probes(
                arch, shape_name, mesh, serve_mult, serve_mode, overrides,
                serve_rank, variant=variant,
                device_mesh=device_mesh if distributed else None,
                realize=realize, seed=seed, probe_outputs=probe_outputs)

    if probe_info is not None:
        flops_dev = probe_info["flops_per_device"]
        bytes_dev = probe_info["bytes_per_device"]
        coll = probe_info["collectives"]
    else:
        flops_dev = full_trace.flops
        bytes_dev = full_trace.bytes_accessed
        coll = op_analysis.collective_bytes(full_trace)
    coll_dev = float(coll.get("total_bytes", 0))

    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_dev / link_bw(n_chips)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cell, cell.args_sds[0])
    flops_global = flops_dev * n_chips
    lb = max(terms.values())
    compile_s = None
    if realize is not None and probe_info is not None:
        compile_s = sum(p["compile_s"] for p in probe_info["probes"])
    result = {
        "arch": arch,
        "shape": shape_name,
        "overrides": dict(overrides) if overrides else None,
        "tag_suffix": tag_suffix,
        "kind": cell.kind,
        "mesh": _mesh_name(mesh),
        "n_chips": n_chips,
        "multi_pod": multi_pod,
        "microbatches": cell.microbatches,
        "ok": True,
        "lower": (None if not lower
                  else "dtensor" if on_dtensors else "meta"),
        "lower_s": None if t_lower is None else round(t_lower, 2),
        "compile_s": compile_s,
        "device": str(realize) if realize is not None else None,
        "card": CARD,
        "memory": {
            "bytes_per_device": None,
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "alias_bytes": alias,
            "peak_gb": None,
        },
        "flops_per_device": flops_dev,
        "flops_global": flops_global,
        "bytes_per_device": bytes_dev,
        "collectives": coll,
        "probe_details": (probe_info or {}).get("probes"),
        "extrapolation": (probe_info or {}).get("extrapolation"),
        "roofline": {
            **terms,
            "bottleneck": bottleneck.replace("_s", ""),
            "step_time_lower_bound_s": lb,
            "model_flops_global": mf,
            "useful_flops_ratio": (mf / flops_global
                                   if flops_global else None),
            "roofline_fraction": ((mf / n_chips / PEAK_FLOPS) / lb
                                  if lb > 0 else None),
            "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
            "link_bw": link_bw(n_chips),
        },
    }
    if save_hlo and full_trace is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, _tag(result) + ".ops.txt"),
                  "w") as f:
            f.write(op_analysis.dump(full_trace))
    return result


def _tag(result: dict) -> str:
    return (f"{result['arch']}_{result['shape']}_"
            f"{'mp' if result['multi_pod'] else 'sp'}"
            + (result.get("tag_suffix") or ""))


def save_result(result: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _tag(result) + ".json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return path


def table(out_dir: str) -> str:
    """The records in ``out_dir`` as a markdown table, one row a cell:
    per-device argument GB, flops and collective GB, the roofline terms
    in seconds, the bottleneck, the useful-flops ratio and the roofline
    fraction; a failed cell with its error."""
    rows = ["| Cell | ok | Arg GB | Flops | Coll GB | Compute s | "
            "Memory s | Coll s | Bottleneck | Useful | Roofline |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            r = json.load(f)
        cell = f"{r['arch']} {r['shape']}"
        if not r.get("ok"):
            rows.append(f"| {cell} | no: {r['error'][:60]} |" + " |" * 9)
            continue
        rf = r["roofline"]
        rows.append(
            f"| {cell} | yes | {r['memory']['argument_bytes'] / 1e9:.4g} "
            f"| {r['flops_per_device']:.3g} "
            f"| {r['collectives']['total_bytes'] / 1e9:.4g} "
            f"| {rf['compute_s']:.3g} | {rf['memory_s']:.3g} "
            f"| {rf['collective_s']:.3g} | {rf['bottleneck']} "
            f"| {rf['useful_flops_ratio']:.3g} "
            f"| {rf['roofline_fraction']:.2g} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS) + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable cell (sequentially)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--serve-mult", default="auto")
    ap.add_argument("--serve-mode", default="lowrank",
                    choices=("lowrank", "lowrank_prepared", "int8",
                             "lut", "bf16"))
    ap.add_argument("--serve-rank", type=int, default=4)
    ap.add_argument("--save-hlo", action="store_true",
                    help="dump the full-depth step's op trace "
                         "(<tag>.ops.txt)")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the analysis probes")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--tag", default="",
                    help="suffix for the result file name")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out as a markdown table")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return

    if args.all:
        cells, _skips = all_cells()
        todo = list(cells)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]

    for arch, shape in todo:
        tag = (f"{arch}_{shape}_{'mp' if args.multi_pod else 'sp'}"
               + args.tag)
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[dryrun] skip {tag} (exists)", flush=True)
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            overrides = dict(kv.split("=", 1) for kv in args.override)
            res = run_cell(arch, shape, args.multi_pod, args.serve_mult,
                           args.serve_mode, args.save_hlo, args.out,
                           probes=not args.no_probes, overrides=overrides,
                           tag_suffix=args.tag,
                           serve_rank=args.serve_rank)
        except Exception as e:  # record failures — they are bugs to fix
            res = {"arch": arch, "shape": shape,
                   "multi_pod": args.multi_pod, "tag_suffix": args.tag,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        save_result(res, args.out)
        if res.get("ok"):
            r = res["roofline"]
            print(f"[dryrun] {tag}: OK lower={res['lower_s']}s "
                  f"bottleneck={r['bottleneck']} "
                  f"lb={r['step_time_lower_bound_s']:.4f}s "
                  f"roofline_frac={r['roofline_fraction']:.3f}",
                  flush=True)
        else:
            print(f"[dryrun] {tag}: FAIL {res['error']}", flush=True)


if __name__ == "__main__":
    main()
