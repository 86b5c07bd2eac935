"""Production mesh, sharding rules and the sweep mesh (port of
``repro.launch.mesh``, DESIGN.md §6).

Mesh: single-pod (data=16, model=16) = 256 chips; multi-pod adds an
outer ``pod`` axis (2, 16, 16) = 512 chips.  ``pod`` behaves as an outer
data-parallel axis whose gradient reduction crosses the slow link.

Parameter sharding is FSDP-style: every weight matrix puts one dim on
``model`` (tensor parallelism / expert parallelism) and one on the
data(-and-pod) axes (ZeRO-3 parameter sharding).  Axes are applied only
when the dim is divisible; GQA head counts that don't divide 16
(yi/llava 56H, qwen3-14b 40H, whisper 20H) simply drop to replicated on
that dim.

The rules are pure functions over a mesh *description*: anything with
``axis_names`` and a ``shape`` map from axis name to size (``Mesh``
here, a ``jax.sharding.Mesh`` or a duck-typed stand-in).  A spec is a
tuple whose entries are the reference's ``PartitionSpec`` entries (None,
an axis name, or a tuple of two or more axis names, major to minor;
``pspec``); ``NamedSharding`` pairs one with its mesh, and
``NamedSharding.placements`` turns it into DTensor placements over a
``torch.distributed`` ``DeviceMesh``.

The sweep mesh (``sweep_mesh``) is the one this port runs work on: a
1-D ``("sweep",)`` mesh over devices, which one process drives (as
JAX's single controller does).  ``bank_sharding`` and the other
leading-axis helpers decide, for a count n, whether the leading axis of
a sweep's lanes, a population, a policy bank's rows or an engine's
slots splits across it — when n divides by the mesh size — or runs
whole on the first device; ``NamedSharding.shards(n)`` says which
device takes which slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

Spec = tuple


def pspec(*entries) -> Spec:
    """A spec with the entries the reference's ``PartitionSpec`` keeps:
    a tuple of one axis is that axis's name, an empty tuple None."""
    def canon(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(canon(e) for e in entries)


@dataclass(frozen=True)
class Mesh:
    """A named device mesh: ``sizes`` along ``axis_names`` and, for a
    mesh that places work, its ``devices`` in row-major order (empty for
    a description, as ``make_production_mesh`` gives).  A device may be
    listed more than once: a two-entry mesh of one card splits work on
    that card."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError("one size an axis name")
        n = 1
        for s in self.sizes:
            n *= s
        if self.devices and len(self.devices) != n:
            raise ValueError(f"a {self.sizes} mesh needs {n} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def device_at(self, coords: dict[str, int]) -> torch.device:
        """The device at mesh coordinates ``coords`` (axes left out at
        0)."""
        if not self.devices:
            raise ValueError("a mesh description has no devices")
        flat = 0
        for name, size in zip(self.axis_names, self.sizes):
            flat = flat * size + coords.get(name, 0)
        return self.devices[flat]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with an
    outer ``pod`` axis: a description, with no devices."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes ('pod','data') or ('data',)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fits(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


@dataclass(frozen=True)
class NamedSharding:
    """A spec on its mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    def shards(self, n: int) -> list[tuple[torch.device, int, int]]:
        """Which device takes which slice of a leading axis of ``n``:
        ``[(device, start, stop), ...]`` in order.  The axis splits into
        equal slices along the spec's leading mesh axes when ``n``
        divides by their size (slice i on the device at index i along
        them, 0 along the rest); otherwise the whole runs on the mesh's
        first device."""
        devices = getattr(self.mesh, "devices", ())
        if not len(devices):
            raise ValueError("a mesh description places nothing: build the "
                             "mesh with sweep_mesh()")
        lead = self.spec[0] if len(self.spec) else None
        if lead is None:
            return [(devices[0], 0, n)]
        axes = (lead,) if isinstance(lead, str) else tuple(lead)
        size = axis_size(self.mesh, axes)
        if not _fits(n, size):
            return [(devices[0], 0, n)]
        per = n // size
        out = []
        for i in range(size):
            coords, rest = {}, i
            for a in reversed(axes):
                coords[a] = rest % self.mesh.shape[a]
                rest //= self.mesh.shape[a]
            out.append((self.mesh.device_at(coords), i * per,
                        (i + 1) * per))
        return out

    def placements(self, device_mesh) -> tuple:
        """DTensor placements of this spec over ``device_mesh`` (a
        ``torch.distributed`` ``DeviceMesh`` whose ``mesh_dim_names`` are
        this mesh's axis names): ``Shard(d)`` on each mesh dimension that
        tensor dim d names, ``Replicate()`` on the others.  A tuple of
        axes on one dim shards it major to minor in the tuple's order,
        which DTensor applies in mesh-dimension order, so the tuple must
        list its axes in that order."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(device_mesh.mesh_dim_names or ())
        if len(names) != device_mesh.ndim:
            raise ValueError("the DeviceMesh needs mesh_dim_names")
        on: dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            unknown = [a for a in axes if a not in names]
            if unknown:
                raise ValueError(f"spec {self.spec} names axes {unknown} "
                                 f"the DeviceMesh {names} lacks")
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"spec entry {entry} lists its axes out "
                                 f"of the mesh's order {names}")
            for a in axes:
                on[a] = d
        return tuple(Shard(on[a]) if a in on else Replicate()
                     for a in names)


# ----------------------------------------------------------------------
# Parameter sharding rules
# ----------------------------------------------------------------------
# matched against the LAST path component; (model_dim, fsdp_dim) are
# indices into the *trailing* (non-stacked) dims of the leaf.
#   in-proj style (d_in, d_out): model on the output dim, fsdp on input
#   out-proj style (d_in, d_out): model on the input dim, fsdp on output
_OUT_PROJ_NAMES = ("wo", "out_proj", "w_down", "wdown")


def param_pspec(path: str, shape: tuple, mesh) -> Spec:
    fsdp = data_axes(mesh)
    parts = path.split("/")
    last = parts[-1]
    stacked = 1 if parts and parts[0].endswith("blocks") else 0
    tshape = tuple(shape)[stacked:]
    tnd = len(tshape)

    def assemble(tspec: list) -> Spec:
        return pspec(*([None] * stacked + tspec))

    # prepared-weight leaves (lowrank serving): tabs are (..., R, K, N)
    # and shard like the original weight; aux scalars replicate.
    if last == "tabs":
        parent = parts[-2] if len(parts) >= 2 else ""
        model_dim, fsdp_dim = ((-2, -1) if parent in _OUT_PROJ_NAMES
                               else (-1, -2))
        spec = [None] * tnd
        if _fits(tshape[model_dim], axis_size(mesh, "model")):
            spec[model_dim] = "model"
        elif tnd >= 4 and _fits(tshape[0], axis_size(mesh, "model")):
            spec[0] = "model"          # experts: EP on E
        if spec[fsdp_dim] is None and _fits(tshape[fsdp_dim],
                                            axis_size(mesh, fsdp)):
            spec[fsdp_dim] = fsdp
        return assemble(spec)
    if last in ("colsum", "w_scale", "w_zp"):
        spec = [None] * tnd
        if tnd >= 1 and last == "colsum":
            parent = parts[-2] if len(parts) >= 2 else ""
            if parent not in _OUT_PROJ_NAMES and \
                    _fits(tshape[-1], axis_size(mesh, "model")):
                spec[-1] = "model"
        return assemble(spec)

    if tnd <= 1:
        return assemble([None] * tnd)

    if ("moe" in path or "ffn_" in path) and tnd == 3:
        # experts (E, d, f): EP on E, fsdp on the widest remaining dim
        spec = [None, None, None]
        if _fits(tshape[0], axis_size(mesh, "model")):
            spec[0] = "model"
        wide = 1 + int(tshape[2] >= tshape[1])
        if _fits(tshape[wide], axis_size(mesh, fsdp)):
            spec[wide] = fsdp
        return assemble(spec)

    if last in ("embed", "unembed"):
        v, d = tshape
        spec = [None, None]
        if _fits(v, axis_size(mesh, "model")):
            spec[0] = "model"
            if _fits(d, axis_size(mesh, fsdp)):
                spec[1] = fsdp
        elif _fits(d, axis_size(mesh, "model")):
            spec[1] = "model"
        return assemble(spec)

    if last == "w" and tnd == 4:  # conv kernels (kh,kw,cin,cout): replicate
        return assemble([None] * 4)

    if tnd == 2:
        model_dim = 0 if last in _OUT_PROJ_NAMES else 1
        fsdp_dim = 1 - model_dim
        spec = [None, None]
        if _fits(tshape[model_dim], axis_size(mesh, "model")):
            spec[model_dim] = "model"
        if _fits(tshape[fsdp_dim], axis_size(mesh, fsdp)):
            spec[fsdp_dim] = fsdp
        return assemble(spec)

    return assemble([None] * tnd)


def tree_with_paths(tree) -> tuple[list[str], list]:
    """(paths, leaves) of a nested dict/list tree, paths joined with "/"
    and dict keys in sorted order, as the reference's
    ``_tree_with_paths`` flattens a pytree."""
    paths, leaves = [], []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
        else:
            paths.append("/".join(prefix))
            leaves.append(node)

    walk(tree, ())
    return paths, leaves


def _map_tree(tree, fn, prefix=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _shape(leaf) -> tuple:
    """A leaf's shape; a host scalar (a cache's ``pos``) has none."""
    return tuple(getattr(leaf, "shape", ()))


def params_shardings(params_shapes, mesh):
    """Tree of tensors (e.g. ``models.registry.abstract_params``) -> the
    same tree of ``NamedSharding``."""
    return _map_tree(params_shapes, lambda p, l: NamedSharding(
        mesh, param_pspec(p, _shape(l), mesh)))


# ----------------------------------------------------------------------
# Activation / batch / cache sharding rules
# ----------------------------------------------------------------------
def batch_pspec(name: str, shape: tuple, mesh,
                microbatched: bool = False) -> Spec:
    dp = data_axes(mesh)
    lead = [None] if microbatched else []
    body = list(shape[1:] if microbatched else shape)
    spec: list = [None] * len(body)
    if body and _fits(body[0], axis_size(mesh, dp)):
        spec[0] = dp
    return pspec(*(lead + spec))


def cache_pspec(path: str, shape: tuple, mesh, long_context: bool) -> Spec:
    """KV/state cache sharding.  Dense KV (G,B,T,H,D): batch on data,
    sequence on model (long_500k: sequence on (data,model) since B=1).
    MLA ckv (G,B,T,C): batch on data.  Mamba state (G,B,H,P,N): batch on
    data, heads on model.  Conv state (G,B,W,C): batch data, C model."""
    dp = data_axes(mesh)
    last = path.split("/")[-1]
    nd = len(shape)
    spec: list = [None] * nd
    if last == "pos" or nd <= 1:
        return pspec(*spec)
    # the batch dim: stacked caches are (G, B, ...); whisper's cross kv
    # is (L, B, F, H, D) — batch is dim 1 in both.
    bdim = 1
    if long_context:
        seq_axes = tuple(dp) + ("model",)
        if last in ("k", "v", "ckv", "kr") and nd >= 3:
            if _fits(shape[2], axis_size(mesh, seq_axes)):
                spec[2] = seq_axes
                return pspec(*spec)
    if _fits(shape[bdim], axis_size(mesh, dp)):
        spec[bdim] = dp
    if last in ("k", "v") and nd == 5:
        if _fits(shape[3], axis_size(mesh, "model")):
            spec[3] = "model"          # kv heads (whisper MHA: 20 -> no)
        elif _fits(shape[2], axis_size(mesh, "model")):
            spec[2] = "model"          # sequence on model
    elif last == "state" and nd == 5:
        if _fits(shape[2], axis_size(mesh, "model")):
            spec[2] = "model"          # ssm heads
    elif last == "conv" and nd == 4:
        if _fits(shape[3], axis_size(mesh, "model")):
            spec[3] = "model"          # conv channels
    return pspec(*spec)


def cache_shardings(cache_shapes, mesh, long_context: bool = False):
    return _map_tree(cache_shapes, lambda p, l: NamedSharding(
        mesh, cache_pspec(p, _shape(l), mesh, long_context)))


def batch_shardings(batch_shapes, mesh, microbatched: bool = False):
    """A batch of tensors or of ``(shape, dtype)`` pairs
    (``configs.shapes.batch_specs``) -> ``NamedSharding`` a leaf."""
    return {k: NamedSharding(mesh, batch_pspec(
        k, v[0] if isinstance(v, tuple) else _shape(v), mesh,
        microbatched)) for k, v in batch_shapes.items()}


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ----------------------------------------------------------------------
# Batched-sweep (leading-axis) sharding — DESIGN.md §2.4
# ----------------------------------------------------------------------
def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def sweep_mesh(max_devices: Optional[int] = None, *,
               devices: Optional[Sequence] = None) -> Mesh:
    """1-D ``("sweep",)`` mesh for splitting a sweep's lanes, a
    population, a policy bank's rows or an engine's slots.  By default
    every visible CUDA device, and it raises without one; ``devices``
    lists them instead, e.g. ``["cpu", "cpu"]`` (the CPU only when asked)
    or one card twice, which exercises the split on that card.
    ``max_devices`` keeps the first ones."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: sweep_mesh() spans the GPUs; pass "
                "devices=['cpu', ...] to build a mesh on the CPU explicitly")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [_device(d) for d in devices]
    if max_devices is not None:
        devs = devs[:max_devices]
    if not devs:
        raise ValueError("a sweep mesh needs at least one device")
    return Mesh(("sweep",), (len(devs),), tuple(devs))


def bank_pspec(n_banks: int, mesh, axis: str = "sweep") -> Spec:
    """Spec for a ``(n_banks, 256, 256)`` LutBank (or any lane-leading
    array): split the leading axis across ``axis`` when divisible, else
    replicate — the parameter rules' divisibility policy."""
    if axis in mesh.axis_names and _fits(n_banks, axis_size(mesh, axis)):
        return (axis,)
    return ()


def bank_sharding(n_banks: int, mesh=None,
                  axis: str = "sweep") -> NamedSharding:
    """Sharding for the batched resilience engine's bank axis; pass it as
    ``bank_eval(..., sharding=...)`` / ``explore(..., sharding=...)``.
    With a 1-D ``sweep_mesh`` each device evaluates ``n_banks /
    n_devices`` multipliers of the sweep, and the lanes' outputs gather
    on the first device."""
    mesh = mesh if mesh is not None else sweep_mesh()
    return NamedSharding(mesh, bank_pspec(n_banks, mesh, axis))


def lane_sharding(bank_sh: NamedSharding) -> NamedSharding:
    """Sharding for a wide bank's per-lane aux arrays (operand widths,
    product masks, reduce codes): same mesh, leading (lane) axis only.
    ``bank_eval`` slices them with the lanes itself."""
    lead = bank_sh.spec[0] if len(bank_sh.spec) else None
    return NamedSharding(bank_sh.mesh, (lead,))


def slot_sharding(n_slots: int, mesh=None,
                  axis: str = "sweep") -> NamedSharding:
    """Sharding for the continuous-batching engine's slot axis; pass it
    as ``ContinuousEngine(..., sharding=...)``: each device keeps a
    replica of the parameters and the LUT bank and decodes ``n_slots /
    n_devices`` in-flight requests.  Non-divisible counts replicate."""
    mesh = mesh if mesh is not None else sweep_mesh()
    return NamedSharding(mesh, bank_pspec(n_slots, mesh, axis))


def leading_axis_sharding(sharding: NamedSharding,
                          rank: int) -> NamedSharding:
    """Extend a 1-D (leading-axis) sharding to a rank-``rank`` leaf:
    same mesh and leading spec, trailing dims replicated."""
    lead = sharding.spec[0] if len(sharding.spec) else None
    return NamedSharding(sharding.mesh, tuple([lead] + [None] * (rank - 1)))


def pop_sharding(n_pop: int, mesh=None,
                 axis: str = "sweep") -> NamedSharding:
    """Sharding for the population-evolution engine's candidate axis;
    pass it as ``PopEvaluator(..., sharding=...)`` /
    ``evolve_ladder(..., sharding=...)``: the input planes and exact
    values are copied to every device, and each scores ``n_pop /
    n_devices`` offspring in one K11 launch.  Non-divisible counts
    replicate (the evaluator pads populations to a divisible multiple
    before splitting)."""
    mesh = mesh if mesh is not None else sweep_mesh()
    return NamedSharding(mesh, bank_pspec(n_pop, mesh, axis))


def policy_sharding(n_policies: int, mesh=None,
                    axis: str = "sweep") -> NamedSharding:
    """Sharding for the heterogeneous engine's policy axis — the rows of
    a ``PolicyBank`` assignment matrix ``(n_policies, n_layers)``; pass
    it as ``policy_bank_eval(..., assign_sharding=...)`` /
    ``explore_heterogeneous(..., assign_sharding=...)``: every device
    holds the whole LUT bank and verifies ``n_policies / n_devices``
    candidate compositions.  Non-divisible counts replicate."""
    mesh = mesh if mesh is not None else sweep_mesh()
    return NamedSharding(mesh, bank_pspec(n_policies, mesh, axis))


def module_sharding(n_assignments: int, mesh=None,
                    axis: str = "sweep") -> NamedSharding:
    """Sharding for the module-axis profiler's assignment axis (DESIGN.md
    §2.12): a module sweep lowers onto a ``PolicyBank``, so the axis to
    split is the policy axis.  Pass it as ``policy_bank_eval(...,
    assign_sharding=...)`` / ``profile_architecture(...,
    assign_sharding=...)``.  Non-divisible counts replicate."""
    mesh = mesh if mesh is not None else sweep_mesh()
    return NamedSharding(mesh, bank_pspec(n_assignments, mesh, axis))
