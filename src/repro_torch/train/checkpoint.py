"""Fault-tolerant checkpoint manager (port of ``repro.train.checkpoint``,
DESIGN.md §6).

The on-disk layout is the reference's, so each package restores what
the other wrote: ``<dir>/step-%09d/shard-00000.npz`` holding every leaf
under its reference path (``optimizer.tree_leaves``: a ``(params,
opt_state)`` state gives ``0/<param path>``, ``1/.step``, ``1/.m/...``,
``1/.v/...``), plus ``manifest.json`` with the step, the leaves' shapes
and dtypes and the metadata.

  * writes go to ``<dir>/tmp-<step>-<pid>`` and are published with one
    atomic ``os.replace`` to ``step-<step>`` (a crashed writer never
    corrupts the latest checkpoint);
  * the ``keep`` latest checkpoints are retained, older ones removed;
  * an async save (``block=False`` on a manager made with
    ``async_save=True``) copies every tensor to host numpy before its
    thread starts — required here, not only faster: the next training
    step updates the same tensors in place;
  * ``restore`` copies the checkpoint into a template's tensors in place
    (on their device, in their dtype), so an ``nn.Module`` and the
    optimizer state stay linked to the tensors they hold.

Per-host shards: with a ``torch.distributed`` group up, rank r writes
``shard-{r:05d}.npz`` (every process without one writes
``shard-00000``), and ``manifest.json`` records ``n_hosts`` = the world
size.  The leaves are dealt out in turn, leaf i to rank i mod the world
size, so no process writes the whole state; a DTensor leaf is gathered
(``full_tensor``, a collective every rank joins) and written by its
rank.  Every rank writes into one staging directory, and rank 0
publishes it after a barrier.  ``restore`` merges every ``shard-*.npz``,
as the reference's does; with ``shardings`` (a tree of
``launch.mesh.NamedSharding`` over a ``torch.distributed`` ``DeviceMesh``)
it returns DTensors placed by ``NamedSharding.placements`` on the
current mesh, whatever mesh wrote the checkpoint — the elastic path.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from .optimizer import tree_leaves


def _world() -> tuple[int, int]:
    """(rank, world size) of the ``torch.distributed`` group, or (0, 1)
    without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    import torch.distributed as dist
    if _world()[1] > 1:
        dist.barrier()


def _host(state: Any) -> dict[str, np.ndarray]:
    """This rank's leaves of ``state`` (leaf i when i mod the world size
    is the rank) as host numpy arrays (copies), by path."""
    rank, world = _world()
    out = {}
    for i, (key, leaf) in enumerate(tree_leaves(state)):
        full = getattr(leaf, "full_tensor", None)
        if full is not None:
            leaf = full()            # a collective: every rank joins
        if i % world == rank:
            out[key] = leaf.detach().to("cpu", copy=True).numpy()
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- paths ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step:09d}")

    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step-"):
                try:
                    steps.append(int(d.split("-")[1]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    # -- save -------------------------------------------------------------
    def save(self, step: int, state: Any, metadata: Optional[dict] = None,
             block: bool = True, policy: Optional[Any] = None) -> None:
        """``policy`` (an ``approx.layers.ApproxPolicy``) is serialized
        spec-first into the manifest metadata, so the chosen accelerator
        configuration ships with the weights; recover it with
        ``policy_from_metadata(restore(...)[1])``."""
        if policy is not None:
            metadata = dict(metadata or {})
            metadata["approx_policy"] = policy.to_json_dict()
        self.wait()  # one outstanding async save at a time
        arrays = _host(state)   # device -> host now, before any update
        if self.async_save and not block and _world()[1] == 1:
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, metadata))
            self._thread.start()
        else:
            self._write(step, arrays, metadata)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrays: dict[str, np.ndarray],
               metadata: Optional[dict]) -> None:
        rank, world = _world()
        final = self._step_dir(step)
        # one staging directory for every rank of a group
        tmp = os.path.join(self.directory, f"tmp-{step:09d}-" + (
            f"{os.getpid()}" if world == 1 else f"w{world}"))
        if rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        _barrier()
        np.savez(os.path.join(tmp, f"shard-{rank:05d}.npz"), **arrays)
        leaves = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                  for k, v in arrays.items()}
        if world > 1:
            import torch.distributed as dist
            every: list = [None] * world
            dist.all_gather_object(every, leaves)
            leaves = {k: v for part in every for k, v in part.items()}
        if rank == 0:
            manifest = {
                "step": step,
                "time": time.time(),
                "n_hosts": world,
                "leaves": leaves,
                "metadata": metadata or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)   # atomic publish
            self._gc()
        _barrier()

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("-")[1]) for d in os.listdir(self.directory)
            if d.startswith("step-"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> tuple[Any, dict]:
        """Copy checkpoint ``step`` (default: the latest) into
        ``template``'s tensors in place; returns (template, metadata).
        With ``shardings`` (a tree of ``NamedSharding`` like
        ``template``'s, over a ``DeviceMesh``) it returns a new tree of
        DTensors instead, each leaf in the template's dtype placed on
        that mesh.  Raises on a missing leaf or a shape mismatch before
        it copies anything."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arrays: dict[str, np.ndarray] = {}
        for fn in sorted(os.listdir(d)):
            if fn.startswith("shard-") and fn.endswith(".npz"):
                with np.load(os.path.join(d, fn)) as z:
                    for k in z.files:
                        arrays[k] = z[k]
        leaves = tree_leaves(template)
        for key, leaf in leaves:
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            if tuple(arrays[key].shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arrays[key].shape} "
                    f"vs model {tuple(leaf.shape)}")
        if shardings is not None:
            return (_placed(template, shardings, arrays),
                    manifest.get("metadata", {}))
        with torch.no_grad():
            for key, leaf in leaves:
                leaf.copy_(torch.from_numpy(np.asarray(arrays[key])))
        return template, manifest.get("metadata", {})


def _placed(template: Any, shardings: Any, arrays: dict) -> Any:
    """``template``'s tree with each leaf ``arrays[path]`` as a DTensor
    on its sharding's ``DeviceMesh``: every rank holds the whole array
    from disk and keeps its own shard (no collective)."""
    from torch.distributed.tensor import distribute_tensor

    sh_of = dict(_sharding_leaves(shardings))
    out = {}
    for key, leaf in tree_leaves(template):
        sh = sh_of[key]
        device_mesh = sh.mesh
        full = torch.from_numpy(np.asarray(arrays[key])).to(
            device=device_mesh.device_type, dtype=leaf.dtype)
        out[key] = distribute_tensor(full, device_mesh,
                                     sh.placements(device_mesh),
                                     src_data_rank=None)
    return _renest(template, out)


def _sharding_leaves(shardings: Any, prefix: str = "") -> list:
    """``(path, NamedSharding)`` of a sharding tree, with the paths
    ``optimizer.tree_leaves`` gives the matching state."""
    sep = "/" if prefix else ""
    if isinstance(shardings, dict):
        return [kv for k in sorted(shardings)
                for kv in _sharding_leaves(shardings[k],
                                           f"{prefix}{sep}{k}")]
    if isinstance(shardings, tuple) and hasattr(shardings, "_fields"):
        return [kv for f in shardings._fields
                for kv in _sharding_leaves(getattr(shardings, f),
                                         f"{prefix}{sep}.{f}")]
    if isinstance(shardings, (tuple, list)):
        return [kv for i, v in enumerate(shardings)
                for kv in _sharding_leaves(v, f"{prefix}{sep}{i}")]
    return [(prefix, shardings)]


def _renest(template: Any, flat: dict, prefix: str = "") -> Any:
    """A tree shaped like ``template`` holding ``flat[path]``."""
    sep = "/" if prefix else ""
    if isinstance(template, dict):
        return {k: _renest(v, flat, f"{prefix}{sep}{k}")
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _renest(getattr(template, f), flat, f"{prefix}{sep}.{f}")
            for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_renest(v, flat, f"{prefix}{sep}{i}")
                              for i, v in enumerate(template))
    return flat[prefix]


def policy_from_metadata(metadata: dict):
    """Recover the ApproxPolicy stored by ``save(..., policy=...)``,
    or None when the checkpoint predates policy shipping."""
    d = (metadata or {}).get("approx_policy")
    if d is None:
        return None
    from ..approx.layers import ApproxPolicy
    return ApproxPolicy.from_json_dict(d)
