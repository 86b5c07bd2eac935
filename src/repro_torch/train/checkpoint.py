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

One process writes one shard (``shard-00000``); the reference's
per-host shards and resharding onto a mesh need a mesh (ROADMAP.md
Queue 1, "Launch tooling and multi-device").
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


def _host(state: Any) -> dict[str, np.ndarray]:
    """Every leaf of ``state`` as a host numpy array (a copy), by path."""
    out = {}
    for key, leaf in tree_leaves(state):
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
        if self.async_save and not block:
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
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f"tmp-{step:09d}-{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard-00000.npz"), **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "n_hosts": 1,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in arrays.items()},
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)   # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("-")[1]) for d in os.listdir(self.directory)
            if d.startswith("step-"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None
                ) -> tuple[Any, dict]:
        """Copy checkpoint ``step`` (default: the latest) into
        ``template``'s tensors in place; returns (template, metadata).
        Raises on a missing leaf or a shape mismatch before it copies
        anything."""
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
        with torch.no_grad():
            for key, leaf in leaves:
                leaf.copy_(torch.from_numpy(np.asarray(arrays[key])))
        return template, manifest.get("metadata", {})


def policy_from_metadata(metadata: dict):
    """Recover the ApproxPolicy stored by ``save(..., policy=...)``,
    or None when the checkpoint predates policy shipping."""
    d = (metadata or {}).get("approx_policy")
    if d is None:
        return None
    from ..approx.layers import ApproxPolicy
    return ApproxPolicy.from_json_dict(d)
