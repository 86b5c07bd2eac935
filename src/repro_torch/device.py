"""Device selection for the port's entry points.

The port's entry points run on the GPU.  A caller that wants the CPU
(the tests, which compare the port with the JAX reference at small
sizes) says so with ``device="cpu"``; nothing ever moves to the CPU on
its own.
"""
from __future__ import annotations

import copy
from typing import Any, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the first CUDA
    device and raises when there is none.

    Resolving a CUDA device also turns TF32 off for float32 matmuls and
    cuDNN, so the ``f32`` datapath computes in IEEE float32 as the
    reference does."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's entry points run on the GPU; "
                "pass device='cpu' to run on the CPU explicitly")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def device_key(device: DeviceLike) -> torch.device:
    """``device`` with its index: ``"cuda"`` names the current CUDA
    device, so two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def replicate(tree: Any, device: DeviceLike) -> Any:
    """A copy of ``tree`` on ``device``: tensors and ``nn.Module``s,
    also inside dicts, lists and tuples; anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, dict):
        return {k: replicate(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, device) for v in tree)
    return tree
