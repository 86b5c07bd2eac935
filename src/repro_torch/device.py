"""Device selection for the port's entry points.

The port's entry points run on the GPU.  A caller that wants the CPU
(the tests, which compare the port with the JAX reference at small
sizes) says so with ``device="cpu"``; nothing ever moves to the CPU on
its own.
"""
from __future__ import annotations

from typing import Union

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
