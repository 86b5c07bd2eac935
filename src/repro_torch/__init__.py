"""PyTorch/CUDA port of ``repro`` (approximate-multiplier emulation for
DNN accelerators), one subpackage per reference subpackage.

The package imports ``torch`` and numpy only.  Its entry points run on
the first CUDA device unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve_device``); without a GPU and without an
explicit CPU request they raise.
"""
