"""DPBalance on PyTorch and CUDA (NVIDIA Hopper, sm_90a).

The port of the JAX package ``repro``: the same module layout and names
(``core/demand.py``, ``core/waterfill.py``, ...), written as plain
functions on tensors.  Every value is float32, as in ``repro``; integer
selections handed to the CUDA kernels are int32.

Device rule: nothing here picks a device behind the caller's back.
Input constructors take ``device="cuda"`` by default and raise when CUDA is
unavailable; callers that want the CPU pass ``device="cpu"`` explicitly.
Every later function runs on the device of the tensors it is given, and
:mod:`repro_torch.core.hotpath` dispatches by that device alone: a CUDA
tensor goes to the hand-written Hopper kernel (or raises), a CPU tensor
to the kernel's plain twin in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` when a CUDA
    device is asked for and CUDA is unavailable (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain twins on the CPU")
    return dev
