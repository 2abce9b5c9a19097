"""Launchers of the Hopper DP clip-and-accumulate kernels
(``csrc/dp_clip_noise.cu``), and their composition.

:func:`rownorms` and :func:`clip_accumulate` take CUDA tensors only
(float32, contiguous) and raise on anything else; each adds one to its
entry of :data:`LAUNCHES` per launch.  The training code calls
:func:`dp_clip_accumulate`, or its two halves :func:`dp_row_scales` and
:func:`dp_accumulate` where it works on the clipped rows in between;
each picks by the device of ``g`` alone -- a CPU tensor runs the twins
of :mod:`repro_torch.kernels.ref`, a CUDA tensor the kernels -- with no
flag and no fallback.

Bounds quoted below use the H100 SXM's published 3.35 TB/s of HBM.
"""
from __future__ import annotations

import torch

from .budget_alloc import _check, _on_cuda, _raise_on, _stream
from .build import library
from . import ref

# Kernel launches per launcher since the last reset_launches().
LAUNCHES = {"rownorms": 0, "clip_accumulate": 0}
NORM_EPS = 1e-12
_F32 = torch.float32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    return library("dp_clip_noise")


def rownorms(g: torch.Tensor) -> torch.Tensor:
    """Squared L2 norm per row: g [B, P] -> [B].

    Replaces ``repro/kernels/dp_clip_noise.py:rownorms``, whose TPU grid
    carried each row's sum along the sequential P axis.  Bound: bytes
    (B*P*4 read once).  Design: (chunk, row) blocks write partial sums,
    a second launch adds each row's partials in float64 in a fixed order;
    no atomics, so bitwise stable from run to run, and within 1e-5
    relative of the twin."""
    _on_cuda(g)
    if g.dim() != 2:
        raise ValueError(f"g: expected [B, P], got {tuple(g.shape)}")
    B, P = g.shape
    _check(g, "g", _F32, (B, P))
    lib = _lib()
    chunk = lib.dp_rownorms_chunk()
    partial = torch.empty(B * (-(-P // chunk)), dtype=_F32, device=g.device)
    out = torch.empty(B, dtype=_F32, device=g.device)
    _raise_on(lib.dp_rownorms(g.data_ptr(), out.data_ptr(),
                              partial.data_ptr(), B, P, _stream(g)),
              "dp_rownorms")
    LAUNCHES["rownorms"] += 1
    return out


def clip_accumulate(g: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """sum_b scales_b * g_b: g [B, P], scales [B] -> [P].

    Replaces ``repro/kernels/dp_clip_noise.py:clip_accumulate``.  Bound:
    bytes (B*P*4 read, P*4 written).  Design: one thread per column (per
    4 columns with 16-byte loads), rows in order with one ``__fmaf_rn``
    each; bitwise equal to the twin."""
    _on_cuda(g, scales)
    if g.dim() != 2:
        raise ValueError(f"g: expected [B, P], got {tuple(g.shape)}")
    B, P = g.shape
    _check(g, "g", _F32, (B, P))
    _check(scales, "scales", _F32, (B,))
    out = torch.empty(P, dtype=_F32, device=g.device)
    _raise_on(_lib().dp_clip_accumulate(g.data_ptr(), scales.data_ptr(),
                                        out.data_ptr(), B, P, _stream(g)),
              "dp_clip_accumulate")
    LAUNCHES["clip_accumulate"] += 1
    return out


def clip_scales(norms: torch.Tensor, clip: float) -> torch.Tensor:
    """The DP clip factor ``min(1, clip / max(norm, 1e-12))``, float32,
    with one IEEE division (as XLA divides)."""
    denom = torch.clamp(norms, min=NORM_EPS)
    return torch.clamp(torch.full_like(denom, clip) / denom, max=1.0)


def dp_row_scales(g: torch.Tensor, clip: float):
    """Each row's DP clip factor and norm, ``(scales [B], norms [B])``:
    ``scale_b = min(1, clip / max(||g_b||, 1e-12))``.  ``g [B, P]``
    float32; a CPU tensor runs the twin, a CUDA tensor ``rownorms``."""
    cpu = g.device.type == "cpu"
    norms = torch.sqrt(ref.rownorms_ref(g) if cpu else rownorms(g))
    return clip_scales(norms, clip), norms


def dp_accumulate(g: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``sum_b scales_b * g_b [P]``: the twin on a CPU tensor,
    ``clip_accumulate`` on a CUDA tensor."""
    if g.device.type == "cpu":
        return ref.clip_accumulate_ref(g, scales)
    return clip_accumulate(g, scales)


def dp_clip_accumulate(g: torch.Tensor, clip: float):
    """Per-row DP clip and sum: ``(sum_b scale_b * g_b [P], norms [B])``
    (:func:`dp_row_scales`, then :func:`dp_accumulate`).  ``g [B, P]``
    float32; CPU tensors run the twins, CUDA tensors the two kernels."""
    scales, norms = dp_row_scales(g, clip)
    return dp_accumulate(g, scales), norms
