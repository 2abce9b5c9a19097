"""Launcher of the Hopper RG-LRU scan (``csrc/rg_lru.cu``, ``rg_scan``)
and the dispatch the ``rec`` blocks call.

:func:`rglru_scan_cuda` takes CUDA tensors only (float32, contiguous) and
raises on anything else; it adds one to ``LAUNCHES["rglru_scan"]`` per
launch.  :func:`rglru_scan` picks by the device of ``a`` alone -- a CPU
tensor runs the twin :func:`repro_torch.kernels.ref.rglru_scan_ref`, a
CUDA tensor the kernel -- with no flag and no fallback.

The kernel has no backward.  On the CPU the twin runs under autograd
through :class:`_TwinScan`, whose backward is the same recurrence run in
reverse; on the card, a call that needs a gradient raises
``NotImplementedError`` (training ``rec`` blocks on the card waits for the
scan's backward kernel, ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

from .budget_alloc import _check, _on_cuda, _raise_on, _stream
from .build import library
from . import ref

# Kernel launches since the last reset_launches().
LAUNCHES = {"rglru_scan": 0}


def reset_launches() -> None:
    LAUNCHES["rglru_scan"] = 0


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t on the card: a, b [B, S, D] float32, h0
    [B, D] (zeros when None) -> every h_t, [B, S, D].

    Replaces ``repro/kernels/rg_lru.py:rglru_scan``.  Bound: bytes (a and
    b read, h written: 12*B*S*D).  Design (source header): a thread per
    (batch row, channel) walks t with the next 16 steps' operands loaded
    ahead, one ``__fmaf_rn`` per step; any S and D."""
    ts = (a, b) if h0 is None else (a, b, h0)
    _on_cuda(*ts)
    if a.dim() != 3:
        raise ValueError(f"a: expected [B, S, D], got {tuple(a.shape)}")
    B, S, D = a.shape
    _check(a, "a", torch.float32, (B, S, D))
    _check(b, "b", torch.float32, (B, S, D))
    if h0 is not None:
        _check(h0, "h0", torch.float32, (B, D))
    for name, t in zip(("a", "b", "h0"), ts):
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: must be 4-byte aligned")
    out = torch.empty_like(a)
    _raise_on(library("rg_lru").rg_scan(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), B, S, D, _stream(a)), "rg_scan")
    LAUNCHES["rglru_scan"] += 1
    return out


class _TwinScan(torch.autograd.Function):
    """The twin with a gradient: g_t = dL/dh_t + a_{t+1} g_{t+1} from the
    last step back; dL/db_t = g_t, dL/da_t = g_t h_{t-1}, dL/dh0 = a_0
    g_0."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = ref.rglru_scan_ref(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, grad_h):
        a, h, h0 = ctx.saved_tensors
        S = a.shape[1]
        g = torch.zeros_like(grad_h)
        carry = torch.zeros_like(grad_h[:, 0])
        for t in range(S - 1, -1, -1):
            carry = grad_h[:, t] + carry
            g[:, t] = carry
            carry = a[:, t] * carry
        prev = torch.cat([(torch.zeros_like(h[:, :1]) if h0 is None
                           else h0[:, None]), h[:, :-1]], dim=1)
        grad_h0 = None if h0 is None else carry
        return g * prev, g, grad_h0


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scan by the device of ``a``: the twin on the CPU (under
    autograd where a gradient is needed), :func:`rglru_scan_cuda` on a
    CUDA tensor."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, h0))
    if a.device.type == "cpu":
        return _TwinScan.apply(a, b, h0) if needs_grad else \
            ref.rglru_scan_ref(a, b, h0)
    if needs_grad:
        raise NotImplementedError(
            "rglru_scan has no backward kernel on the card yet (ROADMAP.md, "
            "Queue 2); run under torch.no_grad() to serve")
    return rglru_scan_cuda(a, b, h0)
