"""Launcher of the Hopper RG-LRU scan (``csrc/rg_lru.cu``, ``rg_scan_at``)
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
scan's backward kernel, ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

from typing import Optional

import torch

from .budget_alloc import _cdiv, _check, _on_cuda, _raise_on, _stream
from .build import library
from . import ref

# Kernel launches since the last reset_launches().
LAUNCHES = {"rglru_scan": 0}

# The ring's constants, as csrc/rg_lru.cu has them.
SCAN_STAGES = 4              # kStages: ring slots a warp
SCAN_STEP = 8                # kStep: a stage is a multiple of this many steps
SCAN_STAGE_MAX = 48          # kStageMax: steps a stage
SCAN_CHANNELS = 64           # kChannels: channels (threads) a block
SCAN_IN_FLIGHT = 3_500_000   # bytes of a and b to keep in flight
SMEM_MAX = 232_448           # shared memory a block may use on an H100


def reset_launches() -> None:
    LAUNCHES["rglru_scan"] = 0


def scan_geometry(B: int, S: int, D: int) -> int:
    """Steps a stage of the scan over B rows x S steps x D channels: each
    warp streams a and b through a ring of SCAN_STAGES slots of that many
    steps; 0 runs the direct path (no ring).

    The SCAN_STAGES - 1 stages in flight hold at least SCAN_IN_FLIGHT
    bytes of a and b across the card: ceil(SCAN_IN_FLIGHT / (8 B D))
    steps ahead, over SCAN_STAGES - 1 stages, rounded up to SCAN_STEP;
    capped by SCAN_STAGE_MAX and so that the ring, SCAN_STAGES stages,
    never exceeds S (rounded down to SCAN_STEP; S < 32 gives 0).  The
    ring's tensor maps need D % 4 == 0; any other D gives 0."""
    if D % 4:
        return 0
    ahead = _cdiv(SCAN_IN_FLIGHT, 8 * B * D)
    stage = _cdiv(_cdiv(ahead, SCAN_STAGES - 1), SCAN_STEP) * SCAN_STEP
    fit = S // SCAN_STAGES // SCAN_STEP * SCAN_STEP
    return min(stage, SCAN_STAGE_MAX, fit)


def scan_smem(stage: int) -> int:
    """Dynamic shared memory of a block on the ring, bytes: each warp's a
    and b rings, its two h slots and its SCAN_STAGES mbarriers."""
    return SCAN_CHANNELS // 32 * ((2 * SCAN_STAGES + 2) * stage * 32 * 4
                                  + SCAN_STAGES * 8)


def ring_takes(*ts: torch.Tensor) -> bool:
    """Whether the ring's tensor maps take these operands: every one
    16-byte aligned (D % 4 == 0 is scan_geometry's part)."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _scan(a, b, h0) -> torch.Tensor:
    B, S, D = a.shape
    out = torch.empty_like(a)
    stage = scan_geometry(B, S, D) if ring_takes(a, b, out) else 0
    _raise_on(library("rg_lru").rg_scan_at(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), B, S, D, stage, _stream(a)), "rg_scan")
    return out


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t on the card: a, b [B, S, D] float32, h0
    [B, D] (zeros when None) -> every h_t, [B, S, D].

    Replaces ``repro/kernels/rg_lru.py:rglru_scan``.  Bound: bytes (a and
    b read, h written: 12*B*S*D).  Design (source header): a thread per
    (batch row, channel) walks t, one ``__fmaf_rn`` per step, from a ring
    of a and b in shared memory that each warp fills ahead of the chain
    with tensor-map boxes, deep enough (:func:`scan_geometry`) to keep
    SCAN_IN_FLIGHT bytes in flight.  S < 32, D % 4 != 0 and operands that
    are not 16-byte aligned take the direct path, which loads ahead in
    registers.  Any S and D; B up to 65,535."""
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
    if B > 65535:
        raise ValueError(f"a: at most 65535 rows (the grid's limit), got {B}")
    out = _scan(a, b, h0)
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
            "Queue 1 item 9); run under torch.no_grad() to serve")
    return rglru_scan_cuda(a, b, h0)
