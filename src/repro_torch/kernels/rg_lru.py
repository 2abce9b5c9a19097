"""Launchers of the Hopper RG-LRU scan and its gradient (``csrc/rg_lru.cu``,
``rg_scan_at`` and ``rg_scan_bwd``) and the dispatch the ``rec`` blocks
call.

:func:`rglru_scan_cuda` and :func:`rglru_scan_bwd_cuda` take CUDA tensors
only (float32, contiguous) and raise on anything else; they add one to
``LAUNCHES["rglru_scan"]`` and ``BWD_LAUNCHES["rglru_scan_bwd"]`` per
launch.  :func:`rglru_scan` picks by the device of ``a`` alone -- a CPU
tensor runs the twin :func:`repro_torch.kernels.ref.rglru_scan_ref`, a
CUDA tensor the kernel -- with no flag and no fallback.  Under autograd
the CPU runs :class:`_TwinScan`, whose backward is the recurrence run in
reverse in torch ops, and the card :class:`_CudaScan`, whose backward is
that recurrence as a kernel, bitwise the twin's.
"""
from __future__ import annotations

from typing import Optional

import torch

from .budget_alloc import _cdiv, _check, _on_cuda, _raise_on, _stream
from .build import library
from . import ref

# Kernel launches since the last reset_launches(): the scan, and its
# gradient apart (serving launches only the first).
LAUNCHES = {"rglru_scan": 0}
BWD_LAUNCHES = {"rglru_scan_bwd": 0}

# The ring's constants, as csrc/rg_lru.cu has them.
SCAN_STAGES = 4              # kStages: ring slots a warp
SCAN_STEP = 8                # kStep: a stage is a multiple of this many steps
SCAN_STAGE_MAX = 48          # kStageMax: steps a stage
SCAN_CHANNELS = 64           # kChannels: channels (threads) a block
SCAN_IN_FLIGHT = 3_500_000   # bytes of a and b to keep in flight
SMEM_MAX = 232_448           # shared memory a block may use on an H100


def reset_launches() -> None:
    LAUNCHES["rglru_scan"] = 0
    BWD_LAUNCHES["rglru_scan_bwd"] = 0


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
    _check_operands(("a", a), ("b", b), h0=h0)
    out = _scan(a, b, h0)
    LAUNCHES["rglru_scan"] += 1
    return out


def _check_operands(*named, h0):
    """Raise unless every named [B, S, D] operand and h0 [B, D] (or None)
    is a contiguous, 4-byte aligned float32 tensor on one CUDA device,
    with B <= 65,535 (the grid's limit)."""
    named = named + (() if h0 is None else (("h0", h0),))
    _on_cuda(*(t for _, t in named))
    first, a = named[0]
    if a.dim() != 3:
        raise ValueError(f"{first}: expected [B, S, D], got {tuple(a.shape)}")
    B, S, D = a.shape
    for name, t in named:
        _check(t, name, torch.float32, (B, D) if name == "h0" else (B, S, D))
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: must be 4-byte aligned")
    if B > 65535:
        raise ValueError(f"{first}: at most 65535 rows (the grid's limit), "
                         f"got {B}")


def rglru_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor,
                        grad_h: torch.Tensor,
                        h0: Optional[torch.Tensor] = None):
    """The scan's gradient on the card: a, h (the forward's output) and
    grad_h = dL/dh [B, S, D] float32, h0 [B, D] or None -> ``(dL/da,
    dL/db, dL/dh0)``, the last None when h0 is.

    No Pallas kernel replaced: ``repro`` differentiates
    ``repro/models/recurrent.py:64 linear_scan`` (an associative scan) by
    autodiff.  Contract: :meth:`_TwinScan.backward`, bitwise.  Bound:
    bytes (a, grad_h and h read, dL/da and dL/db written: 20*B*S*D).
    Design (source): one thread a (batch row, channel) walks t from S - 1
    down, the next 16 steps' operands loaded ahead in registers, one
    rounded add and two rounded products a step.  Any S and D; B up to
    65,535."""
    _check_operands(("a", a), ("h", h), ("grad_h", grad_h), h0=h0)
    B, S, D = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    _raise_on(library("rg_lru").rg_scan_bwd(
        a.data_ptr(), grad_h.data_ptr(), h.data_ptr(),
        None if h0 is None else h0.data_ptr(), da.data_ptr(), db.data_ptr(),
        None if dh0 is None else dh0.data_ptr(), B, S, D, _stream(a)),
        "rg_scan_bwd")
    BWD_LAUNCHES["rglru_scan_bwd"] += 1
    return da, db, dh0


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


class _CudaScan(torch.autograd.Function):
    """The kernel with a gradient: :func:`rglru_scan_cuda` forward,
    :func:`rglru_scan_bwd_cuda` backward."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = rglru_scan_cuda(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, grad_h):
        a, h, h0 = ctx.saved_tensors
        return rglru_scan_bwd_cuda(a, h, grad_h.contiguous(), h0)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scan by the device of ``a``: the twin on the CPU, the kernel
    (:func:`rglru_scan_cuda`) on any other device, each under autograd
    where a gradient is needed."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, h0))
    if a.device.type == "cpu":
        return _TwinScan.apply(a, b, h0) if needs_grad else \
            ref.rglru_scan_ref(a, b, h0)
    return _CudaScan.apply(a, b, h0) if needs_grad else \
        rglru_scan_cuda(a, b, h0)
