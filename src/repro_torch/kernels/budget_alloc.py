"""Launchers of the Hopper budget kernels (``csrc/budget_alloc.cu``).

Each launcher takes the tensors of one call, all on one CUDA device, and
checks dtype (float32, selections and masks int32), shape and contiguity;
it allocates the outputs with ``torch.empty``, launches the kernel on
``torch.cuda.current_stream()``, raises if the C call returns a nonzero
``cudaError_t``, and adds one to its entry of :data:`LAUNCHES`.  Anything
else raises: there is no fallback.  :mod:`repro_torch.core.hotpath` sends
CPU tensors to the plain twins instead.

Card figures quoted below are the H100 SXM's published peaks: 3.35 TB/s
of HBM bandwidth and 67 TFLOP/s of float32 outside the tensor cores.
"""
from __future__ import annotations

import torch

from .build import library

# Kernel launches per launcher since the last reset_launches().
LAUNCHES = {"rowmax": 0, "matvec": 0, "matvec_t": 0, "dual_step": 0,
            "boost_scan": 0, "swap_eval": 0}
# Grid of the last launch of swap_eval: {"swap_eval": (analysts, candidates)}.
LAST_GRID: dict[str, tuple[int, int]] = {}


def _lib():
    return library("budget_alloc")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAST_GRID.clear()


def _on_cuda(*ts: torch.Tensor) -> None:
    """Raise unless every tensor is on one CUDA device."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"kernel operands span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"no Hopper kernel for device {dev}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with cudaError_t {err}")


_F32, _I32 = torch.float32, torch.int32


def rowmax(gamma: torch.Tensor) -> torch.Tensor:
    """mu_i = max_k gamma_ik.  [M, K] -> [M].

    Replaces ``repro/kernels/budget_alloc.py:rowmax``.  Bound on the card:
    bytes (reads M*K*4 once; one compare per element).  Design: one
    256-thread block per row with a strided, coalesced loop over K, then a
    warp-shuffle and shared-memory max; order-free, so bitwise equal to
    the twin."""
    _on_cuda(gamma)
    M, K = gamma.shape
    _check(gamma, "gamma", _F32, (M, K))
    out = torch.empty(M, dtype=_F32, device=gamma.device)
    _raise_on(_lib().ba_rowmax(gamma.data_ptr(), out.data_ptr(), M, K,
                               _stream(gamma)), "ba_rowmax")
    LAUNCHES["rowmax"] += 1
    return out


def matvec(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y_i = sum_k c_ik v_k.  [M, K] x [K] -> [M].

    Replaces ``repro/kernels/budget_alloc.py:matvec``.  Bound: bytes (c
    read once, 2 flops per 4 bytes).  Design: one block per row, FMA per
    thread over a strided K loop, tree sum; agrees with the twin to
    float32 rounding (1e-5 relative)."""
    _on_cuda(c, v)
    M, K = c.shape
    _check(c, "c", _F32, (M, K))
    _check(v, "v", _F32, (K,))
    y = torch.empty(M, dtype=_F32, device=c.device)
    _raise_on(_lib().ba_matvec(c.data_ptr(), v.data_ptr(), y.data_ptr(),
                               M, K, _stream(c)), "ba_matvec")
    LAUNCHES["matvec"] += 1
    return y


def matvec_t(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """load_k = sum_i c_ik x_i.  [M, K] x [M] -> [K].

    Replaces ``repro/kernels/budget_alloc.py:matvec_t`` (there ``matvec``
    on a materialised ``c.T``).  Bound: bytes.  Design: one thread per
    column, rows 0..M-1 in order with one FMA each -- coalesced across the
    warp, no transpose -- which is also the reference's rounding order."""
    _on_cuda(c, x)
    M, K = c.shape
    _check(c, "c", _F32, (M, K))
    _check(x, "x", _F32, (M,))
    load = torch.empty(K, dtype=_F32, device=c.device)
    _raise_on(_lib().ba_matvec_t(c.data_ptr(), x.data_ptr(),
                                 load.data_ptr(), M, K, _stream(c)),
              "ba_matvec_t")
    LAUNCHES["matvec_t"] += 1
    return load


def dual_step(c, lam, w_pow, xcap, mask, cap, cap_safe, beta: float):
    """One SP1 dual-ascent sweep: ``(x [M], g [K])``.

    ``x_i = min((w_pow_i / max(sum_k c_ik lam_k, 1e-12))^(1/beta),
    xcap_i)`` where ``mask`` (int32) is set, else 0; ``g_k = (sum_i c_ik
    x_i - cap_k) / cap_safe_k`` with the load summed over rows in order.

    Replaces ``repro/kernels/budget_alloc.py:dual_step``, whose TPU grid
    carried the K-long load through VMEM scratch row tile by row tile.
    Bound: bytes (c is read twice, once per launch; the second read mostly
    hits the 50 MB L2 at the scheduler's sizes).  Design: two launches in
    one C call -- a block per row for the denominator and x, then a thread
    per column for the row-ordered FMA load -- so g is bitwise the twin's
    given the same x, and x agrees to 1e-5 relative."""
    _on_cuda(c, lam, w_pow, xcap, mask, cap, cap_safe)
    M, K = c.shape
    _check(c, "c", _F32, (M, K))
    for t, n in ((lam, "lam"), (cap, "cap"), (cap_safe, "cap_safe")):
        _check(t, n, _F32, (K,))
    for t, n in ((w_pow, "w_pow"), (xcap, "xcap")):
        _check(t, n, _F32, (M,))
    _check(mask, "mask", _I32, (M,))
    x = torch.empty(M, dtype=_F32, device=c.device)
    g = torch.empty(K, dtype=_F32, device=c.device)
    inv_beta = float(torch.tensor(1.0 / float(beta), dtype=_F32))
    _raise_on(_lib().ba_dual_step(
        c.data_ptr(), lam.data_ptr(), w_pow.data_ptr(), xcap.data_ptr(),
        mask.data_ptr(), cap.data_ptr(), cap_safe.data_ptr(), x.data_ptr(),
        g.data_ptr(), M, K, inv_beta, _stream(c)), "ba_dual_step")
    LAUNCHES["dual_step"] += 1
    return x, g


def _boost_sweep(g_ord, sel, left, kappa_max: float, keep_left: bool):
    """Launch the boost sweep on ``g_ord [B, N, K]``, ``sel [B, C, N]``
    int32, ``left [B, C, K]``; returns ``(extras, left_after or None)``."""
    B, N, K = g_ord.shape
    C = sel.shape[1]
    _check(g_ord, "g_ord", _F32, (B, N, K))
    _check(sel, "sel", _I32, (B, C, N))
    _check(left, "left", _F32, (B, C, K))
    lib = _lib()
    extras = torch.empty((B, C, N), dtype=_F32, device=g_ord.device)
    spill = K * 4 > lib.ba_boost_smem_limit()
    left_out = (torch.empty((B, C, K), dtype=_F32, device=g_ord.device)
                if keep_left or spill else None)
    kappa_cap = float(torch.tensor(kappa_max - 1.0, dtype=_F32))
    _raise_on(lib.ba_boost_sweep(
        g_ord.data_ptr(), sel.data_ptr(), left.data_ptr(), extras.data_ptr(),
        None if left_out is None else left_out.data_ptr(), B, C, N, K,
        kappa_cap, _stream(g_ord)), "ba_boost_sweep")
    return extras, left_out


def boost_scan(g_ord, sel_ord, leftover, kappa_max: float):
    """SP2 boost sweep for one selection per analyst: ``g_ord [M, N, K]``,
    ``sel_ord [M, N]`` int32, ``leftover [M, K]`` -> ``(extras [M, N],
    leftover_after [M, K])``.

    Replaces ``repro/kernels/budget_alloc.py:boost_scan`` (batched there by
    vmap; here the analyst axis is the grid).  Bound: at paper size, the
    N-step dependency chain per analyst (latency, not bytes: M blocks on
    132 SMs).  Design: the boost-sweep kernel (see :func:`swap_eval`) with
    one candidate per analyst; bitwise equal to the twin."""
    _on_cuda(g_ord, sel_ord, leftover)
    M, N, K = g_ord.shape
    extras, left = _boost_sweep(g_ord, sel_ord.reshape(M, 1, N),
                                leftover.reshape(M, 1, K), kappa_max, True)
    LAUNCHES["boost_scan"] += 1
    return extras.reshape(M, N), left.reshape(M, K)


def swap_eval(g_ord, sel_c, leftover_c, kappa_max: float):
    """Boost sweeps for every swap candidate of every analyst:
    ``g_ord [M, N, K]``, ``sel_c [M, C, N]`` int32, ``leftover_c [M, C,
    K]`` -> ``extras [M, C, N]``.

    Replaces ``repro/kernels/budget_alloc.py:swap_eval`` (the O(N^3 K)
    term of a round).  Bound: bytes -- each candidate's leftover row is
    read once (M*C*K*4), the analyst's demand rows are shared by its C
    blocks through L2.  Design: one block per (analyst, candidate); the
    leftover row stays in dynamic shared memory while K*4 <= 200 KB (in a
    device buffer above that); per selected visit a block-wide min of
    left/g over live blocks, the clip, and an FMA debit; unselected
    visits are skipped.  Bitwise equal to the twin."""
    _on_cuda(g_ord, sel_c, leftover_c)
    extras, _ = _boost_sweep(g_ord, sel_c, leftover_c, kappa_max, False)
    LAUNCHES["swap_eval"] += 1
    LAST_GRID["swap_eval"] = tuple(sel_c.shape[:2])
    return extras
