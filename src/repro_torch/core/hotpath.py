"""Kernel dispatch for the scheduler hot path.

Each function picks by the device of its tensors alone: CPU tensors run the
kernel's plain twin (:mod:`repro_torch.kernels.ref`); any other tensor goes
to the Hopper kernel's launcher (:mod:`repro_torch.kernels.budget_alloc`),
which launches on one CUDA device or raises.  There is no flag and no
fallback.  Operands follow the kernels' contract: contiguous float32, with
selections and masks as int32 0/1.

Unlike ``repro``'s per-analyst functions (batched there by ``vmap``), the
SP2 sweeps here take the analyst axis as a leading dimension, which the
kernels make part of their grid.
"""
from __future__ import annotations

from ..kernels import budget_alloc as ba
from ..kernels import ref


def _cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def rowmax(g):
    """mu_i = max_k g_ik.  [M, K] -> [M]."""
    return ref.rowmax_ref(g) if _cpu(g) else ba.rowmax(g)


def matvec(c, v):
    """y_i = sum_k c_ik v_k.  [M, K] x [K] -> [M]."""
    return ref.matvec_ref(c, v) if _cpu(c, v) else ba.matvec(c, v)


def matvec_t(c, x):
    """load_k = sum_i c_ik x_i.  [M, K] x [M] -> [K]."""
    return ref.matvec_t_ref(c, x) if _cpu(c, x) else ba.matvec_t(c, x)


def dual_step(c, lam, w_pow, beta: float, xcap, mask, cap, cap_safe):
    """One SP1 dual-ascent sweep: ``(x [M], g [K])`` with ``x_i =
    clip((w_pow_i / sum_k c_ik lam_k)^(1/beta), xcap_i)`` where ``mask``
    is set, else 0, and ``g_k = (sum_i c_ik x_i - cap_k) / cap_safe_k``."""
    args = (c, lam, w_pow, xcap, mask, cap, cap_safe)
    return (ref.dual_step_ref if _cpu(*args) else ba.dual_step)(*args, beta)


def dual_ascent(c, lam, w_pow, beta: float, xcap, mask, cap, cap_safe, *,
                adaptive: bool, max_iters: int, tol: float):
    """SP1's dual ascent from ``lam``, :func:`dual_step` sweeps until the
    KKT error is at most ``tol`` or ``max_iters`` ran: ``(lam [K], iters
    int32 scalar)``.  On the card one launch, no host sync."""
    args = (c, lam, w_pow, xcap, mask, cap, cap_safe)
    fn = ref.dual_ascent_ref if _cpu(*args) else ba.dual_ascent
    return fn(*args, beta, adaptive=adaptive, max_iters=max_iters, tol=tol)


def boost_scan(g_ord, sel_ord, leftover, kappa_max: float):
    """SP2's sequential proportional boost, one selection per analyst:
    ``g_ord [M, N, K]``, ``sel_ord [M, N]``, ``leftover [M, K]``.  Returns
    ``(leftover_after [M, K], extras [M, N])`` (``repro``'s order)."""
    fn = ref.boost_scan_ref if _cpu(g_ord, sel_ord, leftover) else \
        ba.boost_scan
    extras, left = fn(g_ord, sel_ord, leftover, kappa_max)
    return left, extras


def swap_eval(g_ord, sel_c, leftover_c, kappa_max: float):
    """Boost sweeps for ``[M, C]`` swap candidates: ``g_ord [M, N, K]``,
    ``sel_c [M, C, N]``, ``leftover_c [M, C, K]`` -> ``extras [M, C,
    N]``."""
    fn = ref.swap_eval_ref if _cpu(g_ord, sel_c, leftover_c) else \
        ba.swap_eval
    return fn(g_ord, sel_c, leftover_c, kappa_max)
