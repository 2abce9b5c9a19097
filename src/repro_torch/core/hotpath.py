"""Kernel dispatch for the scheduler hot path.

Each function picks by the device of its tensors alone: CPU tensors run the
kernel's plain twin (:mod:`repro_torch.kernels.ref`); any other tensor goes
to the Hopper kernel's launcher (:mod:`repro_torch.kernels.budget_alloc`),
which launches on one CUDA device or raises.  There is no flag and no
fallback.  Operands follow the kernels' contract: contiguous float32, with
selections and masks as int32 0/1.

Unlike ``repro``'s per-analyst functions (batched there by ``vmap``), the
SP2 sweeps here take the analyst axis as a leading dimension, which the
kernels make part of their grid.  A lockstep fleet of E episodes
(``run_fleet(mode="vmap")``) folds into that axis for the sweeps and the
row-max, and gives the SP1 functions a leading fleet axis (``c [E, M,
K]``, ``lam [E, K]``, ...), one launch each for the whole fleet; every
episode's result is bitwise its lone call's.  A sharded axis takes no
fleet (``RoundInputs.fleet_axes`` refuses one).

A sharded ``block_axis`` (:mod:`repro_torch.shard`) keys the fused SP1
sweep and the two boost sweeps to ``repro``'s sharded algorithm, as
``repro/core/hotpath.py`` does: the denominator of x(lambda) and each
visit's water level are cross-stripe reductions, which cannot live inside
one device's kernel.  SP1 then runs the two-matvec path (the ``matvec``
and ``matvec_t`` kernels on the card, the cross-stripe sums and the KKT
error in one all_reduce an iteration) and the sweeps run their twins'
torch scans with a MIN hook per visit, on whatever device the stripe
lives.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import budget_alloc as ba
from ..kernels import ref
from .blockaxis import LOCAL, BlockAxis


def _cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def rowmax(g):
    """mu_i = max_k g_ik.  [M, K] -> [M]; a fleet's [E, M, K] -> [E, M]
    as one launch over its E * M rows."""
    if _cpu(g):
        return ref.rowmax_ref(g)
    return ba.rowmax(g.reshape(-1, g.shape[-1])).reshape(g.shape[:-1])


def matvec(c, v):
    """y_i = sum_k c_ik v_k.  [M, K] x [K] -> [M]; a fleet's [E, M, K] x
    [E, K] -> [E, M]."""
    return ref.matvec_ref(c, v) if _cpu(c, v) else ba.matvec(c, v)


def matvec_t(c, x):
    """load_k = sum_i c_ik x_i.  [M, K] x [M] -> [K]; a fleet's [E, M, K]
    x [E, M] -> [E, K]."""
    return ref.matvec_t_ref(c, x) if _cpu(c, x) else ba.matvec_t(c, x)


def _sharded_sweep(c, denom, w_pow, xcap, mask, cap, cap_safe,
                   beta: float):
    """x and the stripe's residual given the finished sums ``denom`` of
    ``c lam``, op for op :func:`ref.dual_step_ref`."""
    denom = torch.clamp(denom, min=ref.DUAL_EPS)
    x = (w_pow.float() / denom) ** (1.0 / float(beta))
    x = torch.minimum(x, xcap.float())
    x = torch.where(mask.bool(), x, 0.0)
    return x, (matvec_t(c, x) - cap.float()) / cap_safe.float()


def _dual_ascent_sharded(c, lam, w_pow, xcap, mask, cap, cap_safe,
                         beta: float, *, adaptive: bool, max_iters: int,
                         tol: float, block_axis: BlockAxis):
    """:func:`ref.dual_ascent_ref` on a block stripe (``repro``'s
    two-matvec path), with one all_reduce an iteration.

    The rows' partial sums of ``c lam`` for the next iteration travel with
    this iteration's KKT error, which rides in the rank's slot of an
    ``[S]`` tail (zeros elsewhere, so the SUM hands every rank every
    stripe's error exactly); the stop rule reads their max.  The values,
    the iteration count and lam are those of the per-iteration loop with
    a SUM and a MAX hook, which ``repro`` runs."""
    F32 = np.float32
    M = c.shape[0]
    mine = torch.arange(block_axis.size, device=c.device) == block_axis.rank
    tol32 = float(F32(tol))
    it, viol = 0, float("inf")
    eta, viol_prev = F32(0.5), F32(np.inf)
    denom = block_axis.sum(matvec(c, lam))
    while it < max_iters and viol > tol32:
        _, g = _sharded_sweep(c, denom, w_pow, xcap, mask, cap, cap_safe,
                              beta)
        if not adaptive:
            eta = ref.decay_eta(it)
        lam = torch.clamp(lam * torch.exp(float(eta) * g), 1e-12, 1e12)
        err = ref.kkt_error(lam, g)
        fused = block_axis.sum(torch.cat([matvec(c, lam),
                                          torch.where(mine, err, 0.0)]))
        denom, viol = fused[:M], torch.amax(fused[M:]).item()
        if adaptive:
            eta, viol_prev = ref.adapt_eta(eta, viol, viol_prev)
        it += 1
    return lam, torch.tensor(it, dtype=torch.int32, device=lam.device)


def dual_step(c, lam, w_pow, beta: float, xcap, mask, cap, cap_safe,
              block_axis: BlockAxis = LOCAL):
    """One SP1 dual-ascent sweep: ``(x [M], g [K])`` with ``x_i =
    clip((w_pow_i / sum_k c_ik lam_k)^(1/beta), xcap_i)`` where ``mask``
    is set, else 0, and ``g_k = (sum_i c_ik x_i - cap_k) / cap_safe_k``."""
    args = (c, lam, w_pow, xcap, mask, cap, cap_safe)
    if block_axis.sharded:
        return _sharded_sweep(c, block_axis.sum(matvec(c, lam)), w_pow, xcap,
                              mask, cap, cap_safe, beta)
    return (ref.dual_step_ref if _cpu(*args) else ba.dual_step)(*args, beta)


def dual_ascent(c, lam, w_pow, beta: float, xcap, mask, cap, cap_safe, *,
                adaptive: bool, max_iters: int, tol: float,
                block_axis: BlockAxis = LOCAL):
    """SP1's dual ascent from ``lam``, :func:`dual_step` sweeps until the
    KKT error is at most ``tol`` or ``max_iters`` ran: ``(lam [K], iters
    int32 scalar)``; a fleet's ``(lam [E, K], iters [E])``, each episode
    with its own count and stop rule.  On the card one launch, no host
    sync; the twin reads the fleet's KKT errors once an iteration.  On a
    sharded
    axis the twin's loop with the cross-stripe sums and the KKT error
    finished before the stop rule reads it, so every rank stops at the
    same iteration (:func:`_dual_ascent_sharded`)."""
    args = (c, lam, w_pow, xcap, mask, cap, cap_safe)
    if block_axis.sharded:
        return _dual_ascent_sharded(
            *args, beta, adaptive=adaptive, max_iters=max_iters, tol=tol,
            block_axis=block_axis)
    fn = ref.dual_ascent_ref if _cpu(*args) else ba.dual_ascent
    return fn(*args, beta, adaptive=adaptive, max_iters=max_iters, tol=tol)


def boost_scan(g_ord, sel_ord, leftover, kappa_max: float,
               block_axis: BlockAxis = LOCAL):
    """SP2's sequential proportional boost, one selection per analyst:
    ``g_ord [M, N, K]``, ``sel_ord [M, N]``, ``leftover [M, K]``.  Returns
    ``(leftover_after [M, K], extras [M, N])`` (``repro``'s order)."""
    if block_axis.sharded:
        extras, left = ref.boost_scan_ref(g_ord, sel_ord, leftover,
                                          kappa_max, reduce=block_axis.min)
        return left, extras
    fn = ref.boost_scan_ref if _cpu(g_ord, sel_ord, leftover) else \
        ba.boost_scan
    extras, left = fn(g_ord, sel_ord, leftover, kappa_max)
    return left, extras


def swap_eval(g_ord, sel_c, leftover_c, kappa_max: float,
              block_axis: BlockAxis = LOCAL):
    """Boost sweeps for ``[M, C]`` swap candidates: ``g_ord [M, N, K]``,
    ``sel_c [M, C, N]``, ``leftover_c [M, C, K]`` -> ``extras [M, C,
    N]``."""
    if block_axis.sharded:
        return ref.swap_eval_ref(g_ord, sel_c, leftover_c, kappa_max,
                                 reduce=block_axis.min)
    fn = ref.swap_eval_ref if _cpu(g_ord, sel_c, leftover_c) else \
        ba.swap_eval
    return fn(g_ord, sel_c, leftover_c, kappa_max)
