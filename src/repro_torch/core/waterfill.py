"""SP1 -- analyst-level alpha-fair allocation via the Lagrange-multiplier method.

Solves (paper Eqs 17-19, the continuous relaxation of Eq 13)

    max   sum_i (mu_i a_i x_i)^(1-beta) / (1-beta)
    s.t.  sum_i c_ik x_i <= cap_k   for every block k,   x_i >= 0

with the KKT closed form x_i(lambda) = [(mu_i a_i)^(1-beta) / sum_k
lambda_k c_ik]^(1/beta) (paper Appendix B, Eq 39) and projected
multiplicative dual ascent lambda_k <- lambda_k exp(eta g_k).

The ascent with its stop rule is one
:func:`repro_torch.core.hotpath.dual_ascent`: on the card the ``dual_step``
kernel's ascent mode, one launch that runs every iteration and the stop
rule there, as ``repro``'s ``lax.while_loop`` does, so a solve makes no
host sync and ``iters`` stays on the device; on the CPU the twin's loop
(:func:`repro_torch.kernels.ref.dual_ascent_ref`), with the same iteration
count and lam.

With a sharded ``block_axis`` (:mod:`repro_torch.shard`), ``c`` and
``cap`` are the caller's block stripes and the multipliers stay
stripe-local for the whole ascent; only the ``[M]``-sized analyst
aggregates (the matvec partials, the feasibility caps, the KKT error)
cross the stripes, as in ``repro``.

A lockstep fleet solves every episode's SP1 at once: a leading episode
axis on every operand (``c [E, M, K]``, ``cap [E, K]``, ...), one ascent
launch for all (each episode with its own count and stop rule), and every
reduction here per episode.  SP1 couples an episode's analysts through
its block capacity, so the episodes stay an axis of their own, never
folded into the analysts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..fp import pow_runs
from . import hotpath
from .blockaxis import LOCAL, BlockAxis

_EPS = 1e-12


class WaterfillResult(NamedTuple):
    x: torch.Tensor          # [M] allocation ratios
    lam: torch.Tensor        # [K] final multipliers
    violation: torch.Tensor  # scalar max constraint violation
    iters: torch.Tensor      # scalar int32 iterations executed
    # (a fleet: each with a leading episode axis)


def _x_of_lambda(lam, c, w_pow, beta, xcap, mask,
                 block_axis: BlockAxis = LOCAL):
    """x_i(lambda) from KKT stationarity, clipped to the per-analyst cap
    (the matvec's partial sums finished across stripes)."""
    denom = torch.clamp(block_axis.sum(hotpath.matvec(c, lam)), min=_EPS)
    x = pow_runs(w_pow / denom, 1.0 / beta, 1)
    x = torch.minimum(x, xcap)
    return torch.where(mask, x, torch.zeros_like(x))


def alpha_fair_waterfill(mu, a, c, mask, cap=None, beta: float = 2.2,
                         max_iters: int = 4000, tol: float = 1e-6,
                         lam0=None, adaptive: bool = False,
                         block_axis: BlockAxis = LOCAL) -> WaterfillResult:
    """Solve SP1.  Returns ratios x_i >= 0 with sum_i c_ik x_i <= cap_k.

    ``mu``/``a``/``mask`` are ``[M]``, ``c`` is ``[M, K]``, ``cap`` ``[K]``
    (default ones), each with a leading episode axis for a fleet.
    ``lam0`` warm-starts the duals; ``adaptive`` replaces the cold step
    ``0.5 / (1 + 0.001 it)`` with one that grows x1.2 while the KKT error
    falls and shrinks x0.7 when it rises, kept in [0.2, 1.5]."""
    if beta <= 0:
        raise ValueError("alpha-fairness requires beta > 0")
    lead = tuple(c.shape[:-2])
    K = c.shape[-1]
    dev = c.device
    if cap is None:
        cap = torch.ones(lead + (K,), dtype=c.dtype, device=dev)
    w = torch.clamp(mu * a, min=_EPS)
    w_pow = torch.where(mask, pow_runs(w, 1.0 - beta, 1),
                        torch.zeros_like(w))

    # x_i <= min_k cap_k / c_ik is necessary for feasibility.
    inf = torch.full((), float("inf"), device=dev)
    ratio = torch.where(c > _EPS,
                        cap[..., None, :] / torch.clamp(c, min=_EPS), inf)
    xcap = block_axis.min(torch.amin(ratio, dim=-1))
    cmax = block_axis.max(torch.amax(c, dim=-1))
    mask = mask & (cmax > _EPS) & torch.isfinite(xcap)
    xcap = torch.where(mask, xcap, torch.zeros_like(xcap))

    if lam0 is None:
        lam = torch.ones(lead + (K,), dtype=c.dtype, device=dev)
    else:
        lam = torch.clamp(lam0.to(c.dtype), 1e-12, 1e12)
    cap_safe = torch.clamp(cap, min=_EPS)
    lam, iters = hotpath.dual_ascent(
        c, lam, w_pow, beta, xcap, mask.to(torch.int32), cap, cap_safe,
        adaptive=adaptive, max_iters=max_iters, tol=tol,
        block_axis=block_axis)
    x = _x_of_lambda(lam, c, w_pow, beta, xcap, mask, block_axis)

    # Final exact projection: uniform scale-down of any residual overshoot
    # so the output is always feasible (budgets must never overdraw).
    load = hotpath.matvec_t(c, x)
    ones = torch.ones_like(load)
    ratio = torch.where(load > cap, cap_safe / torch.clamp(load, min=_EPS),
                        ones)
    x = x * block_axis.min(torch.amin(ratio, dim=-1, keepdim=True))
    violation = block_axis.max(torch.amax(
        torch.clamp(hotpath.matvec_t(c, x) - cap, min=0.0) / cap_safe,
        dim=-1))
    return WaterfillResult(x=x, lam=lam, violation=violation, iters=iters)
