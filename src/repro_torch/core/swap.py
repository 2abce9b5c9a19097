"""Incremental SP2 swap engine -- exact candidate compaction for
``swap_refine`` (``repro/core/swap.py``).

A single swap (drop selected s, add unselected u) can only be valid when
``sel[s] & ~sel[u] & active[u] & s != u``; with m pipelines selected there
are at most ``m (N - m) <= floor(N^2 / 4)`` such pairs.  Compacting the
N^2 grid into that many slots with an order-preserving stable sort never
drops a valid candidate, and evaluating each survivor with the same
arithmetic as the reference (same feasibility sum, same boost sweep, same
objective reduction) keeps every objective -- and the s-major first-maximum
argmax -- bit-identical, at a quarter of the work.

Every function is batched over analysts (leading ``M`` axis); the boost
sweeps of all ``[M, C]`` candidates go to the ``swap_eval`` kernel in one
launch per chunk.
"""
from __future__ import annotations

import torch

from ..fp import seq_sum
from . import hotpath
# Module import: packing imports this module at its own top.
from . import packing

_BIG = 1e30
# Candidate-chunk residency cap of swap_batch_objectives: ``repro``'s bound
# on one analyst's [chunk, N, K] feasibility broadcast (2^28 f32 = 1 GB).
_CHUNK_ELEMS = 2 ** 28


def swap_candidate_cap(n: int) -> int:
    """Static bound on the number of potentially valid swap candidates."""
    return max((n * n) // 4, 1)


def swap_candidates(sel, active):
    """Compact each analyst's N^2 (s, u) grid to ``swap_candidate_cap(N)``
    slots, preserving the flat s-major order.  ``sel``/``active`` are
    ``[M, N]`` bool.  Returns ``(s_c, u_c, valid_c)``, each ``[M, C]``."""
    N = sel.shape[-1]
    ar = torch.arange(N, device=sel.device)
    s_flat, u_flat = ar.repeat_interleave(N), ar.repeat(N)
    valid = (sel[:, s_flat] & ~sel[:, u_flat] & active[:, u_flat]
             & (s_flat != u_flat))
    # stable argsort: valid (key 0) first, flat order preserved within
    order = torch.argsort((~valid).to(torch.int32), dim=-1, stable=True)
    order = order[:, :swap_candidate_cap(N)]
    return s_flat[order], u_flat[order], torch.gather(valid, 1, order)


def _selection_sums(gamma, cands):
    """``sum_n gamma[m, n, :] * cands[m, c, n]`` over n in index order.
    ``gamma [M, N, K]``, ``cands [M, C, N]`` bool -> ``[M, C, K]``.  The
    reference's broadcast-and-sum over N (XLA reduces it in index order),
    accumulated one row at a time so no ``[M, C, N, K]`` temporary exists."""
    M, C, N = cands.shape
    acc = gamma.new_zeros((M, C, gamma.shape[-1]))
    for n in range(N):
        acc = acc + gamma[:, None, n, :] * cands[:, :, n, None].to(gamma.dtype)
    return acc


def swap_candidate_objectives(gamma, mu, a, active, sel, budget,
                              kappa_max: float):
    """Evaluate the compacted candidate set.  Returns ``(cands [M, C, N],
    objs [M, C], valid [M, C])`` with invalid or infeasible slots of
    ``objs`` at ``-_BIG``."""
    s_c, u_c, valid_c = swap_candidates(sel, active)
    M, C = s_c.shape
    cands = sel[:, None, :].expand(M, C, sel.shape[-1]).clone()
    cands.scatter_(2, s_c[..., None], False)
    cands.scatter_(2, u_c[..., None], True)
    objs, feas = swap_batch_objectives(gamma, mu, a, cands, budget,
                                       kappa_max)
    ok = valid_c & feas
    return cands, torch.where(ok, objs, torch.full_like(objs, -_BIG)), ok


def swap_batch_objectives(gamma, mu, a, cands, budget, kappa_max: float,
                          chunk: int = 4096):
    """Boosted Eq-20 objectives of a ``[M, C, N]`` stack of selections.

    Returns ``(objs [M, C], feas [M, C])`` with the exact per-candidate
    arithmetic of a ``proportional_boost`` recompute.  Stacks larger than
    ``chunk`` candidates per analyst (capped so one analyst's ``[chunk,
    N, K]`` stays within ``_CHUNK_ELEMS``) run chunk by chunk, as in
    ``repro``; a candidate's arithmetic is independent of its neighbours,
    so chunking changes no bit."""
    M, C, N = cands.shape
    if chunk:
        cap = max(1, _CHUNK_ELEMS // max(N * gamma.shape[-1], 1))
        chunk = max(1, min(int(chunk), cap))
    if chunk and C > chunk:
        parts = [swap_batch_objectives(gamma, mu, a, cands[:, i:i + chunk],
                                       budget, kappa_max, chunk=0)
                 for i in range(0, C, chunk)]
        return (torch.cat([p[0] for p in parts], 1),
                torch.cat([p[1] for p in parts], 1))
    used = _selection_sums(gamma, cands)                         # [M, C, K]
    feas = torch.all(used <= budget[:, None, :] + packing._FEAS, dim=-1)
    leftover = budget[:, None, :] - used
    order = torch.argsort(-(mu * a), dim=-1, stable=True)       # [M, N]
    g_ord = torch.take_along_dim(gamma, order[..., None], dim=1)
    c_ord = torch.take_along_dim(cands, order[:, None, :],
                                 dim=2).to(torch.int32)
    extras = hotpath.swap_eval(g_ord, c_ord, leftover, kappa_max)
    x = torch.zeros_like(extras).scatter_(
        2, order[:, None, :].expand(M, C, N), extras)
    x = torch.where(cands, 1.0 + x, torch.zeros_like(x))
    objs = seq_sum(mu[:, None, :] * a[:, None, :] * x * cands, -1)
    return objs, feas


def swap_refine_incremental(gamma, mu, a, active, sel, budget,
                            kappa_max: float):
    """Single-swap local search over the compacted candidate set: keep the
    feasible candidate with the best boosted objective if it beats the
    current selection by more than 1e-12 (ties to the first candidate in
    s-major order).  ``[M, N]`` bool in and out."""
    cands, objs, _ = swap_candidate_objectives(gamma, mu, a, active, sel,
                                               budget, kappa_max)
    _, _, base_obj = packing.proportional_boost(gamma, mu, a, active, sel,
                                                budget, kappa_max)
    best = torch.argmax(objs, dim=-1)
    best_obj = torch.gather(objs, 1, best[:, None])[:, 0]
    improved = best_obj > base_obj + 1e-12
    best_cand = cands[torch.arange(cands.shape[0], device=sel.device), best]
    return torch.where(improved[:, None], best_cand, sel)
