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

The certified beam (:func:`swap_refine_beam`) evaluates only the
candidates with the largest O(1) objective bounds
(:func:`swap_prune_bounds`) and proves, per analyst, that no pruned
candidate could change the outcome; where the proof fails the caller
reruns the full compacted sweep (``packing.pack_all_pruned``).

Every function is batched over analysts (leading ``M`` axis); the boost
sweeps of all ``[M, C]`` candidates go to the ``swap_eval`` kernel in one
launch per chunk.  ``block_axis``: on a sharded axis ``gamma`` and
``budget`` are block stripes and feasibility, water levels and bounds are
finished across stripes (``repro``'s sites).
"""
from __future__ import annotations

import torch

from ..fp import fma, seq_dot, seq_sum
from . import hotpath
from .blockaxis import LOCAL, BlockAxis
# Module import: packing imports this module at its own top.
from . import packing

_BIG = 1e30
# Pruning-bound constants (``repro``'s): demand liveness threshold (the
# boost sweep's eps, so "no live block -> kappa-capped" agrees with the
# exact sweep) and the certificate's relative headroom against float32
# accumulation error.
_PRUNE_EPS = 1e-9
_CERT_RTOL = 2e-4
# Headroom of the definitely-infeasible screen: it tests the algebraic form
# ``base_used - gamma_s + gamma_u`` of a candidate's usage, while the exact
# sweep re-sums over the selection; only violations clearing this slack are
# certainly infeasible.
_SCREEN_ATOL = 1e-3
# Witness blocks per swapped-in row for that screen.
_SCREEN_WITNESSES = 8
# Candidate-chunk residency cap of swap_batch_objectives: the elements of
# one chunk's ``[M, chunk, K]`` selection sums (2^28 f32 = 1 GB).  The
# port accumulates those sums one pipeline at a time, so this is its
# largest temporary (``repro`` bounds its ``[chunk, N, K]`` broadcast).
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


def _swapped(sel, s_c, u_c):
    """``sel - {s} + {u}`` for each ``[M, C]`` pair -> ``[M, C, N]``."""
    M, C = s_c.shape
    cands = sel[:, None, :].expand(M, C, sel.shape[-1]).clone()
    cands.scatter_(2, s_c[..., None], False)
    cands.scatter_(2, u_c[..., None], True)
    return cands


def swap_candidate_objectives(gamma, mu, a, active, sel, budget,
                              kappa_max: float,
                              block_axis: BlockAxis = LOCAL):
    """Evaluate the compacted candidate set.  Returns ``(cands [M, C, N],
    objs [M, C], valid [M, C])`` with invalid or infeasible slots of
    ``objs`` at ``-_BIG``."""
    s_c, u_c, valid_c = swap_candidates(sel, active)
    cands = _swapped(sel, s_c, u_c)
    objs, feas = swap_batch_objectives(gamma, mu, a, cands, budget,
                                       kappa_max, block_axis)
    ok = valid_c & feas
    return cands, torch.where(ok, objs, torch.full_like(objs, -_BIG)), ok


def swap_batch_objectives(gamma, mu, a, cands, budget, kappa_max: float,
                          block_axis: BlockAxis = LOCAL, chunk: int = 4096):
    """Boosted Eq-20 objectives of a ``[M, C, N]`` stack of selections.

    Returns ``(objs [M, C], feas [M, C])`` with the exact per-candidate
    arithmetic of a ``proportional_boost`` recompute.  Stacks larger than
    ``chunk`` candidates per analyst (capped so the ``[M, chunk, K]``
    selection sums stay within ``_CHUNK_ELEMS``) run chunk by chunk, as in
    ``repro``; a candidate's arithmetic is independent of its neighbours,
    so chunking changes no bit."""
    M, C, N = cands.shape
    if chunk:
        cap = max(1, _CHUNK_ELEMS // max(M * gamma.shape[-1], 1))
        chunk = max(1, min(int(chunk), cap))
    if chunk and C > chunk:
        parts = [swap_batch_objectives(gamma, mu, a, cands[:, i:i + chunk],
                                       budget, kappa_max, block_axis,
                                       chunk=0)
                 for i in range(0, C, chunk)]
        return (torch.cat([p[0] for p in parts], 1),
                torch.cat([p[1] for p in parts], 1))
    used = _selection_sums(gamma, cands)                         # [M, C, K]
    feas = block_axis.all(
        torch.all(used <= budget[:, None, :] + packing._FEAS, dim=-1))
    leftover = budget[:, None, :] - used
    order = torch.argsort(-(mu * a), dim=-1, stable=True)       # [M, N]
    g_ord = torch.take_along_dim(gamma, order[..., None], dim=1)
    c_ord = torch.take_along_dim(cands, order[:, None, :],
                                 dim=2).to(torch.int32)
    extras = hotpath.swap_eval(g_ord, c_ord, leftover, kappa_max, block_axis)
    x = torch.zeros_like(extras).scatter_(
        2, order[:, None, :].expand(M, C, N), extras)
    x = torch.where(cands, 1.0 + x, torch.zeros_like(x))
    objs = seq_sum(mu[:, None, :] * a[:, None, :] * x * cands, -1)
    return objs, feas


def swap_refine_incremental(gamma, mu, a, active, sel, budget,
                            kappa_max: float, block_axis: BlockAxis = LOCAL):
    """Single-swap local search over the compacted candidate set: keep the
    feasible candidate with the best boosted objective if it beats the
    current selection by more than 1e-12 (ties to the first candidate in
    s-major order).  ``[M, N]`` bool in and out."""
    cands, objs, _ = swap_candidate_objectives(gamma, mu, a, active, sel,
                                               budget, kappa_max, block_axis)
    _, _, base_obj = packing.proportional_boost(gamma, mu, a, active, sel,
                                                budget, kappa_max, block_axis)
    best = torch.argmax(objs, dim=-1)
    best_obj = torch.gather(objs, 1, best[:, None])[:, 0]
    improved = best_obj > base_obj + 1e-12
    best_cand = cands[torch.arange(cands.shape[0], device=sel.device), best]
    return torch.where(improved[:, None], best_cand, sel)


def _top_k(x, k: int):
    """The ``k`` largest entries along the last axis, ties to the lowest
    index (``lax.top_k``'s order), as ``(values, indices)``.

    ``torch.topk`` promises no tie order, but its values are exact: every
    entry above the ``k``-th value ``t`` is among its picks, and the slots
    left go to the lowest-index entries equal to ``t``, found by ``k``
    first-occurrence ``argmax`` passes over the ``x == t`` mask.  No full
    sort of the row and no host sync; the ``k`` picks are then ordered by
    value, ties by index."""
    v, i = torch.topk(x, k, dim=-1)
    t = v[..., -1:]
    eq = (x == t).to(torch.uint8)
    firsts = []
    for _ in range(k):
        f = torch.argmax(eq, dim=-1, keepdim=True)  # first 1 of the row
        firsts.append(f)
        eq.scatter_(-1, f, 0)
    del eq
    above = torch.arange(k, device=x.device) < (v > t).sum(
        -1, keepdim=True)
    ties = torch.cumsum(~above, -1) - 1             # slot among the ties
    i = torch.where(above, i, torch.gather(torch.cat(firsts, -1), -1,
                                           ties.clamp(min=0)))
    i = torch.sort(i, dim=-1).values
    v, o = torch.sort(torch.gather(x, -1, i), dim=-1, descending=True,
                      stable=True)
    return v, torch.gather(i, -1, o)


def swap_prune_bounds(gamma, mu, a, sel, budget, kappa_max: float,
                      s_c, u_c, valid_c, block_axis: BlockAxis = LOCAL):
    """O(1)-per-candidate upper bound on each compacted candidate's boosted
    objective (``repro/core/swap.py:swap_prune_bounds``, over analysts).

    With ``w = mu a``, the base selection's leftover ``L0`` and each row's
    binding block ``k*_j = argmin_k L0_k / gamma_jk`` over live blocks, a
    swapped-in row's boost is at most ``e_ub[s, j] = clip(rho0_j +
    gamma[s, k*_j] / gamma[j, k*_j], 0, kappa_max - 1)``, so

        ub(s, u) = T - w_s + w_u + rowB[s]
                   - relu(w_s) e_ub[s, s] + relu(w_u) e_ub[s, u]

    with ``T`` the base weight and ``rowB = e_ub @ where(sel, relu(w))``.
    A candidate whose swapped-in row, at any of its ``_SCREEN_WITNESSES``
    blocks of largest ``gamma_uk - L0_k``, adds more than the leftover
    plus what the removed row frees there (by ``_FEAS + _SCREEN_ATOL``)
    is certainly infeasible: its bound is ``-_BIG``.  Invalid slots are
    ``-inf``.  ``gamma [M, N, K]``, the candidates ``[M, C]`` -> ``ub [M,
    C]``.  On a sharded axis a bound built from one stripe's blocks is
    still a bound, so the stripes' bounds are combined by the MIN hook."""
    M, N, K = gamma.shape
    w = mu * a
    wp = torch.clamp(w, min=0.0)
    L0 = budget - seq_sum(gamma * sel[..., None].to(gamma.dtype), 1)
    ratio0 = torch.where(gamma > _PRUNE_EPS,
                         L0[:, None, :] / torch.clamp(gamma, min=_PRUNE_EPS),
                         torch.full_like(gamma, float("inf")))   # [M, N, K]
    kstar = torch.argmin(ratio0, dim=-1)                        # [M, N]
    rho0 = torch.gather(ratio0, 2, kstar[..., None])[..., 0]
    d = torch.gather(gamma, 2, kstar[..., None])[..., 0]
    del ratio0
    G = torch.gather(gamma, 2, kstar[:, None, :].expand(M, N, N))
    e_ub = torch.clamp(rho0[:, None, :]
                       + G / torch.clamp(d, min=_PRUNE_EPS)[:, None, :],
                       0.0, kappa_max - 1.0)                    # [M, s, j]
    zero = torch.zeros_like(w)
    rowB = seq_dot(e_ub, torch.where(sel, wp, zero)[:, None, :], 2)
    e_diag = torch.diagonal(e_ub, dim1=1, dim2=2)
    T = seq_sum(torch.where(sel, w, zero), 1)

    def at(x, i):
        return torch.gather(x, 1, i)

    su = s_c * N + u_c
    ub = T[:, None] - at(w, s_c) + at(w, u_c) + at(rowB, s_c)
    ub = fma(-at(wp, s_c), at(e_diag, s_c), ub)
    ub = fma(at(wp, u_c), at(e_ub.reshape(M, N * N), su), ub)
    # the definitely-infeasible screen at each u's tightest blocks
    J = min(_SCREEN_WITNESSES, K)
    gapv, kdag = _top_k(gamma - L0[:, None, :], J)              # [M, N, J]
    G2 = torch.gather(gamma, 2, kdag.reshape(M, 1, N * J).expand(M, N, N * J))
    viol = torch.any(gapv[:, None] - G2.reshape(M, N, N, J)
                     > packing._FEAS + _SCREEN_ATOL, dim=-1)     # [M, s, u]
    ub = torch.where(at(viol.reshape(M, N * N), su),
                     torch.full_like(ub, -_BIG), ub)
    return block_axis.min(
        torch.where(valid_c, ub, torch.full_like(ub, float("-inf"))))


def swap_refine_beam(gamma, mu, a, active, sel, budget, kappa_max: float,
                     beam: int, block_axis: BlockAxis = LOCAL):
    """Certified top-``beam`` search over each analyst's compacted grid.

    Evaluates exactly (:func:`swap_batch_objectives`) only the ``beam``
    candidates with the largest bounds, ties to the earliest in s-major
    order, re-sorted to s-major order so the argmax resolves ties as the
    full sweep does.  The certificate holds where the largest pruned bound
    sits below ``max(best_obj, base_obj + 1e-12)`` by ``_CERT_RTOL``
    relative headroom, or where the beam's best and every pruned bound are
    at the infeasible floor: then no pruned candidate changes the outcome
    and ``sel_new`` is the full sweep's selection.  Where it fails the
    caller must rerun the full sweep.

    Returns ``(sel_new [M, N], cert_ok [M] bool, margin [M])``, margin the
    threshold minus the largest pruned bound (``inf`` if none was
    pruned)."""
    s_c, u_c, valid_c = swap_candidates(sel, active)
    M, C = s_c.shape
    W = max(1, min(int(beam), C))
    ub = swap_prune_bounds(gamma, mu, a, sel, budget, kappa_max,
                           s_c, u_c, valid_c, block_axis)
    top_ub, top_idx = _top_k(ub, min(W + 1, C))
    if top_idx.shape[-1] > W:
        beam_idx, pruned_ub = top_idx[:, :W], top_ub[:, W]
    else:                       # the beam covers the whole grid
        beam_idx = top_idx
        pruned_ub = torch.full_like(ub[:, 0], float("-inf"))
    beam_idx = torch.sort(beam_idx, dim=-1).values    # s-major order
    s_b, u_b = torch.gather(s_c, 1, beam_idx), torch.gather(u_c, 1, beam_idx)
    valid_b = torch.gather(valid_c, 1, beam_idx)
    cands_b = _swapped(sel, s_b, u_b)
    objs_b, feas_b = swap_batch_objectives(gamma, mu, a, cands_b, budget,
                                           kappa_max, block_axis)
    objs_b = torch.where(valid_b & feas_b, objs_b,
                         torch.full_like(objs_b, -_BIG))
    best = torch.argmax(objs_b, dim=-1)
    best_obj = torch.gather(objs_b, 1, best[:, None])[:, 0]
    _, _, base_obj = packing.proportional_boost(gamma, mu, a, active, sel,
                                                budget, kappa_max, block_axis)
    thresh = torch.maximum(best_obj, base_obj + 1e-12)
    # the first clause is ``pruned_ub + _CERT_RTOL * (1 + |thresh|) <
    # thresh``, one FMA as XLA contracts it
    cert_ok = ((fma(1.0 + thresh.abs(), _CERT_RTOL, pruned_ub) < thresh)
               | ((pruned_ub <= -_BIG) & (best_obj <= -_BIG)))
    improved = best_obj > base_obj + 1e-12
    best_cand = cands_b[torch.arange(M, device=sel.device), best]
    sel_new = torch.where(improved[:, None], best_cand, sel)
    return sel_new, cert_ok, thresh - pruned_ub
