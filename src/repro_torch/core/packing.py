"""SP2 -- pipeline-level reallocation inside each analyst (paper Eqs 20-24).

Given each analyst's granted budget vector (from SP1), pick its pipeline
set:

    (Eq 23)  maximise the NUMBER of covered pipelines, then
    (Eq 20)  maximise sum_j mu_ij x_ij a_ij over the chosen set, x_ij >= 1
             (one-or-more, Eq 5), returning unused budget.

* greedy cover by ascending mu_ij (max-count packing heuristic),
* a single-swap refinement that keeps the count but may improve the
  boosted Eq-20 objective (what picks Bob's P3 over P4 in Fig 2), by
  default through the incremental engine in :mod:`repro_torch.core.swap`,
* the closed-form sequential proportional boost for Eq 20: each selected
  pipeline, in descending mu_ij a_ij order, receives kappa_j = min_k
  leftover_k / gamma_jk extra, capped at kappa_max (Bob's P3: 1.25).

Everything is batched over analysts: ``gamma [M, N, K]``, ``mu``/``a``/
``active``/``sel`` ``[M, N]``, ``budget [M, K]``; the boost sweeps run as
one kernel launch over the whole analyst axis.  Given its budget vector an
analyst's SP2 is independent of every other, so a lockstep fleet of E
episodes folds into this axis (E * M rows, episode-major).  An exhaustive
oracle for one analyst at small N lives in :func:`exact_pack` (numpy
enumeration, boost sweep on ``device``).

``block_axis`` (:mod:`repro_torch.core.blockaxis`): on a sharded axis
``gamma`` and ``budget`` are block stripes, ``mu`` the global dominant
share; feasibility verdicts and water levels are finished across stripes
(``repro``'s sites).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..fp import seq_dot, seq_sum
from . import hotpath
from . import swap as _swap
from .blockaxis import LOCAL, BlockAxis, grant_fits_scan

_EPS = 1e-9
_FEAS = 1e-6  # feasibility slack (float32 headroom on normalized shares)
_BIG = 1e30


class PackResult(NamedTuple):
    x_ij: torch.Tensor       # [M, N] allocation ratio (0 or >= 1)
    selected: torch.Tensor   # [M, N] bool
    used: torch.Tensor       # [M, K] budget consumed
    objective: torch.Tensor  # [M] Eq-20 value
    swapped: Optional[torch.Tensor] = None  # [M] bool: refinement changed greedy
    water: Optional[torch.Tensor] = None    # [M] post-boost min leftover share


def greedy_cover(gamma, mu, active, budget, block_axis: BlockAxis = LOCAL):
    """Max-count pipeline set by ascending-mu greedy.  -> [M, N] bool.
    ``mu`` is the global dominant share, so the visit order is the same on
    every stripe."""
    key = torch.where(active, mu, torch.full_like(mu, _BIG))
    order = torch.argsort(key, dim=-1, stable=True)
    dems = torch.take_along_dim(gamma, order[..., None], dim=1)
    _, taken = grant_fits_scan(dems, torch.gather(active, 1, order), budget,
                               _FEAS, block_axis)
    sel = torch.zeros_like(active).scatter_(1, order, taken)
    return sel & active


def proportional_boost(gamma, mu, a, active, sel, budget, kappa_max: float,
                       block_axis: BlockAxis = LOCAL):
    """Eq 20 heuristic: x = 1 for selected, then greedy kappa boosts in the
    fixed descending mu*a order (unselected visits are no-ops).  Returns
    ``(x_ij [M, N], used [M, K], objective [M])``."""
    base_used = seq_sum(gamma * sel[..., None].to(gamma.dtype), 1)
    leftover = budget - base_used

    order = torch.argsort(-(mu * a), dim=-1, stable=True)  # selection-free
    g_ord = torch.take_along_dim(gamma, order[..., None], dim=1)
    sel_ord = torch.gather(sel, 1, order).to(torch.int32)

    leftover, extras = hotpath.boost_scan(g_ord, sel_ord, leftover,
                                          kappa_max, block_axis)
    x = torch.zeros_like(mu).scatter_(1, order, extras)
    x = torch.where(sel, 1.0 + x, torch.zeros_like(x))
    used = seq_dot(gamma, x[..., None], 1)
    obj = seq_sum(mu * a * x * sel, -1)
    return x, used, obj


def swap_refine_reference(gamma, mu, a, active, sel, budget,
                          kappa_max: float, block_axis: BlockAxis = LOCAL):
    """Single-swap local search, reference path: for every (selected s,
    unselected u) try sel - {s} + {u} with a full ``proportional_boost``
    recompute; keep the feasible candidate with the best objective.
    O(N^3 K); the oracle of :func:`repro_torch.core.swap.
    swap_refine_incremental`, which must return the same selection."""
    M, N = mu.shape
    cands, objs, valids = [], [], []
    for s in range(N):
        for u in range(N):
            cand = sel.clone()
            cand[:, s] = False
            cand[:, u] = True
            valid = sel[:, s] & ~sel[:, u] & active[:, u] & (s != u)
            used = seq_sum(gamma * cand[..., None].to(gamma.dtype), 1)
            feasible = block_axis.all(
                torch.all(used <= budget + _FEAS, dim=-1))
            _, _, obj = proportional_boost(gamma, mu, a, active, cand,
                                           budget, kappa_max, block_axis)
            cands.append(cand)
            objs.append(obj)
            valids.append(valid & feasible)
    cands = torch.stack(cands, 1)                                 # [M,N2,N]
    objs = torch.stack(objs, 1)
    objs = torch.where(torch.stack(valids, 1), objs,
                       torch.full_like(objs, -_BIG))
    _, _, base_obj = proportional_boost(gamma, mu, a, active, sel, budget,
                                        kappa_max, block_axis)
    best = torch.argmax(objs, dim=-1)
    improved = torch.gather(objs, 1, best[:, None])[:, 0] > base_obj + 1e-12
    best_cand = cands[torch.arange(M, device=sel.device), best]
    return torch.where(improved[:, None], best_cand, sel)


def swap_refine(gamma, mu, a, active, sel, budget, kappa_max: float,
                incremental: bool = True, block_axis: BlockAxis = LOCAL):
    """Single-swap refinement: the incremental engine (default) or the
    O(N^3 K) reference; both return the same selection bit for bit."""
    fn = (_swap.swap_refine_incremental if incremental
          else swap_refine_reference)
    return fn(gamma, mu, a, active, sel, budget, kappa_max, block_axis)


def _finish_analyst(gamma, mu, a, active, sel0, sel, budget,
                    kappa_max: float,
                    block_axis: BlockAxis = LOCAL) -> PackResult:
    """Shared SP2 tail: boost the final selection, assemble the result."""
    swapped = torch.any(sel != sel0, dim=-1)
    x, used, obj = proportional_boost(gamma, mu, a, active, sel, budget,
                                      kappa_max, block_axis)
    water = block_axis.min(torch.amin(budget - used, dim=-1))
    return PackResult(x_ij=x, selected=sel, used=used, objective=obj,
                      swapped=swapped, water=water)


def pack_all(gamma, mu, a, active, budget, kappa_max: float = 8.0,
             refine: bool = True, incremental: bool = True,
             block_axis: BlockAxis = LOCAL) -> PackResult:
    """Full SP2 for every analyst at once (``repro``'s ``vmap`` of
    ``pack_analyst``, written over the analyst axis)."""
    sel0 = greedy_cover(gamma, mu, active, budget, block_axis)
    sel = (swap_refine(gamma, mu, a, active, sel0, budget, kappa_max,
                       incremental, block_axis) if refine else sel0)
    return _finish_analyst(gamma, mu, a, active, sel0, sel, budget,
                           kappa_max, block_axis)


def pack_analyst(gamma, mu, a, active, budget, kappa_max: float = 8.0,
                 refine: bool = True, incremental: bool = True,
                 block_axis: BlockAxis = LOCAL) -> PackResult:
    """Full SP2 for one analyst (``gamma [N, K]``, ``budget [K]``): the
    analyst axis of :func:`pack_all` at size one."""
    pack = pack_all(gamma[None], mu[None], a[None], active[None],
                    budget[None], kappa_max, refine, incremental, block_axis)
    return PackResult(*(x[0] for x in pack))


def pack_all_pruned(gamma, mu, a, active, budget, kappa_max: float = 8.0,
                    swap_beam: int = 8, block_axis: BlockAxis = LOCAL,
                    episodes: Optional[int] = None):
    """SP2 for every analyst with the certified swap beam
    (:func:`repro_torch.core.swap.swap_refine_beam`).

    The per-analyst certificates are AND-ed per episode and read on the
    host once: a certified episode finishes on the beam's selections; the
    analysts of every other episode rerun the full compacted sweep.  Only
    one side runs for an episode, never both, and either way the result is
    :func:`pack_all`'s bit for bit.

    ``episodes``: the analyst axis is E episodes' M analysts each
    (episode-major), and the certificate is per episode.  Returns
    ``(PackResult, cert_ok, margin)``, margin the tightest analyst's
    certificate margin: scalars, or ``[E]`` with ``episodes``.  On a
    sharded axis every quantity behind the certificate is post-collective,
    so every stripe takes the same side."""
    sel0 = greedy_cover(gamma, mu, active, budget, block_axis)
    sel, ok, margin = _swap.swap_refine_beam(gamma, mu, a, active, sel0,
                                             budget, kappa_max, swap_beam,
                                             block_axis)
    E = 1 if episodes is None else int(episodes)
    cert_ok = torch.all(ok.reshape(E, -1), dim=-1)
    failed = np.flatnonzero(~cert_ok.cpu().numpy())   # the one host read
    if failed.size == E:
        sel = _swap.swap_refine_incremental(gamma, mu, a, active, sel0,
                                            budget, kappa_max, block_axis)
    elif failed.size:
        m = sel.shape[0] // E
        rows = torch.as_tensor((failed[:, None] * m + np.arange(m)).ravel(),
                               device=sel.device)
        full = _swap.swap_refine_incremental(
            *(t[rows] for t in (gamma, mu, a, active, sel0, budget)),
            kappa_max, block_axis)
        sel = sel.index_copy(0, rows, full)
    pack = _finish_analyst(gamma, mu, a, active, sel0, sel, budget,
                           kappa_max, block_axis)
    margin = torch.amin(margin.reshape(E, -1), dim=-1)
    if episodes is None:
        return pack, cert_ok[0], margin[0]
    return pack, cert_ok, margin


def _batched_boost_objective(gamma, mu, a, active, sels, budget,
                             kappa_max: float):
    """One analyst's ``[S, N]`` selections -> ``[S]`` boosted objectives,
    the subsets taking the place of the analyst axis."""
    S = sels.shape[0]

    def rep(x):
        return x.expand(S, *x.shape)

    _, _, obj = proportional_boost(rep(gamma), rep(mu), rep(a), rep(active),
                                   sels, rep(budget), kappa_max)
    return obj


def exact_pack(gamma, mu, a, active, budget, kappa_max: float = 8.0,
               device="cuda"):
    """Exhaustive oracle for tests (one analyst, at most 16 active
    pipelines): enumerate subsets, maximise the count and then the boosted
    objective (the same sequential boost).  Ties go to the lowest subset
    bitmask.  The subsets are enumerated in numpy; their boost sweep runs
    on ``device`` (``boost_scan`` on the card, its twin on the CPU).
    Returns ``(selected [N] bool, count, objective)`` in numpy."""
    dev = resolve_device(device)
    gamma, mu, a = (np.asarray(x, np.float32) for x in (gamma, mu, a))
    active, budget = np.asarray(active, bool), np.asarray(budget, np.float32)
    N = mu.shape[0]
    idxs = np.flatnonzero(active)
    n = idxs.size
    if n > 16:
        raise ValueError(f"exact_pack enumerates 2^{n} subsets; N_active "
                         "must be <= 16")
    bits = np.arange(1 << n)
    sels = np.zeros((1 << n, N), bool)
    sels[:, idxs] = (bits[:, None] >> np.arange(n)) & 1
    used = sels.astype(gamma.dtype) @ gamma                       # [S, K]
    feasible = (used <= budget + _FEAS).all(axis=1)
    objs = _batched_boost_objective(
        *(torch.from_numpy(x).to(dev)
          for x in (gamma, mu, a, active, sels, budget)),
        kappa_max).cpu().numpy().astype(np.float64)
    counts = sels.sum(axis=1)
    key = np.where(feasible, counts * 1.0, -1.0)
    best_count = int(key.max())
    if best_count < 0:        # no feasible subset (a negative budget)
        return np.zeros(N, bool), 0, -np.inf
    cand = feasible & (counts == best_count)
    best_obj = objs[cand].max()
    best = int(np.flatnonzero(cand & (objs >= best_obj))[0])
    return sels[best], best_count, float(objs[best])
