"""Demand model for privacy-budget scheduling (paper §IV, Defs 5-6).

Shapes (padded, fixed per round): M data analysts, N pipelines per analyst,
K data blocks.  ``demand [M, N, K]`` is the raw privacy demand (epsilon)
pipeline j of analyst i places on block k; ``capacity [K]`` the remaining
budget of each block; gamma = demand / the block's total budget.

A lockstep fleet (``run_fleet(mode="vmap")``) puts E episodes' rounds on a
leading axis of every field (``demand [E, M, N, K]``, ``capacity [E,
K]``, ...; ``now`` stays one scalar); every helper here reduces along axes
counted from the end, so it serves one round and a fleet's alike.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..fp import seq_dot, seq_sum
from . import hotpath
from .blockaxis import LOCAL, BlockAxis

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DemandView:
    """Two-ring residency view of the ``[M, N, B]`` demand tensor.

    The round functions never mutate demand; what varies tick to tick in a
    long-running service is only the *hot ring* -- the stripe of slots the
    current chunk's mints can touch, where retirement wipes stale demand
    columns.  Those wipes are monotone and time-indexed: the entry
    ``(m, n, b)`` is zero at tick ``t`` exactly when slot ``b`` was
    re-minted at some chunk tick ``mint_tick[b] <= t`` and the pipeline
    was submitted before it (``spawn_tick[m, n] < mint_tick[b]``).  So
    ``base`` -- the cold page store, the tensor as it stood at the chunk
    boundary -- stays constant through the chunk, and :meth:`masked`
    rebuilds the tick's effective demand by folding the wipe predicate
    into the activity mask the round applies anyway.  Every value is
    bit-identical to mutating the tensor in place: ``x * 1.0 == x`` and
    ``x * 0.0 == 0.0`` for the nonnegative finite demands.

    ``mint_tick=None`` is the monolithic view (engine episodes, wrap-free
    chunks, the full-tensor carry fallback): ``base`` is already current.
    """

    base: torch.Tensor                         # [M, N, B]
    mint_tick: Optional[torch.Tensor] = None   # [B] i32 chunk mint tick
                                               #   (NEVER if not minted)
    spawn_tick: Optional[torch.Tensor] = None  # [M, N] i32 activation tick
    now_tick: Optional[int] = None             # current tick

    def wiped(self) -> torch.Tensor:
        """[M, N, B] bool -- entries retired by this chunk's mints up to
        (and including) ``now_tick``."""
        mt = self.mint_tick[None, None, :]
        return (mt <= self.now_tick) & (self.spawn_tick[..., None] < mt)

    def masked(self, active: torch.Tensor) -> torch.Tensor:
        """The tick's effective demand: ``base`` with inactive pipelines
        (and, in the two-ring view, retired entries) zeroed, in one
        elementwise pass."""
        m = active[..., None]
        if self.mint_tick is not None:
            m = m & ~self.wiped()
        return self.base * m.to(self.base.dtype)


@dataclasses.dataclass(frozen=True)
class RoundInputs:
    """Everything the scheduler sees for one allocation round, or for one
    lockstep round of a fleet (a leading episode axis on every field but
    ``now``).

    ``weight`` is the optional per-analyst tier weight (it multiplies
    ``a_i``); ``lam`` the previous round's SP1 duals for a warm start."""

    demand: torch.Tensor        # [M, N, K] raw epsilon demand
    active: torch.Tensor        # [M, N] bool -- pipeline exists and is pending
    arrival: torch.Tensor       # [M, N] arrival time (seconds)
    loss: torch.Tensor          # [M, N] matching degree l_ij in (0, 1]
    capacity: torch.Tensor      # [K] remaining budget of each block
    budget_total: torch.Tensor  # [K] the block's total budget
    now: torch.Tensor           # scalar current time (seconds)
    weight: Optional[torch.Tensor] = None  # [M] tier weight (or None)
    lam: Optional[torch.Tensor] = None     # [K] warm-start duals (or None)

    @property
    def shape(self):
        return self.demand.shape

    def fleet_axes(self, block_axis: BlockAxis = LOCAL) -> tuple:
        """The leading fleet axes of this round: ``()`` for one round,
        ``(E,)`` for a lockstep fleet.  A sharded ``block_axis`` takes no
        fleet (``NotImplementedError``: ``repro`` runs no sharded
        fleet)."""
        lead = tuple(self.demand.shape[:-3])
        if lead and block_axis.sharded:
            raise NotImplementedError(
                "a fleet on a sharded block axis: repro runs no sharded "
                "fleet")
        return lead

    @classmethod
    def from_numpy(cls, demand, active, arrival, loss, capacity,
                   budget_total, now, weight=None, lam=None, *,
                   device="cuda") -> "RoundInputs":
        """Build from numpy arrays (or scalars) on ``device``; bool for
        ``active``, float32 for the rest.  Raises ``RuntimeError`` when
        ``device`` is CUDA and CUDA is unavailable."""
        dev = resolve_device(device)

        def f32(a):
            return None if a is None else torch.tensor(
                np.asarray(a, np.float32), device=dev)

        return cls(demand=f32(demand),
                   active=torch.tensor(np.asarray(active, bool),
                                       device=dev),
                   arrival=f32(arrival), loss=f32(loss),
                   capacity=f32(capacity), budget_total=f32(budget_total),
                   now=f32(now), weight=f32(weight), lam=f32(lam))


def normalized_demand(demand, budget_total):
    """gamma_ij^<k> = demand / total block budget (Def 5).  [M, N, K]."""
    return demand / torch.clamp(budget_total, min=_EPS)[..., None, None, :]


def pipeline_max_share(gamma, block_axis: BlockAxis = LOCAL):
    """mu_ij = max_k gamma_ij^<k> (Eq 3).  [M, N]."""
    return block_axis.max(torch.amax(gamma, dim=-1))


def infeasible_pipelines(gamma, cap_frac, slack: float = 1e-6,
                         block_axis: BlockAxis = LOCAL):
    """Pipelines whose demand exceeds remaining capacity on any block (they
    cannot satisfy one-or-more this round).  [M, N] bool."""
    return block_axis.any(
        torch.any(gamma > cap_frac[..., None, None, :] + slack, dim=-1))


def analyst_demand(gamma, active):
    """gamma_i^<k> = sum_j gamma_ij^<k> over active pipelines.  [M, K]."""
    return seq_sum(gamma * active[..., None].to(gamma.dtype), -2)


def analyst_max_share(gamma_i, block_axis: BlockAxis = LOCAL):
    """mu_i = max_k gamma_i^<k> (Eq 4), through the row-max kernel (a
    stripe's row-max finished by the MAX hook).  [M]."""
    return block_axis.max(hotpath.rowmax(gamma_i))


def waiting_coefficient(arrival, now, tau: float):
    """T(t) = exp(-t / tau) of the waiting time (Def 8)."""
    wait = torch.clamp(now - arrival, min=0.0)
    return torch.exp(-wait / tau)


def analyst_waiting(arrival, active, now):
    """Average delay t_i over an analyst's pending pipelines (Def 10)."""
    act = active.to(arrival.dtype)
    wait = torch.clamp(now - arrival, min=0.0) * act
    denom = torch.clamp(seq_sum(act, -1), min=1.0)
    return seq_sum(wait, -1) / denom


def analyst_loss(loss, mu_ij, active):
    """l_i: mu-weighted average of the analyst's matching degrees."""
    w = mu_ij * active.to(mu_ij.dtype)
    denom = torch.clamp(seq_sum(w, -1), min=_EPS)
    return seq_dot(w, loss, -1) / denom


@dataclasses.dataclass(frozen=True)
class AnalystView:
    """Per-analyst aggregates consumed by the SP1 water-filling solver."""

    gamma_i: torch.Tensor   # [M, K] assembled normalized demand
    mu_i: torch.Tensor      # [M] analyst dominant-share coefficient
    a_i: torch.Tensor       # [M] T(t_i) * l_i weight
    mask: torch.Tensor      # [M] analyst has any active demand

    @classmethod
    def build(cls, rnd: RoundInputs, tau: float,
              block_axis: BlockAxis = LOCAL) -> "AnalystView":
        gamma = normalized_demand(rnd.demand, rnd.budget_total)
        mu_ij = pipeline_max_share(gamma, block_axis)
        g_i = analyst_demand(gamma, rnd.active)
        mu_i = analyst_max_share(g_i, block_axis)
        t_i = analyst_waiting(rnd.arrival, rnd.active, rnd.now)
        T_i = torch.exp(-t_i / tau)
        l_i = analyst_loss(rnd.loss, mu_ij, rnd.active)
        a_i = T_i * l_i
        if rnd.weight is not None:
            a_i = a_i * rnd.weight
        mask = torch.any(rnd.active, dim=-1)
        return cls(gamma_i=g_i, mu_i=mu_i, a_i=a_i, mask=mask)
