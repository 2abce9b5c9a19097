"""DPBalance sequential allocation (paper Algorithm 1).

Round flow:
  1. per-analyst aggregates (gamma_i, mu_i, a_i)                   [demand.py]
  2. SP1: alpha-fair analyst allocation via Lagrange dual ascent   [waterfill.py]
  3. SP2: per-analyst greedy cover + swap refine + kappa boost     [packing.py]
  4. return unused budget to the pool (one-or-more, Alg.1 l.4/7)
  5. metrics: dominant efficiency (Eq 8), dominant fairness (Eq 9),
     platform utility (Eq 10), #allocated pipelines, leftover.

:func:`schedule_round` runs on the device of its input tensors; on a CUDA
device every hot-path sweep is a Hopper kernel.  With a leading episode
axis on its inputs it runs one lockstep round of a fleet
(``run_fleet(mode="vmap")``): SP1 keeps the episodes as a batch axis (it
couples each episode's analysts through its block capacity), SP2 folds
them into the analyst axis (independent per analyst once SP1 has fixed its
budget vector), and every kernel launch covers the whole fleet; each
episode's result is bitwise its lone round's.  With a sharded
``block_axis`` (:mod:`repro_torch.shard`) the demand and capacity operands
are the caller's block stripes; every per-block sweep stays stripe-local
and only the analyst-level aggregates cross the stripes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..fp import fma, seq_dot
from . import demand as dm
from . import utility as ut
from .blockaxis import LOCAL, BlockAxis
from .packing import pack_all, pack_all_pruned
from .waterfill import alpha_fair_waterfill

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    beta: float = 2.2               # fairness preference (paper Q2 knob)
    lam: Optional[float] = None     # efficiency preference; default (beta-1)/beta
    tau: float = 100.0              # waiting-time decay T(t) = exp(-t/tau)
    kappa_max: float = 2.0          # cap on the one-or-more boost
    weighted_constraints: bool = False  # paper's literal Eq 14
    refine: bool = True             # SP2 single-swap refinement
    incremental_swap: bool = True   # compacted swap engine (core/swap.py);
                                    # False = O(N^3 K) reference path
    solver_iters: int = 4000
    solver_tol: float = 1e-6
    swap_beam: int = 0              # >0: certified top-k pruning of the swap
                                    # sweep (core/swap.py): evaluate only the
                                    # `swap_beam` best-bounded candidates, and
                                    # rerun the full sweep when the exactness
                                    # certificate fails; same result either way
    sp1_warm_start: bool = False    # carry SP1 duals across rounds
                                    # (``rnd.lam`` in, ``sp1_lam`` out) with
                                    # the adaptive ascent step

    def effective_lambda(self) -> float:
        return ut.default_lambda(self.beta) if self.lam is None else self.lam


class RoundResult(NamedTuple):
    # one round's shapes; a lockstep fleet's carry a leading episode axis
    # (a scalar becomes [E])
    x_analyst: torch.Tensor    # [M] SP1 ratios
    x_pipeline: torch.Tensor   # [M, N] final per-pipeline ratios (0 or >= 1)
    selected: torch.Tensor     # [M, N] bool
    grants: torch.Tensor       # [M, N, K] epsilon actually granted
    consumed: torch.Tensor     # [K] epsilon consumed from each block
    utility: torch.Tensor      # [M] analyst utilities U_i
    efficiency: torch.Tensor   # scalar Eq 8
    fairness: torch.Tensor     # scalar Eq 9
    platform: torch.Tensor     # scalar Eq 10
    jain: torch.Tensor         # scalar auxiliary Jain index
    n_allocated: torch.Tensor  # scalar int32 pipelines granted
    leftover: torch.Tensor     # [K] remaining capacity after the round
    sp1_violation: torch.Tensor
    # observability extras: intermediates the round computes anyway
    sp1_iters: Optional[torch.Tensor] = None      # scalar int32
    mu_real: Optional[torch.Tensor] = None        # [M] realized dominant share
    sp2_objective: Optional[torch.Tensor] = None  # [M] boosted Eq-20 objective
    sp2_water: Optional[torch.Tensor] = None      # [M] post-boost min leftover
    swap_accepted: Optional[torch.Tensor] = None  # [M] bool: swap refine fired
    grant_scale: Optional[torch.Tensor] = None    # scalar overdraw-guard scale
    swap_cert_ok: Optional[torch.Tensor] = None      # scalar bool (beam only)
    swap_cert_margin: Optional[torch.Tensor] = None  # scalar (beam only)
    sp1_lam: Optional[torch.Tensor] = None  # [K] final duals (warm start only)


def schedule_round(rnd: dm.RoundInputs, cfg: SchedulerConfig,
                   block_axis: BlockAxis = LOCAL) -> RoundResult:
    """One DPBalance round on the device of ``rnd``'s tensors.

    ``rnd.weight`` (optional [M] tier weight) folds into ``a_i``, so SP1 and
    the Eq 8-10 metrics are tier-weighted; SP2's per-pipeline ``a_ij``
    stays unweighted (a common factor within one analyst).  A leading
    episode axis on ``rnd`` runs a fleet's lockstep round."""
    lead = rnd.fleet_axes(block_axis)
    gamma = dm.normalized_demand(rnd.demand, rnd.budget_total)
    mu_ij = dm.pipeline_max_share(gamma, block_axis)

    # Pipelines demanding exhausted blocks can never satisfy one-or-more:
    # mask them out of this round (they stay pending for the next).
    cap_frac = rnd.capacity / torch.clamp(rnd.budget_total, min=_EPS)
    active = rnd.active & ~dm.infeasible_pipelines(gamma, cap_frac,
                                                   block_axis=block_axis)
    rnd = dataclasses.replace(rnd, active=active)

    view = dm.AnalystView.build(rnd, cfg.tau, block_axis)

    # SP1 -- analyst-level alpha-fair allocation.
    c = (view.gamma_i * view.a_i[..., None] if cfg.weighted_constraints
         else view.gamma_i)
    warm = cfg.sp1_warm_start
    sp1 = alpha_fair_waterfill(
        view.mu_i, view.a_i, c, view.mask, cap=cap_frac, beta=cfg.beta,
        max_iters=cfg.solver_iters, tol=cfg.solver_tol,
        lam0=rnd.lam if warm else None, adaptive=warm,
        block_axis=block_axis)
    budget_i = view.gamma_i * sp1.x[..., None]        # [M, K] granted vectors

    # SP2 -- per-analyst packing; per-pipeline weights a_ij = T(t_ij) l_ij.
    # A fleet's episodes fold into the analyst axis (E * M rows).
    T_ij = dm.waiting_coefficient(rnd.arrival, rnd.now, cfg.tau)
    a_ij = T_ij * rnd.loss
    M, N, K = rnd.demand.shape[-3:]
    sp2 = [t.reshape(-1, *t.shape[len(lead) + 1:])
           for t in (gamma, mu_ij, a_ij, active, budget_i)]
    if cfg.swap_beam > 0 and cfg.refine and cfg.incremental_swap:
        pack, cert_ok, cert_margin = pack_all_pruned(
            *sp2, cfg.kappa_max, cfg.swap_beam, block_axis,
            episodes=lead[0] if lead else None)
    else:
        pack = pack_all(*sp2, cfg.kappa_max, cfg.refine,
                        cfg.incremental_swap, block_axis)
        cert_ok = cert_margin = None
    pack = type(pack)(*(t.reshape(*lead, M, *t.shape[1:]) for t in pack))

    x_ij = pack.x_ij
    grants = rnd.demand * x_ij[..., None]             # epsilon units
    consumed = seq_dot(rnd.demand.reshape(*lead, M * N, K),
                       x_ij.reshape(*lead, M * N, 1), -2)
    # Safety: never overdraw physical capacity (numerical guard).
    over = consumed > fma(rnd.capacity, 1.0 + 1e-6, 1e-7)
    scale = torch.where(over, rnd.capacity / torch.clamp(consumed, min=_EPS),
                        torch.ones_like(consumed))
    grant_scale = block_axis.min(torch.amin(scale, dim=-1))
    grants = grants * grant_scale[..., None, None, None]
    consumed = consumed * grant_scale[..., None]
    leftover = torch.clamp(rnd.capacity - consumed, min=0.0)

    # Metrics -- realized dominant share per analyst after SP2 + returns.
    realized = seq_dot(gamma, x_ij[..., None], -2)              # [M, K]
    mu_real = block_axis.max(torch.amax(realized, dim=-1))      # mu_i * x_i
    util = mu_real * view.a_i * view.mask
    return RoundResult(
        x_analyst=sp1.x, x_pipeline=x_ij, selected=pack.selected,
        grants=grants, consumed=consumed, utility=util,
        efficiency=ut.dominant_efficiency(util, view.mask),
        fairness=ut.dominant_fairness(util, cfg.beta, view.mask),
        platform=ut.platform_utility(util, cfg.beta, cfg.effective_lambda(),
                                     view.mask),
        jain=ut.jain_index(util, view.mask),
        n_allocated=torch.sum(pack.selected, dim=(-2, -1)).to(torch.int32),
        leftover=leftover, sp1_violation=sp1.violation,
        sp1_iters=sp1.iters, mu_real=mu_real, sp2_objective=pack.objective,
        sp2_water=pack.water, swap_accepted=pack.swapped,
        grant_scale=grant_scale, swap_cert_ok=cert_ok,
        swap_cert_margin=cert_margin, sp1_lam=sp1.lam if warm else None)
