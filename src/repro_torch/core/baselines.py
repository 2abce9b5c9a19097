"""Baseline privacy-budget schedulers from the paper's evaluation (§VI):

* DPF  [Luo et al., OSDI'21] -- grant the pending pipeline with the smallest
  dominant share first (max-min fairness at the pipeline level).
* DPK  [Tholoniat et al., "Packing privacy budget"] -- grant the pipelines
  with the smallest total normalized demand first (packing oriented).
* FCFS -- grant in arrival order.

All three grant whole pipelines (x_ij = 1, no boost), as the paper
characterises them in Fig. 2, and return the DPBalance ``RoundResult``
schema so every metric compares directly.  The grant-if-fits sweep visits
all M * N pipelines in one order across analysts.  On a sharded
``block_axis`` the sort key is finished across stripes first, so the visit
order is the same on every stripe, and the sweep batches its cross-stripe
fits checks (:func:`~repro_torch.core.blockaxis.grant_fits_scan`).

A lockstep fleet's round (a leading episode axis on the round's inputs)
sorts each episode's pipelines by its own keys and runs one sweep of M * N
visit steps for the whole fleet; every output gains the episode axis.
"""
from __future__ import annotations

import dataclasses

import torch

from ..fp import seq_dot, tree_sum
from . import demand as dm
from . import utility as ut
from .blockaxis import LOCAL, BlockAxis, grant_fits_scan
from .scheduler import RoundResult, SchedulerConfig

_EPS = 1e-9
_FEAS = 1e-6
_BIG = 1e30


def _sequential_grant(rnd: dm.RoundInputs, cfg: SchedulerConfig,
                      key_fn, block_axis: BlockAxis = LOCAL) -> RoundResult:
    """Flatten the pipelines, sort them by ``key_fn`` ascending (stable:
    ties keep index order, as ``jnp.argsort``), grant each that fits."""
    lead = rnd.fleet_axes(block_axis)
    M, N, K = rnd.demand.shape[-3:]
    gamma = dm.normalized_demand(rnd.demand, rnd.budget_total)
    mu_ij = dm.pipeline_max_share(gamma, block_axis)
    cap_frac = rnd.capacity / torch.clamp(rnd.budget_total, min=_EPS)

    active = rnd.active & ~dm.infeasible_pipelines(gamma, cap_frac, _FEAS,
                                                   block_axis)
    key = key_fn(rnd, gamma, mu_ij, block_axis)             # [M, N]
    key = torch.where(active, key, torch.full_like(key, _BIG)).reshape(
        *lead, M * N)
    order = torch.argsort(key, dim=-1, stable=True)
    # pre-permuted into visit order
    g_ord = torch.take_along_dim(gamma.reshape(*lead, M * N, K),
                                 order[..., None], dim=-2)
    a_ord = torch.gather(active.reshape(*lead, M * N), -1, order)

    _, taken = grant_fits_scan(g_ord, a_ord, cap_frac, _FEAS, block_axis)
    sel = torch.zeros_like(a_ord).scatter_(-1, order, taken).reshape(
        *lead, M, N)
    x_ij = sel.to(gamma.dtype)

    grants = rnd.demand * x_ij[..., None]
    consumed = seq_dot(rnd.demand.reshape(*lead, M * N, K),
                       x_ij.reshape(*lead, M * N, 1), -2)
    leftover = torch.clamp(rnd.capacity - consumed, min=0.0)

    # the masked round keeps the optional tier weight, so the Eq 8-10
    # metrics are weighted like DPBalance's (the grant order is not)
    view = dm.AnalystView.build(dataclasses.replace(rnd, active=active),
                                cfg.tau, block_axis)
    realized = seq_dot(gamma, x_ij[..., None], -2)
    mu_real = block_axis.max(torch.amax(realized, dim=-1))
    util = mu_real * view.a_i * view.mask
    return RoundResult(
        x_analyst=torch.zeros_like(mu_real), x_pipeline=x_ij, selected=sel,
        grants=grants, consumed=consumed, utility=util,
        efficiency=ut.dominant_efficiency(util, view.mask),
        fairness=ut.dominant_fairness(util, cfg.beta, view.mask),
        platform=ut.platform_utility(util, cfg.beta, cfg.effective_lambda(),
                                     view.mask),
        jain=ut.jain_index(util, view.mask),
        n_allocated=torch.sum(sel, dim=(-2, -1)).to(torch.int32),
        leftover=leftover,
        sp1_violation=torch.zeros(lead, dtype=gamma.dtype,
                                  device=gamma.device),
        # no SP1/SP2 stages: only the realized dominant share is meaningful
        mu_real=mu_real)


def _dpf_key(rnd, gamma, mu_ij, block_axis=LOCAL):
    return mu_ij                                   # smallest dominant share


def _dpk_key(rnd, gamma, mu_ij, block_axis=LOCAL):
    # total normalized demand, summed in XLA's order: it is a sort key
    return block_axis.sum(tree_sum(gamma, -1))     # lowest demand packs first


def _fcfs_key(rnd, gamma, mu_ij, block_axis=LOCAL):
    return rnd.arrival                             # earliest arrival first


def dpf_round(rnd: dm.RoundInputs, cfg: SchedulerConfig,
              block_axis: BlockAxis = LOCAL) -> RoundResult:
    return _sequential_grant(rnd, cfg, _dpf_key, block_axis)


def dpk_round(rnd: dm.RoundInputs, cfg: SchedulerConfig,
              block_axis: BlockAxis = LOCAL) -> RoundResult:
    return _sequential_grant(rnd, cfg, _dpk_key, block_axis)


def fcfs_round(rnd: dm.RoundInputs, cfg: SchedulerConfig,
               block_axis: BlockAxis = LOCAL) -> RoundResult:
    return _sequential_grant(rnd, cfg, _fcfs_key, block_axis)
