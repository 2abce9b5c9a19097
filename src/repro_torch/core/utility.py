"""Utility / fairness / efficiency metrics (paper §IV-D/E, Eqs 7-12).

Conventions:

* ``U_i = mu_i * x_i * T(t_i) * l_i`` (Def 8) -- analyst efficiency.
* Dominant efficiency E = sum_i U_i (Def 9, Eq 8).
* Dominant fairness f_beta (Def 10, Eq 9) -- signed; larger is fairer in
  both beta regimes (beta < 1: f in (1, m]; beta > 1: f in (-inf, -m]).
  beta = 1 is a pole of Eq 9 and raises.
* Platform utility Psi_lambda = f_beta * E^lambda (Eq 10).

Every metric reduces the last (analyst) axis, so ``util [E, M]`` gives one
value per episode of a lockstep fleet.  The analyst-axis sums run in index
order (:func:`~repro_torch.fp.seq_sum`, XLA's order for a short axis) and
the powers through :func:`~repro_torch.fp.pow_runs`, so an episode's
metrics are bitwise its lone round's on the CPU and on the card alike.
"""
from __future__ import annotations

import torch

from ..fp import pow_runs, seq_sum

_EPS = 1e-12


def _ones_mask(util):
    return torch.ones_like(util, dtype=torch.bool)


def analyst_utility(mu_i, x_i, a_i):
    """U_i(x_i) = mu_i x_i T(t_i) l_i -- Eq 7 (a_i = T(t_i) l_i)."""
    return mu_i * x_i * a_i


def dominant_efficiency(util, mask=None):
    """Eq 8: platform dominant efficiency = sum of analyst utilities."""
    if mask is not None:
        util = util * mask
    return seq_sum(util, -1)


def dominant_fairness(util, beta: float, mask=None):
    """Eq 9: f_beta(x) = sgn(1-beta) * (sum_i (U_i / sum U)^(1-beta))^(1/beta).

    Masked-out analysts contribute nothing; shares are clamped at 1e-6 so
    a zero-utility analyst under beta > 1 stays finite but penalised."""
    if beta == 1.0:
        raise ValueError("beta = 1 is a pole of Eq. 9 -- nudge it "
                         "(e.g. 1 +/- 1e-3)")
    if mask is None:
        mask = _ones_mask(util)
    mask = mask.to(util.dtype)
    u = util * mask
    total = torch.clamp(seq_sum(u, -1)[..., None], min=_EPS)
    share = torch.clamp(u / total, 1e-6, 1.0)
    powered = torch.where(mask > 0, pow_runs(share, 1.0 - beta, 1),
                          torch.zeros_like(share))
    s = seq_sum(powered, -1)
    sgn = float(torch.sign(torch.tensor(1.0 - beta)))
    return sgn * pow_runs(torch.clamp(s, min=_EPS), 1.0 / beta, 0)


def platform_utility(util, beta: float, lam: float, mask=None):
    """Eq 10: Psi = f_beta(x) * (sum_i U_i)^lambda."""
    f = dominant_fairness(util, beta, mask)
    e = torch.clamp(dominant_efficiency(util, mask), min=_EPS)
    return torch.sign(f) * torch.abs(f) * pow_runs(e, lam, 0)


def alpha_fair_objective(util, beta: float, mask=None):
    """Eq 12: sum_i U_i^(1-beta) / (1-beta); beta = 1 -> sum log U."""
    if mask is None:
        mask = _ones_mask(util)
    u = torch.clamp(util, min=_EPS)
    if abs(beta - 1.0) < 1e-9:
        terms = torch.log(u)
    else:
        terms = u ** (1.0 - beta) / (1.0 - beta)
    return torch.sum(torch.where(mask, terms, torch.zeros_like(terms)),
                     dim=-1)


def normalized_fairness(util, beta: float, mask=None):
    """Signed Eq 9 mapped onto (0, 1], 1 = perfectly fair.

    beta > 1: f in (-inf, -m] -> -m / f;  beta < 1: f in (1, m] -> f / m."""
    if mask is None:
        mask = _ones_mask(util)
    m = torch.clamp(torch.sum(mask.to(util.dtype), dim=-1), min=1.0)
    f = dominant_fairness(util, beta, mask)
    if beta > 1.0:
        return -m / torch.minimum(f, -m)
    return torch.clamp(f / m, 0.0, 1.0)


def jain_index(util, mask=None):
    """Jain's fairness index in [0, 1]; 1 = perfectly fair."""
    if mask is None:
        mask = _ones_mask(util)
    m = mask.to(util.dtype)
    u = util * m
    n = torch.clamp(torch.sum(m, dim=-1), min=1.0)
    num = seq_sum(u, -1) ** 2
    den = torch.clamp(n * seq_sum(u * u, -1), min=_EPS)
    return num / den


def group_fairness(util, beta: float, group_id, n_groups: int, mask=None):
    """Eq 9 restricted to each analyst group (tier) -- ``[n_groups]``."""
    if mask is None:
        mask = _ones_mask(util)
    gids = torch.arange(n_groups, device=util.device)
    gmask = (group_id[None, :] == gids[:, None]) & mask[None, :]
    return torch.stack([dominant_fairness(util, beta, gmask[g])
                        for g in range(n_groups)])


def group_efficiency(util, group_id, n_groups: int, mask=None):
    """Eq 8 per analyst group (tier) -- ``[n_groups]``."""
    if mask is None:
        mask = _ones_mask(util)
    gids = torch.arange(n_groups, device=util.device)
    in_group = (group_id[None, :] == gids[:, None]) & mask[None, :]
    return torch.sum(util[None, :] * in_group, dim=-1)


def default_lambda(beta: float) -> float:
    """lambda = |1-beta|/beta -- Eq 10 reduces to Eq 12 under it."""
    return abs(1.0 - beta) / beta
