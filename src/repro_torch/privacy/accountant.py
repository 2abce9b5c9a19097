"""RDP accountant bridging scheduler grants and DP-SGD noise.

Given a pipeline's granted budget eps_rdp on each block and its planned number
of FL rounds, the accountant derives the Gaussian noise multiplier sigma the
DP-SGD trainer must use so that the pipeline's total RDP cost stays within its
grant (sequential composition over rounds), and certifies the resulting
(eps, delta)-DP at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .rdp import (DEFAULT_ORDERS, best_dp_over_orders, gaussian_rdp,
                  sigma_for_rdp_budget, subsampled_gaussian_rdp)


@dataclasses.dataclass
class RdpAccountant:
    """Tracks composed RDP across a full order grid for one training job."""

    alpha_star: float = 8.0                  # scheduling order (grants are
                                             # epsilon at this single order)
    orders: np.ndarray = dataclasses.field(
        default_factory=lambda: DEFAULT_ORDERS.copy())
    _ledger: np.ndarray = dataclasses.field(default=None)

    def __post_init__(self):
        if self._ledger is None:
            self._ledger = np.zeros_like(self.orders, dtype=np.float64)

    # --------------------------------------------------------------- planning
    def sigma_for_grant(self, eps_grant: float, rounds: int) -> float:
        """Noise multiplier so `rounds` Gaussian steps compose within the grant
        at the scheduling order alpha*."""
        return float(sigma_for_rdp_budget(eps_grant, self.alpha_star, rounds))

    def step_cost(self, sigma: float, q: Optional[float] = None) -> float:
        """RDP cost of one DP-SGD round at alpha* (with optional subsampling)."""
        if q is None:
            return float(gaussian_rdp(sigma, self.alpha_star))
        return float(subsampled_gaussian_rdp(sigma, q, self.alpha_star))

    # -------------------------------------------------------------- recording
    def record_step(self, sigma: float, q: Optional[float] = None) -> None:
        if q is None:
            self._ledger += np.asarray(gaussian_rdp(sigma, self.orders))
        else:
            self._ledger += np.asarray(
                subsampled_gaussian_rdp(sigma, q, self.orders))

    @property
    def spent_at_alpha_star(self) -> float:
        idx = int(np.argmin(np.abs(self.orders - self.alpha_star)))
        return float(self._ledger[idx])

    def certify(self, delta: float = 1e-5):
        """Tightest (eps, delta)-DP over the order grid."""
        eps, alpha = best_dp_over_orders(self._ledger, self.orders, delta)
        return float(eps), float(alpha)
