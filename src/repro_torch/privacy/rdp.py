"""Renyi differential privacy primitives (paper §III-A, Defs 1-4).

The FLaaS platform accounts privacy in (alpha, eps)-RDP [Mironov'17].  The
training substrate adds Gaussian noise to clipped per-example gradients
(DP-SGD); each application of the Gaussian mechanism with noise multiplier
sigma costs eps(alpha) = alpha / (2 sigma^2) at Renyi order alpha.  RDP
composes additively over sequential uses (Def 4) and takes the max over
disjoint data (Def 3) -- exactly the bounded+additive structure that lets
the scheduler treat privacy as a consumable resource.

Host numpy, in float32: ``repro`` computes these in jnp, and with JAX's
default (``jax_enable_x64`` off) every input -- Python floats and the
float64 ``DEFAULT_ORDERS`` alike -- becomes float32.  The port repeats
that rounding, so ``gaussian_rdp``, ``subsampled_gaussian_rdp`` and
``sigma_for_rdp_budget`` (IEEE-rounded ``*``, ``/``, ``sqrt``) equal
``repro``'s bit for bit, and so does every cost an ``RdpAccountant``
adds to its float64 ledger.  ``rdp_to_dp`` also takes a float32 ``log``,
whose last bit differs between libraries: within 1e-6 relative.
"""
from __future__ import annotations

import numpy as np

# Standard order grid (Opacus/TF-Privacy style) + a few low orders.
DEFAULT_ORDERS = np.array(
    [1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0,
     16.0, 20.0, 24.0, 32.0, 48.0, 64.0], dtype=np.float64)

_F32 = np.float32


def _f32(x):
    return np.asarray(x, dtype=_F32)


def gaussian_rdp(sigma, alpha):
    """RDP of the Gaussian mechanism with sensitivity 1: eps = alpha/(2 sigma^2)."""
    sigma = _f32(sigma)
    return _f32(alpha) / (_F32(2.0) * (sigma * sigma))


def subsampled_gaussian_rdp(sigma, q, alpha):
    """Upper bound on RDP of the Poisson-subsampled Gaussian mechanism.

    Uses the standard 'q^2 alpha / sigma^2' regime bound valid for
    q <= 1/5, sigma >= 4 and alpha bounded by sigma^2 L / 2 (Abadi-style
    moments-accountant asymptotics); falls back to the unsubsampled bound
    where that regime does not apply.  Tight numerical accountants exist but
    this closed form is what budget *scheduling* needs: a monotone,
    composable per-step cost.
    """
    sigma, q, alpha = _f32(sigma), _f32(q), _f32(alpha)
    amplified = _F32(3.5) * (q * q) * alpha / (sigma * sigma)
    plain = gaussian_rdp(sigma, alpha)
    regime = (q <= _F32(0.2)) & (sigma >= _F32(1.0))
    return np.where(regime, np.minimum(amplified, plain), plain)


def rdp_to_dp(eps_rdp, alpha, delta):
    """Convert (alpha, eps)-RDP to (eps, delta)-DP:
    eps_dp = eps_rdp + log(1/delta) / (alpha - 1)."""
    return _f32(eps_rdp) + np.log(_f32(1.0 / delta)) / (_f32(alpha)
                                                        - _F32(1.0))


def sigma_for_rdp_budget(eps_rdp, alpha, steps: int = 1):
    """Smallest Gaussian noise multiplier whose `steps`-fold composition stays
    within an (alpha, eps_rdp) budget: sigma = sqrt(steps * alpha / (2 eps))."""
    eps_rdp = np.maximum(_f32(eps_rdp), _F32(1e-12))
    return np.sqrt(_F32(steps) * _f32(alpha) / (_F32(2.0) * eps_rdp))


def best_dp_over_orders(eps_rdp_per_order, orders, delta):
    """Given composed RDP at each order, report the tightest (eps, delta)-DP."""
    eps = rdp_to_dp(eps_rdp_per_order, orders, delta)
    idx = int(np.argmin(eps))
    return eps[idx], _f32(orders)[idx]
