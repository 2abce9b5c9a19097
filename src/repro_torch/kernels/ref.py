"""Plain PyTorch twins of the Hopper kernels.

Each function is the contract its CUDA kernel in ``csrc/budget_alloc.cu``
or ``csrc/dp_clip_noise.cu`` must meet, and the code that runs for a CPU
tensor.  They mirror
``repro/kernels/ref.py`` (the TPU kernels' oracles) operation for
operation, with XLA's rounding rules made explicit (see
:mod:`repro_torch.fp`): every ``a * b + c`` update is one fused
multiply-add, computed in float64 and rounded once to float32 -- exact
except for double rounding on a float32 halfway case -- and the row-ordered
loads accumulate in index order.

Bitwise contracts (kernel == twin == ``repro``): ``rowmax_ref``,
``matvec_t_ref`` (``repro``'s jnp ``x @ c``), ``dual_residual_ref`` (the
``g`` of ``dual_step_ref`` given ``x``), ``boost_scan_ref`` and
``swap_eval_ref``.  ``matvec_ref`` and the ``x`` of ``dual_step_ref`` hold
to 1e-5 relative: their K-long sums are tree reductions whose order is
the device's, and ``pow`` differs by an ulp between libraries.

DP clip: ``clip_accumulate_ref`` is bitwise the kernel's (rows in order,
each step a correctly rounded FMA, :func:`repro_torch.fp.fma_exact`);
``rownorms_ref`` sums each row in the device library's order, and the
kernel's chunked sum agrees with it to 1e-5 relative.
"""
from __future__ import annotations

import torch

from ..fp import fma, fma_exact, seq_dot

DUAL_EPS = 1e-12
BOOST_EPS = 1e-9


def rowmax_ref(gamma: torch.Tensor) -> torch.Tensor:
    """mu_i = max_k gamma_ik.  [M, K] -> [M]."""
    return torch.amax(gamma.float(), dim=-1)


def matvec_ref(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y_i = sum_k c_ik v_k.  [M, K] x [K] -> [M]."""
    return c.float() @ v.float()


def matvec_t_ref(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """load_k = sum_i c_ik x_i, rows 0..M-1 in order, one FMA each (what
    XLA emits for ``x @ c``).  [M, K] x [M] -> [K]."""
    return seq_dot(c.float(), x.float()[:, None], 0)


def dual_residual_ref(c, x, cap, cap_safe) -> torch.Tensor:
    """g_k = (sum_i c_ik x_i - cap_k) / cap_safe_k, the load row-ordered."""
    return (matvec_t_ref(c, x) - cap.float()) / cap_safe.float()


def dual_step_ref(c, lam, w_pow, xcap, mask, cap, cap_safe, beta: float):
    """One SP1 dual-ascent sweep (``repro``'s ``dual_step_ref``):
    ``x_i = min((w_pow_i / max(sum_k c_ik lam_k, 1e-12))^(1/beta), xcap_i)``
    where ``mask`` is set, else 0, and ``g`` from :func:`dual_residual_ref`.
    Returns ``(x [M], g [K])``."""
    denom = torch.clamp(matvec_ref(c, lam), min=DUAL_EPS)
    x = (w_pow.float() / denom) ** (1.0 / float(beta))
    x = torch.minimum(x, xcap.float())
    x = torch.where(mask.bool(), x, torch.zeros_like(x))
    return x, dual_residual_ref(c, x, cap, cap_safe)


def boost_sweep_ref(g_ord, sel, left, kappa_max: float):
    """The SP2 boost sweep for a stack of selections sharing demand rows.

    ``g_ord [B, N, K]`` visit-ordered demand rows, ``sel [B, C, N]``
    selections (nonzero = selected), ``left [B, C, K]`` initial leftovers.
    Visits rows in order; a selected row j gets ``extra = clip(min over
    live k of left_k / g_jk, 0, kappa_max - 1)`` and ``left -= extra *
    g_j`` as one FMA.  Returns ``(extras [B, C, N], left_after [B, C,
    K])``."""
    g = g_ord.float()
    left = left.float()
    on = sel != 0
    inf = torch.tensor(float("inf"), device=g.device)
    extras = []
    for j in range(g.shape[-2]):
        dem = g[:, None, j, :]                                   # [B,1,K]
        ratio = torch.where(dem > BOOST_EPS,
                            left / torch.clamp(dem, min=BOOST_EPS), inf)
        extra = torch.clamp(torch.amin(ratio, dim=-1), 0.0, kappa_max - 1.0)
        extra = torch.where(on[..., j], extra, torch.zeros_like(extra))
        left = fma(-extra[..., None], dem, left)
        extras.append(extra)
    return torch.stack(extras, dim=-1), left


def boost_scan_ref(g_ord, sel_ord, leftover, kappa_max: float):
    """``repro``'s ``boost_scan_ref`` with optional leading batch dims:
    ``g_ord [..., N, K]``, ``sel_ord [..., N]``, ``leftover [..., K]`` ->
    ``(extras [..., N], leftover_after [..., K])``."""
    batch = g_ord.shape[:-2]
    N, K = g_ord.shape[-2:]
    extras, left = boost_sweep_ref(g_ord.reshape(-1, N, K),
                                   sel_ord.reshape(-1, 1, N),
                                   leftover.reshape(-1, 1, K), kappa_max)
    return extras.reshape(*batch, N), left.reshape(*batch, K)


def swap_eval_ref(g_ord, sel_c, leftover_c, kappa_max: float):
    """``repro``'s ``swap_eval_ref`` with optional leading batch dims:
    ``g_ord [..., N, K]``, ``sel_c [..., C, N]``, ``leftover_c [..., C,
    K]`` -> ``extras [..., C, N]``."""
    batch = g_ord.shape[:-2]
    N, K = g_ord.shape[-2:]
    C = sel_c.shape[-2]
    extras, _ = boost_sweep_ref(g_ord.reshape(-1, N, K),
                                sel_c.reshape(-1, C, N),
                                leftover_c.reshape(-1, C, K), kappa_max)
    return extras.reshape(*batch, C, N)


def rownorms_ref(g: torch.Tensor) -> torch.Tensor:
    """Squared L2 norm per row.  g [B, P] -> [B] float32."""
    g = g.float()
    return torch.sum(g * g, dim=-1)


def clip_accumulate_ref(g: torch.Tensor, scales: torch.Tensor
                        ) -> torch.Tensor:
    """sum_b scales_b * g_b -> [P] float32: rows 0..B-1 in order, one FMA
    each (the Pallas body ``acc += g * s`` as XLA contracts it)."""
    g, s = g.float(), scales.float()
    acc = torch.zeros(g.shape[1], dtype=torch.float32, device=g.device)
    for b in range(g.shape[0]):
        acc = fma_exact(g[b], s[b].expand_as(acc), acc)
    return acc
