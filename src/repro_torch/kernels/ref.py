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
``swap_eval_ref``.  ``dual_ascent_ref`` run over the card's ``dual_step``
is bitwise the card's ``dual_ascent``.  ``matvec_ref`` and the ``x`` of
``dual_step_ref`` hold to 1e-5 relative: their K-long sums are tree
reductions whose order is the device's, and ``pow`` differs by an ulp
between libraries.

DP clip: ``clip_accumulate_ref`` is bitwise the kernel's (rows in order,
each step a correctly rounded FMA, :func:`repro_torch.fp.fma_exact`);
``rownorms_ref`` sums each row in the device library's order, and the
kernel's chunked sum agrees with it to 1e-5 relative.

Attention (``csrc/attention.cu``): ``flash_attention_ref`` and
``decode_attention_ref`` are ``repro``'s oracles in the port's layouts
(heads inside a position's row): the whole score matrix, masked with
-1e30, a float32 softmax, GQA by head grouping.  The kernels' online
softmax sums in another order and holds to rtol = atol = 2e-5, the bound
``repro`` holds its Pallas attention kernels to.  Both take any floating
dtype: bfloat16 operands are read as float32, the arithmetic is float32
and the output is rounded once to the input's dtype, as ``repro``'s
Pallas kernels store it; the bfloat16 kernels hold to one bfloat16 ulp of
their twin's output plus that float32 bound.

RG-LRU (``csrc/rg_lru.cu``): ``rglru_scan_ref`` runs the recurrence in
time order, each step one correctly rounded FMA
(:func:`repro_torch.fp.fma_exact`), bitwise what ``repro``'s ``lax.scan``
oracle, its Pallas kernel and the CUDA kernel's ``__fmaf_rn`` give.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..fp import fma, fma_exact, pow_runs, seq_dot

DUAL_EPS = 1e-12
BOOST_EPS = 1e-9


def rowmax_ref(gamma: torch.Tensor) -> torch.Tensor:
    """mu_i = max_k gamma_ik.  [M, K] -> [M]."""
    return torch.amax(gamma.float(), dim=-1)


def matvec_ref(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y_i = sum_k c_ik v_k.  [M, K] x [K] -> [M], or per episode of a
    fleet, [E, M, K] x [E, K] -> [E, M].

    One ``c @ v`` per episode, each on operands of their own: the CPU's
    BLAS may sum in an order that depends on where its operands sit in
    memory, so an episode's slice is copied out first and rounds as a
    lone call on fresh tensors does."""
    c, v = c.float(), v.float()
    if c.dim() == 2:
        return c @ v
    M, K = c.shape[-2:]
    return torch.stack([ci.clone() @ vi.clone() for ci, vi in
                        zip(c.reshape(-1, M, K), v.reshape(-1, K))]
                       ).reshape(c.shape[:-1])


def matvec_t_ref(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """load_k = sum_i c_ik x_i, rows 0..M-1 in order, one FMA each (what
    XLA emits for ``x @ c``).  [M, K] x [M] -> [K], or per episode [E, M,
    K] x [E, M] -> [E, K]."""
    return seq_dot(c.float(), x.float()[..., None], -2)


def dual_residual_ref(c, x, cap, cap_safe) -> torch.Tensor:
    """g_k = (sum_i c_ik x_i - cap_k) / cap_safe_k, the load row-ordered."""
    return (matvec_t_ref(c, x) - cap.float()) / cap_safe.float()


def dual_step_ref(c, lam, w_pow, xcap, mask, cap, cap_safe, beta: float):
    """One SP1 dual-ascent sweep (``repro``'s ``dual_step_ref``):
    ``x_i = min((w_pow_i / max(sum_k c_ik lam_k, 1e-12))^(1/beta), xcap_i)``
    where ``mask`` is set, else 0, and ``g`` from :func:`dual_residual_ref`.
    Returns ``(x [M], g [K])``; with a leading fleet axis ``(x [E, M], g
    [E, K])``, each episode's bitwise its lone call's."""
    denom = torch.clamp(matvec_ref(c, lam), min=DUAL_EPS)
    x = pow_runs(w_pow.float() / denom, 1.0 / float(beta), 1)
    x = torch.minimum(x, xcap.float())
    x = torch.where(mask.bool(), x, torch.zeros_like(x))
    return x, dual_residual_ref(c, x, cap, cap_safe)


def kkt_error(lam_new, g) -> torch.Tensor:
    """KKT error max(primal infeasibility, complementary slackness) over
    the last axis (one per episode of a fleet)."""
    feas = torch.amax(torch.clamp(g, min=0.0), dim=-1)
    comp = torch.amax(lam_new * torch.abs(g), dim=-1)
    return torch.maximum(feas, comp)


def decay_eta(it: int) -> np.float32:
    """The cold ascent's step at iteration ``it``, ``0.5 / (1 + 0.001
    it)`` in float32 with XLA's rounding (it fuses ``1 + 0.001 * it``)."""
    F32 = np.float32
    return F32(0.5) / F32(np.float64(F32(0.001)) * it + 1.0)


def adapt_eta(eta, viol: float, viol_prev):
    """The adaptive step after an iteration whose KKT error is ``viol``:
    grown x1.2 while the error does not rise, else shrunk x0.7, kept in
    [0.2, 1.5], in float32.  Returns ``(eta, viol_prev)`` for the next."""
    F32 = np.float32
    eta = (min(eta * F32(1.2), F32(1.5)) if F32(viol) <= viol_prev
           else max(eta * F32(0.7), F32(0.2)))
    return eta, F32(viol)


def dual_ascent_ref(c, lam, w_pow, xcap, mask, cap, cap_safe, beta: float,
                    *, adaptive: bool, max_iters: int, tol: float,
                    step=dual_step_ref):
    """The SP1 dual ascent from ``lam`` (``repro``'s ``lax.while_loop`` in
    ``alpha_fair_waterfill``): ``(lam [K], iters)``, ``iters`` an int32
    scalar; over a leading fleet axis ``(lam [E, K], iters [E])``.

    Each iteration is one ``step`` (:func:`dual_step_ref`, or the card's
    ``dual_step`` launcher to replay the per-iteration loop there), then
    ``lam = clamp(lam * exp(eta * g), 1e-12, 1e12)`` and the KKT error;
    the stop rule ``it < max_iters and error > tol`` is checked on the host
    every iteration (one device sync each, for all episodes at once), so
    the iteration count is ``repro``'s exactly.  The step size is host
    arithmetic in float32 with ``repro``'s rounding: ``0.5 / (1 + 0.001
    it)``, or with ``adaptive`` 0.5 grown x1.2 while the error does not
    rise, else shrunk x0.7, kept in [0.2, 1.5] (:func:`decay_eta`,
    :func:`adapt_eta`).

    Episodes of a fleet keep their own count, step and stop rule, as under
    ``jax.vmap`` of the loop: an episode that has stopped is frozen (its
    lam and count no longer change) while the others iterate, so each
    episode's lam and count are those of its lone loop."""
    F32 = np.float32
    tol32 = float(F32(tol))
    batch = tuple(c.shape[:-2])
    n = int(np.prod(batch, dtype=np.int64))
    it = np.zeros(n, np.int64)
    run = np.full(n, max_iters > 0)
    eta = np.full(n, F32(0.5), F32)
    viol_prev = np.full(n, np.inf, F32)
    while run.any():
        _, g = step(c, lam, w_pow, xcap, mask, cap, cap_safe, beta)
        if not adaptive:      # every running episode is at iteration it
            eta[run] = decay_eta(int(it[run][0]))
        new = torch.clamp(
            lam * torch.exp(torch.as_tensor(eta, device=lam.device)
                            .reshape(*batch, 1) * g), 1e-12, 1e12)
        viol = kkt_error(new, g).reshape(-1).cpu().numpy()
        lam = torch.where(torch.as_tensor(run, device=lam.device)
                          .reshape(*batch, 1), new, lam)
        it[run] += 1
        if adaptive:
            for e in np.flatnonzero(run):
                eta[e], viol_prev[e] = adapt_eta(eta[e], float(viol[e]),
                                                 viol_prev[e])
        run &= (it < max_iters) & (viol.astype(np.float64) > tol32)
    return lam, torch.as_tensor(it.astype(np.int32).reshape(batch),
                                device=lam.device)


def boost_sweep_ref(g_ord, sel, left, kappa_max: float, reduce=None):
    """The SP2 boost sweep for a stack of selections sharing demand rows.

    ``g_ord [B, N, K]`` visit-ordered demand rows, ``sel [B, C, N]``
    selections (nonzero = selected), ``left [B, C, K]`` initial leftovers.
    Visits rows in order; a selected row j gets ``extra = clip(min over
    live k of left_k / g_jk, 0, kappa_max - 1)`` and ``left -= extra *
    g_j`` as one FMA.  ``reduce`` finishes each visit's min over block
    stripes (``BlockAxis.min``).  Returns ``(extras [B, C, N], left_after
    [B, C, K])``."""
    g = g_ord.float()
    left = left.float()
    on = sel != 0
    inf = torch.tensor(float("inf"), device=g.device)
    extras = []
    for j in range(g.shape[-2]):
        dem = g[:, None, j, :]                                   # [B,1,K]
        ratio = torch.where(dem > BOOST_EPS,
                            left / torch.clamp(dem, min=BOOST_EPS), inf)
        water = torch.amin(ratio, dim=-1)
        if reduce is not None:
            water = reduce(water)
        extra = torch.clamp(water, 0.0, kappa_max - 1.0)
        extra = torch.where(on[..., j], extra, torch.zeros_like(extra))
        left = fma(-extra[..., None], dem, left)
        extras.append(extra)
    return torch.stack(extras, dim=-1), left


def boost_scan_ref(g_ord, sel_ord, leftover, kappa_max: float,
                   reduce=None):
    """``repro``'s ``boost_scan_ref`` with optional leading batch dims:
    ``g_ord [..., N, K]``, ``sel_ord [..., N]``, ``leftover [..., K]`` ->
    ``(extras [..., N], leftover_after [..., K])``."""
    batch = g_ord.shape[:-2]
    N, K = g_ord.shape[-2:]
    extras, left = boost_sweep_ref(g_ord.reshape(-1, N, K),
                                   sel_ord.reshape(-1, 1, N),
                                   leftover.reshape(-1, 1, K), kappa_max,
                                   reduce)
    return extras.reshape(*batch, N), left.reshape(*batch, K)


def swap_eval_ref(g_ord, sel_c, leftover_c, kappa_max: float,
                  reduce=None):
    """``repro``'s ``swap_eval_ref`` with optional leading batch dims:
    ``g_ord [..., N, K]``, ``sel_c [..., C, N]``, ``leftover_c [..., C,
    K]`` -> ``extras [..., C, N]``."""
    batch = g_ord.shape[:-2]
    N, K = g_ord.shape[-2:]
    C = sel_c.shape[-2]
    extras, _ = boost_sweep_ref(g_ord.reshape(-1, N, K),
                                sel_c.reshape(-1, C, N),
                                leftover_c.reshape(-1, C, K), kappa_max,
                                reduce)
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


_MASKED = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, scale=None):
    """q [B,S,H,dh]; k,v [B,Skv,KH,dh] -> [B,S,H,dh] in q's dtype.  Query
    head h reads kv head h // (H // KH); ``causal`` keeps keys at or before
    the query, ``window`` keys within ``window`` positions of it (query
    and key positions both count from 0).  Skv may differ from S (cross
    attention); the launcher takes that only non-causal without a
    window."""
    B, S, H, dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qf = q.float().reshape(B, S, KH, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, _MASKED))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, H, dh).to(q.dtype)


def decode_attention_ref(q, k, v, cache_len: int, *,
                         window: Optional[int] = None, scale=None):
    """q [B,H,dh]; cache k,v [B,L,KH,dh] -> [B,H,dh] in q's dtype, over the
    first ``cache_len`` positions (and, with ``window``, only those after
    ``cache_len - 1 - window``)."""
    B, H, dh = q.shape
    L, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qf = q.float().reshape(B, KH, G, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float()) * scale
    pos = torch.arange(L, device=q.device)
    mask = pos < cache_len
    if window is not None:
        mask &= pos > cache_len - 1 - window
    s = torch.where(mask, s, torch.full_like(s, _MASKED))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.reshape(B, H, dh).to(q.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t, t = 0..S-1 in order, each step one
    correctly rounded FMA.  a, b [B, S, D] float32; h0 [B, D] (zeros when
    None) -> every h_t, [B, S, D] float32."""
    a, b = a.float(), b.float()
    B, S, D = a.shape
    h = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = fma_exact(a[:, t], h, b[:, t])
        out[:, t] = h
    return out
