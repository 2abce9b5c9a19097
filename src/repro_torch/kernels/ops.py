"""The public kernel wrappers, ``repro/kernels/ops.py``'s ``*_op`` names,
over the port's kernel modules: each dispatches by the device of its
tensors (the Hopper kernel on a CUDA tensor, its plain twin of
:mod:`repro_torch.kernels.ref` on a CPU tensor), so there is no
``interpret`` flag, and ``repro``'s TPU tile sizes have no counterpart.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .budget_alloc import boost_scan, dual_step, matvec, matvec_t, rowmax
from .decode_attention import decode_attention
from .dp_clip_noise import clip_accumulate, dp_clip_accumulate, rownorms
from .flash_attention import flash_attention
from .rg_lru import rglru_scan


def flash_attention_op(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None):
    return flash_attention(q, k, v, causal=causal, window=window)


def decode_attention_op(q, k, v, cache_len: int, *,
                        window: Optional[int] = None):
    return decode_attention(q, k, v, cache_len, window=window)


def rglru_scan_op(a, b, h0=None):
    return rglru_scan(a, b, h0)


def dp_clip_accumulate_op(g, clip: float):
    return dp_clip_accumulate(g, clip)


def rowmax_op(gamma):
    from ..core import hotpath
    return hotpath.rowmax(gamma)


def matvec_op(c, v):
    from ..core import hotpath
    return hotpath.matvec(c, v)


def boost_scan_op(g_ord, sel_ord, leftover, *, kappa_max: float = 2.0):
    """One analyst's boost sweep, ``g_ord [N, K]``, ``sel_ord [N]`` (bool
    or int), ``leftover [K]`` -> ``(extras [N], leftover_after [K])``, as
    ``repro``'s; leading analyst dims are taken too."""
    from ..core import hotpath
    one = g_ord.dim() == 2
    if one:
        g_ord, sel_ord, leftover = g_ord[None], sel_ord[None], leftover[None]
    left, extras = hotpath.boost_scan(g_ord, sel_ord.to(torch.int32),
                                      leftover, kappa_max)
    return (extras[0], left[0]) if one else (extras, left)


def dual_step_op(c, lam, w_pow, xcap, mask, cap, cap_safe, *,
                 beta: float = 2.2):
    from ..core import hotpath
    return hotpath.dual_step(c, lam, w_pow, beta, xcap, mask, cap, cap_safe)


__all__ = ["flash_attention_op", "decode_attention_op", "rglru_scan_op",
           "dp_clip_accumulate_op", "rowmax_op", "matvec_op",
           "boost_scan_op", "dual_step_op", "ref", "flash_attention",
           "decode_attention", "rglru_scan", "dp_clip_accumulate",
           "rownorms", "clip_accumulate", "rowmax", "matvec", "matvec_t",
           "boost_scan", "dual_step"]
