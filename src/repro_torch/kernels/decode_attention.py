"""Launcher of the Hopper decode attention kernel (``csrc/attention.cu``,
``att_decode``) and the dispatch the decode step calls.

:func:`decode_attention_cuda` takes CUDA tensors only (q, k and v all
float32 or all bfloat16, contiguous, 16-byte aligned) and raises on
anything else -- a bfloat16 call keeps its split partials float32 and
rounds each output once, in the combine -- and adds one to
``LAUNCHES["decode_attention"]`` per call (two launches on the card: the
splits, then their combination) and leaves the call's grid in
``LAST_GRID["decode_attention"]``.  :func:`decode_attention` picks by the
device of ``q`` alone -- a CPU tensor runs the twin
:func:`repro_torch.kernels.ref.decode_attention_ref`, a CUDA tensor the
kernel -- with no flag and no fallback.  ``cache_len`` is a host int: the
port's decode loop runs on the host.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from .budget_alloc import _check, _on_cuda, _raise_on, _stream
from .build import library
from . import ref

# Kernel launches since the last reset_launches().
LAUNCHES = {"decode_attention": 0}
# The kernel's instantiations: head dim -> query heads per kv head.
GROUPS = {dh: (1, 2, 3, 4, 6, 8) for dh in (16, 32, 64)}
GROUPS[128] = (1, 2, 3, 4, 5, 6, 8, 12)  # qwen2.5-32b 5, starcoder2 12
GROUPS[256] = (10,)                  # recurrentgemma-2b: 10 heads over 1
SMS = 132                            # H100 SXM streaming multiprocessors
NSPLIT_MAX = 64                      # splits per call, at most
# Positions one block takes per loop iteration, by head dim: DecodeMap's
# STEP = NGR * U in csrc/attention.cu (a split is a multiple of it).
STEPS = {16: 256, 32: 128, 64: 64, 128: 32, 256: 16}
# Blocks a kv head's query heads are shared among, by (head dim, G)
# (decode_head_groups in csrc/attention.cu): two at dh 256 (five of
# recurrentgemma-2b's ten heads a block) and past 8 heads (six of
# starcoder2's twelve), else one.
HEAD_GROUPS = {(dh, G): 2 if dh > 128 or G > 8 else 1
               for dh, gs in GROUPS.items() for G in gs}
# The last call's (split, nsplit, blocks, resident blocks per SM).
LAST_GRID: dict[str, tuple[int, int, int, int]] = {}


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0
    LAST_GRID.clear()


def valid_range(cache_len: int, L: int, window: Optional[int]):
    """Positions ``[lo, hi)`` of the cache that the query attends to."""
    hi = int(cache_len)
    if not 1 <= hi <= L:
        raise ValueError(f"cache_len {hi} outside [1, {L}]")
    if window is None:
        return 0, hi
    if int(window) < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    return max(0, hi - int(window)), hi


def split_size(n: int, blocks_per_split: int, residency: int,
               step: int) -> int:
    """Positions per split of ``n`` valid positions: as many splits as
    fit, with ``blocks_per_split`` blocks each, into the ``residency *
    SMS`` blocks the card holds at once (one wave: at B=8 over 32768
    positions a partial second wave cost 17%), at most
    :data:`NSPLIT_MAX`, each a whole number of ``step``-position
    iterations (:data:`STEPS`)."""
    want = max(1, min(NSPLIT_MAX, residency * SMS // max(blocks_per_split, 1)))
    split = max(step, -(-n // want))
    return -(-split // step) * step


@functools.lru_cache(maxsize=None)
def resident_blocks(dh: int, G: int, bf16: bool = False) -> int:
    """Blocks of the split kernel for (dh, G) that one SM holds at once
    (``att_decode_residency``, or ``att_decode_residency_bf16`` for the
    bfloat16 instantiation: registers, shared memory and threads), asked
    of the card once per (dh, G, dtype)."""
    entry = "att_decode_residency" + ("_bf16" if bf16 else "")
    n = getattr(library("attention"), entry)(dh, G)
    if n <= 0:
        raise RuntimeError(f"{entry}({dh}, {G}) returned {n}")
    return n


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache_len: int, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """One query per sequence against a KV cache, on the card: q [B,H,dh],
    k,v [B,L,KH,dh] (the cache's layout) -> [B,H,dh], over the first
    ``cache_len`` positions (with ``window``: the last ``window`` of them).

    Replaces ``repro/kernels/decode_attention.py:decode_attention``.
    Bound: bytes (the K and V rows read).  Design (source header): a block
    per (split of positions, kv head, batch row) serves all H/KH query
    heads of its kv head, so the cache is read once (at dh 256 two blocks
    of five heads each, at dh 128 / G 12 two of six: :data:`HEAD_GROUPS`);
    the splits
    (:func:`split_size`) fill the blocks the card holds at once
    (:func:`resident_blocks`) in one wave, and a second launch merges
    them in order.  Any L."""
    _on_cuda(q, k, v)
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"expected q [B, H, dh] and k [B, L, KH, dh], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, dh = q.shape
    L, KH = k.shape[1], k.shape[2]
    if dh not in GROUPS:
        raise ValueError(f"head dim {dh} not in {sorted(GROUPS)}")
    if H % KH or H // KH not in GROUPS[dh]:
        raise ValueError(f"{H} heads over {KH} kv heads: H/KH not in "
                         f"{GROUPS[dh]} at head dim {dh}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    bf16 = q.dtype == torch.bfloat16
    _check(q, "q", q.dtype, (B, H, dh))
    _check(k, "k", q.dtype, (B, L, KH, dh))
    _check(v, "v", q.dtype, (B, L, KH, dh))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    lo, hi = valid_range(cache_len, L, window)
    res = resident_blocks(dh, H // KH, bf16)
    per_split = B * KH * HEAD_GROUPS[dh, H // KH]
    split = split_size(hi - lo, per_split, res, STEPS[dh])
    nsplit = -(-(hi - lo) // split)
    part_m = torch.empty(B * H * nsplit, dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(B * H * nsplit * dh, dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    entry = "att_decode_bf16" if bf16 else "att_decode"
    _raise_on(getattr(library("attention"), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), B, H, KH,
        L, dh, lo, hi, split, nsplit, 1.0 / math.sqrt(dh), _stream(q)),
        entry)
    LAUNCHES["decode_attention"] += 1
    LAST_GRID["decode_attention"] = (split, nsplit, nsplit * per_split, res)
    return out


def decode_attention(q, k, v, cache_len: int, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Decode attention by the device of ``q``: the twin on the CPU,
    :func:`decode_attention_cuda` on a CUDA tensor."""
    if q.device.type == "cpu":
        valid_range(cache_len, k.shape[1], window)
        return ref.decode_attention_ref(q, k, v, int(cache_len),
                                        window=window)
    return decode_attention_cuda(q, k, v, cache_len, window=window)
