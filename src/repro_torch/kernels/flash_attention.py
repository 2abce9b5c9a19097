"""Launcher of the Hopper prefill attention kernel (``csrc/attention.cu``,
``att_flash``) and the dispatch the model calls: the prefill's causal or
windowed self attention, an encoder's non-causal self attention, and
cross attention (queries of the prompt against keys and values of
another length, non-causal).

:func:`flash_attention_cuda` takes CUDA tensors only (q, k and v all
float32 or all bfloat16, contiguous, in the port's layouts) and raises on
anything else; it adds one to ``LAUNCHES["flash_attention"]`` per launch.
A bfloat16 call computes in float32 what a float32 call computes on the
same values and rounds each output once (``repro``'s Pallas kernel
loads bfloat16, computes in float32 and stores the input's dtype); its
entry points carry ``_bf16``.  :func:`flash_attention`
picks by the device of ``q`` alone -- a CPU tensor runs the twin
:func:`repro_torch.kernels.ref.flash_attention_ref`, a CUDA tensor the
kernel -- with no flag and no fallback.

Neither has a backward: the training forward keeps
:func:`repro_torch.models.layers.chunked_attention` under autograd, as
``repro`` trains through its jnp attention.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .budget_alloc import _check, _on_cuda, _raise_on, _stream
from .build import library
from . import ref

# Kernel launches since the last reset_launches().
LAUNCHES = {"flash_attention": 0}
# The C entry point of the last launch: att_flash, or att_flash_wide (dh 256
# where wide_tiles holds), with _bf16 for bfloat16 operands.
LAST_ENTRY = {"flash_attention": None}
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)  # each at every head dim
BQ = 64           # query rows of a block (csrc/attention.cu: kBQ)
WIDE_KEYS = 256   # keys of a tile of the wide dh-256 kernel (kWideBK)


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0
    LAST_ENTRY["flash_attention"] = None


def _window(window: Optional[int]) -> int:
    if window is None:
        return 0
    if int(window) < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    return int(window)


def wide_tiles(S: int, causal: bool, window: Optional[int]) -> bool:
    """Whether a dh-256 call runs the wide kernel (``att_flash_wide``)
    rather than the narrow one (``att_flash``): where the block of BQ
    query rows that sees the most keys sees a whole WIDE_KEYS tile.  A
    causal window of w keys limits that span to w + BQ - 1; without a
    window, or without the causal mask, the span is S.  Below a tile the
    wide kernel still walks all 16 K chunks of a tile for few keys, and
    the narrow kernel is faster (PERF.md, Findings)."""
    span = S if window is None or not causal else min(S, window + BQ - 1)
    return span >= WIDE_KEYS


def check_lengths(S: int, Skv: int, dh: int, causal: bool,
                  window: Optional[int]) -> None:
    """Raise unless S queries may attend to Skv keys: Skv != S only for
    cross attention -- non-causal, without a window (``repro`` defines no
    causal alignment of two lengths) -- and not at dh 256, which no
    config cross-attends at."""
    if Skv == S:
        return
    if Skv < 1 or causal or window is not None:
        raise ValueError(
            f"keys of length {Skv} against {S} queries: only non-causal "
            "attention without a window (cross attention) takes Skv != S")
    if dh == 256:
        raise NotImplementedError(
            "dh 256 takes Skv == S only (no config cross-attends at dh 256)")


def _att_flash(entry: str, q, k, v, causal: bool, window: Optional[int]):
    """One launch of the C entry ``entry`` on checked tensors; returns the
    output and counts the launch."""
    B, S, H, dh = q.shape
    out = torch.empty_like(q)
    _raise_on(getattr(library("attention"), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
        k.shape[1], H, k.shape[2], dh, int(causal), _window(window),
        1.0 / math.sqrt(dh), _stream(q)), entry)
    LAUNCHES["flash_attention"] += 1
    LAST_ENTRY["flash_attention"] = entry
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Forward GQA attention on the card: q [B,S,H,dh], k,v [B,Skv,KH,dh]
    -> [B,S,H,dh], softmax scale 1/sqrt(dh).  Skv differs from S only for
    cross attention: non-causal, without a window, at dh 16-128 (the
    ``ValueError`` / ``NotImplementedError`` otherwise).

    Replaces ``repro/kernels/flash_attention.py:flash_attention``.  Bound:
    operations (4*dh FLOPs per query-key pair the masks keep).  Design
    (source header): a block per (64 query rows, head, batch row), the
    grid (head, batch row, q tile) with the heaviest causal tiles first,
    key tiles staged in shared memory, online softmax; any S and Skv,
    causal or not, optional sliding window.  By head dim:

    * dh 64, 128: 128 threads, a 4 x 8 score tile and 4 x dh/8
      accumulator a thread fed by 16-byte shared loads.
    * dh 256, key spans under a 256-key tile (``wide_tiles`` false, e.g.
      recurrentgemma-2b's 32-token prompt): 8 warps of 8 rows, a 2 x 4
      score tile and 2 x 32 accumulator a thread, 32-key K/V stages
      loaded by cp.async while the previous stage is used; 209,920 bytes
      of shared memory, one block an SM.
    * dh 256, longer spans: two groups of 8 warps on the same 64 rows,
      8 x 8 scores a lane in one and 8 x 8 outputs in the other, p passed
      between them in shared memory; 256-key tiles whose K arrives in
      16-column chunks through a three-slot cp.async ring and V in
      16-key chunks through a two-slot one; 136 registers a scorer and
      120 an accumulator thread (setmaxnreg), 228,608 bytes of shared
      memory.
    * dh 16, 32: 256 threads with a 4 x 4 tile fed by scalar loads.

    bfloat16 q, k and v are converted to float32 as they are loaded (the
    dh-256 kernels, whose cp.async copies cannot convert, load them with
    plain loads instead) and the output rounded once.  q, k and v must be
    16-byte aligned."""
    _on_cuda(q, k, v)
    if q.dim() != 4:
        raise ValueError(f"q: expected [B, S, H, dh], got {tuple(q.shape)}")
    B, S, H, dh = q.shape
    KH = k.shape[2] if k.dim() == 4 else 0
    if KH < 1 or H % KH:
        raise ValueError(f"heads {H} are not a multiple of kv heads {KH}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    Skv = k.shape[1]
    if q.dtype not in DTYPES:
        raise TypeError(f"q: expected one of {DTYPES}, got {q.dtype}")
    _check(q, "q", q.dtype, (B, S, H, dh))
    _check(k, "k", q.dtype, (B, Skv, KH, dh))
    _check(v, "v", q.dtype, (B, Skv, KH, dh))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    check_lengths(S, Skv, dh, causal, window)
    wide = dh == 256 and wide_tiles(S, causal, window)
    entry = "att_flash_wide" if wide else "att_flash"
    if q.dtype == torch.bfloat16:
        entry += "_bf16"
    return _att_flash(entry, q, k, v, causal, window)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of the prefill, by the device of ``q``: the twin on the
    CPU, :func:`flash_attention_cuda` on a CUDA tensor."""
    if q.device.type == "cpu":
        check_lengths(q.shape[1], k.shape[1], q.shape[-1], causal, window)
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
