"""Launcher of the Hopper prefill attention kernel (``csrc/attention.cu``,
``att_flash``) and the dispatch the model calls.

:func:`flash_attention_cuda` takes CUDA tensors only (float32,
contiguous, in the port's layouts) and raises on anything else; it adds
one to ``LAUNCHES["flash_attention"]`` per launch.  :func:`flash_attention`
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
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _window(window: Optional[int]) -> int:
    if window is None:
        return 0
    if int(window) < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    return int(window)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Forward GQA attention on the card: q [B,S,H,dh], k,v [B,S,KH,dh] ->
    [B,S,H,dh], softmax scale 1/sqrt(dh).

    Replaces ``repro/kernels/flash_attention.py:flash_attention``.  Bound:
    operations (4*dh FLOPs per query-key pair the masks keep).  Design
    (source header): a block per (64 query rows, head, batch row), key
    tiles of 64 in shared memory, online softmax in registers; any S,
    causal or not, optional sliding window.  Two templates: at dh 64 and
    128, 128 threads, each with a 4 x 8 score tile and 4 x dh/8
    accumulator fed by 16-byte shared loads, q, k and v staged with
    16-byte global loads; at dh 16, 32 and 256, 256 threads with a 4 x 4
    tile fed by scalar loads.  q, k and v must be 16-byte aligned."""
    _on_cuda(q, k, v)
    if q.dim() != 4:
        raise ValueError(f"q: expected [B, S, H, dh], got {tuple(q.shape)}")
    B, S, H, dh = q.shape
    KH = k.shape[2] if k.dim() == 4 else 0
    if KH < 1 or H % KH:
        raise ValueError(f"heads {H} are not a multiple of kv heads {KH}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    _check(q, "q", torch.float32, (B, S, H, dh))
    _check(k, "k", torch.float32, (B, S, KH, dh))
    _check(v, "v", torch.float32, (B, S, KH, dh))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    out = torch.empty_like(q)
    _raise_on(library("attention").att_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        KH, dh, int(causal), _window(window), 1.0 / math.sqrt(dh),
        _stream(q)), "att_flash")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of the prefill, by the device of ``q``: the twin on the
    CPU, :func:`flash_attention_cuda` on a CUDA tensor."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
