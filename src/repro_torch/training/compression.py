"""Gradient/update compression for client->server and cross-device traffic.

Error-feedback int8 quantization (1-bit-Adam / EF-SGD family), as in
``repro/training/compression.py``: each tensor is quantized to int8 with
a per-tensor scale ``max|x| / 127`` (``max|x|`` at least 1e-12), values
rounded half to even (``torch.round``, as ``jnp.round``) and clipped to
[-127, 127]; the quantization error is kept in a residual and added back
before the next round, so the compression bias vanishes over time.

A tree is a ``{name: tensor}`` dict.  ``compressed_mean`` is the
aggregation primitive FedAvg uses; ``compressed_psum`` is the int8
all-reduce over a ``torch.distributed`` group (one MAX of the scale, one
int32 SUM), ``repro``'s ``pmax`` / ``psum`` over a mesh axis.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

Tree = Dict[str, torch.Tensor]
SCALE_FLOOR = 1e-12


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32 scalar)`` with ``x ~ q * scale``."""
    x = x.float()
    scale = torch.clamp(torch.amax(torch.abs(x)), min=SCALE_FLOOR) / 127.0
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(tree: Tree, residual: Optional[Tree] = None):
    """Returns ``((q_tree, scales), new_residual)``; ``residual`` is the
    error feedback of the previous call (added before quantizing)."""
    if residual is not None:
        tree = {k: t.float() + residual[k] for k, t in tree.items()}
    q, s = {}, {}
    for k, t in tree.items():
        q[k], s[k] = quantize_int8(t)
    new_residual = {k: t.float() - dequantize_int8(q[k], s[k])
                    for k, t in tree.items()}
    return (q, s), new_residual


def decompress_tree(q: Tree, s: Tree) -> Tree:
    return {k: dequantize_int8(q[k], s[k]) for k in q}


def compressed_mean(trees: List[Tree]) -> Tree:
    """Quantize each contribution, mean in float32 (server-side dequant),
    summed in list order."""
    deqs = [decompress_tree(*compress_tree(t)[0]) for t in trees]
    n = float(len(deqs))
    return {k: sum(d[k] for d in deqs) / n for k in deqs[0]}


def compress_rows(x: torch.Tensor, sizes, residuals=None):
    """:func:`compress_tree` on each row of ``x [n, P]``, whose columns are
    the leaves of ``sizes`` (numels, in order): every leaf of every row
    gets its own scale.  Returns ``(dequantized [n, P], new residuals
    [n, P])``; ``residuals`` ([n, P], or None) is added first."""
    if residuals is not None:
        x = x + residuals
    deq = torch.empty_like(x)
    off = 0
    for n in sizes:
        leaf = x[:, off:off + n]
        peak = torch.amax(torch.abs(leaf), dim=1, keepdim=True)
        scale = torch.clamp(peak, min=SCALE_FLOOR) / 127.0
        deq[:, off:off + n] = _quantize(leaf, scale).float() * scale
        off += n
    if off != x.shape[1]:
        raise ValueError(f"leaf sizes cover {off} of {x.shape[1]} columns")
    return deq, x - deq


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 all-reduce with a shared scale over ``group`` (the default
    process group when None): one float32 MAX all-reduce picks the scale,
    each rank quantizes against it, an int32 SUM all-reduce adds the
    codes, and the sum is dequantized.  Exact up to quantization error
    (error feedback at the caller absorbs the rest)."""
    x = x.float()
    peak = torch.amax(torch.abs(x)).reshape(1)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(peak[0] / 127.0, min=SCALE_FLOOR)
    qsum = _quantize(x, scale).to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    return qsum.float() * scale
