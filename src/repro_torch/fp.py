"""Float32 arithmetic in the reference's rounding order.

``repro`` runs on XLA, whose CPU and TPU backends (a) contract every
``a * b + c`` into one fused multiply-add, rounded once, and (b) reduce a
short axis strictly in index order.  Rounding feeds discrete decisions in
the scheduler (grant-if-fits checks, boost water levels, swap argmax), so
the port reproduces both rules wherever a value can reach one of them:

* :func:`fma` computes ``a * b + c`` in float64 and rounds once to
  float32.  The float64 product of two float32 values is exact, so the
  only gap to a true float32 FMA is double rounding when the float64 sum
  lands exactly on a float32 halfway point.
* :func:`seq_sum` / :func:`seq_dot` accumulate along one axis in index
  order, with every step rounded to float32 (``seq_dot`` through
  :func:`fma`).

Both are device-agnostic elementwise tensor code, so the CPU and the CUDA
runs of the port round identically too.  Long axes (K blocks) keep
``torch.sum``: their results are continuous and held to a tolerance.
"""
from __future__ import annotations

import torch


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (via exact float64 product).
    Python scalars are first rounded to float32, as XLA does with them."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    c = torch.as_tensor(c, dtype=torch.float32, device=a.device)
    return (a.double() * b.double() + c.double()).float()


def seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` in index order, float32 after every step."""
    x = x.movedim(dim, 0)
    acc = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


def seq_dot(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``sum(a * b, dim)`` in index order, each step one fused
    multiply-add: what XLA emits for a multiply feeding a reduction."""
    a, b = torch.broadcast_tensors(a, b)
    p = (a.double() * b.double()).movedim(dim, 0)   # exact products
    acc = torch.zeros(p.shape[1:], dtype=torch.float32, device=p.device)
    for i in range(p.shape[0]):
        acc = (acc.double() + p[i]).float()
    return acc
