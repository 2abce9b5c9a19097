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
* :func:`fma_exact` is a float32 FMA without that gap: the float64 sum
  is rounded to odd (its TwoSum error decides the last bit) before the
  one rounding to float32, which then equals the correctly rounded
  result (53 >= 24 + 2 bits).  It is for twins that must be bitwise
  with a ``__fmaf_rn`` kernel over hundreds of millions of elements.
* :func:`seq_sum` / :func:`seq_dot` accumulate along one axis in index
  order, with every step rounded to float32 (``seq_dot`` through
  :func:`fma`).
* :func:`tree_sum` reduces a long axis the way XLA:CPU's tree reduction
  rewriter does: windows of 32, each summed in index order.
* :func:`pow_runs` is ``x ** p`` whose every run of trailing elements
  rounds as it would in a tensor of its own, so a batched call equals a
  call per run bit for bit on the CPU too.

All are device-agnostic elementwise tensor code, so the CPU and the CUDA
runs of the port round identically too.  Long axes (K blocks) keep
``torch.sum`` where their results are continuous and held to a tolerance;
:func:`tree_sum` is for a long-axis sum that feeds a discrete decision.

:class:`float64` runs float32 code in float64: the exact value that a
float32 result of an ill-conditioned function (xLSTM's gradient) is
measured against.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (via exact float64 product).
    Python scalars are first rounded to float32, as XLA does with them."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    c = torch.as_tensor(c, dtype=torch.float32, device=a.device)
    return (a.double() * b.double() + c.double()).float()


def fma_exact(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
              ) -> torch.Tensor:
    """float32 ``a * b + c``, correctly rounded (what ``__fmaf_rn`` and a
    hardware FMA return) for float32 tensors of one device."""
    p = a.double() * b.double()                     # exact
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)                 # TwoSum: p + c == s + err
    bits = s.view(torch.int64)
    # round to odd: an inexact even s moves one ulp towards the exact sum
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & (bits & 1 == 0), bits + step, bits)
    return bits.view(torch.float64).float()


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


_TREE_WINDOW = 32


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along ``dim`` in XLA:CPU's order for a long axis: while the axis
    is longer than 32, zero-pad it to a multiple of 32 (half the padding,
    rounded down, in front), sum each window of 32 in index order and
    keep the window sums; then sum what is left in index order.  The
    padding adds exact zeros, so only the window boundaries matter."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > _TREE_WINDOW:
        pad = -x.shape[-1] % _TREE_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = seq_sum(x.reshape(*x.shape[:-1], -1, _TREE_WINDOW), -1)
    return seq_sum(x, -1)


def pow_runs(x: torch.Tensor, p: float, run_dims: int) -> torch.Tensor:
    """``x ** p`` with each run of the trailing ``run_dims`` dims (each
    element where ``run_dims`` is 0) rounded as ``run ** p`` alone is.

    On the CPU, torch's ``pow`` by a scalar takes a vector path over
    whole chunks of a contiguous run and a scalar path over its tail, and
    the two round an ulp apart; so the same element can round differently
    as part of ``[E, M]`` and of its own ``[M]``.  Each run is given its
    own row here (a padded stride, so no two rows coalesce into one run),
    which puts every element where the run alone would.  On the card, and
    for a single run, this is ``x ** p``."""
    n = 1
    for s in x.shape[x.dim() - run_dims:]:
        n *= s
    if x.device.type != "cpu" or x.numel() <= n:
        return x ** p
    rows = x.reshape(-1, n)
    # one row a call past 32768 elements, where torch splits the range
    # over threads at offsets that need not fall on a row boundary
    step = max(1, _POW_GRAIN // n)
    out = []
    for r0 in range(0, rows.shape[0], step):
        part = rows[r0:r0 + step]
        buf = part.new_empty(part.shape[0], n + 1)
        buf[:, :n] = part
        out.append(buf[:, :n] ** p)
    return torch.cat(out).reshape(x.shape)


# torch's elementwise grain: a range this long or shorter runs on one thread
_POW_GRAIN = 32768


class float64(TorchDispatchMode):
    """``with float64():`` -- every operation asked for float32 inside
    (``.float()``, a float32 factory such as a state's ``torch.zeros``)
    makes float64 instead, so a model converted by ``.double()`` runs its
    float32 code in float64, forward and backward."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kwargs.get("dtype") is torch.float32:
            kwargs = {**kwargs, "dtype": torch.float64}
        return func(*args, **kwargs)
