"""DP-SGD gradient machinery: clip + noise, two granularities.

* ``example`` mode -- true per-example clipping.  The per-example
  gradients are written row by row into one float32 ``[B, P]`` matrix,
  and the flatten/clip/accumulate step is
  :func:`repro_torch.kernels.dp_clip_noise.dp_clip_accumulate`: the two
  Hopper kernels on the card, their twins on the CPU.
* ``microbatch`` mode -- FL client/cohort-level clipping: the batch is
  split into ``n_micro`` slices, each slice's mean gradient is clipped as
  a unit (DP-FedAvg semantics) and accumulated (memory: 2x grads, not B x).

Noise is added once after aggregation: std = sigma * clip / n_units, drawn
from a ``torch.Generator`` on the gradients' device.

A gradient *tree* here is a ``{name: tensor}`` dict in the model's
parameter order.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..kernels.dp_clip_noise import clip_scales, dp_clip_accumulate
from ..models.transformer import Transformer, unflatten


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(l.float() ** 2) for l in tree.values()))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], clip: float):
    n = global_norm(tree)
    scale = clip_scales(n, clip)
    return {k: l.float() * scale for k, l in tree.items()}, n


def add_noise(tree, generator: torch.Generator, std: float):
    """``tree + std * N(0, 1)`` for a ``{name: tensor}`` dict or a single
    tensor, from ``generator`` (on the tensors' device)."""
    def noisy(l):
        return l + std * torch.randn(l.shape, generator=generator,
                                     dtype=torch.float32, device=l.device)
    if isinstance(tree, torch.Tensor):
        return noisy(tree)
    return {k: noisy(l) for k, l in tree.items()}


def _slice(batch: Dict, lo: int, hi: int) -> Dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def dp_gradients(
    loss_fn: Callable[[Transformer, Dict], torch.Tensor],
    params: Transformer,
    batch: Dict,
    generator: torch.Generator,
    *,
    clip: float = 1.0,
    noise_multiplier: float = 0.0,
    mode: str = "microbatch",
    n_micro: int = 8,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns (noised mean clipped grads float32 ``{name: tensor}``,
    metrics).

    batch leaves have leading dim B; it is split into n_micro slices
    (microbatch mode) or B per-example units (example mode).
    """
    weights = list(params.parameters())
    B = next(iter(batch.values())).shape[0]

    if mode == "example":
        G = torch.empty((B, params.flat.numel()), dtype=torch.float32,
                        device=params.flat.device)
        losses = []
        for b in range(B):
            loss = loss_fn(params, _slice(batch, b, b + 1))
            grads = torch.autograd.grad(loss, weights)
            torch.cat([g.reshape(-1) for g in grads], out=G[b])
            losses.append(loss.detach())
        gsum, norms = dp_clip_accumulate(G, clip)
        gsum = unflatten(params, gsum)
        n_units = B
    elif mode == "microbatch":
        if B % n_micro:
            raise ValueError(f"batch {B} is not a multiple of n_micro "
                             f"{n_micro}")
        m = B // n_micro
        gsum = {k: torch.zeros_like(p) for k, p in params.named_parameters()}
        norms, losses = [], []
        for i in range(n_micro):
            loss = loss_fn(params, _slice(batch, i * m, (i + 1) * m))
            grads = torch.autograd.grad(loss, weights)
            g, n = clip_by_global_norm(dict(zip(gsum, grads)), clip)
            gsum = {k: gsum[k] + g[k] for k in gsum}
            norms.append(n)
            losses.append(loss.detach())
        norms = torch.stack(norms)
        n_units = n_micro
    else:
        raise ValueError(f"unknown DP mode {mode!r}")

    gmean = {k: g / n_units for k, g in gsum.items()}
    if noise_multiplier > 0.0:
        gmean = add_noise(gmean, generator, noise_multiplier * clip / n_units)
    losses = torch.stack(losses)
    metrics = {"grad_norm_mean": torch.mean(norms),
               "grad_norm_max": torch.max(norms),
               "clip_frac": torch.mean((norms > clip).float()),
               "loss_mean": torch.mean(losses)}
    return gmean, metrics
