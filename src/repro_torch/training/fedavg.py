"""DP-FedAvg orchestration: the FL rounds the DPBalance scheduler feeds.

A *pipeline* granted privacy budget by the scheduler runs FL rounds here:
  1. cohort selection with OVER-SELECTION (straggler mitigation: select
     ceil(over_select * cohort) clients, close the round at the reporting
     deadline, drop stragglers -- DP-FedAvg tolerates partial cohorts);
  2. each client trains locally (SGD epochs) on its granted data blocks;
  3. client deltas are clipped (client-level DP), optionally int8-compressed
     with error feedback, averaged, and Gaussian noise calibrated from the
     pipeline's RDP grant is added;
  4. the accountant records the round; the ledger was already debited by the
     scheduler grant -- training can never exceed it.

Elasticity: the cohort is drawn from the *currently live* device set each
round, so node loss shrinks cohorts instead of stalling training.

Port notes.  The cohort, every latency and the kept set come from the
same ``np.random.default_rng(cfg.seed + round_idx)`` draws, in the same
order, as ``repro``'s.  Latencies do not depend on training, so the port
draws them first and trains only the clients that report by the deadline,
writing each one's delta straight into its row of one float32
``[keep, P]`` matrix, rows in latency order (the order ``repro`` sums
them in).  ``aggregate`` clips and sums that matrix with
``dp_clip_accumulate`` -- two Hopper kernels on the card; compressed, it
clips each row by ``rownorms``' scales, quantizes each parameter's slice
of a row on its own scale (``repro``'s per-leaf scale) and sums the
dequantized rows with ``clip_accumulate`` at unit scales.  The model is
updated in place (``model.flat += mean``; for a bfloat16 model each leaf
is added in float32 and rounded once, ``transformer.add_flat_``) rather
than copied: at ``flaas-100m`` a copy is 0.5 GB per pipeline per round.
A bfloat16 client's local SGD steps round each leaf once a step, as
``repro``'s ``_local_sgd_step``; its delta is the difference of the
leaves cast exactly to float32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels.dp_clip_noise import (dp_accumulate, dp_clip_accumulate,
                                     dp_row_scales)
from ..models.transformer import (Transformer, add_flat_, clone_model,
                                  flat_delta)
from ..privacy.accountant import RdpAccountant
from .compression import compress_rows
from .dp_sgd import add_noise


@dataclasses.dataclass
class FedAvgConfig:
    cohort_size: int = 8
    over_select: float = 1.25       # straggler head-room
    deadline_frac: float = 0.8      # fraction of selected that must report
    local_epochs: int = 1
    local_lr: float = 0.05
    local_batch: int = 8
    clip: float = 1.0
    compress: bool = False
    seed: int = 0


def client_update(params: Transformer, loss_fn, batches, lr: float,
                  epochs: int, out: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Local SGD from ``params`` (left unchanged); returns the model delta
    (client -> server) as a flat float32 ``[P]`` vector, written into
    ``out`` when given."""
    work = clone_model(params)
    weights = list(work.parameters())
    for _ in range(epochs):
        for b in batches:
            grads = torch.autograd.grad(loss_fn(work, b), weights)
            with torch.no_grad():
                torch._foreach_sub_(weights, grads, alpha=lr)
    return flat_delta(work, params, out=out)


def _rows(x) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.stack(list(x))
            ).float().contiguous()


def aggregate(deltas, clip: float, noise_std: float,
              generator: torch.Generator, compress: bool = False,
              residuals=None, layout: Optional[Transformer] = None):
    """Clip each client delta, (optionally) int8-compress, average, noise.
    ``deltas`` is a float32 ``[n, P]`` matrix (or a sequence of ``[P]``
    vectors), rows in the order the mean sums them.  Compression needs
    ``layout``, the model whose parameters lay out a row (each is
    quantized on its own scale), and takes error-feedback ``residuals``
    (``[n, P]``, or None).  Returns ``(mean [P], new residuals [n, P] or
    None)``."""
    D = _rows(deltas)
    new_residuals = None
    if compress:
        if layout is None:
            raise ValueError("compressed aggregation needs the layout model")
        scales, _ = dp_row_scales(D, clip)
        D, new_residuals = compress_rows(
            D * scales[:, None], [p.numel() for p in layout.parameters()],
            None if residuals is None else _rows(residuals))
        total = dp_accumulate(D, torch.ones_like(scales))
    else:
        total, _ = dp_clip_accumulate(D, clip)
    n = float(D.shape[0])
    mean = total / n
    if noise_std > 0:
        mean = add_noise(mean, generator, noise_std / n)
    return mean, new_residuals


def fl_round(
    params: Transformer,
    loss_fn,
    client_data: Dict[int, Callable[[], List[Dict]]],
    live_devices: Sequence[int],
    cfg: FedAvgConfig,
    accountant: Optional[RdpAccountant] = None,
    sigma: float = 0.0,
    round_idx: int = 0,
    latency_fn: Optional[Callable[[int], float]] = None,
):
    """One DP-FedAvg round over the live device set.  Updates ``params``
    in place and returns ``(params, metrics)``; ``metrics["kept"]`` lists
    the reporting clients in latency order."""
    rng = np.random.default_rng(cfg.seed + round_idx)
    n_sel = min(int(np.ceil(cfg.cohort_size * cfg.over_select)),
                len(live_devices))
    selected = rng.choice(np.asarray(live_devices), size=n_sel, replace=False)
    latency = [latency_fn(int(d)) if latency_fn else rng.exponential(1.0)
               for d in selected]

    # deadline: keep the fastest deadline_frac * n_sel reporters
    order = sorted(range(n_sel), key=lambda i: latency[i])
    keep = max(1, int(np.ceil(cfg.deadline_frac * n_sel)))
    kept = [int(selected[i]) for i in order[:keep]]

    deltas = torch.empty((keep, params.n_params), dtype=torch.float32,
                         device=params.device)
    for row, dev in enumerate(kept):
        client_update(params, loss_fn, client_data[dev](), cfg.local_lr,
                      cfg.local_epochs, out=deltas[row])

    gen = torch.Generator(device=params.device).manual_seed(
        cfg.seed * 7919 + round_idx)
    mean_delta, _ = aggregate(deltas, cfg.clip, sigma * cfg.clip, gen,
                              compress=cfg.compress, layout=params)
    add_flat_(params, mean_delta)
    if accountant is not None and sigma > 0:
        accountant.record_step(sigma)
    return params, {"cohort": keep, "stragglers_dropped": n_sel - keep,
                    "selected": n_sel, "kept": kept}
