"""GPipe-style pipeline parallelism over a mesh axis (default: 'pod'),
``repro/distributed/pipeline_parallel.py`` on ``torch.distributed``
ranks.

Layers are split into ``n_stages`` contiguous stages, one a rank along
the axis; microbatches stream through and activations hop stages by
point-to-point sends between neighbours.  The schedule is ``repro``'s:
T = n_micro + n_stages - 1 ticks, each tick receive (the previous
stage's output of the tick before) -> compute; stage s is busy for ticks
[s, s + n_micro), so the bubble is (n_stages - 1) / T.

``pipeline_apply`` is a building block, as in ``repro``: the training
step does not use it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor, mesh,
                   axis: str = "pod") -> torch.Tensor:
    """Run microbatches through the pipeline stages laid out along
    ``axis`` of ``mesh`` (every rank of the axis calls it).

    stage_fn(params_one_stage, x) -> y    (same shape as x)
    stage_params: this rank's stage's parameters (``repro`` passes the
        stacked tree and each device holds its slice; here each rank
        holds only its own)
    x_micro: [n_micro, ...] microbatched input, the same on every rank
    Returns [n_micro, ...] the last stage's outputs, on every rank.
    """
    n_stages = mesh.shape[axis]
    n_micro = x_micro.shape[0]
    stage = mesh.coords[axis]
    last = stage == n_stages - 1
    prev_out = torch.zeros_like(x_micro[0])
    outputs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        # receive the previous stage's tick-(t-1) output (a cyclic shift,
        # as ``ppermute`` with i -> i + 1; stage 0 ignores what it gets)
        received = mesh.sendrecv(prev_out, axis)
        my_in = x_micro[min(t, n_micro - 1)] if stage == 0 else received
        out = stage_fn(stage_params, my_in)
        done = t - (n_stages - 1)     # the last stage banks microbatch done
        if last and done >= 0:
            outputs[done] = out
        prev_out = out
    # broadcast from the last stage: zeros elsewhere, then a sum
    if not last:
        outputs = torch.zeros_like(outputs)
    return mesh.all_reduce(outputs, axis)
