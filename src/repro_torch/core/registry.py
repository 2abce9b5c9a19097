"""Scheduler registry -- the one place that knows every scheduler's name.

``repro`` keeps two access levels: the jit-cached public entry
(:func:`get_scheduler`) and the traceable round function for embedding in a
larger program (``get_round_fn``).  The port compiles nothing, so both
names are one function, returning plain functions ``(RoundInputs,
SchedulerConfig, block_axis=LOCAL) -> RoundResult`` that run on the device
of their tensors.
"""
from __future__ import annotations

from typing import Callable

from . import baselines, scheduler
from .demand import RoundInputs
from .scheduler import RoundResult, SchedulerConfig

SCHEDULER_NAMES = ("dpbalance", "dpf", "dpk", "fcfs")

# name -> per-round entry point
SCHEDULERS: dict = {
    "dpbalance": scheduler.schedule_round,
    "dpf": baselines.dpf_round,
    "dpk": baselines.dpk_round,
    "fcfs": baselines.fcfs_round,
}


def get_scheduler(name: str) -> Callable[[RoundInputs, SchedulerConfig],
                                         RoundResult]:
    """Per-round entry point for ``name``."""
    try:
        return SCHEDULERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; expected one of {SCHEDULER_NAMES}"
        ) from None



# the episode engine's name for the same lookup
get_round_fn = get_scheduler
