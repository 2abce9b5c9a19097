"""Freeze a finite trace prefix into an Episode — the service's oracle.

A trace whose first ``n_ticks`` are *episode-compatible* (every analyst
submits exactly once, every submission carries the same pipeline count) can
be frozen into a :class:`~repro_torch.core.engine.Episode` and run through
``engine.run_episode``.  The service loop over the same trace — wrap-free
ledger, enough slots, any chunking — must reproduce the engine's per-round
metrics; :func:`replay_gap` measures the disagreement and the regression
tests pin it to 1e-5 for all four schedulers.

This is the streaming plane's correctness anchor, the same way the legacy
``FlaasSimulator`` anchors the engine.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

from ..core.engine import Episode, run_episode
from ..core.scheduler import SchedulerConfig
from ..core.simulation import ROUND_SECONDS

from .server import FlaasService, ServiceConfig
from .traces import ArrivalTrace, demand_window_ticks

PARITY_KEYS = ("round_efficiency", "round_fairness", "round_fairness_norm",
               "round_jain", "n_allocated", "leftover")


def freeze_trace(trace: ArrivalTrace, n_ticks: int,
                 device="cuda") -> Episode:
    """Materialize the first ``n_ticks`` of ``trace`` as an Episode on
    ``device``.

    Consumes the trace (pass ``trace.reset()`` to keep the original).
    Raises ``ValueError`` when the prefix is not episode-compatible —
    churn traces (re-submitting analysts) cannot be frozen."""
    subs = []
    for t in range(n_ticks):
        subs.extend(trace.step(t))
    analysts = [s.analyst for s in subs]
    if len(set(analysts)) != len(analysts):
        raise ValueError("trace is not episode-compatible: an analyst "
                         "submitted more than once in the frozen window")
    if not subs:
        raise ValueError("no submissions in the frozen window")
    pipes = {s.n_pipelines for s in subs}
    if len(pipes) != 1:
        raise ValueError(f"trace is not episode-compatible: submissions "
                         f"disagree on pipeline count ({sorted(pipes)})")

    M, N = len(subs), pipes.pop()
    bpr = trace.blocks_per_tick
    K = bpr * n_ticks
    demand = np.zeros((M, N, K), np.float32)
    loss = np.ones((M, N), np.float32)
    arrival = np.zeros((M, N), np.float32)
    spawn_round = np.full(M, n_ticks, np.int32)
    # admission order == arrival order == the service's row assignment
    for aid, sub in enumerate(subs):
        spawn_round[aid] = sub.submit_tick
        arrival[aid, :] = sub.submit_tick * ROUND_SECONDS
        loss[aid, :] = sub.loss
        for j in range(N):
            demand[aid, j, sub.bids[j]] = sub.eps[j]

    block_round = np.repeat(np.arange(n_ticks, dtype=np.int32), bpr)
    block_budget = np.tile(
        np.repeat(trace.device_budget.astype(np.float32),
                  trace.blocks_per_device), n_ticks)
    return Episode.from_numpy(demand, loss, arrival, spawn_round,
                              block_budget, block_round, n_ticks,
                              device=device)


def collect_service_metrics(service: FlaasService,
                            n_ticks: int) -> Dict[str, np.ndarray]:
    """Drive the service for ``n_ticks`` keeping the per-tick series
    (the long-running path only keeps streaming aggregates)."""
    chunks = []
    done = 0
    while done < n_ticks:
        T = min(service.cfg.chunk_ticks, n_ticks - done)
        chunks.append(service.run_chunk(T))
        done += T
    return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}


def replay_gap(trace: ArrivalTrace, n_ticks: int, sched_cfg: SchedulerConfig,
               scheduler: str = "dpbalance", *, chunk_ticks: int = 4,
               keys: Iterable[str] = PARITY_KEYS,
               service_factory=FlaasService,
               block_slots_multiple: int = 1,
               device="cuda") -> Dict[str, float]:
    """Max |service - engine| per metric over a frozen trace prefix, both
    on ``device``.

    ``service_factory(cfg, trace, device=device)`` builds the service
    under test -- a sharded plane would pass its own service, whose ring
    must be padded to a multiple of the shard count
    (``block_slots_multiple``)."""
    episode = freeze_trace(trace.reset(), n_ticks, device=device)
    M, N, K = episode.demand.shape
    oracle = {k: v.cpu().numpy()
              for k, v in run_episode(episode, sched_cfg, scheduler).items()}

    # ring >= the episode's K (wrap-free, bit-compatible) and >= the
    # service's minimum demand window; the extra never-created slots carry
    # zero demand / capacity and a budget_total of 1, so every reduction
    # the schedulers perform is unchanged (short traces stay verifiable).
    block_slots = max(K, demand_window_ticks(trace.blocks_per_device) *
                      trace.blocks_per_tick)
    m = block_slots_multiple
    block_slots = -(-block_slots // m) * m
    cfg = ServiceConfig(
        scheduler=scheduler, sched=sched_cfg, analyst_slots=M,
        pipeline_slots=N, block_slots=block_slots, chunk_ticks=chunk_ticks,
        admit_batch=max(M, 1), max_pending=max(4 * M, 64))
    service = service_factory(cfg, trace.reset(), device=device)
    got = collect_service_metrics(service, n_ticks)
    gaps = {}
    for k in keys:
        a = np.asarray(got[k], np.float64)
        b = np.asarray(oracle[k], np.float64)
        # scale-normalized: a summed metric like `leftover` is O(K), where
        # f32 accumulation-order noise alone is ~1e-4 absolute; dividing
        # by the metric's magnitude keeps one tolerance meaningful for
        # every key (identical layouts still report exactly 0).
        gaps[k] = float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))
    return gaps
