"""Paper §VI simulation environment: its configuration.

  * 100 edge devices; per-device global budget eps_g ~ U(1.0, 1.5); every
    device's blocks inherit the device budget.
  * 2 new blocks per device every 10 s (one round = 10 s).
  * 6 data analysts x 25 pipelines arriving via a Poisson process (one
    analyst batch per round on average), 10 rounds.
  * 75% mice pipelines (eps ~ U(0.005, 0.015)), 25% elephant
    (eps ~ U(0.095, 0.105)).
  * A pipeline demands the latest 10 blocks w.p. 0.25, else the latest 1.
  * An analyst targets 20% of devices w.p. 0.5, else all devices.

The legacy host-side simulator (:class:`FlaasSimulator`) keeps its state in
numpy on the host and hands each round to the scheduler as tensors on a
given device; :func:`run_simulation` drives either it or the episode engine
(``repro/core/simulation.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..fp import tree_sum
from .demand import RoundInputs
from .engine import ROUND_SECONDS, generate_episode, run_episode
from .registry import get_scheduler
from .scheduler import RoundResult, SchedulerConfig
from .utility import normalized_fairness

# run_simulation's result schema (both the engine and the legacy path)
_RESULT_KEYS = ("round_efficiency", "round_fairness", "round_fairness_norm",
                "cumulative_efficiency", "cumulative_fairness",
                "cumulative_fairness_norm", "round_jain", "n_allocated",
                "leftover")


@dataclasses.dataclass
class SimConfig:
    n_devices: int = 100
    blocks_per_round_per_device: int = 2
    n_analysts: int = 6
    pipelines_per_analyst: int = 25
    n_rounds: int = 10
    mice_frac: float = 0.75
    mice_eps: tuple = (0.005, 0.015)
    elephant_eps: tuple = (0.095, 0.105)
    budget_range: tuple = (1.0, 1.5)
    p_ten_blocks: float = 0.25
    p_subset_devices: float = 0.5
    subset_frac: float = 0.2
    arrival_rate: float = 1.0  # Poisson analyst-batch arrivals per round
    seed: int = 0
    pad_blocks: bool = True  # pre-size K so shapes are static


@dataclasses.dataclass
class _Pipeline:
    analyst: int
    arrival: float
    loss: float
    demands: Dict[int, float]  # block id -> eps demand
    done: bool = False


class FlaasSimulator:
    """Round-based environment; pending pipelines persist across rounds.
    Host numpy state; :meth:`round_inputs` builds tensors on ``device``."""

    def __init__(self, cfg: SimConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(cfg.seed)
        self.device_budget = self.rng.uniform(*cfg.budget_range,
                                              cfg.n_devices)
        self.block_budget: List[float] = []    # total budget per block
        self.block_capacity: List[float] = []  # remaining budget per block
        self.block_device: List[int] = []
        self.blocks_by_device: List[List[int]] = [
            [] for _ in range(cfg.n_devices)]
        self.pipelines: List[_Pipeline] = []
        self.now = 0.0
        self._arrived = 0
        self._slot_of: Dict[int, tuple] = {}

    # ------------------------------------------------------------------ env
    def _grow_blocks(self):
        for dev in range(self.cfg.n_devices):
            for _ in range(self.cfg.blocks_per_round_per_device):
                bid = len(self.block_budget)
                self.block_budget.append(float(self.device_budget[dev]))
                self.block_capacity.append(float(self.device_budget[dev]))
                self.block_device.append(dev)
                self.blocks_by_device[dev].append(bid)

    def _spawn_pipelines(self):
        cfg, rng = self.cfg, self.rng
        n_new = min(rng.poisson(cfg.arrival_rate),
                    cfg.n_analysts - self._arrived)
        for _ in range(max(n_new, 1 if self._arrived == 0 else 0)):
            if self._arrived >= cfg.n_analysts:
                break
            aid = self._arrived
            self._arrived += 1
            subset = rng.random() < cfg.p_subset_devices
            n_dev = max(1, int(cfg.subset_frac * cfg.n_devices)) if subset \
                else cfg.n_devices
            devices = rng.choice(cfg.n_devices, size=n_dev, replace=False)
            for _ in range(cfg.pipelines_per_analyst):
                mice = rng.random() < cfg.mice_frac
                lo, hi = cfg.mice_eps if mice else cfg.elephant_eps
                depth = 10 if rng.random() < cfg.p_ten_blocks else 1
                demands: Dict[int, float] = {}
                for dev in devices:
                    for bid in self.blocks_by_device[dev][-depth:]:
                        demands[bid] = float(rng.uniform(lo, hi))
                self.pipelines.append(_Pipeline(
                    analyst=aid, arrival=self.now,
                    loss=float(rng.uniform(0.5, 1.0)), demands=demands))

    # ------------------------------------------------------------- interface
    def round_inputs(self) -> RoundInputs:
        cfg = self.cfg
        K = len(self.block_budget)
        if cfg.pad_blocks:  # static K across rounds
            K = cfg.n_devices * cfg.blocks_per_round_per_device * cfg.n_rounds
        M, N = cfg.n_analysts, cfg.pipelines_per_analyst
        demand = np.zeros((M, N, K), np.float32)
        active = np.zeros((M, N), bool)
        arrival = np.zeros((M, N), np.float32)
        loss = np.ones((M, N), np.float32)
        slot = [0] * M
        self._slot_of = {}
        for pid, p in enumerate(self.pipelines):
            if p.done:
                continue
            i, j = p.analyst, slot[p.analyst]
            if j >= N:
                continue
            slot[p.analyst] += 1
            self._slot_of[pid] = (i, j)
            active[i, j] = True
            arrival[i, j] = p.arrival
            loss[i, j] = p.loss
            for bid, eps in p.demands.items():
                demand[i, j, bid] = eps
        cap = np.zeros(K, np.float32)
        tot = np.ones(K, np.float32)  # padded blocks: budget 1, capacity 0
        kreal = len(self.block_budget)
        cap[:kreal] = np.asarray(self.block_capacity, np.float32)
        tot[:kreal] = np.asarray(self.block_budget, np.float32)
        return RoundInputs.from_numpy(demand, active, arrival, loss, cap, tot,
                                      np.float32(self.now),
                                      device=self.device)

    def apply(self, result: RoundResult):
        consumed = result.consumed.cpu().numpy()[: len(self.block_capacity)]
        # float32 like the scheduler (and the engine's device carry)
        cap = np.asarray(self.block_capacity, np.float32)
        self.block_capacity = list(np.maximum(cap - consumed, 0.0))
        selected = result.selected.cpu().numpy()
        for pid, (i, j) in self._slot_of.items():
            if selected[i, j]:
                self.pipelines[pid].done = True

    def step_time(self):
        self.now += ROUND_SECONDS


def run_simulation(scheduler: str, sim_cfg: SimConfig,
                   sched_cfg: SchedulerConfig, *, engine: bool = True,
                   device="cuda") -> Dict[str, np.ndarray]:
    """Drive ``scheduler`` in {'dpbalance', 'dpf', 'dpk', 'fcfs'} for
    ``n_rounds`` on ``device``; returns per-round and cumulative
    efficiency / fairness (+ jain, #allocated, leftover) as numpy arrays.

    By default through the episode engine (:mod:`repro_torch.core.
    engine`); ``engine=False`` drives the legacy host-side
    :class:`FlaasSimulator` round by round, the engine's oracle."""
    if engine:
        out = run_episode(generate_episode(sim_cfg, device=device),
                          sched_cfg, scheduler)
        return {k: out[k].cpu().numpy() for k in _RESULT_KEYS}

    fn = get_scheduler(scheduler)
    sim = FlaasSimulator(sim_cfg, device=device)
    eff, fair, fnorm, jain, nalloc, leftover = [], [], [], [], [], []
    for _ in range(sim_cfg.n_rounds):
        sim._grow_blocks()
        sim._spawn_pipelines()
        rnd = sim.round_inputs()
        res = fn(rnd, sched_cfg)
        sim.apply(res)
        mask = torch.sum(rnd.active, dim=1) > 0
        eff.append(float(res.efficiency))
        fair.append(float(res.fairness))
        fnorm.append(float(normalized_fairness(res.utility, sched_cfg.beta,
                                               mask)))
        jain.append(float(res.jain))
        nalloc.append(int(res.n_allocated))
        # the same reduction (and summation order) as the engine's
        leftover.append(float(tree_sum(res.leftover, -1)))
        sim.step_time()
    eff, fair, fnorm = (np.asarray(eff, np.float32),
                        np.asarray(fair, np.float32),
                        np.asarray(fnorm, np.float32))
    return {
        "round_efficiency": eff,
        "round_fairness": fair,
        "round_fairness_norm": fnorm,
        "cumulative_efficiency": np.cumsum(eff),
        "cumulative_fairness": np.cumsum(fair),
        "cumulative_fairness_norm": np.cumsum(fnorm),
        "round_jain": np.asarray(jain),
        "n_allocated": np.asarray(nalloc),
        "leftover": np.asarray(leftover),
    }
