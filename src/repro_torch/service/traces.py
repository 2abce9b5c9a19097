"""Unbounded arrival-trace generators for the service plane.

An :class:`ArrivalTrace` is the streaming analogue of
:func:`repro_torch.core.engine.generate_episode`: the same workload model (mice vs
elephant demand, device-subset targeting, demand depth, per-device budgets —
all taken from a :class:`~repro_torch.core.simulation.SimConfig`, usually via a
named recipe in :mod:`repro_torch.core.scenarios`) but driven by an *arrival
pattern* that never terminates:

* ``poisson``  — stationary Poisson(rate) analyst-batch arrivals (the
  paper's §VI process, unbounded).
* ``diurnal``  — Poisson with a sinusoidally modulated rate:
  ``rate * (1 + amplitude * sin(2 pi t / period))`` — the day/night load
  curve an FLaaS front door actually sees.
* ``bursty``   — two-state Markov process (quiet/burst) switching with
  probability ``p_switch`` per tick; burst rate = ``burst x rate``.
* ``churn``    — arrivals are *returning* analysts drawn from a finite pool
  of ``pool`` identities; a returning analyst submits a fresh pipeline
  batch under its old identity (the service keeps one slot row per live
  analyst, so churn exercises row recycling).

Each analyst batch is one :class:`Submission` of ``pipelines_per_analyst``
pipelines demanding the latest blocks of its targeted devices, exactly the
episode demand model — which is what lets :mod:`repro_torch.service.replay`
freeze a finite prefix of any trace into an Episode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.scenarios import scenario_config
from ..core.simulation import ROUND_SECONDS, SimConfig

from .tenancy import policy_key, resolve_policy

PATTERNS = ("poisson", "diurnal", "bursty", "churn")

# Deepest demand: a pipeline demands at most the latest 10 blocks *of each
# device* (the paper's workload model; engine/simulation use the same
# depth).  The server's ledger ring MUST cover the window of ticks those
# blocks span — it derives the requirement via demand_window_ticks(), so
# deepening the workload model here automatically tightens the ring guard.
DEMAND_DEPTH_BLOCKS = 10


def demand_window_ticks(blocks_per_device: int) -> int:
    """Ticks spanned by the deepest per-device demand window."""
    return -(-DEMAND_DEPTH_BLOCKS // blocks_per_device)


@dataclasses.dataclass
class Submission:
    """One analyst batch: the admission/queueing unit.

    The tenancy fields (tier/priority/weight/deadline_ticks/cost_cap) are
    stamped by a :class:`~repro_torch.service.tenancy.TenancyPolicy` when the
    trace carries one; their defaults are *plain class attributes* on
    purpose — a pre-tenancy checkpoint's pickled Submissions (which predate
    tenancy) restore without these instance attributes and fall back to
    the class defaults, i.e. the neutral single tier."""

    analyst: int                  # external analyst identity
    submit_tick: int
    bids: List[np.ndarray]        # per pipeline: global block ids demanded
    eps: List[np.ndarray]         # per pipeline: epsilon demand per block
    loss: np.ndarray              # [n_pipelines] matching degree
    tier: str = "default"         # tenancy class name
    priority: int = 0             # strict admission priority (higher first)
    weight: float = 1.0           # analyst utility weight in SP1
    deadline_ticks: Optional[int] = None   # admission deadline (shed past it)
    cost_cap: Optional[float] = None       # cumulative epsilon spend cap

    @property
    def n_pipelines(self) -> int:
        return len(self.bids)


class ArrivalTrace:
    """Deterministic (seeded) unbounded arrival process.

    ``step(tick)`` must be called with consecutive ticks starting at 0 and
    returns that tick's submissions.  ``reset()`` returns a fresh identical
    trace (same seed, same draws) — used by the replay parity oracle to
    consume the trace twice."""

    def __init__(self, sim: SimConfig, pattern: str = "poisson",
                 seed: Optional[int] = None, *, period: int = 48,
                 amplitude: float = 0.9, p_switch: float = 0.1,
                 burst: float = 5.0, pool: int = 8, tiers=None):
        if pattern not in PATTERNS:
            raise ValueError(
                f"unknown pattern {pattern!r}; expected one of {PATTERNS}")
        self.sim = sim
        self.pattern = pattern
        self.seed = sim.seed if seed is None else seed
        # Tiered-tenant mix (None = plain single-class trace).  Tier
        # assignment is a pure function of (seed, analyst id) on its own
        # RNG stream (tenancy.TenancyPolicy.assign), so stamping consumes
        # no draws from self.rng: a single-tier stamped trace emits
        # bitwise-identical submissions to the unstamped one.
        self.tiers = resolve_policy(tiers)
        self._knobs = dict(period=period, amplitude=amplitude,
                           p_switch=p_switch, burst=burst, pool=pool)
        self.rng = np.random.default_rng(self.seed)
        self.device_budget = self.rng.uniform(
            *sim.budget_range, sim.n_devices)
        self.blocks_per_device = sim.blocks_per_round_per_device
        self.blocks_per_tick = sim.n_devices * sim.blocks_per_round_per_device
        self._next_analyst = 0
        self._next_tick = 0
        self._bursting = False

    # ------------------------------------------------------------- control
    def reset(self) -> "ArrivalTrace":
        return ArrivalTrace(self.sim, self.pattern, self.seed,
                            tiers=self.tiers, **self._knobs)

    def precompute(self, n_ticks: int) -> "PrecomputedTrace":
        """Record the next ``n_ticks`` into a replayable trace.

        Load generation (numpy draws) happens here, once, on a fresh copy
        (``self`` is not consumed); the returned trace's ``step`` is a list
        lookup.  This is how benchmarks separate the load generator from
        the system under test, and how one trace window is replayed across
        schedulers/chunkings for comparison."""
        src = self.reset()
        events = [src.step(t) for t in range(n_ticks)]
        return PrecomputedTrace(src, events)

    # ---------------------------------------------------------- durability
    def state_dict(self) -> dict:
        """The trace cursor: RNG bit-generator state plus the consecutive-
        tick bookkeeping.  Restoring it into a *fresh* trace built from
        the same (scenario, pattern, seed, knobs) resumes the stream at
        the checkpointed tick with bitwise-identical draws — the property
        that makes service crash recovery exact at chunk boundaries."""
        return {"kind": "arrival", "pattern": self.pattern, "seed": self.seed,
                "tiers": policy_key(self.tiers),
                "rng": self.rng.bit_generator.state,
                "next_tick": self._next_tick,
                "next_analyst": self._next_analyst,
                "bursting": self._bursting}

    def load_state_dict(self, d: dict) -> None:
        if d.get("kind") != "arrival" or d.get("pattern") != self.pattern \
                or d.get("seed") != self.seed:
            raise ValueError(
                f"trace checkpoint ({d.get('kind')}/{d.get('pattern')}/"
                f"seed {d.get('seed')}) does not match this trace "
                f"(arrival/{self.pattern}/seed {self.seed})")
        # "tiers" is absent from pre-tenancy checkpoints: the
        # cursor/draws are tier-independent, so only check when recorded.
        if "tiers" in d and d["tiers"] != policy_key(self.tiers):
            raise ValueError(
                f"trace checkpoint tenant mix {d['tiers']!r} does not "
                f"match this trace's {policy_key(self.tiers)!r}")
        self.rng.bit_generator.state = d["rng"]
        self._next_tick = int(d["next_tick"])
        self._next_analyst = int(d["next_analyst"])
        self._bursting = bool(d["bursting"])

    # ------------------------------------------------------------- pattern
    def _rate(self, tick: int) -> float:
        base = self.sim.arrival_rate
        if self.pattern == "diurnal":
            k = self._knobs
            return max(0.0, base * (1.0 + k["amplitude"] *
                                    np.sin(2 * np.pi * tick / k["period"])))
        if self.pattern == "bursty":
            if self.rng.random() < self._knobs["p_switch"]:
                self._bursting = not self._bursting
            return base * self._knobs["burst"] if self._bursting else base
        return base                      # poisson / churn: stationary

    def _analyst_id(self) -> int:
        if self.pattern == "churn":
            return int(self.rng.integers(self._knobs["pool"]))
        aid = self._next_analyst
        self._next_analyst += 1
        return aid

    # --------------------------------------------------------------- steps
    def step(self, tick: int) -> List[Submission]:
        """Submissions arriving at ``tick`` (consecutive calls only)."""
        if tick != self._next_tick:
            raise ValueError(f"trace must be stepped consecutively: "
                             f"expected tick {self._next_tick}, got {tick}")
        self._next_tick += 1
        n_new = int(self.rng.poisson(self._rate(tick)))
        if tick == 0 and self.pattern != "churn":
            n_new = max(n_new, 1)        # same warm start as the episode
        return [self._draw_submission(tick) for _ in range(n_new)]

    def _draw_submission(self, tick: int) -> Submission:
        """One analyst batch with the episode's demand model: each pipeline
        demands the latest ``depth`` blocks of the analyst's device subset,
        mice/elephant epsilon mix, loss ~ U(0.5, 1)."""
        sim, rng = self.sim, self.rng
        bpd, bpr = self.blocks_per_device, self.blocks_per_tick
        T = (tick + 1) * bpd             # blocks each device has so far
        subset = rng.random() < sim.p_subset_devices
        n_dev = max(1, int(sim.subset_frac * sim.n_devices)) if subset \
            else sim.n_devices
        devices = rng.choice(sim.n_devices, size=n_dev, replace=False)
        bids, eps, loss = [], [], []
        for _ in range(sim.pipelines_per_analyst):
            mice = rng.random() < sim.mice_frac
            lo, hi = sim.mice_eps if mice else sim.elephant_eps
            depth = DEMAND_DEPTH_BLOCKS if rng.random() < sim.p_ten_blocks \
                else 1
            ts = np.arange(max(0, T - depth), T)
            base = (ts // bpd) * bpr + (ts % bpd)
            b = (devices[:, None] * bpd + base[None, :]).reshape(-1)
            bids.append(b.astype(np.int64))
            eps.append(rng.uniform(lo, hi, b.size).astype(np.float32))
            loss.append(rng.uniform(0.5, 1.0))
        sub = Submission(analyst=self._analyst_id(), submit_tick=tick,
                         bids=bids, eps=eps,
                         loss=np.asarray(loss, np.float32))
        if self.tiers is not None:
            self.tiers.stamp(sub, self.seed)
        return sub

    # ------------------------------------------------------------- derived
    def arrival_seconds(self, tick: int) -> float:
        return tick * ROUND_SECONDS


class PrecomputedTrace:
    """A recorded trace window replayed as list lookups (see
    :meth:`ArrivalTrace.precompute`).  Carries the source trace's ledger
    facts (device budgets, mint rates) so it is a drop-in for the server;
    stepping past the recorded window raises."""

    def __init__(self, src: ArrivalTrace, events: List[List[Submission]]):
        self.sim = src.sim
        self.pattern = src.pattern
        self.seed = src.seed
        self.tiers = getattr(src, "tiers", None)
        self.device_budget = src.device_budget
        self.blocks_per_device = src.blocks_per_device
        self.blocks_per_tick = src.blocks_per_tick
        self._events = events
        self._next_tick = 0

    def reset(self) -> "PrecomputedTrace":
        fresh = PrecomputedTrace.__new__(PrecomputedTrace)
        fresh.__dict__.update(self.__dict__)
        fresh._next_tick = 0
        return fresh

    def state_dict(self) -> dict:
        """Cursor only — the recorded events are the caller's to rebuild
        (restore into a fresh ``.reset()`` copy of the same window)."""
        return {"kind": "precomputed", "pattern": self.pattern,
                "seed": self.seed, "next_tick": self._next_tick}

    def load_state_dict(self, d: dict) -> None:
        if d.get("kind") != "precomputed" or d.get("pattern") != self.pattern \
                or d.get("seed") != self.seed:
            raise ValueError(
                f"trace checkpoint ({d.get('kind')}/{d.get('pattern')}/"
                f"seed {d.get('seed')}) does not match this trace "
                f"(precomputed/{self.pattern}/seed {self.seed})")
        self._next_tick = int(d["next_tick"])

    def step(self, tick: int) -> List[Submission]:
        if tick != self._next_tick:
            raise ValueError(f"trace must be stepped consecutively: "
                             f"expected tick {self._next_tick}, got {tick}")
        if tick >= len(self._events):
            raise ValueError(f"tick {tick} beyond the recorded window "
                             f"({len(self._events)} ticks)")
        self._next_tick += 1
        return self._events[tick]

    def arrival_seconds(self, tick: int) -> float:
        return tick * ROUND_SECONDS


def make_trace(scenario: str, pattern: str = "poisson", seed: int = 0,
               trace_knobs: Optional[Dict] = None, tiers=None,
               **size) -> ArrivalTrace:
    """Trace from a named scenario recipe (+ SimConfig size overrides).

    ``tiers`` (a tenant-mix name like ``"free_pro_enterprise"`` or a
    :class:`~repro_torch.service.tenancy.TenancyPolicy`) stamps every submission
    with its analyst's tier contract — the tiered-tenant traces over the
    same 9 scenario recipes."""
    sim = scenario_config(scenario, seed=seed, **size)
    return ArrivalTrace(sim, pattern, seed, tiers=tiers,
                        **(trace_knobs or {}))
