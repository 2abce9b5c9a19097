"""Batched admission with backpressure, priority classes, and SLO policing.

Submissions accumulate host-side in a set of per-priority-class FIFOs; at
every chunk boundary the server drains up to ``admit_batch`` of them into
free slots of the :class:`~repro_torch.service.state.SlotTable`.  Outcomes per
submission:

* **admitted** — a row (and enough pipeline columns) was free;
* **deferred** — the table is full or the analyst's row has no free
  columns; the submission stays queued, FIFO order within its class
  preserved (head-of-line blocking is deliberate: skipping ahead would
  starve large batches);
* **rejected** — the queue itself is full (``max_pending``), or the
  submission asks for more pipelines than a row can ever hold
  (``max_pipelines``) and would head-of-line block its class forever;
* **rejected_deadline** — the submission's admission deadline
  (``Submission.deadline_ticks``) passed while it was queued: it is shed
  at the next drain instead of admitted late (shedding is monotone in the
  drain tick — once past its deadline a submission can never be admitted);
* **rejected_cost_cap** — the tenant's telemetry-tracked cumulative
  epsilon spend already meets ``Submission.cost_cap``.

Drain order is **strict priority** (higher ``Submission.priority`` class
first, FIFO within each class) with an *aging* anti-starvation rule: once
a class's head has waited at least ``age_ticks``, it competes at top
priority, and among aged heads the globally oldest wins — so sustained
high-priority load can delay, but never indefinitely starve, a lower
class.  A single class (every submission priority 0, the default) is
exactly the old global FIFO.

Head-of-line deferrals are counted (``AdmissionStats.deferred``) so a
stalled queue is distinguishable from an empty one in
``telemetry.summary()`` (``deferral_rate``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .state import SlotTable
from .traces import Submission

# state_dict schema: bump on incompatible change.  Version 1 (pre-tenancy)
# was a single {"pending": [...], "stats": {...}} FIFO and is still
# accepted by load_state_dict (every v1 submission re-buckets into its
# priority class — 0, the only class v1 could hold).
_QUEUE_VERSION = 2


@dataclasses.dataclass
class AdmissionStats:
    offered: int = 0          # submissions handed to offer()
    admitted: int = 0
    rejected: int = 0         # dropped: backpressure, unfit, shed, capped
    rejected_oversize: int = 0  # subset of rejected: could never fit a row
    rejected_deadline: int = 0  # subset: admission deadline passed queued
    rejected_cost_cap: int = 0  # subset: tenant spend already at its cap
    deferred: int = 0         # head-of-line deferral events at drain()
    pipelines_admitted: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class AdmissionQueue:
    """Bounded per-priority-class FIFOs of pending submissions (host side).

    ``max_pipelines`` (the slot table's column count, when given) rejects
    submissions at ``offer`` time that no row could ever hold — deferring
    them would head-of-line block their class forever.  ``age_ticks``
    enables the aging/anti-starvation rule at drain (None: pure strict
    priority)."""

    def __init__(self, max_pending: int = 1024,
                 max_pipelines: Optional[int] = None,
                 age_ticks: Optional[int] = None):
        self.max_pending = max_pending
        self.max_pipelines = max_pipelines
        self.age_ticks = age_ticks
        self._classes: Dict[int, deque] = {}
        self.stats = AdmissionStats()

    # --------------------------------------------------------------- views
    @property
    def pending(self) -> List[Submission]:
        """Every queued submission in drain order (priority descending,
        FIFO within each class) — the combined view checkpoint round-trip
        tests and callers iterate; with one class it is the plain FIFO."""
        out: List[Submission] = []
        for p in sorted(self._classes, reverse=True):
            out.extend(self._classes[p])
        return out

    @property
    def depth(self) -> int:
        return sum(len(q) for q in self._classes.values())

    def pending_pipelines(self) -> int:
        """Total pipelines (not submissions) waiting — the demand side of
        a sharded plane's chunk-boundary free-slot census (the supply
        side would be the all-gathered per-shard count)."""
        return sum(s.n_pipelines for q in self._classes.values() for s in q)

    # --------------------------------------------------------------- offer
    def offer(self, subs: List[Submission]) -> int:
        """Enqueue new submissions; returns how many were rejected."""
        rejected = 0
        for sub in subs:
            self.stats.offered += 1
            if (self.max_pipelines is not None
                    and sub.n_pipelines > self.max_pipelines):
                rejected += 1
                self.stats.rejected += 1
                self.stats.rejected_oversize += 1
            elif self.depth >= self.max_pending:
                rejected += 1
                self.stats.rejected += 1
            else:
                prio = int(getattr(sub, "priority", 0))
                self._classes.setdefault(prio, deque()).append(sub)
        return rejected

    # --------------------------------------------------------------- drain
    def _shed_expired(self, now_tick: int) -> None:
        """Deadline-expiry shedding: drop every queued submission whose
        admission deadline has passed.  Monotone in ``now_tick`` — the
        shed set at tick t is a subset of the shed set at any t' >= t."""
        for prio, q in self._classes.items():
            kept = deque()
            for sub in q:
                dl = getattr(sub, "deadline_ticks", None)
                if dl is not None and now_tick - sub.submit_tick > dl:
                    self.stats.rejected += 1
                    self.stats.rejected_deadline += 1
                else:
                    kept.append(sub)
            self._classes[prio] = kept

    def _next_class(self, now_tick: Optional[int]) -> Optional[int]:
        """The class whose head drains next: strict priority, except that
        aged heads (waited >= age_ticks) compete at top priority and the
        globally oldest aged head wins (ties break toward the higher
        class)."""
        live = [p for p, q in self._classes.items() if q]
        if not live:
            return None
        if self.age_ticks is not None and now_tick is not None:
            aged = [p for p in live
                    if now_tick - self._classes[p][0].submit_tick
                    >= self.age_ticks]
            if aged:
                return min(aged, key=lambda p:
                           (self._classes[p][0].submit_tick, -p))
        return max(live)

    def drain(self, table: SlotTable, admit_batch: int,
              now_tick: Optional[int] = None,
              spend: Optional[Callable[[int], float]] = None,
              ) -> List[Tuple[Submission, int, List[int]]]:
        """Admit up to ``admit_batch`` queued submissions into free slots.

        Returns ``(submission, row, cols)`` placements; the caller applies
        them to device state (the server activates each at
        ``max(submit_tick, boundary)``, so prefetched arrivals activate at
        their arrival tick and deferred ones as soon as admitted).  Stops
        at the first selected head that does not fit; each such stop with
        work still queued counts one head-of-line deferral.

        ``now_tick`` (the boundary tick) enables deadline shedding and
        aging; ``spend`` maps an analyst id to its cumulative realized
        epsilon spend (telemetry-tracked) for cost-cap enforcement.  Both
        default off, preserving the plain-FIFO drain."""
        if now_tick is not None:
            self._shed_expired(now_tick)
        placements: List[Tuple[Submission, int, List[int]]] = []
        while len(placements) < admit_batch:
            prio = self._next_class(now_tick)
            if prio is None:
                break
            q = self._classes[prio]
            sub = q[0]
            cap = getattr(sub, "cost_cap", None)
            if cap is not None and spend is not None \
                    and float(spend(sub.analyst) or 0.0) >= cap:
                q.popleft()
                self.stats.rejected += 1
                self.stats.rejected_cost_cap += 1
                continue
            placed = table.row_for(sub.analyst, sub.n_pipelines)
            if placed is None:
                self.stats.deferred += 1
                break
            row, cols = placed
            table.commit(sub.analyst, row, cols, sub.submit_tick)
            q.popleft()
            self.stats.admitted += 1
            self.stats.pipelines_admitted += sub.n_pipelines
            placements.append((sub, row, cols))
        return placements

    # ------------------------------------------------------------ durability
    def state_dict(self) -> dict:
        """Snapshot for :meth:`FlaasService.save_checkpoint`: every class
        FIFO (order preserved) and the cumulative counters."""
        return {"version": _QUEUE_VERSION,
                "classes": {int(p): list(q)
                            for p, q in self._classes.items() if q},
                "stats": self.stats.snapshot()}

    def load_state_dict(self, d: dict) -> None:
        if "classes" in d:                       # v2: per-class FIFOs
            self._classes = {int(p): deque(subs)
                             for p, subs in d["classes"].items()}
        else:                                    # v1: one FIFO
            self._classes = {}
            for sub in d["pending"]:
                prio = int(getattr(sub, "priority", 0))
                self._classes.setdefault(prio, deque()).append(sub)
        stats = dict(d["stats"])                 # v1 lacks the new counters
        self.stats = AdmissionStats(**stats)
