"""Streaming service telemetry.

The engine returns whole-episode metric arrays; a long-running service
cannot hold per-tick history forever.  :class:`StreamingTelemetry` folds
each chunk's device outputs into O(1) cumulative aggregates (efficiency /
fairness / allocation counts), tracks admission and queue-depth statistics
from the host side, and keeps grant latencies in a bounded reservoir so
percentiles stay estimable over unbounded streams.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class _Reservoir:
    """Classic reservoir sample of a scalar stream (Vitter's algorithm R)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self.buf = np.empty(capacity, np.float64)
        self.n_seen = 0
        self.rng = np.random.default_rng(seed)

    def add(self, values: np.ndarray) -> None:
        """Vectorized Vitter replacement (one batched draw per chunk).

        The fill phase is a slice copy; the replacement phase draws every
        index in ONE ``rng.integers`` call with a per-value ``high`` array
        (value ``i`` of the batch is the ``n0 + i + 1``-th seen, so
        ``j_i ~ U[0, n0 + i]`` — the same marginal as the scalar loop).
        Duplicate hits on one buffer cell resolve last-writer-wins via
        fancy assignment, matching sequential overwrite order.  NOTE: the
        RNG *stream* differs from the older per-value loop (batched
        generation consumes the bit stream in a different order), so
        reservoirs are statistically unchanged but not draw-for-draw
        reproductions of old runs — the state dict carries ``"v": 2`` to
        mark the regime.  The checkpoint contract is intact: restoring
        ``state_dict()`` mid-stream reproduces an uninterrupted run's
        subsequent draws bitwise."""
        vals = np.asarray(values, np.float64).ravel()
        if vals.size == 0:
            return
        fill = min(max(self.capacity - self.n_seen, 0), vals.size)
        if fill:
            self.buf[self.n_seen:self.n_seen + fill] = vals[:fill]
            self.n_seen += fill
            vals = vals[fill:]
        if vals.size:
            highs = self.n_seen + 1 + np.arange(vals.size, dtype=np.int64)
            js = self.rng.integers(highs)
            hit = js < self.capacity
            self.buf[js[hit]] = vals[hit]
            self.n_seen += int(vals.size)

    def percentiles(self, qs) -> Dict[str, float]:
        if self.n_seen == 0:
            return {f"p{q}": float("nan") for q in qs}
        data = self.buf[: min(self.n_seen, self.capacity)]
        return {f"p{q}": float(np.percentile(data, q)) for q in qs}

    def state_dict(self) -> dict:
        """Buffer + RNG bit-generator state: a restored reservoir makes
        the same replacement draws as the uninterrupted one, so resumed
        percentiles are bitwise-identical.  ``v=2`` marks the batched
        draw regime (see :meth:`add`); v-absent (older) states load
        fine — buffer and RNG state are draw-regime independent."""
        return {"v": 2, "capacity": self.capacity, "buf": self.buf.copy(),
                "n_seen": self.n_seen,
                "rng": self.rng.bit_generator.state}

    def load_state_dict(self, d: dict) -> None:
        d = {k: v for k, v in d.items() if k != "v"}
        if int(d["capacity"]) != self.capacity:
            raise ValueError(
                f"reservoir checkpoint capacity {d['capacity']} != "
                f"configured {self.capacity}")
        self.buf = np.asarray(d["buf"], np.float64).copy()
        self.n_seen = int(d["n_seen"])
        self.rng.bit_generator.state = d["rng"]


class _LatencyHistogram:
    """Exact per-tier latency percentiles over an unbounded stream.

    Tick latencies are small integers, so a fixed-bin count histogram
    (clipped at ``bins - 1``) gives *exact* percentiles in O(bins) memory
    — no reservoir sampling noise in the per-tier SLO metrics.  Also
    tracks attainment against an optional SLO target (latency <= target
    counts as a hit)."""

    def __init__(self, bins: int = 512):
        self.bins = bins
        self.counts = np.zeros(bins, np.int64)
        self.n = 0
        self.slo_target = None
        self.slo_hits = 0

    def add(self, latency_ticks, slo_target=None) -> None:
        lats = np.asarray(latency_ticks, np.int64).ravel()
        np.add.at(self.counts, np.clip(lats, 0, self.bins - 1), 1)
        self.n += int(lats.size)
        if slo_target is not None:
            self.slo_target = int(slo_target)
            self.slo_hits += int(np.sum(lats <= slo_target))

    def percentile(self, q: float) -> float:
        if self.n == 0:
            return float("nan")
        rank = max(0, int(np.ceil(q / 100.0 * self.n)) - 1)
        return float(np.searchsorted(np.cumsum(self.counts), rank + 1))

    def summary(self) -> Dict:
        out = {"count": self.n,
               "p50": self.percentile(50), "p90": self.percentile(90),
               "p99": self.percentile(99)}
        if self.slo_target is not None:
            out["slo_target_ticks"] = self.slo_target
            out["slo_attainment"] = (self.slo_hits / self.n
                                     if self.n else float("nan"))
        return out

    def state_dict(self) -> dict:
        return {"bins": self.bins, "counts": self.counts.copy(),
                "n": self.n, "slo_target": self.slo_target,
                "slo_hits": self.slo_hits}

    @classmethod
    def from_state_dict(cls, d: dict) -> "_LatencyHistogram":
        h = cls(int(d["bins"]))
        h.counts = np.asarray(d["counts"], np.int64).copy()
        h.n = int(d["n"])
        h.slo_target = d["slo_target"]
        h.slo_hits = int(d["slo_hits"])
        return h


class _TierStats:
    """One tier's cumulative service metrics: admission count/latency,
    time-to-first-grant, realized epsilon spend."""

    def __init__(self):
        self.admitted = 0
        self.admission = _LatencyHistogram()
        self.first_grant = _LatencyHistogram()
        self.spend = 0.0

    def summary(self) -> Dict:
        return {"admitted": self.admitted, "spend": self.spend,
                "admission_latency_ticks": self.admission.summary(),
                "first_grant_ticks": self.first_grant.summary()}

    def state_dict(self) -> dict:
        return {"admitted": self.admitted, "spend": self.spend,
                "admission": self.admission.state_dict(),
                "first_grant": self.first_grant.state_dict()}

    @classmethod
    def from_state_dict(cls, d: dict) -> "_TierStats":
        t = cls()
        t.admitted = int(d["admitted"])
        t.spend = float(d["spend"])
        t.admission = _LatencyHistogram.from_state_dict(d["admission"])
        t.first_grant = _LatencyHistogram.from_state_dict(d["first_grant"])
        return t


class StreamingTelemetry:
    """Cumulative service metrics; everything here is host-side numpy."""

    def __init__(self, latency_reservoir: int = 100_000, seed: int = 0):
        self.ticks = 0
        self.cumulative_efficiency = 0.0
        self.cumulative_fairness = 0.0
        self.cumulative_fairness_norm = 0.0
        self.total_allocated = 0
        self.total_leftover = 0.0
        self._jain_sum = 0.0
        self._queue_depth_sum = 0
        self._queue_depth_max = 0
        self._boundaries = 0
        self._latency = _Reservoir(latency_reservoir, seed)
        self.grants = 0
        self.expired_pipelines = 0   # outlived every demanded block
        # paged two-ring residency: per-chunk paging cost so the layout is
        # observable, not just fast (see docs/service.md)
        self.pages_swept = 0         # hot slots grafted back at boundaries
        self.slots_evicted = 0       # stale demand entries wiped on mint
        self._hot_occ_sum = 0.0
        self._paged_chunks = 0
        self.mode_ticks = {"wrapfree": 0, "carry": 0, "paged": 0}
        # tenancy: per-tier latency/SLO/spend stats and per-tenant
        # cumulative epsilon spend (the cost-cap enforcement signal the
        # admission queue reads at drain).  Empty until a tiered event is
        # observed — a plain single-class service carries no tenancy
        # section in its summary.
        self._tier_stats = {}        # tier name -> _TierStats
        self.tenant_spend = {}       # analyst id -> cumulative epsilon
        self.tenant_tier = {}        # analyst id -> tier name
        # certified swap pruning: rounds that ran the beamed SP2
        # sweep and how many of them failed the exactness certificate and
        # re-ran the full compacted sweep.  Zero until a pruned round is
        # observed — a swap_beam=0 service carries no pruning section in
        # its summary (keeps beam-off fingerprints unchanged).
        self.swap_cert_rounds = 0
        self.swap_cert_fallbacks = 0
        # warm-started SP1: dual-ascent effort per tick, folded
        # into the same bucket edges the registry's flaas_sp1_iters
        # histogram exports.  Zero until a warm round is observed — a
        # warm-off service carries no sp1_solver section in its summary
        # (keeps warm-off fingerprints unchanged).
        from ..obs.registry import SP1_ITER_BUCKETS
        self._sp1_edges = np.asarray(SP1_ITER_BUCKETS, np.float64)
        self.sp1_rounds = 0
        self.sp1_iters_sum = 0
        self.sp1_iters_max = 0
        self.sp1_warm_starts = 0
        self.sp1_warm_resets = 0
        self.sp1_iters_buckets = np.zeros(len(SP1_ITER_BUCKETS) + 1,
                                          np.int64)

    # ------------------------------------------------------------- updates
    def observe_chunk(self, ys: Dict[str, np.ndarray]) -> None:
        """Fold one chunk's per-tick device outputs into the aggregates."""
        self.ticks += int(np.asarray(ys["round_efficiency"]).shape[0])
        self.cumulative_efficiency += float(np.sum(ys["round_efficiency"]))
        self.cumulative_fairness += float(np.sum(ys["round_fairness"]))
        self.cumulative_fairness_norm += float(
            np.sum(ys["round_fairness_norm"]))
        self.total_allocated += int(np.sum(ys["n_allocated"]))
        self.total_leftover = float(np.asarray(ys["leftover"])[-1])
        self._jain_sum += float(np.sum(ys["round_jain"]))

    def observe_boundary(self, queue_depth: int) -> None:
        self._boundaries += 1
        self._queue_depth_sum += queue_depth
        self._queue_depth_max = max(self._queue_depth_max, queue_depth)

    def observe_chunk_mode(self, mode: str, n_ticks: int) -> None:
        """Which residency mode the chunk's tick loop ran in
        (wrapfree / paged / carry)."""
        self.mode_ticks[mode] = self.mode_ticks.get(mode, 0) + int(n_ticks)

    def observe_paging(self, pages_swept: int, slots_evicted: int,
                       hot_occupancy: float) -> None:
        """One paged chunk's hot-ring cost: slots swept back into the cold
        store at the boundary, stale demand entries evicted by mints, and
        the mean fraction of hot-ring entries holding live demand."""
        self.pages_swept += int(pages_swept)
        self.slots_evicted += int(slots_evicted)
        self._hot_occ_sum += float(hot_occupancy)
        self._paged_chunks += 1

    def observe_swap_certificates(self, fallbacks: np.ndarray) -> None:
        """One chunk's per-tick certificate-fallback indicators ([T] int,
        1 = the pruning certificate failed and the round re-ran the full
        compacted sweep).  Only emitted when ``swap_beam > 0``."""
        fallbacks = np.asarray(fallbacks)
        self.swap_cert_rounds += int(fallbacks.size)
        self.swap_cert_fallbacks += int(np.sum(fallbacks))

    def observe_sp1(self, iters: np.ndarray, resets: int = 0) -> None:
        """One warm-started chunk's per-tick SP1 dual-ascent iteration
        counts ([T] int) plus the chunk's mint-driven dual resets (slots
        whose carried multiplier was returned to the cold value).  Only
        emitted when ``sp1_warm_start`` is on."""
        iters = np.asarray(iters, np.int64).ravel()
        if iters.size == 0:
            return
        self.sp1_rounds += int(iters.size)
        self.sp1_iters_sum += int(iters.sum())
        self.sp1_iters_max = max(self.sp1_iters_max, int(iters.max()))
        self.sp1_warm_starts += int(iters.size)
        self.sp1_warm_resets += int(resets)
        idx = np.searchsorted(self._sp1_edges, iters.astype(np.float64),
                              side="left")
        self.sp1_iters_buckets += np.bincount(
            idx, minlength=self._sp1_edges.size + 1)

    def observe_expired(self, n: int) -> None:
        """Pipelines completed-with-nothing because every block they
        demanded was retired from the ledger ring before they were
        scheduled."""
        self.expired_pipelines += n

    def observe_latencies(self, latency_ticks: np.ndarray) -> None:
        """Grant latencies (grant tick - submit tick) for newly granted
        pipelines."""
        latency_ticks = np.asarray(latency_ticks)
        self.grants += int(latency_ticks.size)
        self._latency.add(latency_ticks)

    # ------------------------------------------------------------- tenancy
    def _tier(self, name: str) -> _TierStats:
        if name not in self._tier_stats:
            self._tier_stats[name] = _TierStats()
        return self._tier_stats[name]

    def observe_admissions(self, events) -> None:
        """Admitted submissions as ``(tier, latency_ticks, slo_target)``
        triples (latency = activation tick - submit tick; slo_target may
        be None)."""
        for tier, lat, slo in events:
            t = self._tier(tier)
            t.admitted += 1
            t.admission.add([lat], slo)

    def observe_first_grants(self, events) -> None:
        """Per-pipeline time-to-first-grant as
        ``(tier, latency_ticks, slo_target)`` triples."""
        for tier, lat, slo in events:
            self._tier(tier).first_grant.add([lat], slo)

    def observe_spend(self, analyst: int, tier: str, amount: float) -> None:
        """Fold one chunk's realized epsilon grant for ``analyst`` into
        the per-tenant and per-tier spend ledgers (the cost-cap signal)."""
        analyst = int(analyst)
        self.tenant_spend[analyst] = \
            self.tenant_spend.get(analyst, 0.0) + float(amount)
        self.tenant_tier[analyst] = tier
        self._tier(tier).spend += float(amount)

    # ---------------------------------------------------------- durability
    def state_dict(self) -> dict:
        """Every cumulative aggregate plus the latency reservoir (buffer
        and RNG state) — restoring this into a fresh instance continues
        the stream bitwise (see :meth:`FlaasService.save_checkpoint`)."""
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("_latency", "_tier_stats", "_sp1_edges")}
        d["sp1_iters_buckets"] = self.sp1_iters_buckets.copy()
        d["mode_ticks"] = dict(self.mode_ticks)
        d["tenant_spend"] = dict(self.tenant_spend)
        d["tenant_tier"] = dict(self.tenant_tier)
        d["latency"] = self._latency.state_dict()
        d["tier_stats"] = {name: t.state_dict()
                           for name, t in self._tier_stats.items()}
        return d

    def load_state_dict(self, d: dict) -> None:
        d = dict(d)
        self._latency.load_state_dict(d.pop("latency"))
        self.mode_ticks = dict(d.pop("mode_ticks"))
        # absent from pre-tenancy checkpoints — default to empty
        self._tier_stats = {name: _TierStats.from_state_dict(td)
                            for name, td in d.pop("tier_stats", {}).items()}
        for k, v in d.items():
            if k not in self.__dict__:
                raise ValueError(f"unknown telemetry checkpoint field {k!r}")
            if k == "sp1_iters_buckets":
                v = np.asarray(v, np.int64).copy()
            setattr(self, k, v)

    # ------------------------------------------------------------- summary
    def summary(self, admission: Dict | None = None,
                wall_seconds: float | None = None) -> Dict:
        out = {
            "ticks": self.ticks,
            "cumulative_efficiency": self.cumulative_efficiency,
            "cumulative_fairness": self.cumulative_fairness,
            "cumulative_fairness_norm": self.cumulative_fairness_norm,
            "mean_jain": self._jain_sum / max(self.ticks, 1),
            "total_allocated": self.total_allocated,
            "final_leftover": self.total_leftover,
            "grants": self.grants,
            "expired_pipelines": self.expired_pipelines,
            "queue_depth_mean": self._queue_depth_sum /
            max(self._boundaries, 1),
            "queue_depth_max": self._queue_depth_max,
            "grant_latency_ticks": self._latency.percentiles((50, 90, 99)),
            "paging": {
                "mode_ticks": dict(self.mode_ticks),
                "pages_swept": self.pages_swept,
                "slots_evicted": self.slots_evicted,
                "hot_occupancy_mean": self._hot_occ_sum /
                max(self._paged_chunks, 1),
            },
        }
        if self.swap_cert_rounds:
            out["swap_pruning"] = {
                "rounds": self.swap_cert_rounds,
                "cert_fallbacks": self.swap_cert_fallbacks,
                "cert_rate": 1.0 - (self.swap_cert_fallbacks /
                                    self.swap_cert_rounds),
            }
        if self.sp1_rounds:
            out["sp1_solver"] = {
                "rounds": self.sp1_rounds,
                "iters_total": self.sp1_iters_sum,
                "iters_mean": self.sp1_iters_sum / self.sp1_rounds,
                "iters_max": self.sp1_iters_max,
                "warm_starts": self.sp1_warm_starts,
                "warm_resets": self.sp1_warm_resets,
                "iters_buckets": [int(x) for x in self.sp1_iters_buckets],
            }
        if self._tier_stats:
            out["tenancy"] = {
                "tiers": {name: t.summary()
                          for name, t in sorted(self._tier_stats.items())},
                # per-tenant realized spend (string keys: JSON-portable)
                "tenant_spend": {str(a): s for a, s
                                 in sorted(self.tenant_spend.items())},
                "tenants": len(self.tenant_spend),
            }
        if admission:
            out["admission"] = dict(admission)
            offered = max(admission.get("offered", 0), 1)
            out["admission_rate"] = admission.get("admitted", 0) / offered
            out["rejection_rate"] = admission.get("rejected", 0) / offered
            # head-of-line deferral events per offered submission: makes a
            # stalled-but-nonempty queue visible (a submission deferred at
            # several boundaries counts each time, so the rate can top 1.0
            # under sustained head-of-line blocking).
            out["deferral_rate"] = admission.get("deferred", 0) / offered
        if wall_seconds is not None and wall_seconds > 0:
            out["wall_seconds"] = wall_seconds
            out["ticks_per_second"] = self.ticks / wall_seconds
            if admission:
                out["admissions_per_second"] = \
                    admission.get("admitted", 0) / wall_seconds
        return out


# summary keys derived from wall-clock time — the only parts of a summary
# that legitimately differ between an uninterrupted run and a
# checkpoint/restore replay of the same ticks.
WALL_KEYS = ("wall_seconds", "ticks_per_second", "admissions_per_second")


def summary_fingerprint(summary: Dict) -> Dict:
    """``summary`` with every wall-clock-derived key stripped (recursively)
    — two runs that performed identical scheduling work have *equal*
    fingerprints, which is how the crash-recovery tests and the
    ``--smoke`` parity row assert bitwise resume."""
    return {k: summary_fingerprint(v) if isinstance(v, dict) else v
            for k, v in summary.items() if k not in WALL_KEYS}


def json_safe(obj):
    """Recursively coerce a summary into plain JSON-serializable types:
    numpy scalars/arrays -> Python numbers/lists, dict keys -> str, and
    NaN/inf -> None (strict JSON has no literal for them).  This is the
    serializer behind ``ServiceConfig(telemetry_path=...)``'s JSON-lines
    export — the output round-trips through ``json.dumps(...,
    allow_nan=False)``."""
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [json_safe(v) for v in obj.tolist()]
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        f = float(obj)
        return f if np.isfinite(f) else None
    return obj
