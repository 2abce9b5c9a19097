"""Labeled metrics registry — counters, gauges, histograms.

Prometheus-shaped but dependency-free: a metric is a name + help string +
label names; each label-value tuple owns one cell.  Hot-path updates are
one dict lookup + one float add (O(1)); histograms batch-observe numpy
arrays via ``searchsorted``.  The registry is a plain host object —
``state_dict``/``load_state_dict`` ride the checkpoint host-payload
channel, and :meth:`MetricsRegistry.merge` folds another registry's cells
in (the sharded service folds per-shard deltas at the chunk-boundary
all-gather).

:func:`absorb_summary` is the adapter from the service's streaming
telemetry summary dict onto the stable ``flaas_*`` metric catalog
(documented in ``docs/observability.md``).  Cumulative aggregates map to
counters via ``set_total`` (monotone set-to-value, so re-absorbing a
summary is idempotent rather than double-counting).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np

_TYPES = ("counter", "gauge", "histogram")

# default histogram buckets: wall-clock seconds (phase timers, chunk walls)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)

# SP1 dual-ascent iteration counts (warm-started solver): a warm
# steady-state solve lands in the 10-20 band, a cold/perturbed one in the
# hundreds, and the top bucket matches the solver's default max_iters.
SP1_ITER_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                    1000.0, 2000.0, 4000.0)


def _check_labels(labelnames: Tuple[str, ...], labels: Tuple[str, ...]):
    if len(labels) != len(labelnames):
        raise ValueError(
            f"expected {len(labelnames)} label value(s) {labelnames}, "
            f"got {labels!r}")


class _Metric:
    """Base: one named family; cells keyed by label-value tuples."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._cells: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels) -> Tuple[str, ...]:
        key = tuple(str(v) for v in labels)
        _check_labels(self.labelnames, key)
        return key

    def cells(self) -> Dict[Tuple[str, ...], float]:
        return dict(self._cells)


class Counter(_Metric):
    """Monotone counter.  ``inc`` adds; ``set_total`` sets the cumulative
    value directly (for absorbing an upstream aggregate that is already
    cumulative — never decreases)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, labels: Iterable = ()) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        self._cells[key] = self._cells.get(key, 0.0) + amount

    def set_total(self, total: float, labels: Iterable = ()) -> None:
        key = self._key(labels)
        cur = self._cells.get(key, 0.0)
        if total + 1e-9 < cur:
            raise ValueError(
                f"counter {self.name}{key} would decrease: {cur} -> {total}")
        self._cells[key] = float(total)

    def value(self, labels: Iterable = ()) -> float:
        return self._cells.get(self._key(labels), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, labels: Iterable = ()) -> None:
        self._cells[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, labels: Iterable = ()) -> None:
        key = self._key(labels)
        self._cells[key] = self._cells.get(key, 0.0) + amount

    def value(self, labels: Iterable = ()) -> float:
        return self._cells.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative ``le`` buckets on export).

    Each cell is ``[counts per bucket + overflow, sum, n]``; observing a
    numpy batch is one ``searchsorted`` + ``bincount``."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames=(),
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError("buckets must be strictly increasing")
        self.buckets = tuple(float(b) for b in buckets)
        self._edges = np.asarray(self.buckets, np.float64)

    def _cell(self, labels):
        key = self._key(labels)
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = {
                "counts": np.zeros(len(self.buckets) + 1, np.int64),
                "sum": 0.0, "n": 0}
        return cell

    def observe(self, value: float, labels: Iterable = ()) -> None:
        self.observe_many(np.asarray([value], np.float64), labels)

    def observe_many(self, values: np.ndarray, labels: Iterable = ()) -> None:
        vals = np.asarray(values, np.float64).ravel()
        if vals.size == 0:
            return
        cell = self._cell(labels)
        idx = np.searchsorted(self._edges, vals, side="left")
        cell["counts"] += np.bincount(idx, minlength=len(self.buckets) + 1)
        cell["sum"] += float(vals.sum())
        cell["n"] += int(vals.size)


class MetricsRegistry:
    """Collection of metric families, keyed by name.  Getter methods are
    get-or-create and type-checked, so call sites can be stateless."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, labelnames, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, tuple(labelnames), **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        elif m.labelnames != tuple(labelnames):
            raise ValueError(f"metric {name!r} labelnames mismatch: "
                             f"{m.labelnames} != {tuple(labelnames)}")
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def metrics(self):
        return [self._metrics[k] for k in sorted(self._metrics)]

    # ------------------------------------------------------------ folding
    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other``'s cells into this registry: counters and
        histogram counts add; gauges take ``other``'s value (last writer
        wins).  Used to fold per-shard registry deltas at the chunk
        boundary — merge is associative, and commutative for the additive
        kinds (asserted by the hypothesis property suite)."""
        for name in sorted(other._metrics):
            m = other._metrics[name]
            if isinstance(m, Histogram):
                mine = self.histogram(name, m.help, m.labelnames, m.buckets)
                for key, cell in m._cells.items():
                    dst = mine._cell(key)
                    dst["counts"] += cell["counts"]
                    dst["sum"] += cell["sum"]
                    dst["n"] += cell["n"]
            elif isinstance(m, Counter):
                mine = self.counter(name, m.help, m.labelnames)
                for key, v in m._cells.items():
                    mine._cells[key] = mine._cells.get(key, 0.0) + v
            else:
                mine = self.gauge(name, m.help, m.labelnames)
                mine._cells.update(m._cells)

    # --------------------------------------------------------- durability
    def state_dict(self) -> dict:
        out = {"version": 1, "metrics": {}}
        for name, m in self._metrics.items():
            entry = {"kind": m.kind, "help": m.help,
                     "labelnames": list(m.labelnames)}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
                entry["cells"] = {
                    key: {"counts": cell["counts"].copy(),
                          "sum": cell["sum"], "n": cell["n"]}
                    for key, cell in m._cells.items()}
            else:
                entry["cells"] = dict(m._cells)
            out["metrics"][name] = entry
        return out

    def load_state_dict(self, d: dict) -> None:
        self._metrics = {}
        for name, entry in d.get("metrics", {}).items():
            labelnames = tuple(entry["labelnames"])
            if entry["kind"] == "histogram":
                m = self.histogram(name, entry["help"], labelnames,
                                   tuple(entry["buckets"]))
                for key, cell in entry["cells"].items():
                    dst = m._cell(tuple(key))
                    dst["counts"] = np.asarray(cell["counts"],
                                               np.int64).copy()
                    dst["sum"] = float(cell["sum"])
                    dst["n"] = int(cell["n"])
            else:
                cls = Counter if entry["kind"] == "counter" else Gauge
                m = self._get(cls, name, entry["help"], labelnames)
                m._cells = {tuple(k): float(v)
                            for k, v in entry["cells"].items()}


# --------------------------------------------------------------- absorber
def _finite(x) -> bool:
    try:
        return math.isfinite(float(x))
    except (TypeError, ValueError):
        return False


def absorb_summary(reg: MetricsRegistry, summary: Dict) -> None:
    """Map a :meth:`StreamingTelemetry.summary` dict (plus the admission /
    paging / tenancy sections the service folds in) onto the ``flaas_*``
    catalog.  Cumulative upstream aggregates go through ``set_total`` so
    absorbing successive summaries of the same stream is idempotent."""
    c, g = reg.counter, reg.gauge
    c("flaas_ticks_total", "Service ticks executed").set_total(
        summary.get("ticks", 0))
    c("flaas_pipelines_allocated_total",
      "Pipeline grants (one per selected pipeline-tick)").set_total(
        summary.get("total_allocated", 0))
    c("flaas_grants_total",
      "Pipelines granted at least once").set_total(summary.get("grants", 0))
    c("flaas_pipelines_expired_total",
      "Pipelines retired with zero grant (every demanded block "
      "left the ring)").set_total(summary.get("expired_pipelines", 0))
    c("flaas_efficiency_total",
      "Cumulative dominant efficiency (paper Eq 8)").set_total(
        summary.get("cumulative_efficiency", 0.0))
    c("flaas_fairness_total",
      "Cumulative dominant fairness (paper Eq 9)").set_total(
        max(summary.get("cumulative_fairness", 0.0), 0.0))
    g("flaas_jain_index_mean", "Mean per-tick Jain index").set(
        summary.get("mean_jain", 0.0))
    g("flaas_leftover_epsilon", "Unspent epsilon across the live ring "
      "after the last tick").set(summary.get("final_leftover", 0.0))
    g("flaas_queue_depth_mean", "Mean admission queue depth at chunk "
      "boundaries").set(summary.get("queue_depth_mean", 0.0))
    g("flaas_queue_depth_max", "Max admission queue depth").set(
        summary.get("queue_depth_max", 0))
    for q, v in summary.get("grant_latency_ticks", {}).items():
        if _finite(v):
            g("flaas_grant_latency_ticks",
              "Grant latency reservoir percentiles",
              ("quantile",)).set(v, (q,))

    adm = summary.get("admission", {})
    for outcome in ("offered", "admitted", "rejected", "deferred",
                    "shed_deadline", "capped"):
        if outcome in adm:
            c("flaas_admission_total", "Admission pipeline outcomes",
              ("outcome",)).set_total(adm[outcome], (outcome,))

    paging = summary.get("paging", {})
    for mode, ticks in paging.get("mode_ticks", {}).items():
        c("flaas_mode_ticks_total", "Ticks per residency mode",
          ("mode",)).set_total(ticks, (mode,))
    c("flaas_pages_swept_total", "Hot-ring slots grafted back at chunk "
      "boundaries").set_total(paging.get("pages_swept", 0))
    c("flaas_slots_evicted_total", "Stale demand entries wiped by "
      "mints").set_total(paging.get("slots_evicted", 0))
    g("flaas_hot_occupancy_mean", "Mean live fraction of the hot "
      "ring").set(paging.get("hot_occupancy_mean", 0.0))

    sp1 = summary.get("sp1_solver", {})
    if sp1:
        c("flaas_sp1_warm_starts_total",
          "SP1 solves entered from carried duals").set_total(
            sp1.get("warm_starts", 0))
        c("flaas_sp1_warm_resets_total",
          "Per-slot dual resets to the cold value at block mint").set_total(
            sp1.get("warm_resets", 0))
        # the telemetry plane already folded the per-tick counts into
        # bucket totals (same edges), so the histogram cell is set to the
        # cumulative values directly — idempotent like set_total above.
        hist = reg.histogram("flaas_sp1_iters",
                             "SP1 dual-ascent iterations per round",
                             buckets=SP1_ITER_BUCKETS)
        cell = hist._cell(())
        cell["counts"] = np.asarray(sp1.get("iters_buckets",
                                            cell["counts"]),
                                    np.int64).copy()
        cell["n"] = int(sp1.get("rounds", 0))
        cell["sum"] = float(sp1.get("iters_total", 0))

    pruning = summary.get("swap_pruning", {})
    if pruning:
        c("flaas_swap_cert_rounds_total",
          "Rounds scheduled through the certified SP2 pruning "
          "beam").set_total(pruning.get("rounds", 0))
        c("flaas_swap_cert_fallback_total",
          "Pruned rounds whose exactness certificate failed (re-ran the "
          "full compacted sweep)").set_total(
            pruning.get("cert_fallbacks", 0))
        g("flaas_swap_cert_rate",
          "Fraction of pruned rounds certified exact").set(
            pruning.get("cert_rate", 1.0))

    ten = summary.get("tenancy", {})
    for tier, ts in ten.get("tiers", {}).items():
        c("flaas_tier_admitted_total", "Admissions per service tier",
          ("tier",)).set_total(ts.get("admitted", 0), (tier,))
        c("flaas_tier_spend_total", "Realized epsilon spend per tier",
          ("tier",)).set_total(ts.get("spend", 0.0), (tier,))
        for section in ("admission_latency_ticks", "first_grant_ticks"):
            sec = ts.get(section, {})
            att = sec.get("slo_attainment")
            if _finite(att):
                g("flaas_tier_slo_attainment",
                  "Fraction of events meeting the tier SLO target",
                  ("tier", "slo")).set(att, (tier, section))
            for q in ("p50", "p90", "p99"):
                if _finite(sec.get(q)):
                    g("flaas_tier_latency_ticks",
                      "Per-tier latency percentiles (exact, "
                      "integer-tick histograms)",
                      ("tier", "event", "quantile")).set(
                        sec[q], (tier, section, q))
    if "tenants" in ten:
        g("flaas_tenants", "Tenants with realized spend").set(ten["tenants"])

    if _finite(summary.get("ticks_per_second")):
        g("flaas_ticks_per_second", "Service throughput (wall)").set(
            summary["ticks_per_second"])

    shards = summary.get("sharding", {})
    if "n_shards" in shards:
        g("flaas_shards", "Block-ledger stripe count").set(
            shards["n_shards"])
        g("flaas_free_pipeline_slots", "Unoccupied pipeline slots at the "
          "last boundary census").set(shards.get("free_pipeline_slots", 0))
        for s, live in enumerate(shards.get("shard_live_blocks", [])):
            g("flaas_shard_live_blocks", "Live minted blocks per stripe",
              ("shard",)).set(live, (str(s),))
