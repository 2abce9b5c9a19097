"""Observability plane for the FLaaS service.

Five parts, all host-side except the trace *outputs* (extra per-tick
outputs of the tick loop, gated by ``ServiceConfig(trace_level=...)``):

* :mod:`repro_torch.obs.registry` — labeled metrics registry
  (counters/gauges/histograms, O(1) hot-path updates) plus the
  ``absorb_summary`` adapter that maps a service summary dict onto the
  stable metric catalog.
* :mod:`repro_torch.obs.exporter` — Prometheus text-format exposition
  (:func:`render_prometheus`), a stdlib HTTP ``/metrics`` endpoint
  (:class:`MetricsServer`), and the append-only :class:`JsonlSink`
  (flush-per-record, fsync on close).
* :mod:`repro_torch.obs.tracing` — per-tick decision traces (SP1
  dual-ascent iterations / KKT residuals, SP2 water levels, swap counts,
  dominant shares) drained at chunk boundaries into a bounded host buffer
  with Chrome-trace-event / Perfetto export.
* :mod:`repro_torch.obs.profiler` — wall-clock phase timers (admission
  drain, mint planning, the tick loop, host sync, telemetry fold) with
  optional ``torch.profiler.record_function`` ranges.
* :mod:`repro_torch.obs.audit` — append-only checksummed per-grant privacy
  audit ledger plus the offline conservation verifier
  (``python -m repro_torch.obs.audit verify <ledger>``).

The whole plane is bitwise-neutral when disabled: at ``trace_level=0``
with no metrics port / audit path, the tick loop runs the same ops and
every per-tick metric is identical to a build without this package.
"""
from .audit import AuditWriter, read_ledger, verify_ledger
from .exporter import JsonlSink, MetricsServer, render_prometheus
from .profiler import PhaseProfiler
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       absorb_summary)
from .tracing import (TRACE_KEY_PREFIX, DecisionTrace, split_trace_ys,
                      trace_round_outputs, trace_ys_keys)

__all__ = [
    "AuditWriter", "read_ledger", "verify_ledger",
    "JsonlSink", "MetricsServer", "render_prometheus",
    "PhaseProfiler",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "absorb_summary",
    "TRACE_KEY_PREFIX", "DecisionTrace", "split_trace_ys",
    "trace_round_outputs", "trace_ys_keys",
]
