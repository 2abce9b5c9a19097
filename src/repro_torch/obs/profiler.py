"""Wall-clock phase profiler for the service tick loop.

The chunk loop has a handful of host phases worth separating: admission
drain, mint/page planning, the chunk's tick loop, host sync
(device -> numpy), 
telemetry fold, checkpoint save.  :class:`PhaseProfiler` accumulates
``perf_counter`` wall time and call counts per phase — two float adds per
phase boundary, cheap enough to stay always-on — and optionally opens a
``torch.profiler.record_function`` range per phase so the phases land on
the ``torch.profiler`` timeline when one is being captured.

State rides the checkpoint host payload (wall totals resume across
restores), and :meth:`publish` mirrors the totals into the metrics
registry as ``flaas_phase_seconds_total`` / ``flaas_phase_calls_total``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class PhaseProfiler:
    def __init__(self, annotate: bool = False):
        self.annotate = bool(annotate)
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.annotate:
            ctx = torch.profiler.record_function(f"flaas/{name}")
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.observe(name, time.perf_counter() - t0)

    def observe(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + float(seconds)
        self.calls[name] = self.calls.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name in sorted(self.seconds):
            n = self.calls[name]
            s = self.seconds[name]
            out[name] = {"calls": n, "seconds": s,
                         "mean_us": (s / n) * 1e6 if n else 0.0}
        return out

    def publish(self, registry) -> None:
        sec = registry.counter("flaas_phase_seconds_total",
                               "Host wall seconds per tick-loop phase",
                               ("phase",))
        cnt = registry.counter("flaas_phase_calls_total",
                               "Calls per tick-loop phase", ("phase",))
        for name in self.seconds:
            sec.set_total(self.seconds[name], (name,))
            cnt.set_total(self.calls[name], (name,))

    # ---------------------------------------------------------- durability
    def state_dict(self) -> dict:
        return {"seconds": dict(self.seconds), "calls": dict(self.calls)}

    def load_state_dict(self, d: dict) -> None:
        self.seconds = {k: float(v) for k, v in d.get("seconds", {}).items()}
        self.calls = {k: int(v) for k, v in d.get("calls", {}).items()}
