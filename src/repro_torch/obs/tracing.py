"""Per-tick decision traces.

The scheduler's internals (SP1 dual-ascent iterations and KKT residual,
SP2 boost water level, swap candidates/acceptances, per-analyst dominant
shares) are all intermediates the round already computes —
:class:`~repro_torch.core.scheduler.RoundResult` carries them as trailing
optional fields.  :func:`trace_round_outputs` turns them into extra
per-tick outputs of the service tick body, gated by
``ServiceConfig(trace_level=...)``:

* level 0 — no trace keys exist; the tick body runs exactly the ops of a
  build without this module (bitwise-neutral, asserted in tests);
* level 1 — SP1 internals + per-analyst allocation/utility/dominant
  share (5 keys);
* level 2 — adds SP2 internals: boosted objective, boost water level,
  swap-candidate counts and accepted swaps, overdraw-guard scale.

The service drains trace ys from the chunk output at the boundary into a
:class:`DecisionTrace` — a bounded host-side ring of per-tick records
with Chrome-trace-event (Perfetto-loadable) export.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Dict, Tuple

import numpy as np
import torch

TRACE_KEY_PREFIX = "trace_"

_L1_KEYS = ("trace_sp1_iters", "trace_sp1_residual", "trace_x_analyst",
            "trace_utility", "trace_dominant_share")
_L2_KEYS = ("trace_sp2_objective", "trace_boost_water",
            "trace_swap_candidates", "trace_swap_accepted",
            "trace_grant_scale", "trace_swap_cert_ok",
            "trace_swap_cert_margin")


def trace_ys_keys(level: int) -> Tuple[str, ...]:
    """The exact output key set a chunk emits at ``trace_level=level``
    (what the drain is keyed on)."""
    if level <= 0:
        return ()
    return _L1_KEYS + (_L2_KEYS if level >= 2 else ())


def trace_round_outputs(res, pending, level: int) -> Dict[str, torch.Tensor]:
    """Per-tick trace outputs from one round's :class:`RoundResult`.

    ``pending`` is the [M, N] active mask the round saw (for the
    swap-candidate count: a refinement pass over ``m`` selected of ``n``
    active pipelines evaluates ``m * (n - m)`` candidates, the compacted
    grid of :func:`repro_torch.core.swap.swap_candidates`).  Baseline
    schedulers leave the SP1/SP2 fields ``None``; zeros / unit scale are
    substituted so the trace schema is scheduler-independent.  Every value
    stays on the round's device.
    """
    if level <= 0:
        return {}
    M = res.utility.shape[0]
    f32, dev = res.utility.dtype, res.utility.device
    i32 = torch.int32
    zeros_m = torch.zeros((M,), dtype=f32, device=dev)
    out = {
        "trace_sp1_iters": (torch.zeros((), dtype=i32, device=dev)
                            if res.sp1_iters is None
                            else res.sp1_iters.to(i32)),
        "trace_sp1_residual": res.sp1_violation.to(f32),
        "trace_x_analyst": res.x_analyst,
        "trace_utility": res.utility,
        "trace_dominant_share": (zeros_m if res.mu_real is None
                                 else res.mu_real),
    }
    if level >= 2:
        m_sel = torch.sum(res.selected, dim=1).to(i32)
        n_act = torch.sum(pending, dim=1).to(i32)
        out["trace_sp2_objective"] = (zeros_m if res.sp2_objective is None
                                      else res.sp2_objective)
        out["trace_boost_water"] = (zeros_m if res.sp2_water is None
                                    else res.sp2_water)
        out["trace_swap_candidates"] = m_sel * (n_act - m_sel)
        out["trace_swap_accepted"] = (
            torch.zeros((M,), dtype=torch.bool, device=dev)
            if res.swap_accepted is None else res.swap_accepted)
        out["trace_grant_scale"] = (torch.ones((), dtype=f32, device=dev)
                                    if res.grant_scale is None
                                    else res.grant_scale)
        # certified swap pruning: per-round certificate verdict and
        # tightest margin.  Full-sweep (swap_beam=0) and baseline rounds
        # carry None -- substitute the trivially-certified values so the
        # level-2 schema stays scheduler- and config-independent.
        cert = res.swap_cert_ok
        out["trace_swap_cert_ok"] = (
            torch.ones((), dtype=torch.bool, device=dev) if cert is None
            else cert)
        marg = res.swap_cert_margin
        out["trace_swap_cert_margin"] = (
            torch.zeros((), dtype=f32, device=dev) if marg is None
            else marg.to(f32))
    return out


def split_trace_ys(ys: Dict[str, np.ndarray]):
    """Pop every ``trace_*`` key out of a chunk's host-side ys dict;
    returns ``(ys_without_traces, traces)``."""
    traces = {k: ys.pop(k) for k in list(ys) if k.startswith(TRACE_KEY_PREFIX)}
    return ys, traces


class DecisionTrace:
    """Bounded host-side ring of per-tick decision records.

    ``extend`` ingests one chunk's trace ys ([T]-leading arrays) at the
    boundary; the newest ``max_ticks`` ticks are retained.  Export is
    Chrome trace-event JSON (counter events on the tick timeline, one
    process per series, per-analyst series as event args), loadable in
    Perfetto / ``chrome://tracing``.
    """

    # wall micros per tick on the trace timeline (display scale only)
    _US_PER_TICK = 1000.0

    def __init__(self, level: int, max_ticks: int = 4096):
        self.level = int(level)
        self.max_ticks = int(max_ticks)
        self.ticks: deque = deque(maxlen=self.max_ticks)

    def __len__(self) -> int:
        return len(self.ticks)

    def extend(self, tick0: int, traces: Dict[str, np.ndarray]) -> None:
        if not traces:
            return
        n = next(iter(traces.values())).shape[0]
        for t in range(n):
            rec = {"tick": int(tick0) + t}
            for key, arr in traces.items():
                v = np.asarray(arr[t])
                rec[key[len(TRACE_KEY_PREFIX):]] = (
                    v.item() if v.ndim == 0 else v)
            self.ticks.append(rec)

    def records(self):
        """Per-tick records with numpy arrays coerced to lists."""
        out = []
        for rec in self.ticks:
            out.append({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                        for k, v in rec.items()})
        return out

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON: ``ph: "C"`` counter events, ``ts`` =
        tick * 1ms on the display timeline."""
        events = []
        for rec in self.ticks:
            ts = rec["tick"] * self._US_PER_TICK
            for key, v in rec.items():
                if key == "tick":
                    continue
                if isinstance(v, np.ndarray):
                    args = {f"a{i}": float(x) for i, x in enumerate(v)}
                else:
                    args = {"value": float(v)}
                events.append({"name": key, "ph": "C", "ts": ts,
                               "pid": 1, "tid": 1, "args": args})
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"trace_level": self.level,
                              "ticks": len(self.ticks)}}

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome_trace(), f)
