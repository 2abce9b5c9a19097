"""Streaming FLaaS service plane — continuous admission, persistent block
ledger, and load-driven scheduling layered on the episode engine.

The engine (:mod:`repro_torch.core.engine`) evaluates *pre-generated
finite* episodes; this package turns the same per-round scheduling
machinery into a long-running online system: unbounded arrival traces, a
fixed-capacity device-resident state with slot recycling, batched
admission with backpressure, a chunked tick loop with host sync only at
chunk boundaries, streaming telemetry, and a replay oracle that pins the
service loop against ``engine.run_episode``.  See ``docs/service.md``.
"""
from .queue import AdmissionQueue, AdmissionStats
from .replay import (PARITY_KEYS, collect_service_metrics, freeze_trace,
                     replay_gap)
from .server import FlaasService, ServiceConfig
from .state import (NEVER, MintPlan, PagePlan, ServiceState, SlotTable,
                    admit_batch, plan_mints, plan_pages)
from .telemetry import StreamingTelemetry, json_safe, summary_fingerprint
from .tenancy import (FREE_PRO_ENTERPRISE, SINGLE_TIER, TENANT_MIXES,
                      TenancyPolicy, TierSpec, resolve_policy)
from .traces import (PATTERNS, ArrivalTrace, PrecomputedTrace, Submission,
                     make_trace)

__all__ = [
    "AdmissionQueue", "AdmissionStats", "PARITY_KEYS",
    "collect_service_metrics", "freeze_trace", "replay_gap", "FlaasService",
    "ServiceConfig", "NEVER", "MintPlan", "PagePlan", "ServiceState",
    "SlotTable", "admit_batch", "plan_mints", "plan_pages",
    "StreamingTelemetry", "json_safe", "summary_fingerprint", "PATTERNS",
    "ArrivalTrace", "PrecomputedTrace", "Submission", "make_trace",
    "FREE_PRO_ENTERPRISE", "SINGLE_TIER", "TENANT_MIXES", "TenancyPolicy",
    "TierSpec", "resolve_policy",
]
