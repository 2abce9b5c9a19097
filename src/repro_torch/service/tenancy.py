"""Multi-tenant service tier model: priority classes, SLOs, cost caps.

A production FLaaS does not serve peer analysts — it serves *tiers* of
tenants (free / pro / enterprise) with different admission priorities,
utility weights, latency SLOs, and budget-spend caps.  This module is the
single home of that policy surface:

* :class:`TierSpec` — one tier's contract: queue ``priority`` (strict,
  higher drains first), scheduler ``weight`` (multiplies the analyst's
  DPBalance utility coefficient ``a_i = T(t_i) l_i``, so SP1's
  alpha-fair water-filling favors heavier tiers), an admission
  ``deadline_ticks`` (a submission still queued past it is *shed*, not
  admitted late), a cumulative-spend ``cost_cap`` (epsilon units,
  enforced at drain against telemetry-tracked realized spend), and two
  SLO targets (``slo_admission_ticks``, ``slo_first_grant_ticks``) the
  telemetry reports attainment rates against.
* :class:`TenancyPolicy` — an ordered set of tiers plus the queue's
  anti-starvation knob ``age_ticks``, with a *deterministic* analyst →
  tier assignment: the tier is a pure function of ``(trace seed,
  analyst id)`` via a dedicated RNG stream, so stamping tiers onto a
  trace consumes **zero** draws from the trace's main RNG — a
  single-tier stamped trace emits bitwise-identical submissions to the
  unstamped one (the property the ``tenancy_default_parity`` smoke row
  asserts).

Fairness scope (see docs/tenancy.md): DPBalance's sharing-incentive and
envy-freeness theorems are peer-analyst results; with tier weights they
hold *within* each tier (equal-weight analysts), while cross-tier the
mechanism deliberately favors heavier tiers — utility is weakly monotone
in the reported weight, so tier membership must be billed/authenticated
rather than self-reported (the cross-tier strategyproofness
characterization in ``tests/test_tenancy.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# Dedicated stream id for tier assignment: keeps the per-analyst RNG
# disjoint from every other seeded stream in the repo.
_ASSIGN_STREAM = 0x7E9A


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One service tier's contract (see module docstring)."""

    name: str
    priority: int = 0                 # strict admission priority (higher first)
    weight: float = 1.0               # multiplies a_i in the DPBalance utility
    deadline_ticks: Optional[int] = None   # shed if queued longer (None: never)
    cost_cap: Optional[float] = None       # cumulative epsilon cap (None: none)
    slo_admission_ticks: Optional[int] = None
    slo_first_grant_ticks: Optional[int] = None
    share: float = 1.0                # arrival fraction within a TenancyPolicy

    def stamp(self, sub) -> None:
        """Write this tier's contract onto a Submission in place."""
        sub.tier = self.name
        sub.priority = self.priority
        sub.weight = float(self.weight)
        sub.deadline_ticks = self.deadline_ticks
        sub.cost_cap = self.cost_cap


DEFAULT_TIER = TierSpec("default")


@dataclasses.dataclass(frozen=True)
class TenancyPolicy:
    """An ordered tier set + queue aging knob + deterministic assignment."""

    tiers: Tuple[TierSpec, ...]
    age_ticks: Optional[int] = None   # queue anti-starvation horizon
    name: Optional[str] = None        # registry key (for checkpoints/repr)

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("TenancyPolicy needs at least one tier")
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")

    def spec(self, name: str) -> TierSpec:
        """Tier by name; unknown names get the neutral default tier (a
        plain Submission carries ``tier='default'``)."""
        for t in self.tiers:
            if t.name == name:
                return t
        return DEFAULT_TIER

    def assign(self, seed: int, analyst: int) -> TierSpec:
        """Deterministic analyst → tier draw from the arrival ``share``
        mix.  Pure function of ``(seed, analyst)`` on a dedicated RNG
        stream — never consumes the trace's main RNG."""
        rng = np.random.default_rng([int(seed), _ASSIGN_STREAM, int(analyst)])
        u = rng.random()
        total = sum(t.share for t in self.tiers)
        acc = 0.0
        for t in self.tiers:
            acc += t.share / total
            if u < acc:
                return t
        return self.tiers[-1]

    def stamp(self, sub, seed: int) -> None:
        self.assign(seed, sub.analyst).stamp(sub)

    def slo_map(self) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
        return {t.name: (t.slo_admission_ticks, t.slo_first_grant_ticks)
                for t in self.tiers}


# ----------------------------------------------------------------- presets
# Single neutral tier: priority 0, weight 1, no deadline/cap — a service
# configured with it is bitwise identical to the pre-tenancy service.
SINGLE_TIER = TenancyPolicy((dataclasses.replace(DEFAULT_TIER, share=1.0),),
                            name="single")

# The canonical free/pro/enterprise mix (fleet-scale tenant population):
# strict priority enterprise > pro > free, 4x utility-weight spread,
# tighter SLOs and looser caps up the ladder, and an aging horizon so
# sustained enterprise load cannot starve the free class forever.
FREE_PRO_ENTERPRISE = TenancyPolicy((
    TierSpec("free", priority=0, weight=0.5, deadline_ticks=24,
             cost_cap=2.0, slo_admission_ticks=8,
             slo_first_grant_ticks=24, share=0.6),
    TierSpec("pro", priority=1, weight=1.0, deadline_ticks=64,
             cost_cap=10.0, slo_admission_ticks=4,
             slo_first_grant_ticks=12, share=0.3),
    TierSpec("enterprise", priority=2, weight=2.0, deadline_ticks=None,
             cost_cap=None, slo_admission_ticks=2,
             slo_first_grant_ticks=8, share=0.1),
), age_ticks=16, name="free_pro_enterprise")

TENANT_MIXES: Dict[str, TenancyPolicy] = {
    "single": SINGLE_TIER,
    "free_pro_enterprise": FREE_PRO_ENTERPRISE,
}


def resolve_policy(policy) -> Optional[TenancyPolicy]:
    """None | registry name | TenancyPolicy -> TenancyPolicy (or None)."""
    if policy is None or isinstance(policy, TenancyPolicy):
        return policy
    if isinstance(policy, str):
        if policy not in TENANT_MIXES:
            raise ValueError(f"unknown tenant mix {policy!r}; expected one "
                             f"of {tuple(TENANT_MIXES)}")
        return TENANT_MIXES[policy]
    raise TypeError(f"tenancy policy must be None, a mix name, or a "
                    f"TenancyPolicy (got {type(policy).__name__})")


def policy_key(policy: Optional[TenancyPolicy]) -> Optional[str]:
    """Stable identity recorded in trace/service checkpoints: the registry
    name when the policy has one, else a structural repr."""
    if policy is None:
        return None
    return policy.name or repr(policy)
