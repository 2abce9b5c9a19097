"""Scenario generator library for engine fleet sweeps.

A *scenario* is a named recipe for a :class:`~repro_torch.core.simulation.
SimConfig` -- the paper's §VI default plus knob overrides exploring the
workload space the evaluation only samples: demand mix (mice/elephant),
arrival burstiness and analyst churn, per-device budget heterogeneity, and
demand locality (``repro/core/scenarios.py``'s nine, unchanged).  All
scenarios share the paper's (M, N, K, R) shape defaults, so their episodes
stack into one fleet (:func:`make_fleet`) for
:func:`repro_torch.core.engine.run_fleet`, which on the card runs them in
lockstep (``mode="auto"`` is ``"vmap"`` there, ``"map"`` on the CPU).

    fleet = make_fleet("bursty_arrivals", n_seeds=64)
    out = run_fleet(fleet, SchedulerConfig(beta=2.2), "dpbalance")
    out["cumulative_efficiency"][:, -1]     # [64] final efficiency per seed
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .engine import Episode, generate_episode, stack_episodes
from .simulation import SimConfig


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Named SimConfig recipe; ``overrides`` are applied on top of the
    paper-default SimConfig (seed excluded — seeds come from the fleet)."""

    name: str
    description: str
    overrides: Dict[str, object] = dataclasses.field(default_factory=dict)

    def config(self, seed: int = 0, **extra) -> SimConfig:
        kw = dict(self.overrides)
        kw.update(extra)
        return SimConfig(seed=seed, **kw)


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in [
    Scenario(
        "paper_default",
        "the paper's §VI setup verbatim: 75% mice, Poisson(1) arrivals, "
        "U(1.0,1.5) device budgets"),
    Scenario(
        "mice_fleet",
        "all-mice demand: many tiny pipelines, packing density stress",
        {"mice_frac": 1.0}),
    Scenario(
        "elephant_storm",
        "75% elephant pipelines: block contention and starvation stress",
        {"mice_frac": 0.25}),
    Scenario(
        "bursty_arrivals",
        "Poisson(3) analyst batches per round: every analyst lands in the "
        "first rounds and competes at once",
        {"arrival_rate": 3.0}),
    Scenario(
        "analyst_churn",
        "Poisson(0.5) trickle: late arrivals face earlier winners and "
        "drained early blocks (waiting-time decay matters)",
        {"arrival_rate": 0.5}),
    Scenario(
        "tight_budgets",
        "device budgets U(0.4,0.6): ~1/3 the paper's privacy capacity",
        {"budget_range": (0.4, 0.6)}),
    Scenario(
        "heterogeneous_devices",
        "device budgets U(0.25,3.0): strong per-device budget skew",
        {"budget_range": (0.25, 3.0)}),
    Scenario(
        "deep_history",
        "75% of pipelines demand the latest 10 blocks: wide demand "
        "vectors, cross-round coupling",
        {"p_ten_blocks": 0.75}),
    Scenario(
        "local_analysts",
        "every analyst targets a disjoint-ish 10% device slice: high "
        "locality, low analyst overlap",
        {"p_subset_devices": 1.0, "subset_frac": 0.1}),
]}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; available: "
                         f"{sorted(SCENARIOS)}") from None


def scenario_config(name: str, seed: int = 0, **extra) -> SimConfig:
    """SimConfig for scenario `name` at `seed` (+ explicit overrides)."""
    return get_scenario(name).config(seed=seed, **extra)


def make_fleet(name: str, n_seeds: int, base_seed: int = 0, *,
               device="cuda", **extra) -> Episode:
    """Pre-generate ``n_seeds`` episodes of scenario ``name`` (seeds
    ``base_seed .. base_seed+n_seeds-1``) on ``device``, stacked on a
    leading fleet axis for :func:`repro_torch.core.engine.run_fleet`."""
    return stack_episodes(
        generate_episode(scenario_config(name, seed=base_seed + s, **extra),
                         device=device)
        for s in range(n_seeds))


def make_scenario_grid(names, n_seeds: int, base_seed: int = 0, *,
                       device="cuda", **extra) -> Episode:
    """Fleet over the (scenario x seed) grid on ``device``, flattened on one
    leading axis ordered scenario-major (row s*n_seeds+k = scenario s, seed
    k)."""
    return stack_episodes(
        generate_episode(scenario_config(name, seed=base_seed + s, **extra),
                         device=device)
        for name in names for s in range(n_seeds))
