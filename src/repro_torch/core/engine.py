"""Multi-round episodes: generation and the round-by-round loop.

1. :func:`generate_episode` pre-generates a whole episode as static-shape
   arrays from a seed, replaying ``repro``'s numpy RNG call order draw for
   draw, so its arrays equal ``repro.core.engine.generate_episode``'s.
2. :func:`run_episode` applies any scheduler's round function
   (:func:`repro_torch.core.registry.get_round_fn`) round after round on
   the episode's device, carrying ``(capacity, done[, lam])`` --
   ``repro``'s ``lax.scan`` body written as a Python loop.  It is the
   lockstep loop below for a fleet of one.
3. :func:`run_fleet` runs a stacked fleet of episodes
   (:func:`stack_episodes`) in one of ``repro``'s two modes: ``"vmap"``
   advances every episode one round at a time together (the round
   functions take the fleet as a leading axis, so each kernel launch
   covers the whole fleet), ``"map"`` runs them one after another.  Each
   episode's rows are the same bits in both modes; ``"auto"`` takes
   ``"map"`` on the CPU and ``"vmap"`` on the card, as ``repro`` does by
   backend.

Static-shape convention: every pipeline (i, j) has a fixed slot for the
whole episode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..fp import seq_dot, tree_sum
from . import utility as ut
from .blockaxis import LOCAL, BlockAxis
from .demand import (AnalystView, DemandView, RoundInputs,
                     infeasible_pipelines, normalized_demand)
from .registry import get_round_fn
from .scheduler import SchedulerConfig

_EPS = 1e-9

ROUND_SECONDS = 10.0


@dataclasses.dataclass(frozen=True)
class Episode:
    """One pre-generated episode as static-shape tensors: M analysts x N
    pipelines x K blocks (every block the episode will create), R rounds."""

    demand: torch.Tensor        # [M, N, K] each pipeline's fixed demand
    loss: torch.Tensor          # [M, N] matching degree l_ij
    arrival: torch.Tensor       # [M, N] arrival time (seconds)
    spawn_round: torch.Tensor   # [M] round the analyst's batch arrives; R = never
    block_budget: torch.Tensor  # [K] total budget of each block
    block_round: torch.Tensor   # [K] round each block is created
    n_rounds: int = 10

    @property
    def shape(self):
        return self.demand.shape

    @classmethod
    def from_numpy(cls, demand, loss, arrival, spawn_round, block_budget,
                   block_round, n_rounds: int, *,
                   device="cuda") -> "Episode":
        """Episode on ``device`` from numpy arrays (float32 / int32).
        Raises ``RuntimeError`` when ``device`` is CUDA and CUDA is
        unavailable."""
        dev = resolve_device(device)

        def put(a, dtype):
            return torch.tensor(np.asarray(a, dtype), device=dev)

        return cls(demand=put(demand, np.float32), loss=put(loss, np.float32),
                   arrival=put(arrival, np.float32),
                   spawn_round=put(spawn_round, np.int32),
                   block_budget=put(block_budget, np.float32),
                   block_round=put(block_round, np.int32),
                   n_rounds=int(n_rounds))


_FIELDS = ("demand", "loss", "arrival", "spawn_round", "block_budget",
           "block_round")


def generate_episode(cfg, device="cuda") -> Episode:
    """Pre-generate an episode from ``SimConfig`` ``cfg`` on ``device``.

    Replays the legacy simulator's RNG call order draw for draw (device
    budgets -> per-round Poisson arrivals -> per-analyst device subsets ->
    per-pipeline mice/depth/demand/loss)."""
    resolve_device(device)          # fail before the host work
    rng = np.random.default_rng(cfg.seed)
    M, N, R = cfg.n_analysts, cfg.pipelines_per_analyst, cfg.n_rounds
    bpd = cfg.blocks_per_round_per_device
    bpr = cfg.n_devices * bpd                     # blocks created per round
    K = bpr * R

    device_budget = rng.uniform(*cfg.budget_range, cfg.n_devices)
    # block bid (created round rr, device dev, slot s) = rr*bpr + dev*bpd + s
    block_round = np.repeat(np.arange(R, dtype=np.int32), bpr)
    block_device = np.tile(np.repeat(np.arange(cfg.n_devices), bpd), R)
    block_budget = device_budget[block_device].astype(np.float32)

    demand = np.zeros((M, N, K), np.float32)
    loss = np.ones((M, N), np.float32)
    arrival = np.zeros((M, N), np.float32)
    spawn_round = np.full(M, R, np.int32)         # R = never arrives

    arrival_rate = getattr(cfg, "arrival_rate", 1.0)
    arrived = 0
    for r in range(R):
        T = (r + 1) * bpd              # blocks each device has so far
        n_new = min(rng.poisson(arrival_rate), M - arrived)
        for _ in range(max(n_new, 1 if arrived == 0 else 0)):
            if arrived >= M:
                break
            aid = arrived
            arrived += 1
            spawn_round[aid] = r
            arrival[aid, :] = r * ROUND_SECONDS
            subset = rng.random() < cfg.p_subset_devices
            n_dev = max(1, int(cfg.subset_frac * cfg.n_devices)) if subset \
                else cfg.n_devices
            devices = rng.choice(cfg.n_devices, size=n_dev, replace=False)
            for j in range(N):
                mice = rng.random() < cfg.mice_frac
                lo, hi = cfg.mice_eps if mice else cfg.elephant_eps
                depth = 10 if rng.random() < cfg.p_ten_blocks else 1
                # latest `depth` blocks of each targeted device; one vector
                # draw consumes the PCG64 stream like per-block scalar draws
                ts = np.arange(max(0, T - depth), T)
                base = (ts // bpd) * bpr + (ts % bpd)
                bids = (devices[:, None] * bpd + base[None, :]).reshape(-1)
                demand[aid, j, bids] = rng.uniform(lo, hi, bids.size)
                loss[aid, j] = rng.uniform(0.5, 1.0)

    return Episode.from_numpy(demand, loss, arrival, spawn_round,
                              block_budget, block_round, R, device=device)


def round_diagnostics(rnd: RoundInputs, res, cfg: SchedulerConfig,
                      block_axis: BlockAxis = LOCAL
                      ) -> Dict[str, torch.Tensor]:
    """Per-round SP1-level diagnostics (what the fairness-axiom tests
    consume).  Repeats the scheduler's own pipeline masking (pipelines
    demanding exhausted blocks sit the round out), so the per-analyst
    aggregates are the ones the solver saw.  A fleet's lockstep round
    gives each with a leading episode axis."""
    rnd.fleet_axes(block_axis)
    gamma = normalized_demand(rnd.demand, rnd.budget_total)
    cap_frac = rnd.capacity / torch.clamp(rnd.budget_total, min=_EPS)
    unsat = infeasible_pipelines(gamma, cap_frac, block_axis=block_axis)
    view = AnalystView.build(
        dataclasses.replace(rnd, active=rnd.active & ~unsat), cfg.tau,
        block_axis)
    return dict(
        utility=res.utility,
        analyst_mask=view.mask,
        a_i=view.a_i,
        gamma_i=view.gamma_i,
        mu_i=view.mu_i,
        x_analyst=res.x_analyst,
        sp1_violation=res.sp1_violation,
        # realized per-analyst grant in normalized (share) units
        granted_i=seq_dot(gamma, res.x_pipeline[..., None], -2),
        cap_frac=cap_frac,
        selected=res.selected,
    )


def _lockstep(ep: Episode, sched_cfg: SchedulerConfig, scheduler: str,
              diagnostics: bool) -> Dict[str, torch.Tensor]:
    """Every episode of the fleet ``ep`` (a leading axis E) round by round in
    lockstep: one round function call a round for the whole fleet, the
    carry ``(capacity [E, K], done [E, M, N][, lam [E, K]])``.  Returns
    the rows stacked to ``[E, R, ...]`` and the ``final_*`` state ``[E,
    ...]``.  Every reduction here is per episode and in a fixed order
    (:func:`~repro_torch.fp.tree_sum` over the blocks, the cumulative rows
    added round after round), so an episode's rows do not depend on E."""
    round_fn = get_round_fn(scheduler)
    E, M, N, K = ep.demand.shape
    dev = ep.demand.device
    warm = sched_cfg.sp1_warm_start
    capacity = torch.zeros((E, K), dtype=torch.float32, device=dev)
    done = torch.zeros((E, M, N), dtype=torch.bool, device=dev)
    lam = (torch.ones((E, K), dtype=torch.float32, device=dev) if warm
           else None)
    view = DemandView(base=ep.demand)       # the episodes' demand is fixed
    rows: Dict[str, list] = {}
    cum = {}

    for r in range(ep.n_rounds):
        if warm:    # freshly minted blocks start from cold duals
            lam = torch.where(ep.block_round == r, torch.ones_like(lam), lam)
        created = ep.block_round <= r
        capacity = capacity + ep.block_budget * (ep.block_round == r)
        budget_total = torch.where(created, ep.block_budget,
                                   torch.ones_like(ep.block_budget))
        active = (ep.spawn_round[..., None] <= r) & ~done
        now = torch.tensor(np.float32(r) * np.float32(ROUND_SECONDS),
                           device=dev)
        rnd = RoundInputs(
            demand=view.masked(active), active=active,
            arrival=torch.where(active, ep.arrival,
                                torch.zeros_like(ep.arrival)),
            loss=torch.where(active, ep.loss, torch.ones_like(ep.loss)),
            capacity=capacity, budget_total=budget_total, now=now, lam=lam)
        res = round_fn(rnd, sched_cfg)
        if warm and res.sp1_lam is not None:   # baselines have no solver:
            lam = res.sp1_lam                  # their duals pass through

        mask = torch.any(active, dim=-1)
        gap = torch.where(created, capacity - res.consumed - res.leftover,
                          torch.zeros_like(capacity))
        out = {
            "round_efficiency": res.efficiency,
            "round_fairness": res.fairness,
            "round_fairness_norm": ut.normalized_fairness(
                res.utility, sched_cfg.beta, mask),
            "round_jain": res.jain,
            "n_allocated": res.n_allocated,
            "leftover": tree_sum(res.leftover, -1),
            # conservation: consumed + leftover == round-start capacity on
            # every live block, and no overdraw
            "conservation_gap": torch.amax(torch.abs(gap), dim=-1),
            "overdraw": torch.amax(res.consumed - capacity, dim=-1),
            "sp1_iters": (torch.zeros(E, dtype=torch.int32, device=dev)
                          if res.sp1_iters is None else res.sp1_iters),
            "selected": res.selected,
        }
        for k in ("efficiency", "fairness", "fairness_norm"):
            v = out[f"round_{k}"]
            cum[k] = cum[k] + v if r else v
            out[f"cumulative_{k}"] = cum[k]
        if diagnostics:
            out.update(round_diagnostics(rnd, res, sched_cfg))
        for k, v in out.items():
            rows.setdefault(k, []).append(v)
        capacity = torch.clamp(capacity - res.consumed, min=0.0)
        done = done | res.selected

    ys = {k: torch.stack(v, dim=1) for k, v in rows.items()}
    ys["final_capacity"] = capacity
    ys["final_done"] = done
    return ys


def run_episode(episode: Episode, sched_cfg: SchedulerConfig,
                scheduler: str = "dpbalance", *, diagnostics: bool = False,
                validate: bool = True) -> Dict[str, torch.Tensor]:
    """Run one episode round by round on the episode's device, with the
    scheduler ``scheduler`` (one of ``registry.SCHEDULER_NAMES``): the
    lockstep loop for a fleet of one.

    Returns per-round metric tensors ``[R]`` -- ``repro``'s keys, plus
    ``sp1_iters`` in both SP1 modes (int32 zeros for the baselines, which
    run no SP1) and ``selected [R, M, N]``; with ``diagnostics`` also
    :func:`round_diagnostics`' ``[R, ...]`` -- and the ``final_*``
    episode-end state.  The baselines pass warm duals through unchanged.
    With ``validate``, capacity conservation and no overdraw are checked
    after the episode."""
    one = Episode(**{f: getattr(episode, f)[None] for f in _FIELDS},
                  n_rounds=episode.n_rounds)
    ys = {k: v[0] for k, v in _lockstep(one, sched_cfg, scheduler,
                                        diagnostics).items()}
    if validate:
        check_conservation(ys, scheduler)
    return ys


# run_fleet(mode="auto") by the fleet's device type, repro's table
# (repro/core/engine.py, _FLEET_MODE_DEFAULT): episodes one after another
# on the CPU, in lockstep on an accelerator.
_FLEET_MODE_DEFAULT = {"cpu": "map"}
_FLEET_MODE_FALLBACK = "vmap"


def resolve_fleet_mode(mode: str = "auto", device="cuda") -> str:
    """The fleet mode :func:`run_fleet` uses for ``mode`` on ``device``
    (the fleet's; ``repro`` reads its global backend instead): ``"auto"``
    is ``"map"`` on the CPU and ``"vmap"`` on the card; ``"map"`` and
    ``"vmap"`` are themselves."""
    if mode == "auto":
        return _FLEET_MODE_DEFAULT.get(torch.device(device).type,
                                       _FLEET_MODE_FALLBACK)
    if mode not in ("vmap", "map"):
        raise ValueError(
            f"unknown fleet mode {mode!r}; use 'vmap'/'map'/'auto'")
    return mode


def _episode_at(fleet: Episode, e: int) -> Episode:
    return Episode(**{f: getattr(fleet, f)[e] for f in _FIELDS},
                   n_rounds=fleet.n_rounds)


def run_fleet(fleet: Episode, sched_cfg: SchedulerConfig,
              scheduler: str = "dpbalance", *, diagnostics: bool = False,
              validate: bool = True,
              mode: str = "auto") -> Dict[str, torch.Tensor]:
    """Run a stacked fleet (leading fleet axis ``E``, from
    :func:`stack_episodes`) on its device; returns :func:`run_episode`'s
    rows stacked to ``[E, R, ...]`` (``final_*`` ``[E, ...]``).

    ``mode`` (:func:`resolve_fleet_mode`): ``"vmap"`` runs the episodes in
    lockstep, one round of every episode a step and each kernel launch
    covering the fleet (on the card a dpbalance round launches each budget
    kernel as often as one episode's round does); ``"map"`` runs them one
    after another; ``"auto"`` picks by the fleet's device.  Each episode's
    rows are bitwise the same in every mode."""
    if resolve_fleet_mode(mode, fleet.demand.device) == "vmap":
        ys = _lockstep(fleet, sched_cfg, scheduler, diagnostics)
    else:
        rows: Dict[str, list] = {}
        for e in range(fleet.demand.shape[0]):
            out = run_episode(_episode_at(fleet, e), sched_cfg, scheduler,
                              diagnostics=diagnostics, validate=False)
            for k, v in out.items():
                rows.setdefault(k, []).append(v)
        ys = {k: torch.stack(v) for k, v in rows.items()}
    if validate:
        check_conservation(ys, scheduler)
    return ys


def stack_episodes(episodes) -> Episode:
    """Stack same-shape Episodes (one device) along a new leading fleet
    axis."""
    episodes = list(episodes)
    if not episodes:
        raise ValueError("need at least one episode")
    rounds = {ep.n_rounds for ep in episodes}
    if len(rounds) > 1:
        raise ValueError(f"episodes disagree on n_rounds: {sorted(rounds)}")
    return Episode(**{f: torch.stack([getattr(ep, f) for ep in episodes])
                      for f in _FIELDS}, n_rounds=rounds.pop())


def check_conservation(out: Dict[str, torch.Tensor], scheduler: str) -> None:
    """Raise ``AssertionError`` if any round overdrew a block or lost
    budget (|capacity - consumed - leftover| or overdraw above 1e-4)."""
    gap = float(torch.amax(out["conservation_gap"]))
    over = float(torch.amax(out["overdraw"]))
    if gap > 1e-4 or over > 1e-4:
        raise AssertionError(
            f"budget conservation violated under {scheduler!r}: "
            f"max |capacity - consumed - leftover| = {gap:.3e}, "
            f"max overdraw = {over:.3e}")
