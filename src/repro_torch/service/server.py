"""The service tick loop: chunks of T ticks between host round-trips.

Layering on the episode engine:

* the per-tick body is the *engine's* round body (mint blocks -> build
  ``RoundInputs`` -> dispatch through ``registry.get_round_fn`` -> debit
  capacity, mark grants) lifted onto persistent :class:`ServiceState`
  instead of a pre-generated ``Episode``;
* ``chunk_ticks`` consecutive ticks run as one Python loop on the state's
  device, their per-tick outputs stacked once at the chunk's end -- the
  host reads device state **only at chunk boundaries**, where it drains
  the admission queue into recycled slots, plans the chunk's block mints,
  and folds telemetry.  The next tick is kept as a host int, so a
  boundary reads from the card once: the chunk's stacked outputs;
* admissions are *prefetched*: the server polls the trace for the whole
  upcoming chunk at the boundary, and each admitted pipeline activates
  mid-chunk at its own ``spawn_tick`` -- the same mechanism as the
  engine's ``spawn_round``, which is what makes a frozen trace replay
  bit-compatible with :func:`repro_torch.core.engine.run_episode` (see
  :mod:`repro_torch.service.replay`).

On a CUDA state every round's hot-path sweeps are the Hopper kernels
(through :mod:`repro_torch.core.hotpath`); on a CPU state their twins.
:class:`repro_torch.shard.ShardedFlaasService` runs the same tick loop
over a block stripe per rank, its reductions finished across stripes by a
sharded :class:`~repro_torch.core.blockaxis.BlockAxis`.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import utility as ut
from ..fp import tree_sum
from ..core.blockaxis import LOCAL, BlockAxis
from ..core.demand import DemandView, RoundInputs
from ..core.engine import round_diagnostics
from ..core.registry import get_round_fn
from ..core.scheduler import SchedulerConfig
from ..core.simulation import ROUND_SECONDS
from ..obs.audit import AuditWriter
from ..obs.exporter import JsonlSink, MetricsServer
from ..obs.profiler import PhaseProfiler
from ..obs.registry import MetricsRegistry, absorb_summary
from ..obs.tracing import DecisionTrace, split_trace_ys, trace_round_outputs
from .queue import AdmissionQueue
from .state import (BLOCK_FIELDS, NEVER, ServiceState, SlotTable,
                    admit_batch, plan_mints, to_device)
from .telemetry import StreamingTelemetry
from .tenancy import policy_key, resolve_policy
from .traces import ArrivalTrace, demand_window_ticks

# host-payload schema of save_checkpoint (repro's): v1 predates tenancy,
# v2 adds it, v3 the observability plane, v4 the warm-SP1 ``lam`` leaf
_CHECKPOINT_VERSION = 4
_COMPAT_VERSIONS = (1, 2, 3, 4)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    scheduler: str = "dpbalance"
    sched: SchedulerConfig = SchedulerConfig()
    analyst_slots: int = 8         # M rows in the slot table
    pipeline_slots: int = 32       # N columns per row
    block_slots: int = 4096        # B ledger ring slots
    chunk_ticks: int = 8           # T -- ticks per host round-trip
    admit_batch: int = 32          # max submissions admitted per boundary
    max_pending: int = 1024        # queue bound (backpressure beyond this)
    validate: bool = True          # host-checks conservation per chunk
    diagnostics: bool = False      # per-tick SP1 diagnostics in chunk output
    paged: bool = True             # two-ring paged demand residency on wrap
                                   # chunks (False = carry the full tensor)
    latency_reservoir: int = 100_000
    # Tenancy policy: None (adopt the trace's tier mix, if any), a tenant-
    # mix registry name, or a TenancyPolicy.  Governs queue priorities /
    # aging, SLO targets, and cost caps; tier *assignment* always comes
    # stamped on the submissions themselves.
    tenancy: object = None
    # JSON-lines telemetry export: append summary() at every chunk
    # boundary (NaN-safe plain-dict serialization; see telemetry.json_safe)
    # through obs.exporter.JsonlSink: a persistent append handle, flushed
    # per chunk, fsynced on close().
    telemetry_path: Optional[str] = None
    # ------------------------------------------------------ observability
    # Prometheus /metrics endpoint: None = off, 0 = ephemeral port (read
    # it back from service.metrics_server.port), else the literal port.
    metrics_port: Optional[int] = None
    # Decision tracing (obs.tracing): 0 adds no trace outputs (bitwise-
    # neutral), 1 adds SP1 internals + per-analyst shares, 2 adds SP2
    # water levels / swap counts / the overdraw-guard scale.
    trace_level: int = 0
    trace_ticks: int = 4096        # host-side trace ring (newest ticks kept)
    # Append-only checksummed per-grant audit ledger (obs.audit); None =
    # off.  Enabling it adds the per-pipeline grant ratios to the chunk
    # outputs for host-side attribution.
    audit_path: Optional[str] = None
    # Wrap tick-loop phases in torch.profiler.record_function ranges (the
    # wall-clock phase profiler itself is always on -- it is host-side).
    profile_annotations: bool = False


def _chunk_metrics(state: ServiceState, mint_ops, tick0: int, *,
                   cfg: SchedulerConfig, round_fn, n_ticks: int,
                   mode: str, diagnostics: bool = False,
                   trace_level: int = 0, audit: bool = False,
                   block_axis: BlockAxis = LOCAL):
    """Run ticks ``[tick0, tick0 + n_ticks)`` on the state's device;
    returns ``(final_carry, ys)`` and leaves ``state`` untouched.  With a
    sharded ``block_axis`` the state and the block-axis mint operands are
    the rank's stripe, and every per-tick output is finished across
    stripes, so ``ys`` is the same on every rank.

    Mirrors ``engine.run_episode`` tick for tick, so a wrap-free ledger
    over an episode-compatible trace is bit-identical to it.

    Three bodies (see :class:`~repro_torch.service.state.MintPlan`):

    * ``"wrapfree"``: ``mint_ops = (mint_add, budget_total, created[,
      minted])`` rows; the carry is ``(done, capacity)`` and the mint is
      ``capacity += mint_add`` -- **op for op the engine's round body**.
    * ``"paged"`` (ring wrapped, default): ``mint_ops = (mask, budgets,
      budget_total, created, mint_tick, hot_slots)``; minted slots evict
      their previous block (capacity set, not added; stale demand
      retired).  Demand stays constant through the chunk: the only
      in-chunk demand mutations are the monotone retirement wipes, each
      pinned to its slot's ``mint_tick``, so the tick body rebuilds the
      hot ring algebraically (:class:`~repro_torch.core.demand.DemandView`
      folds the wipe predicate into the activity mask) and the has-demand
      expiry test is hoisted to three chunk-level reductions.  Every value
      is bit-identical to the full-tensor carry.  The chunk-boundary
      eviction sweep -- one elementwise pass applying the chunk's
      accumulated wipes -- carries the cold store forward.
    * ``"carry"`` (ring wrapped, hot window spilled -- a slot minted twice
      in one chunk): the full demand tensor joins the carry.
    """
    dev = state.device
    f32 = state.demand.dtype
    retire = mode != "wrapfree"
    # Warm-started SP1: the per-block duals join the carry so every tick's
    # solve resumes from the previous tick's fixed point.  Minted slots
    # reset their dual entry to 1.0 (the cold value) -- the new block's
    # constraint has no history -- the mirror of the engine's birth-round
    # reset.
    warm = cfg.sp1_warm_start
    ticks = range(tick0, tick0 + n_ticks)
    nows = to_device(np.asarray(ticks, np.float32) * np.float32(ROUND_SECONDS),
                     np.float32, dev)
    if mode == "paged":
        *tick_ops, mint_tick, hot_slots = mint_ops   # [B] i32, [S, Hp/S]
        hot_slots = hot_slots.reshape(-1).long()     # local hot-ring slots
        spawn_b = state.spawn_tick[..., None]        # [M, N, 1]
        # the hot ring, gathered once per chunk: every in-chunk demand
        # mutation (and therefore every chunk-hoisted reduction below)
        # lives in these H columns -- O(M*N*H) work, not O(M*N*B).
        hot_dem = state.demand[:, :, hot_slots]      # [M, N, H]
        mt_h = mint_tick[hot_slots][None, None, :]   # [1, 1, H]
        live_h = hot_dem > 0.0
        minted_h = mt_h != int(NEVER)                # padding cols: False
        doomed_h = live_h & (spawn_b < mt_h) & minted_h
        # has-demand expiry test, hoisted to chunk-level reductions (the
        # cold store never changes inside a chunk; OR-decomposition over
        # cold / never-wiped-hot / not-yet-wiped-hot entries is exact):
        # a pipeline still has demand at tick t iff it has a cold entry,
        # a hot entry it submitted after the re-mint, or a doomed entry
        # whose wipe tick is still ahead.
        cold_any = torch.any((state.demand > 0.0) &
                             (mint_tick[None, None, :] == int(NEVER)), dim=-1)
        keep_any = torch.any(live_h & minted_h & (spawn_b >= mt_h), dim=-1)
        last_wipe = torch.amax(
            torch.where(doomed_h, mt_h, torch.full_like(mt_h, -1)), dim=-1)
        # paging telemetry (per chunk): stale entries retired by the
        # chunk's mints + live hot-ring entries at the boundary.
        hot_evicted = block_axis.sum(torch.sum(doomed_h.to(torch.int32)))
        hot_live = block_axis.sum(torch.sum((live_h & minted_h).to(
            torch.int32)))
    else:
        tick_ops = tuple(mint_ops)

    def tick_out(view, pending, capacity, budget_total, created, now,
                 lam=None):
        """Shared per-tick round + metrics, all mint modes."""
        rnd = RoundInputs(
            demand=view.masked(pending),
            active=pending,
            arrival=torch.where(pending, state.arrival,
                                torch.zeros_like(state.arrival)),
            loss=torch.where(pending, state.loss,
                             torch.ones_like(state.loss)),
            capacity=capacity, budget_total=budget_total, now=now,
            # per-analyst tier weight (constant through the chunk; all
            # ones in the default single-tier service, bitwise-neutral)
            weight=state.weight,
            lam=lam)
        res = round_fn(rnd, cfg, block_axis=block_axis)
        mask = torch.sum(pending, dim=1) > 0
        gap = torch.where(created, capacity - res.consumed - res.leftover,
                          torch.zeros_like(capacity))
        out = {
            "round_efficiency": res.efficiency,
            "round_fairness": res.fairness,
            "round_fairness_norm": ut.normalized_fairness(
                res.utility, cfg.beta, mask),
            "round_jain": res.jain,
            "n_allocated": res.n_allocated,
            # in the engine's order (tree_sum), so a wrap-free service
            # replays run_episode's rows bit for bit
            "leftover": block_axis.sum(tree_sum(res.leftover, -1)),
            # realized epsilon granted per analyst row this tick -- the
            # cost-cap / per-tenant spend signal (host maps rows to
            # tenants at the boundary)
            "analyst_spend": block_axis.sum(torch.sum(res.grants,
                                                      dim=(1, 2))),
            "conservation_gap": block_axis.max(torch.amax(torch.abs(gap))),
            "overdraw": block_axis.max(torch.amax(res.consumed - capacity)),
            "selected": res.selected,
        }
        # certified swap pruning: per-tick fallback indicator; a baseline
        # round under the same config carries no certificate and reports
        # zero fallbacks.
        if cfg.swap_beam > 0 and cfg.refine and cfg.incremental_swap:
            out["cert_fallback"] = (
                torch.zeros((), dtype=torch.int32, device=dev)
                if res.swap_cert_ok is None
                else (~res.swap_cert_ok).to(torch.int32))
        if warm:
            # solver effort per tick -- a baseline round runs no SP1
            out["sp1_iters"] = (torch.zeros((), dtype=torch.int32, device=dev)
                                if res.sp1_iters is None else res.sp1_iters)
        if diagnostics:
            out.update(round_diagnostics(rnd, res, cfg, block_axis))
        # Observability outputs, both gated by config: with trace_level=0
        # and no audit the tick runs exactly the ops of a build without
        # the obs plane.  Every value is an intermediate the round already
        # computed; nothing feeds back into the carry.
        if trace_level > 0:
            out.update(trace_round_outputs(res, pending, trace_level))
        if audit:
            out["audit_x"] = res.x_pipeline          # [M, N] grant ratios
            out["audit_scale"] = (torch.ones((), dtype=f32, device=dev)
                                  if res.grant_scale is None
                                  else res.grant_scale)
        return res, out

    done, capacity = state.done, state.block_capacity
    demand = state.demand
    lam = state.lam if warm else None
    rows: Dict[str, list] = {}
    for i, t in enumerate(ticks):
        # Retirement wipes a minted slot's demand column only for
        # pipelines submitted BEFORE the mint tick -- their entries
        # referenced the evicted block.  A pipeline spawning at exactly
        # the mint tick demands the block being minted then (prefetched
        # admission wrote it at the boundary), so its demand survives.
        xs = [op[i] for op in tick_ops]
        if mode == "paged":
            minted, budgets, budget_total, created = xs
            capacity = torch.where(minted, budgets, capacity)
            view = DemandView(base=state.demand, mint_tick=mint_tick,
                              spawn_tick=state.spawn_tick, now_tick=t)
            any_demand = cold_any | keep_any | (last_wipe > t)
        elif mode == "carry":
            minted, budgets, budget_total, created = xs
            stale = minted[None, None, :] & (state.spawn_tick < t)[..., None]
            demand = torch.where(stale, torch.zeros_like(demand), demand)
            capacity = torch.where(minted, budgets, capacity)
            view = DemandView(base=demand)
            any_demand = torch.any(demand > 0.0, dim=-1)
        elif warm:  # wrap-free + warm: mint mask rides along for the reset
            mint_add, budget_total, created, minted = xs
            view = DemandView(base=state.demand)
            capacity = capacity + mint_add
        else:       # wrap-free: demand is constant, the mint is an add
            mint_add, budget_total, created = xs
            view = DemandView(base=state.demand)
            capacity = capacity + mint_add
        if warm:
            lam = torch.where(minted, torch.ones_like(lam), lam)
        pending = (state.spawn_tick <= t) & ~done
        if retire:
            # A long-pending pipeline can outlive its every demanded block
            # (all retired).  Zero demand must not read as "trivially
            # grantable" -- greedy_cover would hand it a phantom zero-
            # budget grant.  It *expires* instead: completed with nothing,
            # slot recycled at the boundary, counted in telemetry.
            has_demand = block_axis.any(any_demand)
            expired = pending & ~has_demand
            pending = pending & has_demand
        res, out = tick_out(view, pending, capacity, budget_total,
                            created, nows[i], lam)
        capacity = torch.clamp(capacity - res.consumed, min=0.0)
        done = done | res.selected
        if retire:
            done = done | expired
            out["expired"] = expired
        if warm and res.sp1_lam is not None:
            lam = res.sp1_lam       # baselines run no SP1: pass-through
        for k, v in out.items():
            rows.setdefault(k, []).append(v)

    ys = {k: torch.stack(v) for k, v in rows.items()}
    final = (done, capacity) if mode != "carry" else (demand, done, capacity)
    if mode == "paged":
        # chunk-boundary eviction sweep: apply the chunk's accumulated
        # wipes to the cold page store in one elementwise pass.
        mt_b = mint_tick[None, None, :]
        swept = torch.where((mt_b != int(NEVER)) & (spawn_b < mt_b),
                            torch.zeros_like(state.demand), state.demand)
        final = (swept,) + final
        ys["hot_evicted"] = hot_evicted
        ys["hot_live"] = hot_live
    if warm:
        final = final + (lam,)
    # Return only what changed; the host grafts the carries back onto the
    # state (see FlaasService.run_chunk).
    return final, ys


def _to_host(ys: Dict[str, torch.Tensor],
             device: torch.device) -> Dict[str, np.ndarray]:
    """Every chunk output as numpy with one wait on the device: the copies
    are queued without blocking, then the stream is synchronised once."""
    out = {k: v.to("cpu", non_blocking=True) for k, v in ys.items()}
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return {k: v.numpy() for k, v in out.items()}


class FlaasService:
    """Long-running scheduling service over an :class:`ArrivalTrace`.

    Its state lives on ``device`` (CUDA by default; raises without it --
    pass ``device="cpu"`` for the twins)."""

    def __init__(self, cfg: ServiceConfig, trace: ArrivalTrace,
                 device="cuda"):
        dev = resolve_device(device)
        if trace.sim.pipelines_per_analyst > cfg.pipeline_slots:
            raise ValueError(
                f"trace submits {trace.sim.pipelines_per_analyst} pipelines "
                f"per analyst but rows have {cfg.pipeline_slots} slots")
        window_ticks = demand_window_ticks(trace.blocks_per_device)
        window = window_ticks * trace.blocks_per_tick
        if cfg.block_slots < window:
            raise ValueError(
                f"block ring ({cfg.block_slots}) smaller than the deepest "
                f"demand window ({window} blocks = {window_ticks} "
                f"ticks x {trace.blocks_per_tick} blocks/tick)")
        self.cfg = cfg
        self.trace = trace
        self.device = dev
        # Tenancy policy: explicit config wins; otherwise adopt the
        # trace's tier mix (a tiered trace activates SLO/aging/cost-cap
        # machinery without extra config).  None = plain single-class
        # service.
        self.tenancy = resolve_policy(
            cfg.tenancy if cfg.tenancy is not None
            else getattr(trace, "tiers", None))
        self.state = ServiceState.create(cfg.analyst_slots,
                                         cfg.pipeline_slots, cfg.block_slots,
                                         device=dev)
        self.tick = 0                    # host mirror of state.tick
        self.table = SlotTable(cfg.analyst_slots, cfg.pipeline_slots)
        self.queue = AdmissionQueue(
            cfg.max_pending, max_pipelines=cfg.pipeline_slots,
            age_ticks=self.tenancy.age_ticks if self.tenancy else None)
        self.telemetry = StreamingTelemetry(cfg.latency_reservoir,
                                            seed=trace.seed)
        # host mirrors of each analyst row's tier contract (set at
        # admission; device side carries only the weight vector)
        self._row_tier = np.array(["default"] * cfg.analyst_slots, object)
        self._row_weight = np.ones(cfg.analyst_slots, np.float32)
        # host mirrors of the ledger metadata (MintPlan precomputes the
        # per-tick budget_total/created rows from these, which is what
        # keeps the wrap-free tick body engine-identical)
        self._ledger_budget = np.ones(cfg.block_slots, np.float32)
        self._ledger_birth = np.full(cfg.block_slots, -1, np.int32)
        self._wall = 0.0
        # ------------------------------------------------- observability
        self.registry = MetricsRegistry()
        self.profiler = PhaseProfiler(annotate=cfg.profile_annotations)
        self.trace_sink = (DecisionTrace(cfg.trace_level, cfg.trace_ticks)
                           if cfg.trace_level > 0 else None)
        self._telemetry_sink = (JsonlSink(cfg.telemetry_path)
                                if cfg.telemetry_path else None)
        self.metrics_server = (MetricsServer(self.registry, cfg.metrics_port)
                               if cfg.metrics_port is not None else None)
        # audit: per-slot host mirrors of the admitted demand (global bids
        # + epsilon), attributed to the ledger at grant, dropped at release
        self._audit_slots: Dict[tuple, dict] = {}
        self.audit = (AuditWriter(cfg.audit_path, self._audit_meta())
                      if cfg.audit_path else None)

    # ------------------------------------------------------------ boundary
    def admit_boundary(self, n_ticks: int) -> int:
        """The host half of a chunk boundary: poll the trace across the
        upcoming ``n_ticks``, enqueue with backpressure, drain one
        admission batch into recycled slots.  Returns the chunk's first
        tick."""
        tick0 = self.tick
        events = []
        for t in range(tick0, tick0 + n_ticks):
            events.extend(self.trace.step(t))
        self.queue.offer(events)
        placements = self.queue.drain(self.table, self.cfg.admit_batch,
                                      now_tick=tick0,
                                      spend=self.telemetry.tenant_spend.get)
        if placements:
            for sub, row, _ in placements:
                self._row_tier[row] = sub.tier
                self._row_weight[row] = np.float32(sub.weight)
            self.state = admit_batch(self.state,
                                     *self._placement_arrays(placements,
                                                             tick0),
                                     weight=self._row_weight.copy())
            if self.tenancy is not None:
                self.telemetry.observe_admissions([
                    (sub.tier, max(0, tick0 - sub.submit_tick),
                     self.tenancy.spec(sub.tier).slo_admission_ticks)
                    for sub, _, _ in placements])
        self.telemetry.observe_boundary(self.queue.depth)
        return tick0

    def _slot_of(self, bids: np.ndarray) -> np.ndarray:
        """Global block id -> ledger ring slot.  Subclass hook for a
        sharded service's striped layout."""
        return bids % self.cfg.block_slots

    def _page_shards(self) -> int:
        """Shard count the hot ring is paged over.  Subclass hook: a
        sharded service pages each shard's own ``bid % S`` stripe."""
        return 1

    def _ring_layout_shards(self) -> int:
        """Stripe count of the ledger-ring layout ``_slot_of`` implements
        (1 = the plain ``bid % B`` ring)."""
        return 1

    def _host_blocks(self, a: np.ndarray) -> np.ndarray:
        """The part of a host ``[..., B]`` ledger array this service holds
        on its device (all of it).  Subclass hook: a sharded service holds
        its rank's stripe."""
        return a

    def _compiled_step(self, n_ticks: int, mode: str):
        """The ``(state, mint_ops, tick0) -> (final_carry, ys)`` chunk
        step, a plain function (nothing is compiled; the hook keeps
        ``repro``'s name).  Subclass hook for a sharded step."""
        cfg = self.cfg
        return functools.partial(
            _chunk_metrics, cfg=cfg.sched,
            round_fn=get_round_fn(cfg.scheduler), n_ticks=n_ticks,
            mode=mode, diagnostics=cfg.diagnostics,
            trace_level=cfg.trace_level, audit=cfg.audit_path is not None)

    def _plan_chunk(self, tick0: int, n_ticks: int):
        """(plan, mode, device mint_ops, step) for the upcoming chunk.
        Mode resolution: wrap-free chunks keep the engine-identical fast
        path; wrap chunks run paged (hot-ring carry) unless paging is off
        or the hot window spills the ring, which falls back to the
        full-tensor carry."""
        plan = plan_mints(tick0, n_ticks, self.cfg.block_slots,
                          self.trace.device_budget,
                          self.trace.blocks_per_device,
                          self._ledger_budget, self._ledger_birth,
                          slot_fn=self._slot_of,
                          page_shards=self._page_shards()
                          if self.cfg.paged else 0)
        dev = self.device

        def put(a, dtype):
            return to_device(a, dtype, dev)

        if not plan.retire:
            mode = "wrapfree"   # budgets rows double as the capacity-add
            ops = (put(plan.budgets, np.float32),
                   put(plan.budget_total, np.float32),
                   put(plan.created, bool))
            if self.cfg.sched.sp1_warm_start:
                # warm SP1 resets minted slots' duals even on wrap-free
                # chunks (fresh slots hold 1.0 already, so this is a
                # value-level no-op, but it keeps the tick body uniform)
                ops = ops + (put(plan.mask, bool),)
        else:
            mode = "paged" if plan.pages is not None else "carry"
            ops = (put(plan.mask, bool), put(plan.budgets, np.float32),
                   put(plan.budget_total, np.float32),
                   put(plan.created, bool))
            if mode == "paged":
                ops = ops + (put(plan.pages.mint_tick, np.int32),
                             put(plan.pages.hot_slots, np.int32))
        return plan, mode, ops, self._compiled_step(n_ticks, mode)

    def tick_loop_fn(self, n_ticks: int):
        """The tick loop for the upcoming chunk, as a zero-argument
        callable that does NOT advance state.  This is the benchmark hook
        that isolates the device work from boundary work -- symmetric with
        engine rounds/sec excluding ``generate_episode``."""
        tick0 = self.tick
        _, _, ops, step = self._plan_chunk(tick0, n_ticks)
        state = self.state
        return lambda: step(state, ops, tick0)

    # ----------------------------------------------------------- chunk step
    def run_chunk(self, n_ticks: Optional[int] = None) -> Dict[str, np.ndarray]:
        """One boundary-to-boundary step: poll/admit, tick loop, recycle."""
        T = self.cfg.chunk_ticks if n_ticks is None else n_ticks
        t0 = time.perf_counter()
        with self.profiler.phase("admit_drain"):
            tick0 = self.admit_boundary(T)

        # plan this chunk's block mints; run the tick loop; graft the
        # changed carries + ledger-metadata mirrors back onto the state.
        # (In paged mode final[0] is the cold store with the hot ring
        # already swept back in -- the boundary eviction sweep.)
        with self.profiler.phase("plan_mints"):
            plan, mode, ops, step = self._plan_chunk(tick0, T)
        with self.profiler.phase("chunk_execute"):
            final, ys = step(self.state, ops, tick0)
        self._ledger_budget = plan.next_budget
        self._ledger_birth = plan.next_birth
        warm = self.cfg.sched.sp1_warm_start
        if warm:
            *final, lam_f = final
        dev = self.device
        self.tick = tick0 + T
        self.state = dataclasses.replace(
            self.state,
            demand=final[0] if plan.retire else self.state.demand,
            done=final[-2], block_capacity=final[-1],
            lam=lam_f if warm else self.state.lam,
            block_budget=to_device(self._host_blocks(plan.next_budget),
                                   np.float32, dev),
            block_birth=to_device(self._host_blocks(plan.next_birth),
                                  np.int32, dev),
            tick=torch.full((), self.tick, dtype=torch.int32, device=dev))
        with self.profiler.phase("host_sync"):
            ys = _to_host(ys, dev)
        # chunk-boundary observability drains: decision traces out of the
        # ys dict into the host ring; audit grant ratios held for the
        # grant-attribution pass below.
        ys, traces = split_trace_ys(ys)
        if self.trace_sink is not None:
            self.trace_sink.extend(tick0, traces)
        audit_x = ys.pop("audit_x", None)            # [T, M, N]
        audit_scale = ys.pop("audit_scale", None)    # [T]
        if self.cfg.validate:
            self._check_conservation(ys)

        # certified swap pruning: fold this chunk's per-tick fallback
        # indicators (present only when cfg.sched.swap_beam > 0)
        cert_fb = ys.pop("cert_fallback", None)
        if cert_fb is not None:
            self.telemetry.observe_swap_certificates(cert_fb)

        # warm SP1: fold this chunk's per-tick solver iteration counts +
        # the mint-driven dual resets (present only when warm-start is on)
        sp1_iters = ys.pop("sp1_iters", None)
        if sp1_iters is not None:
            self.telemetry.observe_sp1(sp1_iters,
                                       resets=int(plan.mask.sum()))

        # paging telemetry: hot-ring size/evictions/occupancy per chunk
        self.telemetry.observe_chunk_mode(mode, T)
        hot_evicted = ys.pop("hot_evicted", None)
        hot_live = ys.pop("hot_live", None)
        if hot_evicted is not None:
            H = plan.pages.hot_size
            MN = self.cfg.analyst_slots * self.cfg.pipeline_slots
            self.telemetry.observe_paging(
                pages_swept=H, slots_evicted=int(hot_evicted.sum()),
                hot_occupancy=float(hot_live.mean()) / max(MN * H, 1))

        # recycle granted + expired slots, record grant latencies and
        # per-tenant spend, fold telemetry.
        selected = ys.pop("selected")                      # [T, M, N]
        expired = ys.pop("expired", None)
        spend_t = ys.pop("analyst_spend")                  # [T, M]
        if self.tenancy is not None:
            # rows still own their tenants here (release happens below)
            spend_m = spend_t.sum(axis=0)
            for m in np.nonzero(spend_m > 0)[0]:
                owner = int(self.table.row_owner[m])
                if owner >= 0:
                    self.telemetry.observe_spend(
                        owner, str(self._row_tier[m]), float(spend_m[m]))
        done_now = selected.any(axis=0)
        if done_now.any():
            grant_tick = tick0 + np.argmax(selected, axis=0)
            lat = grant_tick[done_now] - self.table.submit_tick[done_now]
            self.telemetry.observe_latencies(lat)
            if self.tenancy is not None:
                tiers = self._row_tier[np.where(done_now)[0]]
                self.telemetry.observe_first_grants([
                    (str(t), int(l),
                     self.tenancy.spec(str(t)).slo_first_grant_ticks)
                    for t, l in zip(tiers, lat)])
            if self.audit is not None:
                # attribute every grant to its global blocks BEFORE the
                # slot-table release below recycles the rows
                self._audit_grants(tick0, selected, audit_x, audit_scale)
        release = done_now
        if expired is not None and expired.any():
            expired_now = expired.any(axis=0)
            self.telemetry.observe_expired(
                int((expired_now & self.table.occupied).sum()))
            release = release | expired_now
        self.table.release_done(release)
        if self._audit_slots:
            for m, n in zip(*np.nonzero(release)):
                self._audit_slots.pop((int(m), int(n)), None)
        with self.profiler.phase("telemetry_fold"):
            self.telemetry.observe_chunk(ys)
        self._wall += time.perf_counter() - t0
        self.registry.histogram(
            "flaas_chunk_seconds",
            "Boundary-to-boundary chunk wall time").observe(
            time.perf_counter() - t0)
        if self.audit is not None:
            self.audit.flush()
        if self.metrics_server is not None:
            self.publish_metrics()
        if self._telemetry_sink is not None:
            self._export_telemetry()
        return ys

    # ------------------------------------------------------------ main loop
    def run(self, n_ticks: int) -> Dict:
        """Run ``n_ticks`` service ticks; returns the telemetry summary."""
        end = self.tick + n_ticks
        while self.tick < end:
            self.run_chunk(min(self.cfg.chunk_ticks, end - self.tick))
        return self.summary()

    def summary(self) -> Dict:
        return self.telemetry.summary(admission=self.queue.stats.snapshot(),
                                      wall_seconds=self._wall)

    # -------------------------------------------------------- observability
    def publish_metrics(self) -> None:
        """Fold the current summary + profiler totals into the metrics
        registry (the ``flaas_*`` catalog).  Runs automatically at every
        chunk boundary while the exporter endpoint is up; call it manually
        to inspect ``service.registry`` without one."""
        absorb_summary(self.registry, self.summary())
        self.profiler.publish(self.registry)

    def close(self) -> None:
        """Orderly shutdown of the observability plane: flush + fsync the
        telemetry sink and audit ledger, stop the metrics endpoint.  The
        service itself stays usable (sinks do not reopen).  Idempotent;
        also runs on ``with FlaasService(...) as service:`` exit."""
        if self.metrics_server is not None:
            self.publish_metrics()
            self.metrics_server.close()
            self.metrics_server = None
        if self.audit is not None:
            self.audit.close()
            self.audit = None
        if self._telemetry_sink is not None:
            self._telemetry_sink.close()
            self._telemetry_sink = None

    def __enter__(self) -> "FlaasService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _audit_meta(self) -> Dict:
        """Budget geometry + writer identity for the audit ledger's
        ``open`` record (what the offline verifier maps bids to budgets
        with)."""
        return {
            "device_budget": [float(b) for b in
                              np.asarray(self.trace.device_budget).ravel()],
            "blocks_per_device": int(self.trace.blocks_per_device),
            "n_devices": int(self.trace.blocks_per_tick //
                             self.trace.blocks_per_device),
            "block_slots": int(self.cfg.block_slots),
            "layout_shards": self._ring_layout_shards(),
            "scheduler": self.cfg.scheduler,
            "tick": self.tick,
        }

    def _audit_grants(self, tick0: int, selected: np.ndarray,
                      audit_x: np.ndarray, audit_scale: np.ndarray) -> None:
        """Write one ledger record per pipeline granted this chunk.

        The admission mirror holds each slot's *global* block ids and
        epsilon demand; the entries still live at the grant tick are
        exactly those whose slot had not been re-minted yet (block
        ``bid``'s successor ``bid + B`` mints at tick ``(bid + B) / bpr``
        -- the same wipe predicate the tick body applies), so the host
        attribution reproduces the device grant epsilon for epsilon."""
        B = self.cfg.block_slots
        bpr = self.trace.blocks_per_tick
        rel = np.argmax(selected, axis=0)                  # [M, N]
        for m, n in zip(*np.nonzero(selected.any(axis=0))):
            rec = self._audit_slots.get((int(m), int(n)))
            if rec is None:
                continue        # admitted before auditing was enabled
            tr = int(rel[m, n])
            gt = tick0 + tr
            x = np.float32(audit_x[tr, m, n]) * np.float32(audit_scale[tr])
            live = (rec["bids"] + B) // bpr > gt
            if x <= 0.0 or not live.any():
                continue        # selected with zero realized grant
            eps = rec["eps"][live].astype(np.float32) * x
            self.audit.grant(
                tick=gt, analyst=rec["analyst"], pipeline=int(n),
                tier=rec["tier"], x=float(x),
                bids=rec["bids"][live], eps=eps)

    # ----------------------------------------------------------- durability
    def checkpoint_host_state(self) -> Dict:
        """Everything the device state does not carry: ledger-metadata
        mirrors, slot table, admission queue, telemetry, the trace cursor
        and the observability plane.  Restoring this plus the device state
        into a fresh service resumes it bitwise (same grants, same draws,
        same summary fingerprint) -- see :meth:`load_checkpoint`."""
        return {
            "kind": "flaas-service",
            "version": _CHECKPOINT_VERSION,
            "layout_shards": self._ring_layout_shards(),
            "geometry": (self.cfg.analyst_slots, self.cfg.pipeline_slots,
                         self.cfg.block_slots),
            "ledger_budget": self._ledger_budget.copy(),
            "ledger_birth": self._ledger_birth.copy(),
            "wall": self._wall,
            "table": self.table.state_dict(),
            "queue": self.queue.state_dict(),
            "telemetry": self.telemetry.state_dict(),
            "trace": self.trace.state_dict(),
            "row_tier": [str(t) for t in self._row_tier],
            "row_weight": self._row_weight.copy(),
            "tenancy": policy_key(self.tenancy),
            # v3 observability plane: registry counters resume bitwise,
            # profiler wall totals accumulate across restores, and the
            # audit mirrors keep not-yet-granted pipelines attributable
            # after a restore (the ledger file is append-only on disk --
            # reopening it continues its hash chain).
            "obs": {
                "registry": self.registry.state_dict(),
                "profiler": self.profiler.state_dict(),
                "audit_slots": {k: {kk: (vv.copy()
                                         if isinstance(vv, np.ndarray)
                                         else vv)
                                    for kk, vv in rec.items()}
                                for k, rec in self._audit_slots.items()},
            },
        }

    def save_checkpoint(self, manager, metadata: Optional[Dict] = None) -> int:
        """Checkpoint the whole service at the current chunk boundary
        through a :class:`~repro_torch.checkpoint.CheckpointManager`;
        returns the step saved under, the service's tick."""
        with self.profiler.phase("checkpoint_save"):
            return self._write_checkpoint(manager, self.state, metadata)

    def _write_checkpoint(self, manager, state: ServiceState,
                          metadata: Optional[Dict]) -> int:
        step = self.tick
        meta = {"scheduler": self.cfg.scheduler,
                "layout_shards": self._ring_layout_shards(),
                **(metadata or {})}
        manager.save(step, state, metadata=meta,
                     host_state=self.checkpoint_host_state())
        return step

    def _checkpoint_template(self) -> ServiceState:
        """The state a checkpoint restores into (its shapes, dtypes and
        devices).  Subclass hook: a sharded service restores the whole
        ring and then keeps its stripe."""
        return self.state

    def _adopt_state(self, state: ServiceState) -> None:
        """Install a restored whole-ring state.  Subclass hook."""
        self.state = state

    def load_checkpoint(self, manager, step: Optional[int] = None) -> int:
        """Restore device and host state from ``manager`` into this
        (freshly constructed, same-config) service; returns the restored
        tick.

        Elastic hand-off: a checkpoint written under an ``S``-striped ring
        layout restores onto an ``S'``-striped one by permuting every
        block-axis array with :func:`repro_torch.shard.state.remap_ring`
        -- both layouts place block ``bid`` by ``bid % B`` alone, so the
        permutation is exact and scheduling continues unchanged."""
        device, host, step = manager.restore(self._checkpoint_template(),
                                             step=step, with_host=True)
        if step is None:
            raise ValueError(f"no checkpoint found in {manager.dir}")
        if not isinstance(host, dict) or host.get("kind") != "flaas-service":
            raise ValueError(
                "checkpoint carries no service host state (was it saved "
                "with FlaasService.save_checkpoint?)")
        if host.get("version") not in _COMPAT_VERSIONS:
            raise ValueError(
                f"service checkpoint version {host.get('version')} not "
                f"supported (accepted: {_COMPAT_VERSIONS})")
        geometry = (self.cfg.analyst_slots, self.cfg.pipeline_slots,
                    self.cfg.block_slots)
        if tuple(host["geometry"]) != geometry:
            raise ValueError(
                f"checkpoint geometry {tuple(host['geometry'])} != "
                f"configured {geometry}")
        ledger_budget = np.asarray(host["ledger_budget"], np.float32)
        ledger_birth = np.asarray(host["ledger_birth"], np.int32)
        src, dst = int(host["layout_shards"]), self._ring_layout_shards()
        if src != dst:
            # lazy import: repro_torch.shard imports this module
            from ..shard.state import remap_ring
            idx = remap_ring(src, dst, self.cfg.block_slots)
            at = torch.from_numpy(idx).to(device.device)
            device = dataclasses.replace(device, **{
                f: getattr(device, f).index_select(-1, at)
                for f in BLOCK_FIELDS})
            ledger_budget = ledger_budget[idx]
            ledger_birth = ledger_birth[idx]
        self._adopt_state(device)
        self.tick = int(device.tick)
        self._ledger_budget = ledger_budget.copy()
        self._ledger_birth = ledger_birth.copy()
        self._wall = float(host["wall"])
        self.table.load_state_dict(host["table"])
        self.queue.load_state_dict(host["queue"])
        self.telemetry.load_state_dict(host["telemetry"])
        self.trace.load_state_dict(host["trace"])
        if "row_tier" in host:
            self._row_tier = np.array([str(t) for t in host["row_tier"]],
                                      object)
            self._row_weight = np.asarray(host["row_weight"],
                                          np.float32).copy()
        else:
            # v1 (pre-tenancy) checkpoint: every row is the neutral
            # default tier, matching the all-ones weight leaf the
            # template kept (the file has no weight array)
            self._row_tier = np.array(["default"] * self.cfg.analyst_slots,
                                      object)
            self._row_weight = np.ones(self.cfg.analyst_slots, np.float32)
        # v3 observability plane (older checkpoints: counters start fresh;
        # pipelines admitted before the restore are absent from the audit
        # ledger -- its conservation is an upper bound, so the verifier
        # stays sound)
        obs = host.get("obs", {})
        if "registry" in obs:
            self.registry.load_state_dict(obs["registry"])
        if "profiler" in obs:
            self.profiler.load_state_dict(obs["profiler"])
        self._audit_slots = {
            tuple(k): {"analyst": int(rec["analyst"]),
                       "tier": str(rec["tier"]),
                       "bids": np.asarray(rec["bids"], np.int64).copy(),
                       "eps": np.asarray(rec["eps"], np.float32).copy()}
            for k, rec in obs.get("audit_slots", {}).items()}
        return step

    # -------------------------------------------------------------- helpers
    def _export_telemetry(self) -> None:
        """Append one NaN-safe JSON line of the running summary to
        ``cfg.telemetry_path`` (chunk-boundary cadence, append-only so an
        external collector can tail the file)."""
        self._telemetry_sink.write({"tick": self.tick, **self.summary()})

    def _placement_arrays(self, placements, boundary_tick: int):
        """Operands for one admission batch: ``[M, N]`` slot-metadata
        tables + flat COO demand triples (see
        :func:`repro_torch.service.state.admit_batch`)."""
        M, N = self.cfg.analyst_slots, self.cfg.pipeline_slots
        B = self.cfg.block_slots
        mask = np.zeros((M, N), bool)
        loss = np.zeros((M, N), np.float32)
        arr_s = np.zeros((M, N), np.float32)
        spawn = np.zeros((M, N), np.int32)
        bpr = self.trace.blocks_per_tick
        rows, cols, bids, eps = [], [], [], []
        for sub, row, cs in placements:
            spawn_tick = max(sub.submit_tick, boundary_tick)
            arrival = self.trace.arrival_seconds(sub.submit_tick)
            for j, c in enumerate(cs):
                mask[row, c] = True
                loss[row, c] = sub.loss[j]
                arr_s[row, c] = arrival
                spawn[row, c] = spawn_tick
                # A submission deferred across a ring wrap may demand
                # blocks that have been (or are about to be) evicted;
                # their slots now/soon belong to newer blocks.  Writing
                # `bid % B` blindly would alias that stale demand onto
                # blocks the pipeline never asked for -- drop it instead.
                # Keep an entry only if (1) its block has not already been
                # evicted (slot occupant's birth <= the bid's mint tick)
                # and (2) the block outlives the pipeline's activation
                # (its successor `bid + B` mints strictly after
                # spawn_tick; evictions after activation are handled by
                # the in-loop stale wipe, which is strict in spawn_tick).
                slots = self._slot_of(sub.bids[j])
                keep = ((self._ledger_birth[slots] <= sub.bids[j] // bpr) &
                        ((sub.bids[j] + B) // bpr > spawn_tick))
                if self.audit is not None:
                    # audit mirror: global (layout-independent) bids + the
                    # epsilon written to the device, for grant attribution
                    self._audit_slots[(int(row), int(c))] = {
                        "analyst": int(sub.analyst), "tier": str(sub.tier),
                        "bids": np.asarray(sub.bids[j],
                                           np.int64)[keep].copy(),
                        "eps": np.asarray(sub.eps[j],
                                          np.float32)[keep].copy()}
                rows.append(np.full(int(keep.sum()), row, np.int64))
                cols.append(np.full(int(keep.sum()), c, np.int64))
                bids.append(slots[keep])
                eps.append(sub.eps[j][keep])
        return (mask, loss, arr_s, spawn, np.concatenate(rows),
                np.concatenate(cols), np.concatenate(bids),
                np.concatenate(eps))

    def _check_conservation(self, ys) -> None:
        gap = float(np.max(ys["conservation_gap"]))
        over = float(np.max(ys["overdraw"]))
        if gap > 1e-4 or over > 1e-4:
            raise AssertionError(
                f"budget conservation violated under "
                f"{self.cfg.scheduler!r} at tick {self.tick}: "
                f"gap={gap:.3e} overdraw={over:.3e}")
