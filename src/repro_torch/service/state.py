"""Persistent service-plane state: block ledger + pipeline slot table.

The engine's :class:`~repro_torch.core.engine.Episode` is immutable and
finite -- every block and pipeline the episode will ever see is
pre-generated.  The service plane instead runs *forever* over fixed-size
device tensors:

* **Block ledger** (``block_budget`` / ``block_capacity`` / ``block_birth``,
  all ``[B]``): a ring over global block ids.  Block ``bid`` lives in slot
  ``bid % B``; when the ring wraps, minting a new block *retires* the slot's
  previous occupant (its leftover budget is abandoned and any pipeline
  demand still pointing at the slot is zeroed).  Slots that have never held
  a block carry the engine's pre-creation sentinel (budget 1, capacity 0,
  birth ``-1``) so a fresh ledger is bit-identical to an episode prefix.
* **Pipeline slot table** (``demand[M, N, B]`` + per-pipeline metadata):
  fixed ``M`` analyst rows x ``N`` pipeline columns.  A slot is *recycled*
  (host free-list, :class:`SlotTable`) once its pipeline is granted;
  admission overwrites the slot's demand row in full, so no stale demand
  survives recycling.  ``spawn_tick`` activates a pipeline mid-chunk
  (admission happens at chunk boundaries, activation at the pipeline's
  arrival tick -- the same mechanism as the engine's ``spawn_round``).

Everything in :class:`ServiceState` is a tensor on one device; the host
only reads or writes it at chunk boundaries (see
:mod:`repro_torch.service.server`).  The mint and page plans and the slot
table are host-side numpy.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .. import resolve_device

NEVER = np.int32(np.iinfo(np.int32).max)   # spawn_tick sentinel: not admitted
# the ServiceState fields laid out along the block ring (their last axis)
BLOCK_FIELDS = ("demand", "block_budget", "block_capacity", "block_birth",
                "lam")


def to_device(a, dtype, device) -> torch.Tensor:
    """numpy ``a`` as a ``dtype`` tensor on ``device``.  A copy to a CUDA
    device goes through pinned memory without blocking the host (no
    stream synchronisation at a chunk boundary)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass(frozen=True)
class ServiceState:
    """Device-resident scheduling state that survives across ticks."""

    demand: torch.Tensor          # [M, N, B] epsilon demand per pipeline slot
    arrival: torch.Tensor         # [M, N] submission time (seconds)
    loss: torch.Tensor            # [M, N] matching degree l_ij
    spawn_tick: torch.Tensor      # [M, N] i32 tick the pipeline activates
    done: torch.Tensor            # [M, N] bool -- granted (awaiting recycle)
    weight: torch.Tensor          # [M] per-analyst tier weight (1.0 default)
    block_budget: torch.Tensor    # [B] total budget (1.0 pre-creation)
    block_capacity: torch.Tensor  # [B] remaining budget (0 pre-creation)
    block_birth: torch.Tensor     # [B] i32 mint tick (-1 pre-creation)
    lam: torch.Tensor             # [B] SP1 dual carried across ticks (1.0
                                  #   cold; reset to 1.0 when re-minted)
    tick: torch.Tensor            # scalar i32 -- next tick the server runs

    @property
    def shape(self):
        return self.demand.shape

    @property
    def device(self) -> torch.device:
        return self.demand.device

    @classmethod
    def create(cls, analyst_slots: int, pipeline_slots: int,
               block_slots: int, device="cuda") -> "ServiceState":
        """A fresh state on ``device``; raises ``RuntimeError`` when
        ``device`` is CUDA and CUDA is unavailable."""
        M, N, B = analyst_slots, pipeline_slots, block_slots
        dev = resolve_device(device)
        f32, i32 = torch.float32, torch.int32
        return cls(
            demand=torch.zeros((M, N, B), dtype=f32, device=dev),
            arrival=torch.zeros((M, N), dtype=f32, device=dev),
            loss=torch.ones((M, N), dtype=f32, device=dev),
            spawn_tick=torch.full((M, N), int(NEVER), dtype=i32, device=dev),
            done=torch.zeros((M, N), dtype=torch.bool, device=dev),
            weight=torch.ones((M,), dtype=f32, device=dev),
            block_budget=torch.ones((B,), dtype=f32, device=dev),
            block_capacity=torch.zeros((B,), dtype=f32, device=dev),
            block_birth=torch.full((B,), -1, dtype=i32, device=dev),
            lam=torch.ones((B,), dtype=f32, device=dev),
            tick=torch.zeros((), dtype=i32, device=dev))


def _admit_apply(state: ServiceState, mask, loss, arrival_seconds,
                 spawn_ticks, weight, rows, cols, bids, eps) -> ServiceState:
    # wipe every (re)filled slot's demand row, then write the new demands
    # as one small COO scatter -- no stale demand survives recycling, and
    # nothing proportional to [M, N, B] crosses the host boundary.  Out of
    # place: a chunk step may still hold the old demand tensor.
    demand = state.demand.masked_fill(mask[..., None], 0.0)
    demand.index_put_((rows, cols, bids), eps)
    return dataclasses.replace(
        state,
        demand=demand,
        loss=torch.where(mask, loss, state.loss),
        arrival=torch.where(mask, arrival_seconds, state.arrival),
        spawn_tick=torch.where(mask, spawn_ticks, state.spawn_tick),
        done=state.done & ~mask,
        weight=weight)


def admit_batch(state: ServiceState, mask, loss, arrival_seconds,
                spawn_ticks, rows, cols, bids, eps,
                weight=None) -> ServiceState:
    """Write one admission batch into the slot table (host calls this only
    at chunk boundaries).

    ``mask[M, N]`` marks the slots being (re)filled; ``loss`` /
    ``arrival_seconds`` / ``spawn_ticks`` are full-table arrays whose
    values matter only under the mask.  The demand update arrives as flat
    COO triples ``(rows, cols, bids) -> eps`` -- kilobytes per boundary
    instead of an [M, N, B] dense block -- written with one
    ``index_put_``.  ``weight`` is the full post-admission ``[M]``
    per-analyst tier weight vector (the server's host mirror); None keeps
    the current weights."""
    dev = state.device
    weight = state.weight if weight is None else to_device(
        weight, np.float32, dev)
    i64 = np.int64
    return _admit_apply(
        state, to_device(mask, bool, dev), to_device(loss, np.float32, dev),
        to_device(arrival_seconds, np.float32, dev),
        to_device(spawn_ticks, np.int32, dev), weight,
        to_device(rows, i64, dev), to_device(cols, i64, dev),
        to_device(bids, i64, dev), to_device(eps, np.float32, dev))


@dataclasses.dataclass
class PagePlan:
    """One chunk's hot-ring page schedule (two-ring paged demand residency).

    The chunk's mints can only touch the ring slots of the consecutive
    global-bid window ``[tick0*bpr, tick0*bpr + H)`` — so only those ``H``
    demand columns (the *hot ring*) can change inside the chunk, and the
    only change is the retirement wipe at each slot's mint tick.  The full
    ``[M, N, B]`` tensor (the *cold page store*) therefore stays a chunk
    constant; the hot ring's residency is *algebraic*: ``mint_tick[b]``
    records when slot ``b`` is re-minted, and the tick body reconstructs
    the current hot values by fusing the wipe predicate
    ``(mint_tick <= t) & (spawn_tick < mint_tick)`` into the activity
    mask it applies anyway (:class:`repro_torch.core.demand.DemandView`).  The
    chunk-boundary eviction sweep is one fused elementwise pass applying
    the chunk's accumulated wipes to the cold store.

    ``hot_slots`` additionally names the hot ring explicitly — the
    chunk-level expiry/telemetry reductions are computed on a one-off
    ``[M, N, H]`` gather of those columns instead of full-tensor passes.
    The window is padded up to a multiple of the shard count so every
    shard pages an equal-size stripe; padding slots carry
    ``mint_tick == NEVER`` and behave exactly like cold columns.

    Valid only while every slot is minted at most once per chunk
    (``H <= B``); :func:`plan_pages` returns None when the hot window
    *spills* and the caller falls back to carrying the full tensor.  The
    layout composes with the striped sharded ring as-is: ``mint_tick`` is
    a per-slot vector in the same (global) slot layout as the ledger, so
    it shards with it and every wipe stays shard-local."""

    mint_tick: np.ndarray    # [B] i32 — chunk tick re-minting the slot
                             #   (NEVER where the chunk leaves it cold)
    hot_slots: np.ndarray    # [S, Hp/S] i32 — LOCAL hot-ring slots per
                             #   shard (incl. shard-alignment padding)
    hot_size: int            # slots the chunk's mints touch (H, unpadded)


def plan_pages(tick0: int, n_ticks: int, block_slots: int,
               blocks_per_tick: int, slot_fn=None, n_shards: int = 1):
    """The chunk's :class:`PagePlan`, or None when the hot window would
    not fit in the ring (a slot would be minted twice within one chunk
    and a single re-mint tick could not describe it)."""
    S = int(n_shards)
    B = block_slots
    if B % S:
        raise ValueError(f"block_slots={B} not divisible by {S} shards")
    H = n_ticks * blocks_per_tick
    Hp = -(-H // S) * S                  # shard-aligned hot window
    if Hp > B:
        return None
    b0 = tick0 * blocks_per_tick
    bids = np.arange(b0, b0 + Hp, dtype=np.int64)
    slots = ((bids % B) if slot_fn is None else slot_fn(bids)).astype(
        np.int64)
    mint_tick = np.full(B, NEVER, np.int32)
    minted = bids < b0 + H               # padding bids are not minted
    mint_tick[slots[minted]] = (bids[minted] // blocks_per_tick).astype(
        np.int32)
    # shard s owns the contiguous global slot range [s*B/S, (s+1)*B/S);
    # a window of Hp consecutive bids lands Hp/S slots on every shard
    # under the striped layout (and trivially with S == 1).
    owner = slots // (B // S)
    local = slots % (B // S)
    counts = np.bincount(owner, minlength=S)
    if not (counts == Hp // S).all():    # layout does not stripe evenly
        return None                      # -> carry fallback, still exact
    hot_slots = np.empty((S, Hp // S), np.int32)
    for s in range(S):
        hot_slots[s] = local[owner == s]
    return PagePlan(mint_tick=mint_tick, hot_slots=hot_slots, hot_size=H)


@dataclasses.dataclass
class MintPlan:
    """One chunk's block-mint schedule, fully precomputed on the host so
    the device tick loop applies it with engine-identical ops.

    ``retire`` says whether any minted slot overwrites a live block (ring
    wrapped).  The wrap-free body consumes ``budgets`` as a capacity *add*
    (fresh slots hold 0, so ``capacity += budgets`` is the engine's own
    mint op) plus ``budget_total``/``created`` directly, carrying only
    ``(done, capacity)`` — a service tick is then op-for-op an engine
    round.  Wrap chunks apply ``mask``/``budgets`` as selects (eviction =
    set, not add); the demand side of retirement is described by
    ``pages`` (the two-ring paged layout — only the hot ring joins the
    carry) with the full-tensor carry kept as the spill fallback.
    ``next_*`` are the host mirrors of the ledger metadata after the
    chunk."""

    mask: np.ndarray          # [T, B] bool — minted this tick
    budgets: np.ndarray       # [T, B] f32 — minted budget (0 elsewhere)
    budget_total: np.ndarray  # [T, B] f32 — ledger budget_total at tick t
    created: np.ndarray       # [T, B] bool — slot holds a block at tick t
    retire: bool
    next_budget: np.ndarray   # [B] f32 host mirror after the chunk
    next_birth: np.ndarray    # [B] i32 host mirror after the chunk
    pages: "PagePlan | None" = None   # hot-ring schedule (retire chunks)


def plan_mints(tick0: int, n_ticks: int, block_slots: int,
               device_budget: np.ndarray, blocks_per_device: int,
               prev_budget: np.ndarray, prev_birth: np.ndarray,
               slot_fn=None, page_shards: int = 0) -> MintPlan:
    """Mint schedule for ticks ``[tick0, tick0 + n_ticks)``; ``prev_*``
    are the host ledger mirrors at the chunk boundary.

    ``slot_fn`` maps global block ids to ring slots (default ``bid % B``).
    Any layout whose slot is reused exactly by ``bid + B`` works — the
    sharded service (:mod:`repro_torch.shard`) uses a striped layout so
    each stripe owns the ``bid % n_shards`` blocks
    (:func:`repro_torch.shard.state.ring_slots`).  ``page_shards`` > 0
    additionally attaches a :class:`PagePlan` over that many shard stripes
    to retire chunks (None when the hot window spills)."""
    n_devices = device_budget.shape[0]
    bpr = n_devices * blocks_per_device
    B = block_slots
    ticks = np.arange(tick0, tick0 + n_ticks, dtype=np.int64)
    bids = ticks[:, None] * bpr + np.arange(bpr)[None, :]      # global ids
    slots = ((bids % B) if slot_fn is None else slot_fn(bids)).astype(
        np.int64)
    rows = np.repeat(np.arange(n_ticks), bpr)
    flat = slots.reshape(-1)
    per_tick = np.tile(
        np.repeat(device_budget.astype(np.float32), blocks_per_device),
        n_ticks)
    mask = np.zeros((n_ticks, B), bool)
    mask[rows, flat] = True
    budgets = np.zeros((n_ticks, B), np.float32)
    budgets[rows, flat] = per_tick

    budget_total = np.empty((n_ticks, B), np.float32)
    created = np.empty((n_ticks, B), bool)
    bud, birth = prev_budget.copy(), prev_birth.copy()
    for i in range(n_ticks):
        bud[slots[i]] = budgets[i, slots[i]]
        birth[slots[i]] = tick0 + i
        created[i] = birth >= 0
        budget_total[i] = np.where(created[i], bud, 1.0)
    retire = bool(bids.max() >= B)
    pages = plan_pages(tick0, n_ticks, B, bpr, slot_fn, page_shards) \
        if (retire and page_shards > 0) else None
    return MintPlan(mask=mask, budgets=budgets, budget_total=budget_total,
                    created=created, retire=retire,
                    next_budget=bud, next_birth=birth, pages=pages)


class SlotTable:
    """Host-side occupancy bookkeeping with free-list recycling.

    Analyst rows are handed out from an ascending free list; pipeline
    columns within a row are recycled as their pipelines complete.  A row
    returns to the free list when its last occupied slot is released — an
    analyst whose submissions are still queued at that moment gets a
    (possibly different) row when they drain; only analysts with a
    currently-occupied row keep their identity pinned to it."""

    def __init__(self, analyst_slots: int, pipeline_slots: int):
        self.M, self.N = analyst_slots, pipeline_slots
        self.occupied = np.zeros((self.M, self.N), bool)
        self.row_owner = np.full(self.M, -1, np.int64)   # external analyst id
        self.submit_tick = np.full((self.M, self.N), -1, np.int64)
        self._free_rows: List[int] = list(range(self.M - 1, -1, -1))

    # ------------------------------------------------------------- queries
    def free_pipeline_slots(self) -> int:
        return int((~self.occupied).sum())

    def live_rows(self) -> int:
        return self.M - len(self._free_rows)

    def row_for(self, analyst: int, n_pipes: int):
        """Row + free columns for an admission of ``n_pipes`` pipelines by
        ``analyst``, or None if it cannot be placed right now.

        Prefers the analyst's existing row (returning analysts keep their
        SP1 identity — one row per live analyst); otherwise pops a fresh
        row off the free list."""
        if n_pipes > self.N:
            return None                     # can never fit any row — the
                                            # queue rejects these at offer()
        owned = np.where(self.row_owner == analyst)[0]
        if owned.size:
            row = int(owned[0])
            cols = np.where(~self.occupied[row])[0]
            if cols.size >= n_pipes:
                return row, cols[:n_pipes].tolist()
            return None                     # row full — defer
        if not self._free_rows:
            return None                     # table full — defer
        row = self._free_rows[-1]           # peek; commit() pops
        return row, list(range(n_pipes))

    # ------------------------------------------------------------ mutation
    def commit(self, analyst: int, row: int, cols, submit_tick: int) -> None:
        if self.row_owner[row] == -1:
            popped = self._free_rows.pop()
            assert popped == row, "row_for/commit interleaving bug"
            self.row_owner[row] = analyst
        self.occupied[row, cols] = True
        self.submit_tick[row, cols] = submit_tick

    # -------------------------------------------------------- durability
    def state_dict(self) -> dict:
        """Snapshot for :meth:`FlaasService.save_checkpoint` — restoring
        it into a fresh table reproduces occupancy, analyst identities,
        submit ticks AND the free-list order (row hand-out is LIFO, so the
        order matters for bitwise resume)."""
        return {"occupied": self.occupied.copy(),
                "row_owner": self.row_owner.copy(),
                "submit_tick": self.submit_tick.copy(),
                "free_rows": list(self._free_rows)}

    def load_state_dict(self, d: dict) -> None:
        occupied = np.asarray(d["occupied"], bool)
        if occupied.shape != (self.M, self.N):
            raise ValueError(
                f"slot-table checkpoint is {occupied.shape}, table is "
                f"({self.M}, {self.N})")
        self.occupied = occupied.copy()
        self.row_owner = np.asarray(d["row_owner"], np.int64).copy()
        self.submit_tick = np.asarray(d["submit_tick"], np.int64).copy()
        self._free_rows = [int(r) for r in d["free_rows"]]

    def release_done(self, done: np.ndarray) -> np.ndarray:
        """Recycle slots whose pipelines were granted (``done[M, N]`` from
        the device).  Returns the ``[n, 2]`` (row, col) indices freed this
        call.  Rows with no remaining occupancy go back to the free list."""
        freed = np.argwhere(done & self.occupied)
        self.occupied[done] = False
        self.submit_tick[done] = -1
        for row in np.unique(freed[:, 0]) if freed.size else []:
            row = int(row)
            if not self.occupied[row].any() and self.row_owner[row] != -1:
                self.row_owner[row] = -1
                self._free_rows.append(row)
        return freed
