"""The sharded service plane: FlaasService over block stripes, one rank each.

:class:`ShardedFlaasService` partitions the block-ledger ring and the
demand tensor's block axis over the ranks of a ``torch.distributed``
process group (:mod:`repro_torch.shard.state`).  ``repro`` drives a device
mesh from one controller; the port is SPMD -- one process per rank, each
running the same host plane (trace, queue, slot table, telemetry) from the
same seed, and the same tick loop over its own stripe, in which

* every per-block sweep (waterfill dual ascent, SP2 feasibility scans,
  capacity debits, mint and retire selects) touches only the rank's
  ``B/S`` stripe;
* the analyst-level reductions (the mu_i row-max, the matvec partials, the
  greedy pass's fits checks, the KKT error, the boost water levels) finish
  with small all_reduce calls whose payloads are analyst- or
  pipeline-indexed, never block-indexed
  (:class:`~repro_torch.core.blockaxis.BlockAxis`);
* mints stay stripe-local by construction of the striped ring, so ring
  retirement needs no cross-rank traffic.

Admission stays on the host as in :class:`FlaasService`: at every chunk
boundary the ranks all-gather their live-block census
(:func:`gather_shard_view`) and then drain the same FIFO queue with the
same rules, so the sharded and unsharded services admit identically.
With ``cfg.validate`` the ranks also all-gather a digest of each
boundary's admissions, so host planes that drift apart fail loudly.

Parity (``repro``'s contract): one stripe is the unsharded layout and
arithmetic bit for bit; S stripes match to 1e-5 (the residual is float
reassociation in the cross-stripe partial sums) for all four schedulers,
ring wraps included.
"""
from __future__ import annotations

import functools
import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from ..core.registry import get_round_fn
from ..service.server import FlaasService, ServiceConfig, _chunk_metrics
from ..service.state import NEVER, ServiceState
from ..service.traces import ArrivalTrace
from .state import (ShardedServiceState, all_gather_blocks, barrier,
                    block_axis, group_rank, group_size)

# per-tick diagnostics that carry the block axis (gathered to the ring)
_DIAG_BLOCK_KEYS = ("gamma_i", "granted_i", "cap_frac")


def gather_shard_view(service: "ShardedFlaasService"):
    """(per-stripe live-block counts ``[S]``, free pipeline slots): the
    chunk-boundary all-gather behind sharded admission, from the device."""
    st = service.state
    live = torch.sum(((st.block_birth >= 0) &
                      (st.block_capacity > 0.0)).to(torch.int64)).reshape(1)
    occupied = int(torch.sum((st.spawn_tick != int(NEVER)) & ~st.done))
    M, N, _ = st.demand.shape
    counts = all_gather_blocks(live, service.group).cpu().numpy()
    return counts, int(M * N - occupied)


class ShardedFlaasService(FlaasService):
    """Long-running scheduling service with a block-sharded ledger.

    Drop-in for :class:`FlaasService` (same config, traces, telemetry and
    replay machinery).  Every rank of ``group`` (default: the default
    process group) constructs one with the same config and trace, on its
    own ``device``; rank ``s`` holds stripe ``s`` of the ring.
    ``n_shards``, when given, must be the group's size, and
    ``cfg.block_slots`` must divide evenly over the ranks."""

    def __init__(self, cfg: ServiceConfig, trace: ArrivalTrace, *,
                 group=None, n_shards: Optional[int] = None,
                 device="cuda"):
        S = group_size(group)
        if n_shards is not None and n_shards != S:
            raise ValueError(
                f"the process group has {S} ranks but n_shards={n_shards} "
                f"was also given")
        # ShardedServiceState owns the layout rules (ring divisibility,
        # striped slot map); the `state` property routes every state the
        # base class installs through it, starting with the constructor's
        # fresh whole-ring state.
        self.group = group
        self.sharded = None
        self.block_axis = block_axis(group)
        self._admitted = []
        super().__init__(cfg, trace, device=device)
        self.shard_live_blocks = np.zeros(S, np.int64)
        self.free_pipeline_slots = cfg.analyst_slots * cfg.pipeline_slots

    # ------------------------------------------------------------- layout
    @property
    def n_shards(self) -> int:
        return group_size(self.group)

    @property
    def rank(self) -> int:
        return group_rank(self.group)

    @property
    def state(self) -> ServiceState:
        return self.sharded.state

    @state.setter
    def state(self, value: ServiceState):
        # the constructor's first state is the whole ring: keep the stripe;
        # later ones (admission, chunk grafts) are already local
        if self.sharded is None:
            self.sharded = ShardedServiceState.commit(value, self.group)
        else:
            self.sharded = self.sharded.put(value)

    def _slot_of(self, bids: np.ndarray) -> np.ndarray:
        return self.sharded.slot_of(bids)

    def _page_shards(self) -> int:
        # each rank pages its own `bid % S` stripe: the hot-ring gather,
        # wipes and boundary sweep are rank-local
        return self.n_shards

    def _ring_layout_shards(self) -> int:
        # checkpoints record the stripe count; load_checkpoint remaps the
        # block axis when restoring onto another count
        return self.n_shards

    def _host_blocks(self, a: np.ndarray) -> np.ndarray:
        return a[..., self.sharded.stripe]

    # -------------------------------------------------------------- chunk
    def _compiled_step(self, n_ticks: int, mode: str):
        """The chunk step over this rank's stripe: the SAME
        ``_chunk_metrics`` body with the sharded axis; the host-planned
        mint operands (whole-ring rows) are cut to the stripe here, and a
        paged chunk takes its rank's row of the hot-ring slot table."""
        cfg = self.cfg
        step = functools.partial(
            _chunk_metrics, cfg=cfg.sched,
            round_fn=get_round_fn(cfg.scheduler), n_ticks=n_ticks,
            mode=mode, diagnostics=cfg.diagnostics,
            trace_level=cfg.trace_level, audit=cfg.audit_path is not None,
            block_axis=self.block_axis)
        stripe, rank = self.sharded.stripe, self.rank

        def run(state, ops, tick0):
            if mode == "paged":
                *rows, mint_tick, hot_slots = ops
                ops = tuple(r[:, stripe].contiguous() for r in rows) + (
                    mint_tick[stripe].contiguous(),
                    hot_slots[rank:rank + 1].contiguous())
            else:
                ops = tuple(r[:, stripe].contiguous() for r in ops)
            final, ys = step(state, ops, tick0)
            for k in _DIAG_BLOCK_KEYS:
                if k in ys:
                    ys[k] = all_gather_blocks(ys[k], self.group)
            return final, ys

        return run

    # ----------------------------------------------------------- boundary
    def admit_boundary(self, n_ticks: int) -> int:
        # sharded admission: all-gather the per-stripe ledger census, then
        # drain the queue exactly as the unsharded service (the queue is
        # host-global, the same on every rank)
        self.shard_live_blocks, self.free_pipeline_slots = \
            gather_shard_view(self)
        self._admitted = []
        tick0 = super().admit_boundary(n_ticks)
        if self.cfg.validate:
            self._check_lockstep(tick0)
        return tick0

    def _placement_arrays(self, placements, boundary_tick: int):
        self._admitted = [(int(sub.analyst), int(sub.submit_tick), int(row),
                           tuple(int(c) for c in cols))
                          for sub, row, cols in placements]
        *tables, rows, cols, slots, eps = super()._placement_arrays(
            placements, boundary_tick)
        # keep this stripe's demand entries, in local slot numbers
        st = self.sharded.stripe
        keep = (slots >= st.start) & (slots < st.stop)
        return (*tables, rows[keep], cols[keep], slots[keep] - st.start,
                eps[keep])

    def _check_lockstep(self, tick0: int) -> None:
        """All-gather a digest of this boundary's admissions; raise unless
        every rank admitted the same submissions into the same slots."""
        blob = repr((tick0, self.queue.depth, self._admitted)).encode()
        digest = np.frombuffer(hashlib.blake2b(blob, digest_size=8).digest(),
                               "<i8")
        mine = torch.from_numpy(digest.copy()).to(self.device)
        every = all_gather_blocks(mine, self.group).cpu().numpy()
        if not (every == digest[0]).all():
            raise RuntimeError(
                f"sharded service ranks diverged at the tick-{tick0} "
                f"boundary: admission digests {every.tolist()}")

    def summary(self) -> Dict:
        out = super().summary()
        out["sharding"] = {
            "n_shards": self.n_shards,
            "blocks_per_shard": self.cfg.block_slots // self.n_shards,
            "shard_live_blocks": [int(x) for x in self.shard_live_blocks],
            "free_pipeline_slots": int(self.free_pipeline_slots),
            "pending_pipelines": self.queue.pending_pipelines(),
        }
        return out

    # --------------------------------------------------------- durability
    def save_checkpoint(self, manager, metadata: Optional[Dict] = None) -> int:
        """Every rank gathers the stripes into the whole ring, rank 0
        writes it (with its host plane, the same as every rank's), and
        the ranks meet at a barrier.  Returns the step, the tick."""
        with self.profiler.phase("checkpoint_save"):
            whole = self.sharded.gather()
            step = (self._write_checkpoint(manager, whole, metadata)
                    if self.rank == 0 else self.tick)
            barrier(self.group, self.device)
        return step

    def load_checkpoint(self, manager, step: Optional[int] = None) -> int:
        """Every rank reads the whole ring, remaps it from the writer's
        stripe count to this group's and keeps its own stripe.  Rank 0
        first finishes an async save of its own."""
        if self.rank == 0:
            manager.wait()
        barrier(self.group, self.device)
        return super().load_checkpoint(manager, step)

    def _checkpoint_template(self) -> ServiceState:
        c = self.cfg
        return ServiceState.create(c.analyst_slots, c.pipeline_slots,
                                   c.block_slots, device="cpu")

    def _adopt_state(self, state: ServiceState) -> None:
        self.sharded = ShardedServiceState.commit(state, self.group,
                                                  device=self.device)
