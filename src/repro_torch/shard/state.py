"""Block-axis sharding of the service-plane state over ``torch.distributed``.

The block ledger (``block_budget`` / ``block_capacity`` / ``block_birth``
and the warm-SP1 ``lam``, all ``[B]``) and the ``[M, N, B]`` demand tensor
shard along the block axis: every per-block quantity is independent until
the analyst-level reduction.  The port runs one process per rank (SPMD),
and rank ``s`` of an ``S``-rank process group holds stripe ``s``:

* **Striped ring** (``repro``'s): global block ``bid`` lives in global slot
  ``(bid % S) * (B/S) + (bid // S) % (B/S)`` (:func:`ring_slots`), so
  stripe ``s`` -- the contiguous global range ``[s*B/S, (s+1)*B/S)`` --
  holds exactly the ``bid % S == s`` blocks.  Each tick mints consecutive
  bids, so mints spread round-robin over the stripes and every mint and
  retirement is stripe-local; the slot of ``bid`` is reused by ``bid + B``
  alone, the horizon of the unsharded ``bid % B`` ring, so the host-side
  eviction bookkeeping is unchanged.  With ``S = 1`` the layout is ``bid %
  B`` bit for bit.
* **Local state**: ``demand[:, :, s*B/S:(s+1)*B/S]`` and the ``[B]``
  ledger arrays on the same range; the ``[M, N]`` pipeline tables and the
  ``[M]`` weights are replicated.  The global array is the concatenation
  of the stripes in rank order (:meth:`ShardedServiceState.gather`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.blockaxis import COLLECTIVES, BlockAxis
from ..service.state import BLOCK_FIELDS, ServiceState

AXIS = "shard"


def ring_slots(bids, n_shards: int, block_slots: int):
    """Striped global-slot layout: ``bid -> (bid % S) * (B/S) + (bid // S)
    % (B/S)``.  Stripe ``s`` is the contiguous global range ``[s*B/S,
    (s+1)*B/S)``, i.e. exactly the ``bid % S == s`` blocks."""
    bids = np.asarray(bids)
    per_shard = block_slots // n_shards
    return (bids % n_shards) * per_shard + (bids // n_shards) % per_shard


def remap_ring(n_from: int, n_to: int, block_slots: int) -> np.ndarray:
    """Gather index remapping every block-axis array from the
    ``n_from``-striped ring layout to the ``n_to``-striped one: ``new =
    old[idx]`` puts each block's slot where :func:`ring_slots` under
    ``n_to`` expects it.

    Both layouts are functions of ``bid % B`` alone (the ``bid + B`` reuse
    horizon), so a slot's occupant under the old stripe count has exactly
    one home under the new one: old slot ``g`` holds the bid class
    ``n_from * (g % (B/S)) + g // (B/S)`` (the inverse of
    :func:`ring_slots`), whose new slot is :func:`ring_slots` under
    ``n_to``.  ``n_from == n_to`` gives the identity permutation."""
    B = int(block_slots)
    for n in (n_from, n_to):
        if n < 1 or B % n:
            raise ValueError(
                f"block_slots={B} not divisible by {n} shards")
    g = np.arange(B, dtype=np.int64)
    per = B // n_from
    bid_class = n_from * (g % per) + g // per
    dst = ring_slots(bid_class, n_to, B)
    idx = np.empty(B, np.int64)
    idx[dst] = g
    return idx


def group_size(group=None) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    import torch.distributed as dist
    return dist.get_rank(group)


def wire_device(group, device: torch.device) -> torch.device:
    """Where a gather's tensors travel: the card under NCCL, the host
    under any other backend (Gloo reduces CUDA tensors, but does not
    gather them)."""
    import torch.distributed as dist
    return device if dist.get_backend(group) == "nccl" else \
        torch.device("cpu")


def all_gather_blocks(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the last axis in rank order,
    on ``t``'s device: the global block axis from its stripes (or, for a
    ``[1]`` per-rank census, the ``[S]`` vector)."""
    import torch.distributed as dist
    wire = wire_device(group, t.device)
    x = t.to(wire)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts, dim=-1).to(device=t.device, dtype=t.dtype)


def barrier(group, device: torch.device) -> None:
    """Every rank waits for every other (an all_reduce on the wire, which
    needs no backend-specific device arguments)."""
    import torch.distributed as dist
    dist.all_reduce(torch.zeros(1, device=wire_device(group, device)),
                    group=group)


def block_axis(group=None, fits_segment: int = 8) -> BlockAxis:
    """The sharded :class:`BlockAxis` over ``group``'s ranks."""
    return BlockAxis(AXIS, fits_segment=fits_segment, group=group)


@dataclasses.dataclass(frozen=True)
class ShardedServiceState:
    """A rank's stripe of a :class:`ServiceState`, paired with the process
    group whose ranks hold the other stripes.  ``state`` is a plain
    ``ServiceState`` whose block-axis fields are this rank's stripe, so
    every host-side code path of the unsharded server works on it."""

    state: ServiceState
    group: object = dataclasses.field(default=None, compare=False)

    @classmethod
    def commit(cls, state: ServiceState, group=None,
               device=None) -> "ShardedServiceState":
        """Check a whole-ring ``state`` against the group (the one home of
        the ring-divisibility rule) and keep this rank's stripe, on
        ``device`` (default: the state's)."""
        n = group_size(group)
        B = state.block_budget.shape[0]
        if B % n:
            raise ValueError(
                f"block_slots={B} not divisible by the group's {n} shards")
        per, r = B // n, group_rank(group)
        dev = state.device if device is None else torch.device(device)
        local = dataclasses.replace(state, **{
            f: getattr(state, f)[..., r * per:(r + 1) * per]
            for f in BLOCK_FIELDS})
        local = dataclasses.replace(local, **{
            f.name: getattr(local, f.name).to(dev).contiguous()
            for f in dataclasses.fields(local)})
        return cls(state=local, group=group)

    @classmethod
    def create(cls, analyst_slots: int, pipeline_slots: int,
               block_slots: int, group=None,
               device="cuda") -> "ShardedServiceState":
        return cls.commit(ServiceState.create(analyst_slots, pipeline_slots,
                                              block_slots, device=device),
                          group)

    @property
    def n_shards(self) -> int:
        return group_size(self.group)

    @property
    def rank(self) -> int:
        return group_rank(self.group)

    @property
    def blocks_per_shard(self) -> int:
        return self.state.block_budget.shape[0]

    @property
    def block_slots(self) -> int:
        return self.blocks_per_shard * self.n_shards

    @property
    def stripe(self) -> slice:
        """This rank's range of the global ring."""
        per = self.blocks_per_shard
        return slice(self.rank * per, (self.rank + 1) * per)

    def slot_of(self, bids):
        return ring_slots(bids, self.n_shards, self.block_slots)

    def put(self, state: ServiceState) -> "ShardedServiceState":
        """The same layout over a host-updated local state."""
        return dataclasses.replace(self, state=state)

    def gather(self) -> ServiceState:
        """The whole-ring state on every rank (one all_gather per
        block-axis field)."""
        return dataclasses.replace(self.state, **{
            f: all_gather_blocks(getattr(self.state, f), self.group)
            for f in BLOCK_FIELDS})
