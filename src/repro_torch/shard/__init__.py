"""Sharded service plane: the block ledger striped over process ranks.

Partitions the service plane's block-ledger ring and the ``[M, N, B]``
demand tensor's block axis over the ranks of a ``torch.distributed``
process group (one process per rank), turning the one-device streaming
service (:mod:`repro_torch.service`) into a scale-out system:

* :mod:`repro_torch.shard.state` -- the striped ring layout (stripe ``s``
  holds the ``bid % S == s`` blocks; mints and retirement are
  stripe-local), the layout remap behind elastic restores, the gathers,
  and :class:`ShardedServiceState`;
* :mod:`repro_torch.shard.service` -- :class:`ShardedFlaasService`, whose
  tick loop runs the unsharded body over the rank's stripe with
  cross-stripe all_reduce hooks, plus the chunk-boundary live-block
  census behind admission.

Parity: one stripe is bit-identical to ``FlaasService``; S stripes match
to 1e-5 for all four schedulers.  Launch with
:mod:`repro_torch.launch.sharded_service` (``torch.multiprocessing`` or
``torchrun``; Gloo on CPUs or several ranks on one card, NCCL at one rank
a card).
"""
from .service import ShardedFlaasService, gather_shard_view
from .state import (AXIS, ShardedServiceState, all_gather_blocks, barrier,
                    block_axis, remap_ring, ring_slots)

__all__ = [
    "AXIS", "ShardedFlaasService", "ShardedServiceState",
    "all_gather_blocks", "barrier", "block_axis", "gather_shard_view",
    "remap_ring", "ring_slots",
]
