"""Distribution substrate of the port: ``repro``'s sharding rules and the
shards they describe, tensor-parallel blocks, and GPipe pipeline
parallelism, over ``torch.distributed`` ranks (meshes:
:mod:`repro_torch.launch.mesh`)."""
from .sharding import (batch_pspecs, cache_pspecs, dp_axes, dp_size, gather,
                       local_shape, param_pspecs, shard, state_pspecs,
                       tp_size)

__all__ = ["batch_pspecs", "cache_pspecs", "dp_axes", "dp_size", "gather",
           "local_shape", "param_pspecs", "shard", "state_pspecs",
           "tp_size"]
