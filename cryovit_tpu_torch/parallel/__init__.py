"""The device mesh on ``torch.distributed`` and its sharding rules (port of
``cryovit_tpu/parallel``)."""

from cryovit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    Sharding,
    all_reduce_sum,
    batch_sharding,
    global_sum,
    make_mesh,
    replicate,
    shard_batch,
)
from cryovit_tpu_torch.parallel.spatial import (
    batch_divides,
    encoder_divides,
    halo_exchange,
    place_batch,
    shard_batch_spatial,
    spatial_batch_sharding,
    warn_replicated,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "Sharding",
    "all_reduce_sum",
    "batch_divides",
    "batch_sharding",
    "encoder_divides",
    "global_sum",
    "halo_exchange",
    "make_mesh",
    "place_batch",
    "replicate",
    "shard_batch",
    "shard_batch_spatial",
    "spatial_batch_sharding",
    "warn_replicated",
]
