"""Several devices: data-parallel training and tile-sharded prediction over
a torch.distributed process group (mesh.py), the reductions over the batch
inside a sharded step (collectives.py), and the dry run of the sharded
train step (dryrun.py)."""
from .mesh import (barrier, check_num_devices, data_group, is_initialized,
                   launch, rank, shard_batch, world_group, world_size)

__all__ = ["barrier", "check_num_devices", "data_group", "is_initialized",
           "launch", "rank", "shard_batch", "world_group", "world_size"]
