"""Several devices: data- and spatial-parallel training and tile-sharded
prediction over a torch.distributed process group (mesh.py), the
reductions by axis of the (data x space) grid inside a sharded step
(collectives.py), the halo exchange of H slabs (halo.py), and the dry run
of the sharded train step (dryrun.py)."""
from .mesh import (barrier, check_grid, check_num_devices, data_group,
                   is_initialized, launch, make_grid, rank, shard_batch,
                   world_group, world_size)

__all__ = ["barrier", "check_grid", "check_num_devices", "data_group",
           "is_initialized", "launch", "make_grid", "rank", "shard_batch",
           "world_group", "world_size"]
