"""More than one episode, and more than one device: the lockstep fleet
(``fleet``, ``evaluator``), device meshes (``mesh``), row-sharded maps
(``sharding``) and the batched mapping service (``episodes``)."""

from mass_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from mass_tpu_torch.parallel.sharding import (  # noqa: F401
    shard_voxelmap, sharded_update_fn)
from mass_tpu_torch.parallel.episodes import BatchedMapper  # noqa: F401
