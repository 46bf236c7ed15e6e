"""Multi-device layer of the port (counterpart of yolosharp_tpu/parallel):
the mesh and its row sharding for predict (``mesh``), the process group
of data-parallel train and val (``dist``), and FSDP / ZeRO sharding of the
train state (``fsdp``)."""

from . import dist
from .fsdp import DEFAULT_MIN_SIZE, ShardedParams, fsdp_spec, \
    sharded_param_bytes
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, create_mesh, \
    replicate_tree, shard_batch, visible_devices

__all__ = ["DATA_AXIS", "DEFAULT_MIN_SIZE", "MODEL_AXIS", "Mesh",
           "ShardedParams", "create_mesh", "dist", "fsdp_spec",
           "replicate_tree", "shard_batch", "sharded_param_bytes",
           "visible_devices"]
