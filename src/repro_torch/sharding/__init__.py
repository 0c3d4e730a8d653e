"""Logical-axis sharding rules, mesh shapes and partition specs."""
from .rules import (DEFAULT_RULES, MeshCtx, MeshShape, PartitionSpec, activate_mesh,
                    get_mesh_ctx, local_shape, logical_to_spec, mesh_axes, mesh_size,
                    placements, set_mesh_ctx, shard)

__all__ = ["DEFAULT_RULES", "MeshCtx", "MeshShape", "PartitionSpec", "activate_mesh",
           "get_mesh_ctx", "local_shape", "logical_to_spec", "mesh_axes", "mesh_size",
           "placements", "set_mesh_ctx", "shard"]
