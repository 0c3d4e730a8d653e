"""Logical-axis sharding rules, mesh shapes and partition specs, and the
explicit collectives of the LM's sharded execution (``collectives``)."""
from . import collectives
from .rules import (DEFAULT_RULES, MeshCtx, MeshShape, PartitionSpec, activate_mesh, block,
                    distribute_state, gather_state, get_mesh_ctx, local_shape, logical_to_spec,
                    mesh_axes, mesh_coords, mesh_size, placements, serve_ctx, set_mesh_ctx,
                    shard)

__all__ = ["DEFAULT_RULES", "MeshCtx", "MeshShape", "PartitionSpec", "activate_mesh", "block",
           "collectives", "distribute_state", "gather_state", "get_mesh_ctx", "local_shape",
           "logical_to_spec", "mesh_axes", "mesh_coords", "mesh_size", "placements",
           "serve_ctx", "set_mesh_ctx", "shard"]
