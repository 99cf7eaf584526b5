"""Parallelism: device meshes, the process world for data-parallel training,
batch placement and frame data parallelism (the JAX package's
``parallel/``; the reference runs on one device)."""

from .mesh import (DATA_AXIS, DCN_AXIS, Mesh, average_over_world, data_parallel,
                   distributed_init, launch, make_hybrid_mesh, make_mesh, pad_to_multiple,
                   rank_rows, replicate, shard_batch, world_info)

__all__ = ["DATA_AXIS", "DCN_AXIS", "Mesh", "average_over_world", "data_parallel",
           "distributed_init", "launch", "make_hybrid_mesh", "make_mesh", "pad_to_multiple",
           "rank_rows", "replicate", "shard_batch", "world_info"]
