from .mesh import (
    Mesh,
    Sharded,
    gather,
    make_host_mesh,
    make_mesh,
    map_shards,
    replicate,
    shard_batch,
    shard_generators,
    tree_bytes,
)

__all__ = ["Mesh", "Sharded", "gather", "make_host_mesh", "make_mesh",
           "map_shards", "replicate", "shard_batch", "shard_generators",
           "tree_bytes"]
