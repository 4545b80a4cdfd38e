"""The x-slab domain decomposition of the bucket state (port of the bucket
half of ``mpm_tpu.parallel``): one process drives one slab per device of a
`SlabMesh` (domain.py), and the sharded render composites the slabs' depth
buffers (render.py)."""

from .domain import (ShardedState, SlabMesh, demo_sharded_bucket_step, gather_bucket_state,
                     make_sharded_bucket_step, shard_bucket_state)

__all__ = [
    "ShardedState",
    "SlabMesh",
    "demo_sharded_bucket_step",
    "gather_bucket_state",
    "make_sharded_bucket_step",
    "shard_bucket_state",
]
