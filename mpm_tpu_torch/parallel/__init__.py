"""The x-slab domain decomposition (port of ``mpm_tpu.parallel``): one
process drives one slab per device of a `SlabMesh` (domain.py) for the
bucket state and for the sort-based step of the binned engine, and the
sharded render composites the slabs' depth buffers (render.py)."""

from .domain import (ShardConfig, ShardedSimState, ShardedState, SlabMesh,
                     demo_sharded_bucket_step, demo_sharded_step, gather_bucket_state,
                     gather_live, make_sharded_bucket_step, make_sharded_step,
                     shard_bucket_state, shard_scene)

__all__ = [
    "ShardConfig",
    "ShardedSimState",
    "ShardedState",
    "SlabMesh",
    "demo_sharded_bucket_step",
    "demo_sharded_step",
    "gather_bucket_state",
    "gather_live",
    "make_sharded_bucket_step",
    "make_sharded_step",
    "shard_bucket_state",
    "shard_scene",
]
