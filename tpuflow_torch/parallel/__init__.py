"""Parallelism layouts (counterpart of ``tpuflow/parallel``): FSDP over the
``data`` x ``fsdp`` processes (``sharding``). Tensor, sequence and
pipeline parallelism are ROADMAP Queue 1 item 14."""

from tpuflow_torch.parallel.sharding import (
    ShardPlan,
    fsdp_dim,
    has_sharded_leaf,
    make_shardings,
    shard_model,
)

__all__ = [
    "ShardPlan",
    "fsdp_dim",
    "has_sharded_leaf",
    "make_shardings",
    "shard_model",
]
