"""Parallelism layouts (counterpart of ``tpuflow/parallel``): the JAX
sharding rule over the ``data`` x ``fsdp`` x ``tensor`` x ``expert``
processes (``sharding``: FSDP2 and explicit tensor/expert blocks) and the
Megatron computation on the ``tensor`` and ``expert`` groups
(``tensor``). Sequence and pipeline parallelism are ROADMAP Queue 1 item
14b."""

from tpuflow_torch.parallel.sharding import (
    ShardPlan,
    gpt2_tensor_rules,
    has_sharded_leaf,
    leaf_spec,
    localize,
    make_shardings,
    shard_model,
)
from tpuflow_torch.parallel.tensor import TensorParallel

__all__ = [
    "ShardPlan",
    "TensorParallel",
    "gpt2_tensor_rules",
    "has_sharded_leaf",
    "leaf_spec",
    "localize",
    "make_shardings",
    "shard_model",
]
