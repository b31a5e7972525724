"""Parallelism layouts (counterpart of ``tpuflow/parallel``): the JAX
sharding rule over the ``data`` x ``fsdp`` x ``tensor`` x ``seq`` x
``expert`` processes and the pipeline rule on ``data`` x ``stage``
(``sharding``: FSDP2 and explicit tensor/expert blocks), the Megatron
computation on the ``tensor`` and ``expert`` groups (``tensor``), the
sequence-parallel attention on the ``seq`` group (``ring_attention``,
``ulysses``), the GPipe schedule on the ``stage`` group (``pipeline``)
and the differentiable collectives under them (``p2p``)."""

from tpuflow_torch.parallel.sharding import (
    ShardPlan,
    gpt2_tensor_rules,
    has_sharded_leaf,
    leaf_spec,
    localize,
    make_shardings,
    shard_model,
)
from tpuflow_torch.parallel.pipeline import (
    gpt2_pipeline_loss,
    gpt2_pipeline_shardings,
    make_pipeline_loss,
)
from tpuflow_torch.parallel.ring_attention import ring_attention
from tpuflow_torch.parallel.tensor import TensorParallel
from tpuflow_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "ShardPlan",
    "TensorParallel",
    "gpt2_pipeline_loss",
    "gpt2_pipeline_shardings",
    "gpt2_tensor_rules",
    "has_sharded_leaf",
    "leaf_spec",
    "localize",
    "make_pipeline_loss",
    "make_shardings",
    "ring_attention",
    "shard_model",
    "ulysses_attention",
]
