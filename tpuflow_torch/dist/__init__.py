"""Multi-process runtime (counterpart of ``tpuflow/dist``): the process
group, the ``data`` mesh, the named ``data`` x ``fsdp`` x ``tensor`` x
``seq`` x ``expert`` one and the pipeline's ``data`` x ``stage`` one,
batch placement, gradient averaging and barriers (``mesh``); an elastic
gang's membership generations (``membership``)."""

from tpuflow_torch.dist.mesh import (
    Mesh,
    average_gradients,
    barrier,
    data_axis_size,
    group_sum,
    initialize,
    make_hybrid_mesh,
    make_mesh,
    place_batch,
    process_count,
    process_index,
    replicate,
    shard_batch,
    shutdown,
    step_fence,
    world_sum,
)

__all__ = [
    "Mesh",
    "average_gradients",
    "barrier",
    "data_axis_size",
    "group_sum",
    "initialize",
    "make_hybrid_mesh",
    "make_mesh",
    "place_batch",
    "process_count",
    "process_index",
    "replicate",
    "shard_batch",
    "shutdown",
    "step_fence",
    "world_sum",
]
