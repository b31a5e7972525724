"""Data-parallel runtime (counterpart of ``tpuflow/dist``): the process
group, the ``data`` mesh, batch placement, gradient averaging and
barriers (``mesh``)."""

from tpuflow_torch.dist.mesh import (
    Mesh,
    average_gradients,
    barrier,
    data_axis_size,
    initialize,
    make_mesh,
    process_count,
    process_index,
    replicate,
    shard_batch,
    shutdown,
    step_fence,
)

__all__ = [
    "Mesh",
    "average_gradients",
    "barrier",
    "data_axis_size",
    "initialize",
    "make_mesh",
    "process_count",
    "process_index",
    "replicate",
    "shard_batch",
    "shutdown",
    "step_fence",
]
