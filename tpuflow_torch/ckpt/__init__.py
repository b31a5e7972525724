"""Checkpoints: the raw format, the manager and the handle (counterpart of
``tpuflow/ckpt``), plus ``tree``, which lays the port's training state out
as the JAX checkpoint tree."""

from tpuflow_torch.ckpt.handle import Checkpoint
from tpuflow_torch.ckpt.manager import CheckpointManager, restore_from_handle
from tpuflow_torch.ckpt.raw import CheckpointIOError, CorruptShardError

__all__ = [
    "Checkpoint",
    "CheckpointIOError",
    "CheckpointManager",
    "CorruptShardError",
    "restore_from_handle",
]
