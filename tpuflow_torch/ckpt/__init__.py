"""Checkpoints: the raw format, the manager and the handle (counterpart of
``tpuflow/ckpt``), plus ``tree``, which lays the port's training state out
as the JAX checkpoint tree."""

from tpuflow_torch.ckpt.handle import Checkpoint
from tpuflow_torch.ckpt.manager import (
    CheckpointManager,
    prewarm_restore_handle,
    prewarm_restore_wait,
    restore_from_handle,
)
from tpuflow_torch.ckpt.raw import (
    CheckpointIOError,
    CorruptShardError,
    RecyclePool,
    RestoreArena,
    release_pinned,
)

__all__ = [
    "Checkpoint",
    "CheckpointIOError",
    "CheckpointManager",
    "CorruptShardError",
    "RecyclePool",
    "RestoreArena",
    "release_pinned",
    "prewarm_restore_handle",
    "prewarm_restore_wait",
    "restore_from_handle",
]
