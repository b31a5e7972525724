"""Host utilities the flow layer needs (counterpart of ``tpuflow/utils``):
the inter-process ``FileLock`` and the preemption flag and requeue code."""

from tpuflow_torch.utils.locking import FileLock

__all__ = ["FileLock"]
