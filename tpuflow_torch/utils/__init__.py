"""Host utilities the flow layer needs (counterpart of ``tpuflow/utils``):
the inter-process ``FileLock``, the preemption flag and requeue code
(``preempt``) and the gang heartbeats (``heartbeat``)."""

from tpuflow_torch.utils.locking import FileLock

__all__ = ["FileLock"]
