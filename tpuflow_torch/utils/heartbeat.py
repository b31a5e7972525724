"""Per-member gang heartbeats (counterpart of ``tpuflow/utils/heartbeat.py``).

The gang supervisor (``flow/runner.py``) cannot tell a member that is
busy from one that is stuck in a collective whose peer died: both are
silent. Heartbeat files tell them apart: the runner hands every member a
private path, which the member ``configure``s (``flow/gang_exec.py``;
the JAX package passes it in ``TPUFLOW_HEARTBEAT_FILE``), and the member
stamps it at cheap progress points, every fenced train step
(``train/gpt.py``) and every ``TrainContext.report``. A member whose
last stamp is older than the stall timeout is judged hung and the gang
is killed at once instead of waiting out its deadline.

A member that never stamps is never judged: a step body owes no
heartbeats, and a train loop's first stamp lands only at its first
fence.
"""

from __future__ import annotations

import os

_PATH: str | None = None


def configure(path: str | None) -> None:
    """This process's heartbeat file (None: no heartbeats)."""
    global _PATH
    _PATH = path or None


def beat(step: int | None = None) -> None:
    """Stamp this process's heartbeat file; a no-op without one. Never
    raises: a heartbeat must not fail the step it reports on. ``step`` is
    written as the file's content, so a stall report names the member's
    last step; a step-less beat keeps the last step and touches the
    mtime. After the stamp the fault plan's ``heartbeat_stall`` hook
    runs."""
    path = _PATH
    if not path:
        return
    try:
        if step is None:
            with open(path, "a"):
                pass
        else:
            with open(path, "w") as f:
                f.write(str(int(step)))
        os.utime(path, None)
    except (OSError, TypeError, ValueError):
        return
    from tpuflow_torch.testing import faults

    # After the stamp: a stalled member shows exactly one beat and then
    # goes silent, the signature the supervisor must detect.
    faults.maybe_stall_heartbeat()
