"""Preemption primitives of the flow layer (counterpart of
``tpuflow/utils/preempt.py``): the requeue exit code and the
SIGTERM-sets-a-flag handler.

The infrastructure SIGTERMs a process it is about to take away; the
process exits with the *requeue* code, which the gang supervisor tells
apart from a crash: the step reruns without spending its ``@retry``
budget. The JAX package's training loops read the flag at the next step
boundary and drain a final checkpoint before they exit; the port's loops
do not yet (ROADMAP Queue 1 item 12c), so a gang member exits with the
code as soon as the signal lands (``flow/gang_exec.py``).
"""

from __future__ import annotations

import threading

# BSD EX_TEMPFAIL: "try again later". Distinct from every exit code a crash
# produces (Python exceptions -> 1, signals -> 128+N or negative), so the
# supervisor can classify a member's death as requeue, not failure.
REQUEUE_EXIT_CODE = 75

_FLAG = threading.Event()


def request_preemption(signum=None, frame=None) -> None:
    """Mark this process preempted (signal-handler signature)."""
    _FLAG.set()


def preemption_requested() -> bool:
    return _FLAG.is_set()
