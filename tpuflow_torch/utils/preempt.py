"""Preemption primitives shared by the flow and train layers (counterpart
of ``tpuflow/utils/preempt.py``).

The infrastructure SIGTERMs a process it is about to take away; the
handler only sets a flag. The training loops read it at the next step
boundary, drain a final checkpoint (``emergency_save`` on the fastest
tier when the grace window is closing) and raise ``Preempted``, which a
gang member turns into the *requeue* exit code: the supervisor reruns
the step without spending its ``@retry`` budget.

The JAX package reads the grace budget, the emergency threshold and the
launch attempt from ``TPUFLOW_PREEMPT_GRACE_S``,
``TPUFLOW_PREEMPT_EMERGENCY_S`` and ``TPUFLOW_ATTEMPT``; here each
function takes them as arguments, and ``configure`` installs the
process's own (``flow/gang_exec.py`` does, from the member's pickled
state).
"""

from __future__ import annotations

import signal
import threading
import time

# BSD EX_TEMPFAIL: "try again later". Distinct from every exit code a crash
# produces (Python exceptions -> 1, signals -> 128+N or negative), so the
# supervisor can classify a member's death as requeue, not failure.
REQUEUE_EXIT_CODE = 75

DEFAULT_GRACE_S = 30.0
DEFAULT_EMERGENCY_S = 10.0


class Preempted(RuntimeError):
    """Raised by a train loop at a step boundary after it drained and
    committed its final checkpoint; a gang member turns it into a
    ``REQUEUE_EXIT_CODE`` exit."""


_FLAG = threading.Event()
# Monotonic time of the first preemption request of this cycle: the
# anchor the remaining grace counts down from.
_REQUESTED_AT: float | None = None
# The process's own settings (``configure``).
_GRACE_S = DEFAULT_GRACE_S
_EMERGENCY_S = DEFAULT_EMERGENCY_S
_ATTEMPT = 0


def configure(*, grace_s: float | None = None,
              emergency_s: float | None = None,
              attempt: int | None = None) -> None:
    """Install this process's grace budget, emergency threshold and launch
    attempt (each left as it is when None)."""
    global _GRACE_S, _EMERGENCY_S, _ATTEMPT
    if grace_s is not None:
        _GRACE_S = max(0.0, float(grace_s))
    if emergency_s is not None:
        _EMERGENCY_S = float(emergency_s)
    if attempt is not None:
        _ATTEMPT = int(attempt)


def launch_attempt() -> int:
    """Which launch of the current step this process belongs to (0 = the
    first; retries and requeues count up), as ``configure`` set it."""
    return _ATTEMPT


def request_preemption(signum=None, frame=None) -> None:
    """Mark this process preempted (signal-handler signature). Idempotent:
    a repeated SIGTERM keeps the first request's grace anchor."""
    global _REQUESTED_AT
    if _REQUESTED_AT is None:
        _REQUESTED_AT = time.monotonic()
    _FLAG.set()


def preemption_requested() -> bool:
    return _FLAG.is_set()


def clear_preemption() -> None:
    global _REQUESTED_AT
    _REQUESTED_AT = None
    _FLAG.clear()


def grace_budget_s(budget: float | None = None) -> float:
    """The termination grace this process has after a SIGTERM, in seconds:
    ``budget`` (never negative), else the process's own (``configure``;
    30 s by default)."""
    if budget is not None:
        return max(0.0, float(budget))
    return _GRACE_S


def grace_remaining_s(budget: float | None = None) -> float | None:
    """The grace still left of ``grace_budget_s(budget)`` since the first
    request, never negative; None when no preemption is in flight."""
    anchor = _REQUESTED_AT
    if anchor is None or not _FLAG.is_set():
        return None
    return max(0.0, grace_budget_s(budget) - (time.monotonic() - anchor))


def emergency_save_advised(threshold: float | None = None,
                           budget: float | None = None) -> bool:
    """True when a preemption is in flight and the remaining grace is
    under ``threshold`` seconds (else the process's own, 10 s by default):
    drain points then write the fast local-tier emergency checkpoint
    (``CheckpointManager.emergency_save``) instead of the full save."""
    remaining = grace_remaining_s(budget)
    if remaining is None:
        return False
    return remaining < (_EMERGENCY_S if threshold is None
                        else float(threshold))


def install_sigterm_handler() -> bool:
    """Route SIGTERM to ``request_preemption``. Main thread only (a signal
    module rule): False elsewhere instead of raising."""
    try:
        signal.signal(signal.SIGTERM, request_preemption)
        return True
    except ValueError:  # not the main thread
        return False
