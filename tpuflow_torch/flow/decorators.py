"""Step and flow decorators: retry, gang, card, resources, schedule, trigger.

Counterpart of ``tpuflow/flow/decorators.py``. ``@gpu`` is the twin of the
JAX package's ``@tpu``: a gang step of N processes that form one
``torch.distributed`` world, one process per card. The resource and
environment records (``@kubernetes``, ``@pypi``) and the cron record
(``@schedule``) are kept on the function or class as the JAX package keeps
them; the port has no deployer yet (ROADMAP Queue 1 item 8b).
"""

from __future__ import annotations

from typing import Callable


def retry(
    times: int = 3, backoff_s: float = 2.0, max_backoff_s: float = 60.0
):
    """Step-level retry: a failed step reruns up to ``times`` extra
    attempts. Between attempts the runner sleeps
    ``min(max_backoff_s, backoff_s * 2**(n-1))`` scaled by a uniform
    0.5-1.0 jitter (attempt ``n``, 1-based), so retrying gangs do not
    stampede shared storage or the rendezvous. A member exiting with the
    requeue code (``utils.preempt``) reruns the step without spending
    ``times``."""

    def wrap(fn: Callable) -> Callable:
        fn.__retry_times__ = times
        fn.__retry_backoff_s__ = backoff_s
        fn.__retry_max_backoff_s__ = max_backoff_s
        return fn

    return wrap


def gpu(
    num_parallel: int | None = None,
    all_hosts_started_timeout: float = 300.0,
    heartbeat_timeout: float | None = None,
    min_members: int | None = None,
):
    """Gang step: the body runs as ``num_parallel`` processes (or the
    ``num_parallel`` of the transition into it) forming one
    ``torch.distributed`` world — NCCL on the card, one process per card;
    gloo on the CPU (a flow's ``dist_backend`` parameter and a device with
    a card index change that: see ``flow/gang_exec.py``). Process 0 is the head and only its artifacts persist;
    a join step sees the others as inputs without artifacts. Every member
    must join within ``all_hosts_started_timeout`` seconds or the step
    fails.

    ``heartbeat_timeout``: a member whose heartbeat file (stamped at every
    fenced train step and ``TrainContext.report``,
    ``utils/heartbeat.py``) goes silent for this many seconds is judged
    hung, and the gang is killed at once. None means 600 s (the JAX
    package's ``TPUFLOW_STALL_TIMEOUT_S`` default). A member that never
    stamps is never judged.

    ``min_members``: the elastic gang's floor (``FlowRunner(elastic=
    True)``): a member loss shrinks the gang over the survivors while at
    least this many remain; below it the supervisor falls back to the
    requeue. None means 2 (the JAX package's ``TPUFLOW_GANG_MIN_MEMBERS``
    default)."""

    def wrap(fn: Callable) -> Callable:
        fn.__gang__ = {
            "num_parallel": num_parallel,
            "timeout": all_hosts_started_timeout,
            "heartbeat_timeout": heartbeat_timeout,
            "min_members": min_members,
        }
        return fn

    return wrap


def kubernetes(**resources):
    """Resource request record, kept as ``fn.__resources__``."""

    def wrap(fn: Callable) -> Callable:
        fn.__resources__ = resources
        return fn

    return wrap


def pypi(**env):
    """Per-step environment pin record, kept as ``fn.__pypi__``."""

    def wrap(fn: Callable) -> Callable:
        fn.__pypi__ = env
        return fn

    return wrap


def card(type: str = "blank"):
    """Attach a report card to the step: the step gets ``current.card`` to
    append Markdown/Table/Image components, rendered to ``card.html`` in
    the task directory when the step completes."""

    def wrap(fn: Callable) -> Callable:
        fn.__card__ = type
        return fn

    return wrap


def device_profile(interval: float = 1.0, trace: bool = False):
    """Device memory sampling during the step: every ``interval`` seconds a
    background thread records each card's allocated and peak allocated
    bytes into ``profile.json`` in the task directory, with the platform
    and the cards' names. ``trace=True`` also writes a ``torch.profiler``
    chrome trace of the whole step under ``trace/``."""

    def wrap(fn: Callable) -> Callable:
        fn.__device_profile__ = {"interval": interval, "trace": trace}
        return fn

    return wrap


def schedule(cron: str):
    """Flow-level cron record (``cls.__schedule__``), written into every
    run's metadata; firing runs on it is a scheduler's job."""

    def wrap(cls):
        cls.__schedule__ = cron
        return cls

    return wrap


def trigger_on_finish(flow: str):
    """Event trigger: when the named flow finishes successfully it appends
    an event record; running this flow with ``--triggered`` consumes the
    newest one and exposes ``current.trigger.run``."""

    def wrap(cls):
        cls.__trigger_on_finish__ = flow
        return cls

    return wrap
