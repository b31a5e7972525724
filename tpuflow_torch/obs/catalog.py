"""The telemetry names the port emits, each with its kind (the subset of
``tpuflow/obs/catalog.py`` that the port's emitters use, with the JAX
catalog's kinds; the rest join with the code that emits them).

Kinds: ``span`` (a timed region: ``ts`` and ``dur_s``), ``counter``,
``gauge``, ``histogram`` and ``event`` (a point-in-time record).
"""

from __future__ import annotations

CATALOG: dict[str, tuple[str, str]] = {
    # ---------------------------------------------------------------- flow
    "flow.run": ("span", "one whole flow run, start → terminal status"),
    "flow.step": ("span", "one step/task execution (attempt granularity)"),
    "flow.gang_member": ("span", "one gang member process's step body"),
    "flow.member_failed": (
        "event",
        "gang supervisor: first non-zero member exit (member, rc, log "
        "tail, flight dump); surviving peers are killed promptly",
    ),
    "flow.preempt": (
        "event",
        "a gang member exited with the requeue code after a preemption "
        "drain; the step reruns without consuming the retry budget",
    ),
    # --------------------------------------------------------------- train
    "train.report": ("event", "one TrainContext.report: step + metrics"),
    # ---------------------------------------------------------------- ckpt
    "ckpt.corrupt": (
        "event",
        "a shard failed crc32/truncation verification; restore fell back "
        "to the next tier / previous committed step or raised — never "
        "silent",
    ),
    "ckpt.io_retry": (
        "event",
        "one transient storage error absorbed by the retrying I/O wrapper "
        "(op, path, attempt, jittered backoff slept)",
    ),
    "ckpt.io_error": (
        "event",
        "a storage operation failed for good: permanent errno or retry "
        "budget exhausted (raises CheckpointIOError)",
    ),
    "ckpt.save_failed": (
        "event",
        "one step's save died on a classified storage error after "
        "retries: staging reclaimed, history entry dropped, training "
        "continues on the previous committed step — never a member death",
    ),
    "ckpt.gc": (
        "event",
        "manager startup reclaimed killed-writer leftovers: staged .tmp "
        "dirs, uncommitted step dirs, stale local-tier staging/overflow",
    ),
    "ckpt.upload": (
        "span",
        "local fast tier → persistent run dir copy of one committed step "
        "(on the saver thread); ok=False means the step is durable "
        "locally only",
    ),
    "ckpt.restore_tier": (
        "event",
        "which tier served a restore (local | persistent) for which step "
        "— the fallback-ladder evidence trail",
    ),
    "ckpt.emergency_save": (
        "event",
        "last-chance synchronous commit on the fastest tier inside a "
        "closing preemption-grace window (upload skipped); the requeued "
        "attempt resumes from this step",
    ),
    # ----------------------------------------------------------------- obs
    "obs.dropped": (
        "event",
        "telemetry events lost by this recorder (buffer overflow or a "
        "failed flush), surfaced once at close — never silently",
    ),
    "obs.flight": (
        "event",
        "a crash-forensics flight dump was written (reason + path): the "
        "bounded ring of recent events, the launch fingerprint and the "
        "faulting stack — referenced from the supervisor's "
        "flow.member_failed event",
    ),
}


def kind_of(name: str) -> str:
    """Registered kind of ``name``; raises KeyError for unknown names."""
    return CATALOG[name][0]


def is_registered(name: str) -> bool:
    return name in CATALOG
