"""Crash-forensics flight recorder (counterpart of
``tpuflow/obs/flight.py``).

A gang member that dies on a fatal path (an unhandled exception, the
supervisor's SIGTERM before its SIGKILL, an injected ``member_exit``)
leaves more than a log tail: ``dump_flight`` writes the recorder's ring
of its newest events, the process's launch fingerprint and the faulting
stack to ``<obs_dir>/flight/p<proc>.json``, which the supervisor's
``flow.member_failed`` event names.

Signal safety: the SIGTERM handler calls ``dump_flight``, which may have
interrupted a frame that holds the recorder's buffer lock. The ring is
copied under the lock with a timeout, else without it, and the locked
API (the ``obs.flight`` marker and a flush) runs only when the lock was
free. The dump never raises.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

from tpuflow_torch.obs import recorder as _rec

FLIGHT_SUBDIR = "flight"
# What the port's processes read from their environment: torch's
# rendezvous variables and the card selection.
_ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
             "MASTER_PORT", "CUDA_VISIBLE_DEVICES")


def flight_path(obs_dir: str, proc: int) -> str:
    """Where process ``proc``'s dump lands under ``obs_dir`` (the
    supervisor looks it up by member index)."""
    return os.path.join(obs_dir, FLIGHT_SUBDIR, f"p{int(proc):05d}.json")


def _fingerprint() -> dict[str, str]:
    return {k: os.environ[k][:200] for k in _ENV_KEYS if k in os.environ}


def dump_flight(reason: str, exc: BaseException | None = None) -> str | None:
    """Write this process's flight dump and return its path; None when
    recording is off or the write failed. Atomic (a temporary file, then
    a rename); a later dump replaces an earlier one."""
    rec = _rec.recorder()
    if rec is None:
        return None
    try:
        if exc is not None:
            stack = "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))
        else:
            stack = "".join(traceback.format_stack())
        ring, lock_was_free = rec._ring_snapshot()
        payload = {
            "reason": reason, "ts": time.time(), "proc": rec.proc,
            "pid": os.getpid(), "attempt": rec.attempt,
            "argv": list(sys.argv), "env": _fingerprint(),
            "stack": stack[-8000:], "dropped_events": rec.dropped,
            "events": ring,
        }
        path = flight_path(rec.directory, rec.proc)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=_rec._jsonable)
        os.replace(tmp, path)
        if lock_was_free:
            _rec.event("obs.flight", reason=reason, path=path)
            _rec.flush()
        return path
    except Exception:
        return None
