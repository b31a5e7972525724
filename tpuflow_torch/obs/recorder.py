"""Process-local telemetry recorder: buffered structured JSONL events.

Counterpart of ``tpuflow/obs/recorder.py``. One ``Recorder`` per process
writes ``events.p<proc>.<pid>.jsonl`` under the run's ``obs/``
directory; ``timeline.merge_run_events`` unions the per-process files
into one run timeline. The JAX package finds the directory, the slot and
the launch attempt in its environment; here ``configure(directory,
proc=, attempt=)`` takes them (the flow runner configures the head, and
``flow/gang_exec.py`` each member from its pickled state).

Overhead contract:

- **Disabled** (nothing configured): every API call is one module-level
  boolean check — ``span()`` returns a shared no-op context manager,
  ``counter``/``gauge``/``histogram``/``event`` return at once. No
  allocation, no lock, no file.
- **Enabled**: ``record()`` appends a dict to an in-memory buffer under a
  lock — no file I/O on the caller's thread. A daemon thread flushes the
  buffer every ``flush_interval`` seconds (and on ``flush()``/
  ``close()``/interpreter exit), so writes happen off the step path.

Event schema (one JSON object per line)::

    {"kind": "span|counter|gauge|histogram|event",
     "name": "<catalog name>", "ts": <wall-clock start, s>,
     "proc": <gang process index>, "pid": <os pid>,
     "launch": <launch attempt, when one was configured>,
     "dur_s": <monotonic duration, spans only>,
     "value": <counter/gauge/histogram payload>, ...attrs}

The recorder also keeps a bounded ring of the newest events, the flight
recorder's (``obs/flight.py``) payload when the process dies on a fatal
path.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time
from typing import Any

_ENABLED = False
_RECORDER: "Recorder | None" = None
_LOCK = threading.Lock()

# Beyond this many buffered events (a wedged disk) events are counted,
# not kept, and the count is written as a final ``obs.dropped`` event.
DEFAULT_MAX_BUFFERED = 65536
# The flight ring: the newest events, kept whatever the buffer does.
DEFAULT_FLIGHT_RING = 256


class _NoopSpan:
    """Shared, reentrant no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):  # matches _Span.set
        return self


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_rec", "_name", "_attrs", "_t0", "_ts")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self._name = name
        self._attrs = attrs

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. bytes moved)."""
        self._attrs.update(attrs)
        return self

    def __enter__(self):
        self._ts = time.time()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, *exc):
        dur = time.monotonic() - self._t0
        if exc_type is not None:
            self._attrs.setdefault("error", exc_type.__name__)
        self._rec.record("span", self._name, ts=self._ts, dur_s=dur,
                         **self._attrs)
        return False


class Recorder:
    """Buffered JSONL event writer for one process. ``attempt``: the
    launch attempt stamped into every event as ``launch`` (None: none)."""

    def __init__(self, directory: str, *, proc: int = 0,
                 attempt: int | None = None, flush_interval: float = 0.5,
                 max_buffered: int = DEFAULT_MAX_BUFFERED,
                 flight_ring: int = DEFAULT_FLIGHT_RING):
        self.directory = os.path.abspath(directory)
        self.proc = int(proc)
        # The pid in the name: the head runner and gang member 0 share
        # slot 0 and may flush at once; one writer a file, no torn lines.
        self.path = os.path.join(
            self.directory, f"events.p{self.proc:05d}.{os.getpid()}.jsonl")
        os.makedirs(self.directory, exist_ok=True)
        self._buf: list[dict] = []
        self._max_buffered = max(1, int(max_buffered))
        self.dropped = 0  # events lost to overflow or failed flushes
        self.attempt = None if attempt is None else int(attempt)
        self._ring: collections.deque = collections.deque(
            maxlen=max(0, int(flight_ring)))
        self._lock = threading.Lock()
        # Held from taking a batch until it is on disk: one drain at a
        # time, so ``flush()`` waits for a batch the flush thread holds
        # and batches reach the file in the order they were taken.
        self._write_lock = threading.Lock()
        self._closed = False
        self._flush_interval = flush_interval
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._flush_loop, daemon=True,
                                        name="tpuflow-torch-obs-flush")
        self._thread.start()

    # ------------------------------------------------------------ record
    def record(self, kind: str, name: str, *, ts: float | None = None,
               **attrs) -> None:
        ev = {"kind": kind, "name": name,
              "ts": time.time() if ts is None else ts,
              "proc": self.proc, "pid": os.getpid(), **attrs}
        if self.attempt is not None:
            ev.setdefault("launch", self.attempt)
        with self._lock:
            if self._closed:
                return
            # The ring sees every event, the ones the buffer drops too.
            self._ring.append(ev)
            if len(self._buf) >= self._max_buffered:
                self.dropped += 1
                return
            self._buf.append(ev)

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def _ring_snapshot(self, timeout: float = 0.25
                       ) -> tuple[list[dict], bool]:
        """A copy of the flight ring, safe in a signal handler: the lock
        with a timeout (the interrupted frame may hold it), else a
        lockless copy. Returns ``(events, lock_was_free)``; without the
        lock a caller must not touch the locked API."""
        got = self._lock.acquire(timeout=timeout)
        try:
            try:
                return list(self._ring), got
            except RuntimeError:  # mutated during the lockless copy
                return [], got
        finally:
            if got:
                self._lock.release()

    # ------------------------------------------------------------- flush
    def _drain(self) -> None:
        """Write every buffered event. Returns once each batch taken
        before the call is on disk, the flush thread's included."""
        with self._write_lock:
            with self._lock:
                buf, self._buf = self._buf, []
            if not buf:
                return
            lines = "".join(json.dumps(ev, default=_jsonable) + "\n"
                            for ev in buf)
            try:
                with open(self.path, "a") as f:
                    f.write(lines)
            except OSError:
                # Telemetry never fails the run; the batch is counted lost.
                with self._lock:
                    self.dropped += len(buf)

    def _flush_loop(self) -> None:
        while not self._closed:
            self._wake.wait(self._flush_interval)
            self._wake.clear()
            self._drain()

    def flush(self) -> None:
        self._drain()

    def close(self) -> None:
        if self._closed:  # idempotent (configure() then atexit)
            return
        self._closed = True
        self._wake.set()
        self._drain()
        if self.dropped:
            # Written directly (the buffer is closed), best-effort.
            with self._write_lock:
                try:
                    with open(self.path, "a") as f:
                        f.write(json.dumps({
                            "kind": "event", "name": "obs.dropped",
                            "ts": time.time(), "proc": self.proc,
                            "pid": os.getpid(),
                            "value": self.dropped}) + "\n")
                except OSError:
                    pass
        self._thread.join(timeout=2)


def _jsonable(v: Any):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


# ----------------------------------------------------------- module API
def configure(directory: str | None, *, proc: int = 0,
              attempt: int | None = None) -> Recorder | None:
    """(Re)point the process recorder at ``directory`` as slot ``proc``
    of launch ``attempt``; ``None`` closes it and disables recording."""
    global _ENABLED, _RECORDER
    with _LOCK:
        if _RECORDER is not None:
            _RECORDER.close()
            _RECORDER = None
        _ENABLED = False
        if directory is None:
            return None
        _RECORDER = Recorder(directory, proc=proc, attempt=attempt)
        _ENABLED = True
        return _RECORDER


def enabled() -> bool:
    return _ENABLED


def recorder() -> Recorder | None:
    return _RECORDER if _ENABLED else None


def span(name: str, **attrs):
    """Timed region context manager; a shared no-op when disabled."""
    if not _ENABLED:
        return _NOOP_SPAN
    return _RECORDER.span(name, **attrs)


def counter(name: str, value: float = 1, **attrs) -> None:
    if _ENABLED:
        _RECORDER.record("counter", name, value=value, **attrs)


def gauge(name: str, value: float, **attrs) -> None:
    if _ENABLED:
        _RECORDER.record("gauge", name, value=value, **attrs)


def histogram(name: str, value: float, **attrs) -> None:
    if _ENABLED:
        _RECORDER.record("histogram", name, value=value, **attrs)


def event(name: str, **attrs) -> None:
    if _ENABLED:
        _RECORDER.record("event", name, **attrs)


def flush() -> None:
    if _RECORDER is not None:
        _RECORDER.flush()


def timed_iter(iterable, name: str):
    """Yield from ``iterable``, recording the consumer's wait for each
    item as a ``histogram`` observation of ``name``; disabled, the
    iterable itself (no wrapper frame)."""
    if not _ENABLED:
        return iterable

    def _gen():
        it = iter(iterable)
        while True:
            t0 = time.monotonic()
            try:
                item = next(it)
            except StopIteration:
                return
            histogram(name, time.monotonic() - t0)
            yield item

    return _gen()


@atexit.register
def _atexit_close() -> None:
    if _RECORDER is not None:
        try:
            _RECORDER.close()
        except Exception:
            pass
