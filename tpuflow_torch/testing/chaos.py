"""In-process serving-chaos harness (counterpart of
``tpuflow/testing/chaos.py``).

The proof vehicle for the front-door router's fault-tolerance claims:
several REAL replicas, each a live ``ServeEngine`` with its own
``ReplicaGateway`` (``/generate``), its own ``ProcessLedger`` and its own
``MetricsServer`` (``/status``), run inside one process, discovered
through a real registration directory and polled by a real
``FleetObservatory`` over real HTTP. Chaos comes through the fault
vocabulary (``replica_kill:<id>@<t>`` / ``replica_stall:<id>@<t>`` /
``prefill_kill:<id>@<t>`` in an installed fault plan, read by
``faults.replica_plan()``) or directly through ``LocalReplica.kill()`` /
``.stall()`` / ``.drain()``.

Each replica's state stays private on purpose: the engines would otherwise
all feed the process's live goodput ledger, and the fleet would see one
smeared replica instead of several.

``kill()`` models a dead pod: the step loop stops, every held and new
``/generate`` answers 503 "killed" at once, and both servers close, so the
observatory's next poll fails and the row goes stale. ``stall()`` models a
wedged device: the sockets stay open and accepting, nothing finishes, the
failure only a forward timeout detects. ``drain()`` models SIGTERM:
in-flight work finishes (stepping with ``admit=False``), queued work is
terminal-traced ``drained`` so the gateway answers it 503 and the router
re-dispatches it.

``run_poisson`` is the load side: open-loop Poisson arrivals, one
submitter thread a request, each request ending as exactly one of ok /
rejected (an explicit 503) / error.

A replica steps its engine on a thread of its own: the engine scopes the
per-thread torch state its work needs (``ServeEngine._on_device``), and
nothing here installs a signal handler.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Any, Callable

import numpy as np

from tpuflow_torch.infer.frontdoor import ReplicaGateway
from tpuflow_torch.infer.router import FleetBusy
from tpuflow_torch.obs import fleet as obs_fleet
from tpuflow_torch.obs.export import MetricsServer
from tpuflow_torch.obs.goodput import ProcessLedger


class LocalReplica:
    """One in-process serving replica: engine + gateway + /status.

    The caller builds the engine. ``device_lock`` serialises device work
    across replicas sharing one device (several engines on one card or on
    the CPU); None when each replica owns its device. ``trace`` and
    ``trace_dir`` go to the gateway, whose spans take the replica's id as
    their writer.
    """

    def __init__(
        self,
        replica_id: str,
        engine: Any,
        *,
        registration_dir: str | None = None,
        device_lock: threading.Lock | None = None,
        idle_sleep_s: float = 0.002,
        trace: bool = True,
        trace_dir: str | None = None,
    ):
        self.id = str(replica_id)
        self.engine = engine
        self.lock = threading.RLock()
        self._device_lock = device_lock
        self._idle_sleep_s = float(idle_sleep_s)
        self._ledger = ProcessLedger()
        self._ledger.note_serve_state(0, 0, engine.max_slots)
        # The fleet row carries the replica's role (the router splits ship
        # hops from decode placement on it) and its spill-tier page counts
        # (the warmth tie-break).
        self._ledger.note_serve_role(getattr(engine, "role", "both"))
        if getattr(engine, "pool", None) is not None:
            self._ledger.note_serve_pages(
                engine.pool.free_pages, engine.pool.usable_pages
            )
        self.gateway = ReplicaGateway(
            engine, lock=self.lock, on_complete=self._completed,
            trace=trace, trace_dir=trace_dir, replica_id=self.id,
        )
        self.metrics = MetricsServer(0, snapshot_fn=self._status)
        if registration_dir:
            obs_fleet.register_replica(
                registration_dir,
                self.metrics.url,
                identity={"id": self.id},
            )
        self._stop = threading.Event()
        self._stalled = threading.Event()
        self._draining = False
        self._drained_queue = False
        self._thread = threading.Thread(
            target=self._loop,
            name=f"tpuflow-replica-{self.id}",
            daemon=True,
        )
        self._thread.start()

    # -------------------------------------------------------- plumbing
    def _completed(self, handle: Any) -> None:
        """Feed the private ledger a finished request: its TTFT histogram
        is what makes the fleet's MERGED p99 exist. A recorded trace pins
        its id as the bucket's exemplar, so a fleet p99 exemplar always
        resolves to spans on disk."""
        ctx = getattr(handle, "trace_ctx", None)
        self._ledger.note_serve_ttft(
            getattr(handle, "ttft_s", None),
            trace_id=(
                ctx.trace_id
                if ctx is not None and ctx.recorded
                else None
            ),
        )
        self._ledger.note_serve_complete()

    def _status(self) -> dict:
        return {
            **self._ledger.snapshot(),
            "replica": {"id": self.id},
            "generate_url": self.gateway.url,
        }

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._stalled.is_set():
                time.sleep(self._idle_sleep_s)
                continue
            did = False
            dev = self._device_lock or nullcontext()
            with dev:
                with self.lock:
                    eng = self.engine
                    if eng.queue_depth > 0 or eng.live_slots > 0:
                        did = eng.step(admit=not self._draining)
                    if (
                        self._draining
                        and not self._drained_queue
                        and eng.live_slots == 0
                    ):
                        # SIGTERM path: in-flight work finished; hand
                        # queued work back to the router.
                        eng.drain_queued()
                        self._drained_queue = True
                    self._ledger.note_serve_state(
                        eng.queue_depth, eng.live_slots, eng.max_slots
                    )
                    if getattr(eng, "pool", None) is not None:
                        self._ledger.note_serve_pages(
                            eng.pool.free_pages, eng.pool.usable_pages
                        )
                        tier = getattr(eng.pool, "tier", None)
                        if tier is not None and tier.armed:
                            self._ledger.note_serve_tiers(
                                tier.pages_host,
                                tier.pages_disk,
                                eng.pool.tier_hits,
                            )
            # After a step, yield: a gateway thread waiting on the lock to
            # submit gets it between steps instead of when the loop idles
            # (a lock released and at once re-taken by the same thread
            # starves its waiters).
            time.sleep(0 if did else self._idle_sleep_s)

    # ------------------------------------------------------ chaos verbs
    def kill(self) -> None:
        """Dead pod: stop stepping, fail held and new requests NOW, close
        both servers so the next fleet poll marks the row stale."""
        self._stop.set()
        self.gateway.aborted = True
        self.gateway.close()
        self.metrics.close()

    def stall(self) -> None:
        """Wedged device: sockets stay open, nothing ever finishes."""
        self._stalled.set()

    def unstall(self) -> None:
        self._stalled.clear()

    def drain(self) -> None:
        """SIGTERM: no new admissions (the gateway answers 503
        "draining", the ledger flips ``serve_draining`` so the fleet row
        carries it), in-flight work finishes, queued work re-routes."""
        self._draining = True
        self.gateway.draining = True
        self._ledger.note_serve_draining(True)

    def close(self) -> None:
        """Graceful teardown; safe after ``kill()`` (closing a closed
        server is a no-op)."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        for closer in (self.gateway.close, self.metrics.close):
            try:
                closer()
            except Exception:  # noqa: BLE001 — already-dead servers
                pass


def apply_replica_plan(
    replicas: dict[str, LocalReplica],
    plan: list[tuple[str, str, float]],
    *,
    t0: float | None = None,
) -> threading.Thread:
    """Execute a ``faults.replica_plan()`` schedule against live replicas
    on a timer thread: each ``(kind, id, at_s)`` fires ``kill()`` /
    ``stall()`` at ``t0 + at_s``. Unknown ids are skipped (the plan may
    name replicas another process owns). Returns the (daemon) thread; join
    it to know every fault has fired."""
    start = time.monotonic() if t0 is None else float(t0)

    def _run() -> None:
        for kind, target, at_s in sorted(plan, key=lambda x: x[2]):
            delay = start + at_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            rep = replicas.get(target)
            if rep is None:
                continue
            if kind in ("replica_kill", "prefill_kill"):
                # prefill_kill is a replica_kill aimed at a prefill-role
                # replica: the same dead-pod semantics, its own spec name
                # so one plan can kill the prefill worker mid-ship while
                # the decode replicas ride it out by local prefill.
                rep.kill()
            elif kind == "replica_stall":
                rep.stall()

    th = threading.Thread(
        target=_run, name="tpuflow-chaos-plan", daemon=True
    )
    th.start()
    return th


# ------------------------------------------------------------- load side
def run_poisson(
    submit: Callable[[dict], dict],
    requests: list[dict],
    *,
    rate_qps: float,
    rng: np.random.Generator | None = None,
    jitter: bool = True,
) -> list[dict]:
    """Open-loop Poisson load: request k submits at the k-th arrival time
    whatever became of earlier requests (that is what makes backpressure
    and failover observable). ``submit`` is ``router.route`` or an HTTP
    POST through a FrontDoor.

    Returns one record a request, ``{"request", "response", "error",
    "outcome": "ok"|"rejected"|"error", "latency_s"}``, in input order.
    ``rejected`` is an explicit FleetBusy 503; anything in ``error`` is a
    DROPPED request, which the chaos drives assert never happens."""
    rng = rng if rng is not None else np.random.default_rng(0)
    n = len(requests)
    if rate_qps <= 0:
        raise ValueError("rate_qps must be positive")
    gaps = (
        rng.exponential(1.0 / rate_qps, size=n)
        if jitter
        else np.full(n, 1.0 / rate_qps)
    )
    arrivals = np.cumsum(gaps)
    out: list[dict | None] = [None] * n
    t0 = time.monotonic()

    def _one(k: int, req: dict) -> None:
        delay = t0 + float(arrivals[k]) - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        started = time.monotonic()
        rec: dict[str, Any] = {
            "request": req, "response": None, "error": None,
        }
        try:
            rec["response"] = submit(req)
            rec["outcome"] = "ok"
        except FleetBusy as e:
            rec["error"] = str(e)
            rec["outcome"] = "rejected"
        except Exception as e:  # noqa: BLE001 — accounted, asserted 0
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["outcome"] = "error"
        rec["latency_s"] = time.monotonic() - started
        out[k] = rec

    threads = [
        threading.Thread(
            target=_one, args=(k, r),
            name=f"tpuflow-load-{k}", daemon=True,
        )
        for k, r in enumerate(requests)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return [r for r in out if r is not None]
