"""HTTP faces of the front door (counterpart of
``tpuflow/infer/frontdoor.py``): two small servers and the forwarder that
connects them.

- ``ReplicaGateway`` runs BESIDE a ``ServeEngine`` in each replica
  process: ``POST /generate`` submits into the engine's continuous-
  batching queue (under the step loop's lock) and holds the connection
  until the request finishes. It is idempotent by request id: a duplicate
  of an in-flight id attaches to the existing handle instead of
  submitting twice, and a duplicate of a finished id replays the cached
  answer, which makes a router's re-dispatch safe when a retry races a
  slow original. A draining, drained or killed replica answers 503 with a
  reason a router treats as "go elsewhere". ``{"phase": "prefill"}`` is
  the disaggregated ship hop: the replica prefills, commits the KV pages
  to its store and answers the key (``ServeEngine.ship``). With ``trace``
  on (the JAX default), a ``traceparent`` header rebuilds the request's
  trace context (``obs/trace.py``): the gateway records ``gateway.hold``
  (and ``gateway.attach`` on a deduplicated re-dispatch) and hands the
  context to ``submit``, whose engine flushes the request's lifecycle
  spans when it ends.
- ``FrontDoor`` is the client-facing ingress: ``POST /generate`` runs
  ``Router.route`` (admission, pick, forward, bounded retry) and maps its
  outcomes onto HTTP: 200 with the replica's answer, 503 on ``FleetBusy``
  (queue timeout, retries exhausted), 400 on a malformed request, a JSON
  500 on anything else. It mints the trace context at ingress. ``GET
  /status`` serves the ``router_*`` stats, ``GET /healthz`` 200 while up.
  ``main`` (``python -m tpuflow_torch.infer.frontdoor <target>``) runs it
  over a polled fleet.
- ``http_forward`` is a router's forward function: one POST to a replica
  row's ``generate_url`` with a hard timeout, raising on anything but a
  200.

Stdlib ``http.server`` and ``urllib`` only. The JAX package reads
``TPUFLOW_ROUTER_HOST`` / ``_PORT`` / ``_TARGET`` and ``TPUFLOW_TRACE*``;
here they are arguments (README, "The fleet front on the port").
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib import error as urlerror
from urllib import request as urlrequest

import numpy as np

from tpuflow_torch.infer.router import FleetBusy, Router
from tpuflow_torch.obs import trace as _reqtrace

_RESULT_CACHE_MAX = 2048


def _read_json(handler: BaseHTTPRequestHandler) -> dict | None:
    try:
        n = int(handler.headers.get("Content-Length") or 0)
        body = handler.rfile.read(n) if n > 0 else b""
        obj = json.loads(body.decode("utf-8") or "{}")
        return obj if isinstance(obj, dict) else None
    except (ValueError, OSError):
        return None


def _send_json(
    handler: BaseHTTPRequestHandler, code: int, payload: dict
) -> None:
    body = json.dumps(payload).encode("utf-8")
    try:
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError, OSError):
        pass  # client gave up; the engine-side work is unaffected


class ReplicaGateway:
    """The replica-side /generate endpoint over a live ServeEngine.

    ``lock`` must be the SAME lock the replica's step loop holds while
    stepping: submit and step interleave safely through it. The gateway
    never steps the engine itself; it submits and polls the handle, so a
    stalled step loop shows up to a router as a forward timeout, not a
    crash. ``on_complete`` is called (under the lock) with each finished
    handle. ``draining`` answers new requests 503 "draining"; ``aborted``
    answers every held and new request 503 "killed".

    ``trace`` (the JAX package's ``TPUFLOW_TRACE``, on by default) takes
    the ``traceparent`` header; the spans go to ``trace_dir``
    (``TPUFLOW_TRACE_DIR``), else to ``<recorder dir>/trace``, else they
    are counted dropped, under the writer ``replica_id``
    (``TPUFLOW_FLEET_REPLICA_ID``; None: host-pid).
    """

    def __init__(
        self,
        engine: Any,
        *,
        lock: threading.RLock | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        hold_timeout_s: float = 60.0,
        poll_s: float = 0.005,
        on_complete=None,
        trace: bool = True,
        trace_dir: str | None = None,
        replica_id: str | None = None,
    ):
        self.engine = engine
        self.lock = lock if lock is not None else threading.RLock()
        self.hold_timeout_s = float(hold_timeout_s)
        self.poll_s = float(poll_s)
        self.on_complete = on_complete
        self.trace = bool(trace)
        self.trace_dir = trace_dir
        self.replica_id = replica_id
        self.draining = False
        self.aborted = False
        self._handles: dict[str, Any] = {}
        self._results: OrderedDict[str, dict] = OrderedDict()
        gateway = self

        class _Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (http.server API)
                if self.path != "/generate":
                    _send_json(self, 404, {"error": "not found"})
                    return
                body = _read_json(self)
                if body is None:
                    _send_json(self, 400, {"error": "bad json"})
                    return
                try:
                    code, payload = gateway.handle_generate(
                        body,
                        traceparent=self.headers.get("traceparent"),
                    )
                except Exception as e:  # noqa: BLE001 — a raised
                    # forward is "try another replica" to a router; an
                    # explicit 500 beats a severed connection.
                    code, payload = 500, {
                        "error": f"{type(e).__name__}: {e}"
                    }
                _send_json(self, code, payload)

            def log_message(self, *args):  # silence request spam
                pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="tpuflow-replica-gateway",
            daemon=True,
        )
        self._thread.start()
        h, p = self._server.server_address[:2]
        self.url = f"http://{h}:{p}/generate"

    # ------------------------------------------------------- handling
    def handle_generate(
        self, body: dict, traceparent: str | None = None
    ) -> tuple[int, dict]:
        """One /generate request -> (HTTP code, payload): the replica hop
        of the end-to-end trace. The context rebuilt from ``traceparent``
        records the gateway hold (and escalates a non-200 outcome) as a
        span parented to the forward attempt that carried the request,
        flushed to this replica's trace JSONL. An untraced request skips
        all of it on one ``is not None`` check."""
        rid = str(body.get("id") or "")
        ctx = _reqtrace.from_traceparent(
            traceparent, rid, armed=self.trace, directory=self.trace_dir,
            writer=self.replica_id,
        )
        t0 = time.time()
        code, payload = self._handle_generate(body, rid, ctx)
        if ctx is not None:
            if code != 200:
                # Tail sampling: killed / draining / hold-timeout /
                # malformed outcomes always record.
                ctx.escalate("error")
            ctx.add_span(
                "gateway.hold",
                ts=t0,
                dur_s=time.time() - t0,
                parent=ctx.root_id,
                status=code,
            )
            _reqtrace.flush(ctx)
        return code, payload

    def _remember(self, rid: str, payload: dict) -> None:
        self._results[rid] = payload
        while len(self._results) > _RESULT_CACHE_MAX:
            self._results.popitem(last=False)

    def _handle_generate(
        self, body: dict, rid: str, ctx: Any = None
    ) -> tuple[int, dict]:
        prompt = body.get("prompt")
        if not rid or not isinstance(prompt, list) or not prompt:
            return 400, {"error": "need id and non-empty prompt"}
        if body.get("phase") == "prefill":
            return self._handle_prefill(body, rid, prompt)
        with self.lock:
            done = self._results.get(rid)
            if done is not None:
                return 200, dict(done)  # idempotent replay
            handle = self._handles.get(rid)
            if handle is not None and ctx is not None:
                # Dedupe-attach: a router re-dispatch raced the slow
                # original; the span marks which attempt attached.
                ctx.add_span(
                    "gateway.attach",
                    ts=time.time(),
                    parent=ctx.root_id,
                    attached=True,
                )
            if handle is None:
                if self.aborted:
                    return 503, {"error": "killed"}
                if self.draining:
                    return 503, {"error": "draining"}
                eos = body.get("eos_id")
                # trace= rides only for traced requests and kv_key only
                # when a router shipped a prefill: engines without the
                # keywords serve plain forwards.
                kw = {} if ctx is None else {"trace": ctx}
                if body.get("kv_key"):
                    kw["kv_key"] = str(body["kv_key"])
                try:
                    handle = self.engine.submit(
                        np.asarray(prompt, np.int32),
                        max_new_tokens=int(
                            body.get("max_new_tokens") or 1
                        ),
                        eos_id=None if eos is None else int(eos),
                        **kw,
                    )
                except (TypeError, ValueError) as e:
                    # TypeError covers non-castable fields (a list
                    # max_new_tokens): still the client's fault, 400.
                    return 400, {"error": str(e)}
                self._handles[rid] = handle
        deadline = time.monotonic() + self.hold_timeout_s
        while True:
            with self.lock:
                if self.aborted:
                    self._handles.pop(rid, None)
                    return 503, {"error": "killed"}
                if handle.state == "done":
                    payload = {
                        "id": rid,
                        "tokens": [int(t) for t in handle.tokens],
                        "finish_reason": handle.finish_reason,
                    }
                    if self.on_complete is not None:
                        try:
                            self.on_complete(handle)
                        except Exception:  # noqa: BLE001 — obs only
                            pass
                    self._handles.pop(rid, None)
                    self._remember(rid, payload)
                    return 200, dict(payload)
                if getattr(handle, "drained", False):
                    # SIGTERM landed before this request started: a
                    # router re-dispatches it to a live replica.
                    self._handles.pop(rid, None)
                    return 503, {"error": "drained"}
            if time.monotonic() >= deadline:
                return 503, {"error": "hold timeout"}
            time.sleep(self.poll_s)

    def _handle_prefill(
        self, body: dict, rid: str, prompt: list
    ) -> tuple[int, dict]:
        """The disaggregated ship hop: prefill on THIS replica, commit the
        KV pages to its store, answer the key. Any failure (no store, a
        commit error) is an explicit 503: a router then counts a
        ship-fallback and the decode replica prefills locally, so the
        client's answer never depends on this hop."""
        with self.lock:
            done = self._results.get(rid)
            if done is not None:
                return 200, dict(done)  # idempotent replay
            if self.aborted:
                return 503, {"error": "killed"}
            if self.draining:
                return 503, {"error": "draining"}
            ship = getattr(self.engine, "ship", None)
            if ship is None:
                return 503, {"error": "replica cannot ship"}
            try:
                key = ship(
                    np.asarray(prompt, np.int32),
                    quantize=bool(body.get("quantize")),
                )
            except (TypeError, ValueError) as e:
                return 400, {"error": str(e)}
            except Exception as e:  # noqa: BLE001 — ship is optional;
                # "try another path" beats a severed connection.
                return 503, {"error": f"{type(e).__name__}: {e}"}
            payload = {"id": rid, "kv_key": str(key)}
            self._remember(rid, payload)
            return 200, dict(payload)

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


def http_forward(row: dict, request: dict, timeout_s: float) -> dict:
    """One forward attempt to a replica row's ``generate_url``.

    Raises on ANY failure (no URL in the row, connection refused, timeout,
    non-200, undecodable body): a router's retry loop treats "raise" as
    "try another replica". A 200 body is the client's response, verbatim.
    The in-process trace context (``_trace_ctx``, set by the front door)
    never rides the wire: it travels as a W3C ``traceparent`` header,
    whose span id the router set to THIS forward attempt's span.
    """
    url = row.get("generate_url")
    if not url:
        raise RuntimeError(
            f"replica {row.get('id')!r} exports no generate_url"
        )
    ctx = request.get("_trace_ctx")
    headers = {"Content-Type": "application/json"}
    if ctx is None:
        payload = request
    else:
        payload = {k: v for k, v in request.items() if k != "_trace_ctx"}
        headers["traceparent"] = ctx.to_traceparent()
    data = json.dumps(payload).encode("utf-8")
    req = urlrequest.Request(url, data=data, headers=headers, method="POST")
    try:
        with urlrequest.urlopen(req, timeout=timeout_s) as resp:
            body = resp.read()
    except urlerror.HTTPError as e:
        detail = ""
        try:
            detail = e.read().decode("utf-8", "replace")[:200]
        except OSError:
            pass
        raise RuntimeError(
            f"replica {row.get('id')!r} answered {e.code}: {detail}"
        ) from e
    out = json.loads(body.decode("utf-8"))
    if not isinstance(out, dict):
        raise RuntimeError("replica answered a non-object body")
    return out


class FrontDoor:
    """Client-facing ingress: POST /generate → ``Router.route``, with the
    router's explicit outcomes mapped onto HTTP codes. GET /status serves
    the ``router_*`` stats; GET /healthz answers 200 while up.

    ``host`` / ``port`` are the JAX package's ``TPUFLOW_ROUTER_HOST`` /
    ``_PORT`` (0: an ephemeral port); ``trace``, ``trace_sample`` and
    ``trace_dir`` its ``TPUFLOW_TRACE``, ``_SAMPLE`` and ``_DIR``: the door
    mints each request's context at ingress and writes its spans as the
    writer ``frontdoor``."""

    def __init__(
        self,
        router: Router,
        *,
        host: str = "127.0.0.1",
        port: int = 8900,
        trace: bool = True,
        trace_sample: float = 1.0,
        trace_dir: str | None = None,
    ):
        self.router = router
        door = self

        class _Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (http.server API)
                if self.path != "/generate":
                    _send_json(self, 404, {"error": "not found"})
                    return
                body = _read_json(self)
                if body is None:
                    _send_json(self, 400, {"error": "bad json"})
                    return
                # The context rides the body in-process (the forwarder
                # strips it and speaks traceparent on the wire); the
                # ingress span is the client-observed wall the critical
                # path reconciles against.
                ctx = _reqtrace.maybe_mint(
                    body.get("id"), armed=trace, sample=trace_sample,
                    directory=trace_dir, writer="frontdoor",
                )
                if ctx is not None:
                    body["_trace_ctx"] = ctx
                t0 = time.time()
                try:
                    code, out = 200, door.router.route(body)
                except FleetBusy as e:
                    code, out = 503, {"error": str(e)}
                except (TypeError, ValueError) as e:
                    if ctx is not None:
                        ctx.escalate("error")
                    code, out = 400, {"error": str(e)}
                except Exception as e:  # noqa: BLE001 — every request
                    # ends answered or told: an unexpected failure is a
                    # JSON 500, never a severed connection.
                    if ctx is not None:
                        ctx.escalate("error")
                    code, out = 500, {
                        "error": f"{type(e).__name__}: {e}"
                    }
                if ctx is not None:
                    ctx.add_span(
                        "router.ingress",
                        span_id=ctx.root_id,
                        ts=t0,
                        dur_s=time.time() - t0,
                        status=code,
                    )
                    _reqtrace.flush(ctx)
                _send_json(self, code, out)

            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/status":
                    _send_json(self, 200, door.router.stats())
                elif self.path == "/healthz":
                    _send_json(self, 200, {"ok": True})
                else:
                    _send_json(self, 404, {"error": "not found"})

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="tpuflow-frontdoor",
            daemon=True,
        )
        self._thread.start()
        h, p = self._server.server_address[:2]
        self.url = f"http://{h}:{p}"

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


def main(argv: list[str] | None = None) -> int:
    """``python -m tpuflow_torch.infer.frontdoor <target>``: the fleet's
    ingress. Discover the replicas of ``target`` (a registration
    directory or a comma list of ``/status`` URLs), poll them on a
    background thread (``FleetPoller``: the router only reads its cached
    snapshot, so a slow ``/status`` never stalls routing), and serve
    ``/generate`` until SIGINT or SIGTERM."""
    import argparse
    import signal

    from tpuflow_torch.obs import fleet as _fleet

    ap = argparse.ArgumentParser(
        prog="python -m tpuflow_torch.infer.frontdoor")
    ap.add_argument("target", help="registration directory or comma list "
                    "of replica /status URLs")
    ap.add_argument("--poll-s", type=float, default=5.0,
                    help="seconds between fleet /status sweeps")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8900,
                    help="bind port (0: an ephemeral one)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--ship-min-tokens", type=int, default=0,
                    help="prompts this long take a prefill-replica hop "
                    "(0: off)")
    ap.add_argument("--trace-dir", default=None,
                    help="span directory (default: the recorder's, else "
                    "the spans are counted dropped)")
    args = ap.parse_args(argv)
    observatory = _fleet.FleetObservatory(args.target,
                                          poll_interval_s=args.poll_s)
    poller = _fleet.FleetPoller(observatory)
    router = Router(poller.snapshot, http_forward, page_size=args.page_size,
                    ship_min_tokens=args.ship_min_tokens)
    door = FrontDoor(router, host=args.host, port=args.port,
                     trace_dir=args.trace_dir)
    print(f"[frontdoor] serving {door.url}/generate", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # not the main thread
    try:
        while not stop.is_set():
            router.refresh()
            stop.wait(0.5)
    finally:
        door.close()
        poller.close()
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
