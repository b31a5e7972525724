"""The replica half of the front door: the ``/generate`` gateway beside a
serving engine and the forwarder that posts to it (counterpart of the
replica half of ``tpuflow/infer/frontdoor.py``).

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
  to its store and answers the key (``ServeEngine.ship``).
- ``http_forward`` is a router's forward function: one POST to a replica
  row's ``generate_url`` with a hard timeout, raising on anything but a
  200.

The client-facing ``FrontDoor``, its ``main`` and the ``Router`` come with
ROADMAP item 13c-2, and so does request tracing: the gateway accepts a
``traceparent`` header and ignores it, as the JAX gateway does with its
tracing off (its default). Stdlib ``http.server`` and ``urllib`` only.
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
    ):
        self.engine = engine
        self.lock = lock if lock is not None else threading.RLock()
        self.hold_timeout_s = float(hold_timeout_s)
        self.poll_s = float(poll_s)
        self.on_complete = on_complete
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
        """One /generate request -> (HTTP code, payload). ``traceparent``
        is accepted and ignored until request tracing is ported."""
        rid = str(body.get("id") or "")
        return self._handle_generate(body, rid)

    def _remember(self, rid: str, payload: dict) -> None:
        self._results[rid] = payload
        while len(self._results) > _RESULT_CACHE_MAX:
            self._results.popitem(last=False)

    def _handle_generate(self, body: dict, rid: str) -> tuple[int, dict]:
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
            if handle is None:
                if self.aborted:
                    return 503, {"error": "killed"}
                if self.draining:
                    return 503, {"error": "draining"}
                eos = body.get("eos_id")
                # kv_key rides only when a router shipped a prefill:
                # engines without the keyword serve plain forwards.
                kw = {"kv_key": str(body["kv_key"])} if body.get(
                    "kv_key") else {}
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
    An in-process trace context (``_trace_ctx``, a JAX router's) never
    rides the wire: it travels as a W3C ``traceparent`` header.
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
