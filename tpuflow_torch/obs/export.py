"""Live export: ``/metrics`` (Prometheus) and ``/status`` (JSON) mid-run
(counterpart of ``tpuflow/obs/export.py``).

One daemon-threaded HTTP server serves the process's live goodput ledger
(``obs/goodput.py::live()``): step and token rates, rolling MFU, goodput
so far and, on a serving replica, the engine's ``serve_*`` view, whose
keys a fleet observatory of either package reads. ``/status`` adds the
process id and the replica identity. ``/alerts`` answers 404: the alert
engine comes with ROADMAP item 15 (the JAX server does the same without
one).

The JAX package starts the server from ``TPUFLOW_OBS_HTTP_PORT`` and
``TPUFLOW_OBS_HTTP_HOST`` and registers the replica in
``TPUFLOW_FLEET_REGISTRATION_DIR``; here :func:`start_export` takes the
port, host and registration directory as arguments (``serve_forever``
passes its own). Idempotent per process, member 0 only; a bind failure
prints and disables export, never the run.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpuflow_torch.obs import fleet as _fleet
from tpuflow_torch.obs import goodput as _goodput

# The recorder submodule, not the package's ``recorder()`` accessor that
# shadows it once ``tpuflow_torch.obs`` is initialised.
_rec = importlib.import_module("tpuflow_torch.obs.recorder")

_SERVER: "MetricsServer | None" = None

# (prometheus metric, snapshot key, prometheus type) — one stable,
# documented mapping so dashboards don't chase snapshot-dict drift.
_PROM_SPEC = (
    ("tpuflow_uptime_seconds", "uptime_s", "gauge"),
    ("tpuflow_steps_total", "steps", "counter"),
    ("tpuflow_reports_total", "reports", "counter"),
    ("tpuflow_step", "step", "gauge"),
    ("tpuflow_tokens_total", "tokens", "counter"),
    ("tpuflow_step_rate", "step_rate", "gauge"),
    ("tpuflow_tokens_per_s", "tokens_per_s", "gauge"),
    ("tpuflow_mfu", "mfu", "gauge"),
    ("tpuflow_goodput_fraction", "goodput_fraction", "gauge"),
    ("tpuflow_productive_seconds_total", "productive_s", "counter"),
    ("tpuflow_compile_seconds_total", "compile_s", "counter"),
    ("tpuflow_loss", "loss", "gauge"),
    ("tpuflow_grad_norm", "grad_norm", "gauge"),
    ("tpuflow_nonfinite_steps_total", "nonfinite_steps", "counter"),
    # Device observatory: memory residency of the busiest local
    # device (limit = the tightest device's); keys only present when
    # the device reports memory stats, never zeroed.
    ("tpuflow_hbm_used_bytes", "hbm_used_bytes", "gauge"),
    ("tpuflow_hbm_peak_bytes", "hbm_peak_bytes", "gauge"),
    ("tpuflow_hbm_limit_bytes", "hbm_limit_bytes", "gauge"),
    ("tpuflow_hbm_used_frac", "hbm_used_frac", "gauge"),
    ("tpuflow_hbm_peak_frac", "hbm_peak_frac", "gauge"),
    # Serving engine (infer/serve.py): keys only present when an
    # engine feeds this process's ledger, omitted on training runs.
    ("tpuflow_serve_requests_total", "serve_requests", "counter"),
    ("tpuflow_serve_tokens_total", "serve_tokens", "counter"),
    ("tpuflow_serve_queue_depth", "serve_queue_depth", "gauge"),
    ("tpuflow_serve_slot_occupancy", "serve_slot_occupancy", "gauge"),
    ("tpuflow_serve_tokens_per_s", "serve_tokens_per_s", "gauge"),
    ("tpuflow_serve_ttft_p50_seconds", "serve_ttft_p50_s", "gauge"),
    ("tpuflow_serve_ttft_p99_seconds", "serve_ttft_p99_s", "gauge"),
    # Paged KV: pool headroom, shared-prefix reuse, and
    # per-request speculative acceptance; keys only present on paged /
    # spec-armed engines.
    ("tpuflow_serve_pages_free", "serve_pages_free", "gauge"),
    ("tpuflow_serve_prefix_hit_rate", "serve_prefix_hit_rate", "gauge"),
    ("tpuflow_serve_spec_accept_rate", "serve_spec_accept_rate", "gauge"),
    # Tiered prefix cache: pages parked in the host-DRAM /
    # node-local-disk tiers; keys only present when a tier is armed
    # (the engine's kv_host_mb / kv_disk_dir).
    ("tpuflow_serve_pages_host", "serve_pages_host", "gauge"),
    ("tpuflow_serve_pages_disk", "serve_pages_disk", "gauge"),
    # Serving observatory: engine-time ledger fractions, ITL
    # percentiles, and declared-SLO accounting; keys only present while
    # an engine feeds this process's ledger.
    ("tpuflow_serve_ttft_p95_seconds", "serve_ttft_p95_s", "gauge"),
    ("tpuflow_serve_itl_p50_seconds", "serve_itl_p50_s", "gauge"),
    ("tpuflow_serve_itl_p95_seconds", "serve_itl_p95_s", "gauge"),
    ("tpuflow_serve_itl_p99_seconds", "serve_itl_p99_s", "gauge"),
    ("tpuflow_serve_idle_fraction", "serve_idle_fraction", "gauge"),
    ("tpuflow_serve_decode_fraction", "serve_decode_fraction", "gauge"),
    ("tpuflow_serve_prefill_fraction", "serve_prefill_fraction", "gauge"),
    ("tpuflow_serve_decode_utilization", "serve_decode_utilization",
     "gauge"),
    ("tpuflow_serve_masked_row_waste", "serve_masked_row_waste", "gauge"),
    ("tpuflow_serve_slo_violations_total", "serve_slo_violations",
     "counter"),
)


# Cumulative TTFT/ITL histograms: Prometheus histogram
# convention — per-bucket counts cumulated into le-labeled counts plus
# _sum/_count. Unlike the pre-aggregated percentile GAUGES above (which
# stay, for single-replica dashboards), bucket counts MERGE across
# replicas by summation, which is what makes fleet-exact percentiles
# possible (obs/fleet.py merges them; the fleet p99 from summed
# buckets is bit-equal to bucketing the pooled raw observations).
_PROM_HISTS = (
    ("tpuflow_serve_ttft_seconds", "serve_ttft_hist"),
    ("tpuflow_serve_itl_seconds", "serve_itl_hist"),
)


def prometheus_text(snapshot: dict) -> str:
    """Render a ledger snapshot as Prometheus text exposition (0.0.4).
    Keys absent from the snapshot (MFU off the card, rates before the second
    fence) are omitted rather than invented."""
    lines = []
    for metric, key, ptype in _PROM_SPEC:
        v = snapshot.get(key)
        if not isinstance(v, (int, float)):
            continue
        lines.append(f"# TYPE {metric} {ptype}")
        lines.append(f"{metric} {float(v):.10g}")
    for metric, key in _PROM_HISTS:
        h = snapshot.get(key)
        if not isinstance(h, dict) or not h.get("count"):
            continue
        try:
            edges = list(h["edges"])
            counts = [int(c) for c in h["counts"]]
        except (TypeError, KeyError, ValueError):
            continue
        if len(counts) != len(edges) + 1:
            continue
        lines.append(f"# TYPE {metric} histogram")
        acc = 0
        for edge, c in zip(edges, counts):
            acc += c
            lines.append(f'{metric}_bucket{{le="{float(edge):.10g}"}} {acc}')
        acc += counts[-1]
        lines.append(f'{metric}_bucket{{le="+Inf"}} {acc}')
        lines.append(f"{metric}_sum {float(h.get('sum', 0.0)):.10g}")
        lines.append(f"{metric}_count {int(h['count'])}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def _snapshot(self) -> dict:
        """This server's snapshot source: the per-server override when
        set (tests run several in-process replicas, each over its own
        ledger), else the process's live goodput ledger."""
        fn = getattr(self.server, "_tpuflow_snapshot", None)
        return fn() if fn is not None else _goodput.live().snapshot()

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            route = self.path.split("?", 1)[0]
            if route == "/metrics":
                body = prometheus_text(self._snapshot()).encode()
                ctype = "text/plain; version=0.0.4"
            elif route in ("/status", "/"):
                snap = self._snapshot()
                snap["pid"] = os.getpid()
                # Replica identity: fleet aggregation needs to know WHO
                # answered (replica id, launch attempt, elastic mesh
                # generation when known).
                snap.setdefault(
                    "replica",
                    _fleet.replica_identity(self.server._tpuflow_replica_id),
                )
                body = (json.dumps(snap) + "\n").encode()
                ctype = "application/json"
            else:
                # /alerts included: no alert engine is ported yet.
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-response

    def log_message(self, fmt, *args):
        pass  # scrapes must not spam the member's step log


class MetricsServer:
    """One daemon-threaded HTTP server over the live ledger (or, with
    ``snapshot_fn``, over any snapshot source: the fleet tests run several
    in-process replicas this way). ``replica_id`` names the replica in
    ``/status`` (None: host and pid)."""

    def __init__(
        self, port: int = 0, host: str = "127.0.0.1", snapshot_fn=None,
        replica_id: str | None = None,
    ):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd._tpuflow_snapshot = snapshot_fn
        self._httpd._tpuflow_replica_id = replica_id
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            daemon=True,
            name="tpuflow-obs-export",
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=2)


def start_export(
    port: int,
    *,
    host: str = "127.0.0.1",
    registration_dir: str | None = None,
    proc: int = 0,
    replica_id: str | None = None,
) -> MetricsServer | None:
    """Start the export server on ``host``:``port`` (0: an ephemeral port,
    printed and recorded as an ``obs.export`` event) when this process is
    gang member 0 (``proc``). Idempotent per process: the first caller
    wins, later calls return the same server. A bind failure disables
    export with a printed warning, never the run; a ``port`` that is not
    an int >= 0 raises ``ValueError``. Once ``/status``
    answers, the replica registers in ``registration_dir`` (when given)
    under ``replica_id`` (None: host and pid) so a fleet observatory
    discovers it; a wildcard bind advertises the host's name."""
    global _SERVER
    if isinstance(port, bool) or not isinstance(port, int) or port < 0:
        raise ValueError(f"export port must be an int >= 0, got {port!r}")
    if _SERVER is not None:
        return _SERVER
    if int(proc) != 0:
        return None  # one endpoint per gang: member 0 owns it
    try:
        _SERVER = MetricsServer(port, host=host, replica_id=replica_id)
    except OSError as e:
        print(
            f"[tpuflow] obs export failed to bind {host}:{port} "
            f"({e}); live export disabled"
        )
        return None
    _rec.event("obs.export", port=_SERVER.port)
    reg_url = _SERVER.url
    if host == "0.0.0.0":  # noqa: S104 (the caller opted in)
        reg_url = f"http://{socket.gethostname()}:{_SERVER.port}"
    _fleet.maybe_register(reg_url, registration_dir, replica_id=replica_id)
    print(
        f"[tpuflow] obs export serving /metrics + /status on {_SERVER.url}"
    )
    return _SERVER


def stop() -> None:
    """Tear the process's export server down (tests; the daemon thread
    otherwise dies with the process)."""
    global _SERVER
    if _SERVER is not None:
        _SERVER.close()
        _SERVER = None
