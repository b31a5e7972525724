"""tpuflow_torch.obs — dependency-free telemetry (counterpart of
``tpuflow/obs``, its recorder core): spans, counters, gauges, histograms
and events recorded as structured JSONL under a run's ``obs/``
directory, the flight recorder's ring dumped on fatal paths, the
per-process files merged into one run timeline, the training-health
layer (``obs/health.py``: the monitor, rollback targets, the profile
window, ``health_summary``), and the serving observatory: the engine-time
ledger and access log (``obs/serve_ledger.py``), the fleet observatory
(``obs/fleet.py``), the live goodput ledger (``obs/goodput.py``,
``goodput_live()``) and its ``/metrics`` + ``/status`` export
(``obs/export.py``, ``start_export``); the run observatory: the goodput
ledger of a run's stream (``compute_goodput``) and its summary
(``summarize``, ``obs/timeline.py``); and the device observatory: the
card's memory gauges and the program ledger (``obs/device.py``:
``hbm_snapshot``, ``maybe_emit_hbm``, ``ProgramLedger``,
``device_summary``) and the anomaly-triggered ``torch.profiler``
captures (``obs/profcap.py``: ``AnomalyCapturer``, ``CaptureConfig``);
and the decision observatory: the run registry and its regression verdicts
(``obs/registry.py``: ``append_record``, ``maybe_append_live``,
``trend_rows``, ``compare_rows``), the declarative alert engine behind
``/alerts`` (``obs/alerts.py``: ``AlertEngine``, ``ALERT_RULES``), the
operator CLI (``python -m tpuflow_torch.obs``) and the live watch
(``python -m tpuflow_torch.obs.watch``).

Usage (emitters)::

    from tpuflow_torch import obs

    with obs.span("ckpt.upload", step=3) as sp:
        ...
        sp.set(bytes=nbytes)
    obs.event("ckpt.restore_tier", step=3, tier="local")

Every emitted name is registered in ``obs.catalog``. Disabled (nothing
configured: ``configure(None)``) every call is one boolean check.
"""

from tpuflow_torch.obs.catalog import CATALOG, is_registered, kind_of
from tpuflow_torch.obs.flight import dump_flight, flight_path
from tpuflow_torch.obs.recorder import (
    Recorder,
    configure,
    counter,
    enabled,
    event,
    flush,
    gauge,
    histogram,
    recorder,
    span,
    timed_iter,
)
from tpuflow_torch.obs.timeline import (
    load_run_events,
    merge_run_events,
    read_events,
    summarize,
)

# Last: these layers emit through the functions bound above.
from tpuflow_torch.obs.health import health_summary  # noqa: E402
from tpuflow_torch.obs.goodput import live as goodput_live  # noqa: E402
from tpuflow_torch.obs.export import start_export  # noqa: E402
from tpuflow_torch.obs.goodput import (  # noqa: E402
    BUCKETS as GOODPUT_BUCKETS,
    ProcessLedger,
    compute_goodput,
)
from tpuflow_torch.obs.device import (  # noqa: E402
    ProgramLedger,
    device_summary,
    hbm_snapshot,
    maybe_emit_hbm,
)
from tpuflow_torch.obs.profcap import (  # noqa: E402
    AnomalyCapturer,
    CaptureConfig,
)
from tpuflow_torch.obs.alerts import (  # noqa: E402
    RULES as ALERT_RULES,
    AlertEngine,
    burn_gate,
    format_transition,
)
from tpuflow_torch.obs.alerts import engine as alert_engine  # noqa: E402
from tpuflow_torch.obs.registry import (  # noqa: E402
    append_record,
    backfill_bench,
    compare_rows,
    make_record,
    maybe_append_live,
    read_registry,
    registry_path,
    trend_rows,
    verdict_rows,
)

__all__ = [
    "ALERT_RULES", "AlertEngine", "AnomalyCapturer", "CATALOG",
    "CaptureConfig", "GOODPUT_BUCKETS", "ProcessLedger", "ProgramLedger",
    "Recorder", "alert_engine", "append_record", "backfill_bench",
    "burn_gate", "compare_rows", "compute_goodput", "configure", "counter",
    "device_summary", "dump_flight", "enabled", "event", "flight_path",
    "flush", "format_transition", "gauge", "goodput_live", "hbm_snapshot",
    "histogram", "is_registered", "health_summary", "kind_of",
    "load_run_events", "make_record", "maybe_append_live",
    "maybe_emit_hbm", "merge_run_events", "read_events", "read_registry",
    "recorder", "registry_path", "span", "start_export", "summarize",
    "timed_iter", "trend_rows", "verdict_rows",
]
