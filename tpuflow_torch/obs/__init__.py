"""tpuflow_torch.obs — dependency-free telemetry (counterpart of
``tpuflow/obs``, its recorder core): spans, counters, gauges, histograms
and events recorded as structured JSONL under a run's ``obs/``
directory, the flight recorder's ring dumped on fatal paths, the
per-process files merged into one run timeline, and the training-health
layer (``obs/health.py``: the monitor, rollback targets, the profile
window, ``health_summary``).

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
)

# Last: the health layer emits through the functions bound above.
from tpuflow_torch.obs.health import health_summary  # noqa: E402

__all__ = [
    "CATALOG", "Recorder", "configure", "counter", "dump_flight", "enabled",
    "event", "flight_path", "flush", "gauge", "histogram", "is_registered",
    "health_summary", "kind_of", "load_run_events", "merge_run_events",
    "read_events", "recorder", "span", "timed_iter",
]
