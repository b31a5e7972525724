"""Run-level assembly of the per-process event files (counterpart of
``tpuflow/obs/timeline.py``): ``merge_run_events`` unions every
``<run_dir>/obs/events.p*.jsonl`` into one time-ordered
``<run_dir>/events.jsonl``; ``load_run_events`` reads a run's merged
stream; ``summarize(events)`` folds a stream into headline metrics (step
time, tokens/s, checkpoint GB/s, loader wait, goodput, HBM peak) plus
per-name aggregates."""

from __future__ import annotations

import json
import os
from typing import Any, Iterable

MERGED_NAME = "events.jsonl"
OBS_SUBDIR = "obs"


def obs_dir(run_dir: str) -> str:
    return os.path.join(run_dir, OBS_SUBDIR)


def read_events(path: str) -> list[dict]:
    """One JSONL event file, unparsable lines skipped (a killed writer
    may leave a torn tail)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        return []
    return out


def merge_run_events(run_dir: str, *, out_name: str = MERGED_NAME
                     ) -> list[dict]:
    """Merge every per-process event file under ``<run_dir>/obs`` into one
    ``<run_dir>/events.jsonl`` sorted by (``ts``, ``proc``); returns the
    events. Idempotent (the fragments stay; the merge is a view). A run
    with no events writes no file."""
    d = obs_dir(run_dir)
    try:
        names = sorted(n for n in os.listdir(d)
                       if n.startswith("events.p") and n.endswith(".jsonl"))
    except OSError:
        return []
    events: list[dict] = []
    for name in names:
        events.extend(read_events(os.path.join(d, name)))
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("proc", 0)))
    if events:
        out = os.path.join(run_dir, out_name)
        tmp = out + ".tmp"
        try:
            with open(tmp, "w") as f:
                for ev in events:
                    f.write(json.dumps(ev) + "\n")
            os.replace(tmp, out)
        except OSError:
            pass
    return events


def load_run_events(run_dir: str) -> list[dict]:
    """The run's merged event stream: ``events.jsonl`` once the runner
    merged it, else merged now from the per-process files."""
    path = os.path.join(run_dir, MERGED_NAME)
    if os.path.exists(path):
        return read_events(path)
    return merge_run_events(run_dir)


def _pctl(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


def _ratio_gbps(evs: list[dict]) -> float | None:
    b = sum(float(e.get("bytes", 0.0)) for e in evs)
    d = sum(float(e.get("dur_s", 0.0)) for e in evs)
    return b / d / 1e9 if d > 0 and b > 0 else None


def summarize(events: Iterable[dict]) -> dict[str, Any]:
    """Fold an event stream into per-name aggregates + headline metrics::

        {"spans": {name: {count, total_s, mean_s, max_s}},
         "counters": {name: total},
         "gauges": {name: {last, max}},
         "histograms": {name: {count, mean, p50, max, total}},
         "health": {...},     # obs/health.py::health_summary
         "goodput": {...},    # obs/goodput.py::compute_goodput
         "headline": {...}}   # step time, tokens/s, ckpt GB/s, ...
    """
    from tpuflow_torch.obs.goodput import compute_goodput
    from tpuflow_torch.obs.health import health_summary

    events = list(events)
    spans: dict[str, dict] = {}
    counters: dict[str, float] = {}
    gauges: dict[str, dict] = {}
    hists: dict[str, list[float]] = {}
    for ev in events:
        kind, name = ev.get("kind"), ev.get("name")
        if kind == "span":
            s = spans.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            d = float(ev.get("dur_s", 0.0))
            s["count"] += 1
            s["total_s"] += d
            s["max_s"] = max(s["max_s"], d)
        elif kind == "counter":
            counters[name] = counters.get(name, 0.0) + float(
                ev.get("value", 1.0))
        elif kind == "gauge":
            g = gauges.setdefault(name, {"last": 0.0, "max": 0.0})
            v = float(ev.get("value", 0.0))
            g["last"] = v
            g["max"] = max(g["max"], v)
        elif kind == "histogram":
            hists.setdefault(name, []).append(float(ev.get("value", 0.0)))
    for s in spans.values():
        s["mean_s"] = s["total_s"] / max(s["count"], 1)
    hist_out = {}
    for name, vals in hists.items():
        vals.sort()
        hist_out[name] = {
            "count": len(vals),
            "total": sum(vals),
            "mean": sum(vals) / max(len(vals), 1),
            "p50": _pctl(vals, 0.5),
            "max": vals[-1] if vals else 0.0,
        }

    headline: dict[str, Any] = {}
    step_h = hist_out.get("train.step_s")
    if step_h:
        headline["step_time_p50_s"] = step_h["p50"]
        headline["steps_timed"] = step_h["count"]
    tokens = counters.get("train.tokens")
    if tokens and step_h and step_h["total"] > 0:
        headline["tokens_per_s"] = tokens / step_h["total"]
    saves = [e for e in events
             if e.get("kind") == "span" and e.get("name") == "ckpt.save"]
    restores = [e for e in events if e.get("kind") == "span"
                and e.get("name") == "ckpt.restore"]
    if saves:
        headline["ckpt_save_bytes"] = sum(
            float(e.get("bytes", 0.0)) for e in saves)
        gbps = _ratio_gbps(saves)
        if gbps is not None:
            headline["ckpt_save_gbps"] = gbps
    gbps = _ratio_gbps(restores)
    if gbps is not None:
        headline["ckpt_restore_gbps"] = gbps
    wait = hist_out.get("data.batch_wait_s")
    if wait:
        headline["data_wait_total_s"] = wait["total"]
    hits = counters.get("data.prefetch_hit", 0.0)
    misses = counters.get("data.prefetch_miss", 0.0)
    if hits + misses > 0:
        headline["prefetch_hit_rate"] = hits / (hits + misses)
    fwds = counters.get("infer.spec.forwards", 0.0)
    if fwds > 0:
        headline["spec_tokens_per_forward"] = counters.get(
            "infer.spec.committed", 0.0) / fwds
    if counters.get("serve.requests"):
        headline["serve_requests"] = int(counters["serve.requests"])
    if counters.get("serve.slo_violations"):
        headline["serve_slo_violations"] = int(
            counters["serve.slo_violations"])
    if "fleet.size" in gauges:
        headline["fleet_replicas"] = int(gauges["fleet.size"]["last"])
    # How close to running out of device memory the run lived.
    hbm_peak = gauges.get("device.hbm_peak") or gauges.get(
        "device.hbm_used")
    hbm_limit = gauges.get("device.hbm_limit")
    if hbm_peak and hbm_limit and hbm_limit.get("last"):
        headline["hbm_peak_frac"] = round(
            hbm_peak["max"] / hbm_limit["last"], 4)

    health = health_summary(events)
    if health["anomalies"]:
        headline["health_anomalies"] = len(health["anomalies"])
    if health["rollbacks"]:
        headline["health_rollbacks"] = len(health["rollbacks"])
    if health["dropped_events"]:
        headline["obs_dropped_events"] = health["dropped_events"]

    goodput = compute_goodput(events)
    if goodput["steps_timed"]:
        headline["goodput_fraction"] = round(goodput["fraction"], 4)
    if goodput["buckets"].get("requeue_gap"):
        headline["requeue_gap_s"] = round(goodput["buckets"]["requeue_gap"],
                                          3)
    if goodput["buckets"].get("resize"):
        headline["resize_s"] = round(goodput["buckets"]["resize"], 3)
    return {
        "spans": spans,
        "counters": counters,
        "gauges": gauges,
        "histograms": hist_out,
        "health": health,
        "goodput": goodput,
        "headline": headline,
    }
