"""Run registry and cross-run regression ledger (counterpart of
``tpuflow/obs/registry.py``).

Every training run, serving run and benchmark invocation can append ONE
schema-versioned headline record to a JSONL registry: goodput fraction,
tokens/s, TTFT/ITL percentiles (from the mergeable buckets when the
snapshot carries them), the card's memory fractions, the benchmark
digest's keys, the git commit and dirty flag, and the platform.

Durability contract:

- **Atomic append.** One ``os.write`` of one full line on an ``O_APPEND``
  fd: concurrent writers interleave whole lines, never characters, and a
  crash mid-append leaves at most one torn final line.
- **Torn-line-tolerant reads.** :func:`read_registry` skips any line that
  does not parse (or lacks the record shape) instead of raising.
- **Tolerant metric extraction.** A record or digest missing a key
  yields an absent metric, never ``KeyError``.

Regression math: the newest value against the trailing window's
**median + MAD** (``window`` records, ``zmads`` robust deviations with a
1% jitter floor), so one jittery run does not read as a regression and a
real cliff does. ``python -m tpuflow_torch.obs trend`` / ``compare``
render it; :func:`bench_append_and_verdict` renders the "vs last N runs"
table for a benchmark.

Where the port differs from the JAX module:

- **No knobs.** The JAX module reads ``TPUFLOW_REGISTRY_PATH``,
  ``_WINDOW`` and ``_ZMADS``; here the registry file is always an
  explicit argument (None turns the run-end appends off, the JAX
  default) and the window and threshold are arguments defaulting to the
  JAX defaults (5 records, 8.0 MADs).
- **The platform stamp.** The JAX :func:`maybe_append_live` stamps
  ``platform = "tpu"`` whenever the snapshot carries ``hbm_limit_bytes``.
  The port's snapshot carries that key on the card too (the device
  observatory's memory poll), so a literal port would stamp an H100 run
  as a TPU's: the port stamps ``"gpu"`` there and, like the JAX module,
  nothing off the card.
- **The default file** beside a benchmark's records is
  ``GPU_REGISTRY.jsonl``, never the JAX ``TPU_REGISTRY.jsonl``, so no
  card record lands in a TPU registry.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import time
from typing import Any, Iterable

from tpuflow_torch.obs import fleet as _fleet

# The recorder submodule, not the package's ``recorder()`` accessor that
# shadows it once ``tpuflow_torch.obs`` is initialised.
_rec = importlib.import_module("tpuflow_torch.obs.recorder")

SCHEMA = 1

# The registry file a benchmark defaults to, beside its records.
DEFAULT_BASENAME = "GPU_REGISTRY.jsonl"

# The trailing window and the robust-deviation threshold of the verdicts
# (the JAX package's TPUFLOW_REGISTRY_WINDOW / _ZMADS defaults).
DEFAULT_WINDOW = 5
DEFAULT_ZMADS = 8.0

# (metric name, path into the benchmark compact-summary digest). Every
# lookup is guarded: a digest missing a path yields an absent metric.
_DIGEST_PATHS: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("host_combined_gbps", ("host_combined_gbps",)),
    ("disk_combined_gbps", ("disk_combined_gbps",)),
    ("train_mfu", ("train", "mfu")),
    ("train_tokens_per_s", ("train", "tokens_per_s")),
    ("best_mfu_sweep", ("best_mfu_sweep",)),
    ("spec_decode_numerics_ok", ("spec_decode", "numerics_ok")),
    ("spec_decode_speedup", ("spec_decode", "speedup")),
    ("serve_tokens_per_s", ("serving", "tokens_per_s")),
    ("serve_vs_sequential", ("serving", "vs_sequential")),
    ("serve_ttft_p99_s", ("serving", "ttft_p99_s")),
    ("serve_itl_p99_s", ("serving", "itl_p99_s")),
    ("hbm_peak_frac", ("serving", "hbm_peak_frac")),
    ("paged_vs_slot", ("serving_paged", "vs_slot")),
    ("paged_tokens_per_s", ("serving_paged", "tokens_per_s")),
    # The front door's headline; router_dropped must be 0.
    ("router_requests", ("serving_router", "router_requests")),
    ("router_reroutes", ("serving_router", "router_reroutes")),
    ("router_dropped", ("serving_router", "router_dropped")),
    ("int8_weight_only_speedup", ("int8_weight_only", "speedup")),
    ("int8_fused_native_speedup", ("int8_fused_native", "speedup")),
    ("flash_crossover_T", ("flash_crossover_T",)),
    ("flash_fused_vs_split_T2048", ("flash_fused_vs_split_T2048",)),
    ("flash_fwdbwd_auto_T512", ("flash_fwdbwd_auto_T512",)),
    ("exposed_comm_s", ("exposed_comm_s",)),
)

# Metrics where DOWN is the good direction; everything else is
# higher-is-better (throughputs, speedups, fractions of peak).
_LOWER_IS_BETTER_TOKENS = (
    "ttft", "itl", "exposed_comm", "hbm_peak", "hbm_used", "slo_",
    "compile_s", "dropped", "reroute",
)


def lower_is_better(metric: str) -> bool:
    return any(tok in metric for tok in _LOWER_IS_BETTER_TOKENS)


# -------------------------------------------------------------- records
def registry_path(path: str | None = None,
                  default: str | None = None) -> str | None:
    """The registry file: ``path`` when given, else ``default`` (None: no
    registry, the run-end appends are off). The JAX module reads its
    ``TPUFLOW_REGISTRY_PATH`` here."""
    return path or default


def git_stamp(repo: str | None = None) -> tuple[str | None, bool | None]:
    """(commit, dirty) for ``repo`` (default: this package's checkout);
    (None, None) when git or the repository is unavailable: provenance is
    best-effort."""
    if repo is None:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo,
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or None
        if commit is None:
            return None, None
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], cwd=repo,
            capture_output=True, text=True, timeout=5,
        ).stdout.strip())
        return commit, dirty
    except (OSError, subprocess.SubprocessError):
        return None, None


def make_record(
    kind: str,
    metrics: dict[str, float],
    *,
    source: str,
    run_id: str | None = None,
    platform: str | None = None,
    git: str | None = None,
    git_dirty: bool | None = None,
    ts: float | None = None,
) -> dict[str, Any]:
    if ts is None:
        ts = time.time()
    if run_id is None:
        run_id = f"{kind}-{int(ts)}-{os.getpid()}"
    rec: dict[str, Any] = {
        "schema": SCHEMA,
        "run_id": run_id,
        "ts": round(float(ts), 3),
        "kind": kind,
        "source": source,
        "metrics": dict(metrics),
    }
    if platform is not None:
        rec["platform"] = platform
    if git is not None:
        rec["git"] = git
    if git_dirty is not None:
        rec["git_dirty"] = git_dirty
    return rec


def append_record(path: str, record: dict) -> bool:
    """Crash-safe single-line append: the whole line lands in ONE
    ``O_APPEND`` write, so concurrent appenders interleave records, not
    bytes, and a crash tears at most the final line (which
    :func:`read_registry` skips). Records a ``registry.append`` event.
    Failures return False, never raise."""
    try:
        data = (json.dumps(record, sort_keys=True, default=str)
                + "\n").encode()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
    except OSError:
        return False
    _rec.event(
        "registry.append",
        path=path,
        run_id=record.get("run_id"),
        run_kind=record.get("kind"),
        metrics=len(record.get("metrics") or ()),
    )
    return True


def read_registry(path: str) -> list[dict]:
    """Every well-formed record in file order. A torn final line (crash
    mid-append), a corrupt line or a non-record JSON value is skipped:
    reading a damaged registry never raises."""
    out: list[dict] = []
    try:
        f = open(path, encoding="utf-8", errors="replace")
    except OSError:
        return out
    with f:
        for line in f:
            if not line.endswith("\n"):
                continue  # torn tail: the append died mid-write
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and isinstance(rec.get("metrics"),
                                                    dict):
                out.append(rec)
    return out


# ------------------------------------------------- metric extraction
def _num(v: Any) -> float | None:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)) and v == v:  # NaN-free
        return float(v)
    return None


def _walk(d: Any, path: tuple[str, ...]) -> Any:
    for key in path:
        if not isinstance(d, dict):
            return None
        d = d.get(key)
    return d


def digest_metrics(digest: dict | None) -> dict[str, float]:
    """Flat metrics from a benchmark compact-summary digest: a missing or
    non-numeric leaf is absent from the result."""
    out: dict[str, float] = {}
    if not isinstance(digest, dict):
        return out
    for name, path in _DIGEST_PATHS:
        v = _num(_walk(digest, path))
        if v is not None:
            out[name] = v
    return out


def bench_metrics(parsed: dict | None) -> tuple[dict[str, float], dict]:
    """(metrics, provenance) from any generation of benchmark record: the
    bare metric/value shape, the full record's ``extra`` shape, the
    compact ``summary`` digest. Absent keys degrade to absent metrics."""
    out: dict[str, float] = {}
    prov: dict[str, Any] = {}
    if not isinstance(parsed, dict):
        return out, prov
    v = _num(parsed.get("value"))
    if v is not None:
        out["host_combined_gbps"] = v
    v = _num(parsed.get("vs_baseline"))
    if v is not None:
        out["vs_baseline"] = v
    summary = parsed.get("summary")
    if isinstance(summary, dict):
        out.update(digest_metrics(summary))
        plat = _walk(summary, ("train", "platform"))
        if isinstance(plat, str):
            prov["platform"] = plat
        if isinstance(summary.get("git"), str):
            prov["git"] = summary["git"]
        return out, prov
    extra = parsed.get("extra")
    if isinstance(extra, dict):
        v = _num(_walk(extra, ("tiers", "disk", "combined_gbps")))
        if v is not None:
            out["disk_combined_gbps"] = v
        train = extra.get("train")
        if isinstance(train, dict):
            for name, key in (("train_mfu", "mfu"),
                              ("train_tokens_per_s", "tokens_per_s")):
                v = _num(train.get(key))
                if v is not None:
                    out[name] = v
            if isinstance(train.get("platform"), str):
                prov["platform"] = train["platform"]
    return out, prov


def snapshot_metrics(snap: dict) -> dict[str, float]:
    """Headline metrics from a live goodput/serve ``/status`` snapshot.
    TTFT/ITL percentiles come from the mergeable histogram buckets when
    the snapshot carries them (:func:`fleet.hist_percentiles`, the
    fleet-exact source), else from the pre-aggregated gauges."""
    out: dict[str, float] = {}
    for key in (
        "goodput_fraction", "tokens_per_s", "mfu", "step_rate",
        "hbm_peak_frac", "hbm_used_frac", "serve_tokens_per_s",
        "serve_requests", "serve_slo_violations", "serve_queue_depth",
        "nonfinite_steps",
        # A front door's /status only.
        "router_requests", "router_reroutes", "router_dropped",
    ):
        v = _num(snap.get(key))
        if v is not None:
            out[key] = v
    for which in ("ttft", "itl"):
        h = snap.get(f"serve_{which}_hist")
        p = _fleet.hist_percentiles(h) if isinstance(h, dict) else None
        for q in ("p50", "p95", "p99"):
            v = (_num(p.get(q)) if p
                 else _num(snap.get(f"serve_{which}_{q}_s")))
            if v is not None:
                out[f"serve_{which}_{q}_s"] = v
    return out


def maybe_append_live(kind: str, snap: dict | None = None, *,
                      path: str | None) -> bool:
    """Run-end hook (the flow runner, gang member 0, ``serve_forever``):
    append this process's headline (``snap``, default the live goodput
    ledger's snapshot) to the registry at ``path``; None appends nothing.
    The platform is ``"gpu"`` when the snapshot carries the card's
    memory limit (see the module docstring). Never raises."""
    if not path:
        return False
    try:
        if snap is None:
            from tpuflow_torch.obs import goodput as _goodput

            snap = _goodput.live().snapshot()
        metrics = snapshot_metrics(snap)
        commit, dirty = git_stamp()
        platform = "gpu" if "hbm_limit_bytes" in snap else None
        rec = make_record(kind, metrics, source=f"{kind}:live",
                          platform=platform, git=commit, git_dirty=dirty)
        return append_record(path, rec)
    except Exception:
        return False


# ------------------------------------------------------------- backfill
def record_from_bench_file(path: str) -> dict | None:
    """One registry record from a ``BENCH_r*.json`` benchmark capture; None
    when the file is unreadable. A capture whose ``parsed`` is null (a
    truncated tail) still imports, with whatever the tail's last complete
    JSON line yields, possibly no metrics at all."""
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(raw, dict):
        return None
    parsed = raw.get("parsed")
    if not isinstance(parsed, dict):
        # The tail truncated the record: salvage its last complete line.
        tail = raw.get("tail")
        parsed = None
        if isinstance(tail, str):
            for line in reversed(tail.splitlines()):
                line = line.strip()
                if line.startswith("{") and line.endswith("}"):
                    try:
                        cand = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(cand, dict):
                        parsed = cand
                        break
    metrics, prov = bench_metrics(parsed)
    base = os.path.basename(path)
    n = raw.get("n")
    return make_record(
        "bench", metrics, source=f"backfill:{base}",
        run_id=base.rsplit(".", 1)[0], platform=prov.get("platform"),
        git=prov.get("git"),
        ts=float(n) if isinstance(n, (int, float)) else 0.0,
    )


def backfill_bench(bench_dir: str, path: str) -> int:
    """One-shot importer: append a record per ``BENCH_r*.json`` under
    ``bench_dir`` that the registry does not already hold (idempotent:
    rerunning imports nothing). Returns the number appended. A TPU
    capture keeps its own platform stamp: do not import TPU captures into
    a card's registry (README, "The decision observatory on the port")."""
    try:
        names = sorted(n for n in os.listdir(bench_dir)
                       if n.startswith("BENCH_r") and n.endswith(".json"))
    except OSError:
        return 0
    seen = {r.get("run_id") for r in read_registry(path)}
    appended = 0
    for name in names:
        rec = record_from_bench_file(os.path.join(bench_dir, name))
        if rec is None or rec["run_id"] in seen:
            continue
        if append_record(path, rec):
            appended += 1
            seen.add(rec["run_id"])
    return appended


# ---------------------------------------------------------- trend math
def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _mad(vals: list[float], med: float) -> float:
    return _median([abs(v - med) for v in vals])


def metric_series(
    records: Iterable[dict],
) -> dict[str, list[tuple[str, float]]]:
    """metric -> [(run_id, value)] in record order."""
    series: dict[str, list[tuple[str, float]]] = {}
    for rec in records:
        rid = str(rec.get("run_id", "?"))
        for m, v in (rec.get("metrics") or {}).items():
            fv = _num(v)
            if fv is not None:
                series.setdefault(m, []).append((rid, fv))
    return series


def verdict_rows(
    history: list[dict],
    current: dict[str, float],
    *,
    window: int | None = None,
    zmads: float | None = None,
) -> list[dict]:
    """Per-metric verdicts for ``current`` against the trailing
    ``window`` (None: :data:`DEFAULT_WINDOW`) of ``history`` records. A
    metric with no history is "new"; a last-vs-median deviation inside
    ``zmads`` (None: :data:`DEFAULT_ZMADS`) robust deviations, with a 1%
    jitter floor, is "ok"; outside it, the metric's good direction
    decides "improved" or "REGRESSED"; a metric ``current`` lacks is
    "absent"."""
    if window is None:
        window = DEFAULT_WINDOW
    if zmads is None:
        zmads = DEFAULT_ZMADS
    series = metric_series(history)
    rows: list[dict] = []
    for metric in sorted(set(series) | set(current)):
        cur = _num(current.get(metric))
        past = [v for _, v in series.get(metric, [])][-window:]
        row: dict[str, Any] = {"metric": metric, "n": len(past),
                               "last": cur}
        if cur is None:
            row["verdict"] = "absent"
        elif not past:
            row["verdict"] = "new"
        else:
            med = _median(past)
            mad = _mad(past, med)
            delta = cur - med
            # 1.4826 * MAD ~ sigma for normal jitter; the floor keeps a
            # constant history (MAD 0) from flagging noise.
            scale = max(1.4826 * mad, 0.01 * abs(med), 1e-12)
            z = delta / scale
            row.update(median=round(med, 6), mad=round(mad, 6),
                       delta=round(delta, 6), z=round(z, 2))
            if abs(z) <= zmads:
                row["verdict"] = "ok"
            else:
                good_down = lower_is_better(metric)
                improved = delta < 0 if good_down else delta > 0
                row["verdict"] = "improved" if improved else "REGRESSED"
        rows.append(row)
    return rows


def trend_rows(
    records: list[dict],
    *,
    metrics: list[str] | None = None,
    window: int | None = None,
    zmads: float | None = None,
) -> list[dict]:
    """The registry's newest record judged against its own trailing
    window (``obs trend``). ``metrics`` filters the rows."""
    if not records:
        return []
    rows = verdict_rows(records[:-1], dict(records[-1].get("metrics") or {}),
                        window=window, zmads=zmads)
    if metrics:
        keep = set(metrics)
        rows = [r for r in rows if r["metric"] in keep]
    return rows


def compare_rows(rec_a: dict, rec_b: dict) -> list[dict]:
    """Per-metric A -> B deltas over the union of both records' metrics;
    a side missing the metric reads "absent"."""
    ma = rec_a.get("metrics") or {}
    mb = rec_b.get("metrics") or {}
    rows: list[dict] = []
    for metric in sorted(set(ma) | set(mb)):
        a, b = _num(ma.get(metric)), _num(mb.get(metric))
        row: dict[str, Any] = {"metric": metric, "a": a, "b": b}
        if a is None or b is None:
            row["verdict"] = "absent"
        else:
            row["delta"] = round(b - a, 6)
            if a != 0:
                row["delta_pct"] = round(100.0 * (b - a) / abs(a), 2)
            if b == a:
                row["verdict"] = "same"
            else:
                good_down = lower_is_better(metric)
                improved = b < a if good_down else b > a
                row["verdict"] = "improved" if improved else "REGRESSED"
        rows.append(row)
    return rows


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def format_rows(rows: list[dict], columns: tuple[str, ...]) -> str:
    """Aligned text table (the CLI and benchmark verdict rendering)."""
    body = [[_fmt(r.get(c)) for c in columns] for r in rows]
    widths = [max(len(h), *(len(b[i]) for b in body)) if body else len(h)
              for i, h in enumerate(columns)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(columns, widths))]
    for b in body:
        lines.append("  ".join(c.ljust(w) for c, w in zip(b, widths)))
    return "\n".join(lines)


def bench_append_and_verdict(
    compact: dict, repo: str, log=print, *, path: str | None = None,
    window: int | None = None, zmads: float | None = None,
) -> list[dict]:
    """A benchmark's registry hook: append this invocation's digest to
    the registry (``path``, else :data:`DEFAULT_BASENAME` beside the
    benchmark's records in ``repo``) and render the "vs last N runs"
    verdict table from the trailing history through ``log``. Returns the
    verdict rows."""
    path = registry_path(path, os.path.join(repo, DEFAULT_BASENAME))
    if window is None:
        window = DEFAULT_WINDOW
    history = read_registry(path)
    metrics, prov = bench_metrics(compact)
    commit, dirty = git_stamp(repo)
    rec = make_record("bench", metrics, source="bench.py",
                      platform=prov.get("platform"), git=commit,
                      git_dirty=dirty)
    append_record(path, rec)
    rows = verdict_rows(history, metrics, window=window, zmads=zmads)
    judged = [r for r in rows if r["verdict"] != "absent"]
    if judged:
        log(f"[bench] vs last {min(len(history), window)} runs ({path}):")
        for line in format_rows(
            judged, ("metric", "last", "median", "delta", "z", "verdict")
        ).splitlines():
            log(f"[bench]   {line}")
        regressed = [r["metric"] for r in judged
                     if r["verdict"] == "REGRESSED"]
        if regressed:
            log("[bench] REGRESSED vs trailing median+MAD: "
                + ", ".join(regressed))
    return rows
