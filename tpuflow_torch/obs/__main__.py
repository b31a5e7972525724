"""Operator CLI: ``python -m tpuflow_torch.obs <command> [target] [--json]``
(counterpart of ``python -m tpuflow.obs``).

Eight commands, host-only and safe against a LIVE run from a login shell:

- ``summarize <run_dir>``: the run's merged telemetry (the committed
  ``events.jsonl``, or the per-process fragments of a still-running or
  crashed run): headline metrics plus the goodput ledger.
- ``serve-summary <run_dir>``: the serving observatory: TTFT/ITL
  percentiles split by traffic group, finish reasons and SLO violations
  reproduced from the per-request access log alone, plus the engine-time
  ledger fractions when the event stream carries them.
- ``device-summary <run_dir>``: the device observatory: the program
  ledger from the ``programs.json`` run artifact, the last memory gauges,
  the static budget verdict and any anomaly-triggered ``prof.capture``.
- ``fleet-summary <target>``: poll every replica's ``/status`` once
  (``target``: a registration directory or a comma URL list) and print
  the fleet headline plus one line per replica with its health score.
- ``trend --registry=PATH [--metric=M ...] [--window=N]``: the registry's
  newest record judged against its trailing median+MAD window.
- ``compare <runA> <runB> --registry=PATH``: per-metric deltas between
  two registry records (run-id exact or prefix match).
- ``registry-backfill [<dir>] --registry=PATH``: one-shot idempotent
  import of ``BENCH_r*.json`` captures into the registry.
- ``trace <request_id> <dir> [<dir> ...]``: assemble one request's
  cross-process spans (front door, router forwards, replica gateway,
  engine lifecycle) from the trace directories (a trace directory, or a
  run directory holding ``trace/`` or ``obs/trace/``) into one timeline
  with its critical-path TTFT breakdown.

Output text, ``--json`` structures and exit codes (0 done, 1 nothing
found, 2 usage) are the JAX CLI's. Where the JAX CLI falls back to a
knob (``TPUFLOW_REGISTRY_PATH``, ``TPUFLOW_FLEET_*``,
``TPUFLOW_TRACE_DIR``), this one needs the argument and answers exit 2
with its usage text without it.
"""

from __future__ import annotations

import json
import os
import sys

from tpuflow_torch.obs.goodput import BUCKETS
from tpuflow_torch.obs.serve_ledger import (
    SERVE_BUCKETS,
    load_access_log,
    summarize_access,
)
from tpuflow_torch.obs.timeline import load_run_events, summarize

_USAGE = (
    "usage: python -m tpuflow_torch.obs "
    "{summarize|serve-summary|device-summary} <run_dir> [--json]\n"
    "       python -m tpuflow_torch.obs fleet-summary "
    "<registration_dir>|<url,url,...> [--json]\n"
    "       python -m tpuflow_torch.obs trend --registry=PATH "
    "[--metric=M ...] [--window=N] [--json]\n"
    "       python -m tpuflow_torch.obs compare <runA> <runB> "
    "--registry=PATH [--json]\n"
    "       python -m tpuflow_torch.obs registry-backfill [<bench_dir>] "
    "--registry=PATH\n"
    "       python -m tpuflow_torch.obs trace <request_id> <dir> "
    "[<dir> ...] [--json]"
)


def _usage() -> int:
    print(_USAGE, file=sys.stderr)
    return 2


def _dump(obj) -> int:
    json.dump(obj, sys.stdout, indent=2, sort_keys=True, default=str)
    print()
    return 0


def _summarize(run_dir: str, as_json: bool) -> int:
    events = load_run_events(run_dir)
    if not events:
        print(f"no telemetry found under {run_dir}", file=sys.stderr)
        return 1
    s = summarize(events)
    if as_json:
        return _dump(s)
    print(f"events: {len(events)}")
    headline = s.get("headline", {})
    if headline:
        print("headline:")
        for k, v in sorted(headline.items()):
            print(f"  {k}: {v:.6g}" if isinstance(v, float)
                  else f"  {k}: {v}")
    gp = s.get("goodput") or {}
    wall = gp.get("wall_s", 0.0)
    if wall:
        print(f"goodput: {100.0 * gp.get('fraction', 0.0):.1f}% of "
              f"{wall:.1f}s wall")
        for b in BUCKETS:
            v = gp.get("buckets", {}).get(b, 0.0)
            if v:
                print(f"  {b}: {v:.3f}s ({100.0 * v / wall:.1f}%)")
        for a in gp.get("attempts", []):
            procs = ",".join(f"p{p}" for p in a.get("procs", []))
            print(f"  attempt {a['attempt']}: +{a['start_s']:.1f}s "
                  f"for {a['dur_s']:.1f}s [{procs}]")
    return 0


def _fmt_lat(p: dict | None) -> str:
    if not p:
        return "-"
    return (f"p50={p['p50']:.4f}s p95={p['p95']:.4f}s p99={p['p99']:.4f}s "
            f"(n={p['count']})")


_LEDGER_GAUGES = (
    "serve.idle_fraction",
    "serve.decode_fraction",
    "serve.prefill_fraction",
    "serve.decode_utilization",
    "serve.masked_row_waste",
)


def _serve_summary(run_dir: str, as_json: bool) -> int:
    records = load_access_log(run_dir)
    if not records:
        print(f"no serve access log found under {run_dir} "
              "(obs/access.p*.jsonl: written by a ServeEngine while a "
              "recorder is configured)", file=sys.stderr)
        return 1
    s = summarize_access(records)
    # The engine-time ledger fractions ride the event stream as gauges;
    # an access log with no events is still a summary.
    ledger: dict[str, float] = {}
    for ev in load_run_events(run_dir):
        if ev.get("kind") != "gauge" or ev.get("name") not in _LEDGER_GAUGES:
            continue
        try:
            ledger[ev["name"]] = float(ev.get("value", 0.0))
        except (TypeError, ValueError):
            pass
    if ledger:
        s["ledger"] = ledger
    if as_json:
        return _dump(s)
    print(f"requests: {s['requests']}  tokens: {s['tokens']}  "
          f"slo_violations: {s['slo_violations']}")
    print("finish: " + ", ".join(f"{k}={v}"
                                 for k, v in s["finish_reasons"].items()))
    print(f"ttft: {_fmt_lat(s['ttft'])}")
    print(f"itl:  {_fmt_lat(s['itl'])}")
    for g, rec in s["by_group"].items():
        print(f"  {g}: n={rec['requests']}")
        print(f"    ttft: {_fmt_lat(rec['ttft'])}")
        print(f"    itl:  {_fmt_lat(rec['itl'])}")
    if ledger:
        print("ledger (last gauges):")
        for b in SERVE_BUCKETS:
            v = ledger.get(f"serve.{b}_fraction")
            if v is not None:
                print(f"  {b}: {100.0 * v:.1f}%")
        for extra in ("serve.decode_utilization", "serve.masked_row_waste"):
            if extra in ledger:
                print(f"  {extra.split('.', 1)[1]}: {ledger[extra]:.4f}")
    return 0


def _device_summary(run_dir: str, as_json: bool) -> int:
    from tpuflow_torch.obs.device import device_summary, summarize_entry

    s = device_summary(run_dir)
    if not s:
        print(f"no device telemetry found under {run_dir} "
              "(obs/programs.json, device.* gauges, prof.capture events: "
              "written by the device observatory, see the README)",
              file=sys.stderr)
        return 1
    if as_json:
        return _dump(s)
    programs = s.get("programs") or []
    if programs:
        print(f"programs: {len(programs)} ({s.get('programs_path')})")
        print("  name             compile_s       flops    arg MiB"
              "    out MiB   temp MiB")
        for e in programs:
            print(summarize_entry(e))
    budget = s.get("budget") or {}
    if budget:
        line = (f"budget: resident "
                f"{budget.get('resident_bytes', 0) / 2**30:.3f}"
                f" GiB over {budget.get('programs', len(programs))} "
                f"programs")
        if "resident_frac" in budget:
            line += (f" = {100.0 * budget['resident_frac']:.1f}% of "
                     f"{budget.get('bytes_limit', 0) / 2**30:.2f} GiB limit"
                     + (" [OVER]" if budget.get("over") else ""))
        print(line)
    hbm = s.get("hbm") or {}
    if hbm:
        def gib(*keys):
            for k in keys:
                v = hbm.get(k)
                if v is not None:
                    return f"{v / 2**30:.3f}"
            return "-"

        print(f"hbm: used {gib('hbm_used')} GiB "
              f"(max {gib('hbm_used_max')})"
              f"  peak {gib('hbm_peak_max', 'hbm_peak')}"
              f"  limit {gib('hbm_limit')} GiB")
    for cap in s.get("captures") or []:
        print(f"capture[{cap.get('capture', '?')}]: {cap.get('reason')} "
              f"-> {cap.get('dir')}"
              + (f" (+{cap.get('memory_profile')})"
                 if cap.get("memory_profile") else ""))
    return 0


def _fleet_summary(target: str, as_json: bool) -> int:
    from tpuflow_torch.obs import fleet

    obsy = fleet.FleetObservatory(target)
    if not obsy.discover():
        print("no fleet replicas found under the target (a registration "
              "dir or a comma URL list)", file=sys.stderr)
        return 1
    snap = obsy.poll()
    if as_json:
        return _dump(snap)
    print(fleet.format_fleet_line(snap["fleet"]))
    for row in snap["replicas"]:
        print(fleet.format_replica_line(row))
    fl = snap["fleet"]
    for which in ("ttft", "itl"):
        p = fl.get(which)
        if p:
            print(f"{which}: p50={p['p50']:.4g}s p95={p['p95']:.4g}s "
                  f"p99={p['p99']:.4g}s (n={p['count']}, fleet-exact from "
                  "merged histogram buckets)")
    for g, rate in (fl.get("slo_rate_by_group") or {}).items():
        print(f"slo[{g}]: {100.0 * rate:.2f}% "
              f"({fl['slo_by_group'].get(g, 0)} violations / "
              f"{fl['requests_by_group'].get(g, 0)} requests)")
    return 0


def _trace_cmd(request_id: str, dirs: list[str], as_json: bool) -> int:
    """Assemble one request's cross-process trace. Each of ``dirs`` may
    be the trace directory itself or a parent holding ``trace/`` or
    ``obs/trace/``; spans from every directory merge into one
    timeline."""
    from tpuflow_torch.obs import trace as tracemod

    spans: list[dict] = []
    seen: set[tuple] = set()
    scanned: list[str] = []
    for d in dirs:
        for cand in (d, os.path.join(d, "trace"),
                     os.path.join(d, "obs", "trace")):
            if not os.path.isdir(cand):
                continue
            scanned.append(cand)
            for s in tracemod.spans_for_request(cand, request_id):
                key = (s.get("trace"), s.get("span"), s.get("name"),
                       s.get("ts"), s.get("writer"))
                if key in seen:
                    continue
                seen.add(key)
                spans.append(s)
    assembled = tracemod.assemble(spans)
    if assembled is None:
        print(f"no spans for request {request_id!r} under "
              f"{', '.join(scanned) or ', '.join(dirs)} (unsampled and "
              "never escalated, or the trace dir is wrong)",
              file=sys.stderr)
        return 1
    if as_json:
        return _dump(assembled)
    for line in tracemod.format_timeline(assembled):
        print(line)
    return 0


def _find_record(records: list[dict], token: str) -> dict | None:
    """The newest record whose run_id matches ``token`` exactly, else the
    newest run-id *prefix* match."""
    exact = [r for r in records if r.get("run_id") == token]
    if exact:
        return exact[-1]
    pref = [r for r in records
            if str(r.get("run_id", "")).startswith(token)]
    return pref[-1] if pref else None


def _registry_cli(argv: list[str]) -> int:
    """trend / compare / registry-backfill: the regression ledger."""
    from tpuflow_torch.obs import registry as reg

    cmd = argv[0]
    args: list[str] = []
    metrics: list[str] = []
    path = None
    window = None
    as_json = False
    for a in argv[1:]:
        if a == "--json":
            as_json = True
        elif a.startswith("--metric="):
            metrics.append(a.split("=", 1)[1])
        elif a.startswith("--registry="):
            path = a.split("=", 1)[1]
        elif a.startswith("--window="):
            try:
                window = int(a.split("=", 1)[1])
            except ValueError:
                return _usage()
        elif a.startswith("-"):
            return _usage()
        else:
            args.append(a)
    if not path:
        return _usage()

    if cmd == "registry-backfill":
        if len(args) > 1:
            return _usage()
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        bench_dir = args[0] if args else repo
        n = reg.backfill_bench(bench_dir, path)
        print(f"imported {n} bench record(s) from {bench_dir} -> {path}")
        return 0

    records = reg.read_registry(path)
    if not records:
        print(f"empty registry ({path}): run `python -m tpuflow_torch.obs "
              "registry-backfill --registry=PATH` or a run with a registry "
              "path to fill it", file=sys.stderr)
        return 1

    if cmd == "compare":
        if len(args) != 2:
            return _usage()
        recs = []
        for token in args:
            rec = _find_record(records, token)
            if rec is None:
                print(f"run {token!r} not found in {path} "
                      f"({len(records)} records)", file=sys.stderr)
                return 1
            recs.append(rec)
        rows = reg.compare_rows(recs[0], recs[1])
        if as_json:
            json.dump(rows, sys.stdout, indent=2, sort_keys=True)
            print()
            return 0
        print(f"compare {recs[0].get('run_id')} -> "
              f"{recs[1].get('run_id')} ({path})")
        print(reg.format_rows(
            rows, ("metric", "a", "b", "delta", "delta_pct", "verdict")))
        return 0

    # trend
    if args:
        return _usage()
    rows = reg.trend_rows(records, metrics=metrics or None, window=window)
    if as_json:
        json.dump(rows, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    newest = records[-1]
    print(f"registry: {path} ({len(records)} records) — newest "
          f"{newest.get('run_id')} vs trailing window")
    print(reg.format_rows(
        rows, ("metric", "n", "last", "median", "delta", "z", "verdict")))
    regressed = [r["metric"] for r in rows
                 if r.get("verdict") == "REGRESSED"]
    if regressed:
        print("REGRESSED: " + ", ".join(regressed))
    return 0


def main(argv: list[str]) -> int:
    if argv and argv[0] in ("trend", "compare", "registry-backfill"):
        return _registry_cli(argv)
    if argv and argv[0] == "trace":
        args = [a for a in argv[1:] if not a.startswith("-")]
        flags = {a for a in argv[1:] if a.startswith("-")}
        if flags - {"--json"} or len(args) < 2:
            return _usage()
        return _trace_cmd(args[0], args[1:], "--json" in flags)
    args = [a for a in argv if not a.startswith("-")]
    flags = {a for a in argv if a.startswith("-")}
    commands = ("summarize", "serve-summary", "device-summary",
                "fleet-summary")
    if (flags - {"--json"} or len(args) != 2
            or args[0] not in commands):
        return _usage()
    as_json = "--json" in flags
    if args[0] == "fleet-summary":
        return _fleet_summary(args[1], as_json)
    if args[0] == "serve-summary":
        return _serve_summary(args[1], as_json)
    if args[0] == "device-summary":
        return _device_summary(args[1], as_json)
    return _summarize(args[1], as_json)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
