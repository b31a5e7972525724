"""Live watch of a run or a serving fleet (counterpart of the live modes of
``tools/tpu_watch.py``, ``follow`` and ``fleet``)::

    python -m tpuflow_torch.obs.watch --follow <url> [options]
    python -m tpuflow_torch.obs.watch --fleet <target> [options]

Options: ``--interval S`` (seconds between polls) and ``--max-s S`` (the
deadline).

``--follow`` polls one process's export (``<url>/status``,
``obs/export.py``) and prints one status line per poll: step, step rate,
tokens/s, rolling MFU, goodput so far, last loss, uptime, the card's
memory when it reports, and on a serving replica its queue, occupancy,
tokens/s, TTFT/ITL percentiles, engine-time fractions, SLO count and
tier pages. An unreachable poll is reported and retried.

``--fleet`` polls every replica of a fleet (``target``: a registration
directory or a comma URL list) through ``obs/fleet.py``'s observatory
and prints the fleet headline, one line per replica with its health
score, and the trace id behind the fleet's p99 TTFT bucket when the
merged histogram carries exemplars. A replica answering garbage or
nothing is marked STALE; the watch never crashes on a dying replica.

Both run an alert engine (``obs/alerts.py``; the caller may pass its
own) over every poll and print ``ALERT ... FIRED/RESOLVED`` lines on the
lifecycle edges, deduplicated in between.

The JAX tool reads its cadence and deadline from
``TPU_WATCH_FOLLOW_INTERVAL_S`` and ``TPU_WATCH_MAX_S`` and its default
targets from ``TPUFLOW_OBS_HTTP_PORT`` / ``TPUFLOW_FLEET_*``; here they
are arguments (defaults 5 s and 11 h, the target required). Its evidence
mode, which probes a TPU and commits a capture file, has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

from tpuflow_torch.obs import alerts as alerts_mod
from tpuflow_torch.obs import fleet as fleet_mod

DEFAULT_INTERVAL_S = 5.0
DEFAULT_MAX_S = 11 * 3600.0

_TAG = "watch"


def _fmt(st: dict, key: str, spec: str = "{:.3g}") -> str:
    v = st.get(key)
    return spec.format(v) if isinstance(v, (int, float)) else "-"


def status_line(st: dict) -> str:
    """The babysitter line of one ``/status`` snapshot (without the
    ``[watch HH:MM:SS]`` prefix)."""
    hbm = ""
    if "hbm_used_frac" in st or "hbm_used_bytes" in st:
        # The card's memory: keys exported only when it reports.
        hbm = (f" hbm={_fmt(st, 'hbm_used_frac', '{:.2f}')}"
               f"/{_fmt(st, 'hbm_peak_frac', '{:.2f}')}pk"
               f" ({_fmt(st, 'hbm_used_bytes', '{:.2e}')}B)")
    serving = ""
    if "serve_slot_occupancy" in st:
        serving = (
            f" | serve q={st.get('serve_queue_depth', '-')} "
            f"occ={_fmt(st, 'serve_slot_occupancy', '{:.2f}')} "
            f"tok/s={_fmt(st, 'serve_tokens_per_s', '{:.0f}')} "
            f"ttft50={_fmt(st, 'serve_ttft_p50_s', '{:.3f}')}s "
            f"p99={_fmt(st, 'serve_ttft_p99_s', '{:.3f}')}s "
            f"itl99={_fmt(st, 'serve_itl_p99_s', '{:.4f}')}s "
            f"idle={_fmt(st, 'serve_idle_fraction', '{:.2f}')} "
            f"dec={_fmt(st, 'serve_decode_fraction', '{:.2f}')} "
            f"pre={_fmt(st, 'serve_prefill_fraction', '{:.2f}')} "
            f"slo={st.get('serve_slo_violations', '-')} "
            f"done={st.get('serve_requests', '-')}"
        )
        if "serve_pages_host" in st or "serve_pages_disk" in st:
            # The tiered prefix cache's lower-tier pages, when armed.
            serving += (f" host={st.get('serve_pages_host', '-')} "
                        f"disk={st.get('serve_pages_disk', '-')}")
    return (f"step={st.get('step', '-')} "
            f"rate={_fmt(st, 'step_rate')}/s "
            f"tok/s={_fmt(st, 'tokens_per_s', '{:.0f}')} "
            f"mfu={_fmt(st, 'mfu', '{:.4f}')} "
            f"goodput={_fmt(st, 'goodput_fraction', '{:.3f}')} "
            f"loss={_fmt(st, 'loss', '{:.4f}')} "
            f"up={_fmt(st, 'uptime_s', '{:.0f}')}s" + hbm + serving)


def follow(url: str, interval: float = DEFAULT_INTERVAL_S,
           max_s: float = DEFAULT_MAX_S, *,
           engine: alerts_mod.AlertEngine | None = None, out=None) -> int:
    """Poll ``<url>/status`` every ``interval`` seconds until ``max_s``
    has passed and print one line per poll to ``out`` (default stdout),
    plus the ALERT lines ``engine`` (default a fresh ``AlertEngine``)
    reports."""
    out = out or sys.stdout
    eng = engine if engine is not None else alerts_mod.AlertEngine()
    deadline = time.time() + max_s
    while time.time() < deadline:
        stamp = time.strftime("%H:%M:%S")
        try:
            with urllib.request.urlopen(url.rstrip("/") + "/status",
                                        timeout=5) as r:
                st = json.loads(r.read().decode())
        except (OSError, ValueError) as e:
            print(f"[{_TAG} {stamp}] follow: {url} unreachable ({e}); "
                  f"retry in {interval:.0f}s", file=out, flush=True)
        else:
            print(f"[{_TAG} {stamp}] " + status_line(st), file=out,
                  flush=True)
            for t in eng.observe(status=st):
                print(f"[{_TAG} {stamp}] "
                      + alerts_mod.format_transition(t), file=out,
                      flush=True)
        time.sleep(interval)
    print(f"[{_TAG}] follow deadline reached", file=out, flush=True)
    return 0


def fleet(target: str, interval: float = DEFAULT_INTERVAL_S,
          max_s: float = DEFAULT_MAX_S, *,
          engine: alerts_mod.AlertEngine | None = None, out=None) -> int:
    """Poll the fleet at ``target`` every ``interval`` seconds until
    ``max_s`` has passed and print to ``out`` (default stdout) the
    headline, one line per replica, the p99 exemplar, and the ALERT lines
    of ``engine`` (default a fresh ``AlertEngine``) over the fleet
    aggregate."""
    out = out or sys.stdout
    obsy = fleet_mod.FleetObservatory(target)
    eng = engine if engine is not None else alerts_mod.AlertEngine()
    deadline = time.time() + max_s
    while time.time() < deadline:
        stamp = time.strftime("%H:%M:%S")
        snap = obsy.poll()
        if not snap["replicas"]:
            print(f"[{_TAG} {stamp}] fleet: no replicas discovered "
                  f"(pass a registration dir or a URL list); retry in "
                  f"{interval:.0f}s", file=out, flush=True)
        else:
            print(f"[{_TAG} {stamp}] "
                  + fleet_mod.format_fleet_line(snap["fleet"]), file=out,
                  flush=True)
            for row in snap["replicas"]:
                print(fleet_mod.format_replica_line(row), file=out,
                      flush=True)
            # The concrete trace behind the p99 bucket, when the merged
            # TTFT histogram carries exemplars.
            ex = fleet_mod.hist_exemplar(snap["fleet"].get("ttft_hist"),
                                         0.99)
            if ex is not None:
                print(f"[{_TAG} {stamp}] ttft p99 exemplar: trace {ex} "
                      "(python -m tpuflow_torch.obs trace <request_id> "
                      "resolves it)", file=out, flush=True)
            for t in eng.observe(fleet=snap["fleet"]):
                print(f"[{_TAG} {stamp}] "
                      + alerts_mod.format_transition(t), file=out,
                      flush=True)
        time.sleep(interval)
    print(f"[{_TAG}] fleet deadline reached", file=out, flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpuflow_torch.obs.watch")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--follow", metavar="URL",
                      help="a process's export, e.g. http://127.0.0.1:8080")
    mode.add_argument("--fleet", metavar="TARGET",
                      help="a registration directory or a comma URL list")
    ap.add_argument("--interval", type=float, default=DEFAULT_INTERVAL_S,
                    help="seconds between polls")
    ap.add_argument("--max-s", type=float, default=DEFAULT_MAX_S,
                    help="stop after this many seconds")
    a = ap.parse_args(argv)
    if a.follow is not None:
        return follow(a.follow, a.interval, a.max_s)
    return fleet(a.fleet, a.interval, a.max_s)


if __name__ == "__main__":
    sys.exit(main())
