"""Serving observatory: the engine-time ledger, SLO accounting and the
per-request access log (counterpart of ``tpuflow/obs/serve_ledger.py``).

Three host-side pieces; none touches a tensor:

- :class:`ServeLedger`: the engine-time ledger. A monotonic cursor sweeps
  forward: every charged span advances it, every gap between charges
  lands in ``host_sched``, and the idle sleep in ``serve_forever`` charges
  ``idle``, so the buckets (``prefill``/``decode``/``verify``/``insert``/
  ``host_sched``/``idle``) sum to the measured wall by construction. It
  also keeps the token-efficiency gauges the scheduler knows:
  occupancy-weighted decode utilisation (live rows / batch rows per
  block), masked-row waste from the (fp, int8) x (spec, plain) group
  partition, speculative draft tokens wasted against accepted, and the
  declared-SLO counters (``slo_ttft_s`` / ``slo_itl_s``).
- :class:`AccessLog`: one JSONL line per terminal request
  (``access.p<proc>.<pid>.jsonl`` beside the event fragments under the
  run's ``obs/`` directory) with the request's whole lifecycle: TTFT, the
  per-tick ITL observations, finish reason, pages and the trace.
- :func:`load_access_log` / :func:`summarize_access`: the reader side,
  which reproduces the ``/metrics`` TTFT/ITL percentiles from the access
  log alone (the same :func:`pctl` math), split by numeric path and
  spec/plain group.

The JAX package reads the declared SLOs from ``TPUFLOW_SERVE_SLO_TTFT_MS``
and ``TPUFLOW_SERVE_SLO_ITL_MS``; here :func:`resolve_slo_s` converts the
engine's ``slo_ttft_ms`` / ``slo_itl_ms`` arguments. Stdlib only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Iterable


# Engine-time buckets, in display order. ``verify`` is the speculative
# twin of ``decode``; ``insert`` is the admission's page write;
# ``host_sched`` is everything the host does between device dispatches
# (queue pops, drafts, token harvest, telemetry); ``idle`` is the
# serve_forever sleep when there was nothing to do.
SERVE_BUCKETS: tuple[str, ...] = (
    "prefill", "decode", "verify", "insert", "host_sched", "idle",
)

# Traffic groups: the (numeric path) x (spec/plain) partition the
# scheduler already runs decode blocks by.
GROUPS: tuple[str, ...] = (
    "fp.plain", "fp.spec", "int8.plain", "int8.spec",
)


def group_key(quantize: bool, speculative: bool) -> str:
    """The request's traffic-group label, matching the scheduler's
    (quant, spec) decode-block partition."""
    return ("int8" if quantize else "fp") + (
        ".spec" if speculative else ".plain"
    )


def pctl(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list — THE percentile
    used by the live exporter and the access-log summary, so the summary
    reproduces /metrics exactly."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


def percentiles(vals: Iterable[float]) -> dict[str, float] | None:
    """{count, p50, p95, p99, max} over raw observations (None when
    empty) — one shape for every latency table this module emits."""
    vs = sorted(float(v) for v in vals)
    if not vs:
        return None
    return {
        "count": len(vs),
        "p50": pctl(vs, 0.50),
        "p95": pctl(vs, 0.95),
        "p99": pctl(vs, 0.99),
        "max": vs[-1],
    }


def resolve_slo_s(ms) -> float | None:
    """A declared SLO in SECONDS from milliseconds (operator dashboards
    speak ms, the ledger compares monotonic seconds). None: SLO
    accounting off for that dimension. A value that is not a positive
    number raises ``ValueError`` (the JAX package turns such an
    environment string off; an argument set in code is the caller's
    mistake, and is not hidden)."""
    if ms is None:
        return None
    if isinstance(ms, (int, float)) and not isinstance(ms, bool) and ms > 0:
        return float(ms) / 1000.0
    raise ValueError(f"an SLO must be a positive number of ms, got {ms!r}")


# Bounded per-group latency reservoirs: enough for stable p99 without
# letting a week-long server grow without bound.
_RESERVOIR = 4096


class ServeLedger:
    """Host-side engine-time accounting for one ServeEngine.

    Cursor discipline: ``bucket(name)`` charges the context-managed span
    to ``name`` and the gap since the previous charge to ``host_sched``;
    ``snapshot()`` settles the trailing gap the same way — so
    ``sum(buckets) == wall`` holds at every snapshot, by construction
    (the acceptance criterion's 5% slack only absorbs the float
    rounding of the report itself). Spans charged from two threads may
    overlap (``serve_forever``'s idle sleep and a gateway thread's ship
    prefill): a span is charged only past the cursor, under a lock, so
    no second of the wall counts twice. Pure python; ~1µs per charge."""

    def __init__(
        self,
        slo_ttft_s: float | None = None,
        slo_itl_s: float | None = None,
    ):
        self.slo_ttft_s = slo_ttft_s
        self.slo_itl_s = slo_itl_s
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Restart the accounting window (a caller resets before the
        timed window so warm-up lands outside it)."""
        now = time.monotonic()
        self._t0 = now
        self._cursor = now
        self.buckets: dict[str, float] = {b: 0.0 for b in SERVE_BUCKETS}
        # Decode-block efficiency accumulators (rows are slot-rows of
        # the persistent program's fixed batch).
        self._block_rows = 0       # batch rows dispatched, all blocks
        self._block_live = 0       # rows live in the dispatching group
        self._block_masked = 0     # rows live overall but masked out
        # Speculative economics.
        self.spec_drafted = 0      # draft tokens sent to verify blocks
        self.spec_accepted = 0     # draft tokens the model agreed with
        # SLO accounting (the per-group split feeds the fleet SLO rates).
        self.slo_violations = 0
        self.slo_ttft_violations = 0
        self.slo_itl_violations = 0
        self.slo_by_group: dict[str, int] = {}
        # Per-group latency reservoirs.
        self._ttft: dict[str, list[float]] = {}
        self._itl: dict[str, list[float]] = {}

    # ----------------------------------------------------------- charging
    def bucket(self, name: str) -> "_Charge":
        """Context manager charging its span to ``name`` (the preceding
        uncharged gap goes to host_sched)."""
        return _Charge(self, name)

    def _charge(self, name: str, start: float, end: float) -> None:
        with self._lock:
            if start > self._cursor:
                self.buckets["host_sched"] += start - self._cursor
            self.buckets[name] += max(end - max(start, self._cursor), 0.0)
            self._cursor = max(end, self._cursor)

    # ------------------------------------------------------- block notes
    def note_decode_block(
        self,
        batch_rows: int,
        group_live: int,
        total_live: int,
        *,
        spec: bool = False,
        drafted: int = 0,
        committed: int = 0,
    ) -> None:
        """One group's decode/verify dispatch: ``batch_rows`` is the
        program's fixed batch, ``group_live`` the rows live in THIS
        group, ``total_live`` the rows live engine-wide — the difference
        is the masked-row waste the group partition pays. Speculative
        blocks also report drafted tokens vs committed (committed
        includes one bonus token per live row, so accepted drafts =
        committed - group_live, floored at 0)."""
        self._block_rows += int(batch_rows)
        self._block_live += int(group_live)
        self._block_masked += max(int(total_live) - int(group_live), 0)
        if spec:
            self.spec_drafted += int(drafted)
            self.spec_accepted += max(int(committed) - int(group_live), 0)

    @property
    def decode_utilization(self) -> float | None:
        """Occupancy-weighted decode utilization: live rows / batch rows
        summed over every dispatched block (1.0 = every row of every
        block earned its FLOPs)."""
        if not self._block_rows:
            return None
        return self._block_live / self._block_rows

    @property
    def masked_row_waste(self) -> float | None:
        """Fraction of dispatched batch rows that were live engine-wide
        but masked OUT of the dispatching group's program — the price of
        the (fp,int8)x(spec,plain) partition on mixed traffic."""
        if not self._block_rows:
            return None
        return self._block_masked / self._block_rows

    @property
    def spec_wasted(self) -> int:
        """Draft tokens the verify forward computed and threw away."""
        return max(self.spec_drafted - self.spec_accepted, 0)

    # ------------------------------------------------------ latency + SLO
    def note_ttft(self, group: str, ttft_s: float) -> None:
        r = self._ttft.setdefault(group, [])
        if len(r) < _RESERVOIR:
            r.append(float(ttft_s))

    def note_itl(self, group: str, itl_s: float) -> None:
        r = self._itl.setdefault(group, [])
        if len(r) < _RESERVOIR:
            r.append(float(itl_s))

    def _count_group(self, group: str | None) -> None:
        if group:
            self.slo_by_group[group] = self.slo_by_group.get(group, 0) + 1

    def check_ttft(
        self, ttft_s: float | None, group: str | None = None
    ) -> bool:
        """True (and counted, split by traffic group when given) when
        the declared TTFT SLO is violated."""
        if self.slo_ttft_s is None or ttft_s is None:
            return False
        if ttft_s > self.slo_ttft_s:
            self.slo_violations += 1
            self.slo_ttft_violations += 1
            self._count_group(group)
            return True
        return False

    def check_itl(
        self, itl_s: float | None, group: str | None = None
    ) -> bool:
        """True (and counted, split by traffic group when given) when
        one decode tick's per-token latency violated the declared ITL
        SLO."""
        if self.slo_itl_s is None or itl_s is None:
            return False
        if itl_s > self.slo_itl_s:
            self.slo_violations += 1
            self.slo_itl_violations += 1
            self._count_group(group)
            return True
        return False

    # ----------------------------------------------------------- reports
    def wall_s(self) -> float:
        return time.monotonic() - self._t0

    def fractions(self) -> dict[str, float]:
        """Bucket fractions of wall-so-far; the pending (uncharged) tail
        counts as host_sched, without mutating the ledger."""
        with self._lock:
            now = time.monotonic()
            wall = max(now - self._t0, 1e-9)
            out = {}
            for b in SERVE_BUCKETS:
                v = self.buckets[b]
                if b == "host_sched":
                    v += max(now - self._cursor, 0.0)
                out[b] = v / wall
        return out

    def snapshot(self) -> dict[str, Any]:
        """Settled view: buckets (summing to wall), fractions, the
        efficiency gauges, per-group and aggregate TTFT/ITL
        percentiles, and the SLO counters."""
        with self._lock:
            now = time.monotonic()
            if now > self._cursor:  # settle the tail into host_sched
                self.buckets["host_sched"] += now - self._cursor
                self._cursor = now
            buckets = dict(self.buckets)
        wall = max(now - self._t0, 1e-9)
        all_ttft = [v for r in self._ttft.values() for v in r]
        all_itl = [v for r in self._itl.values() for v in r]
        out: dict[str, Any] = {
            "wall_s": wall,
            "buckets": buckets,
            "fractions": {b: buckets[b] / wall for b in SERVE_BUCKETS},
            "decode_utilization": self.decode_utilization,
            "masked_row_waste": self.masked_row_waste,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_wasted": self.spec_wasted,
            "slo_violations": self.slo_violations,
            "slo_ttft_violations": self.slo_ttft_violations,
            "slo_itl_violations": self.slo_itl_violations,
            "slo_by_group": dict(sorted(self.slo_by_group.items())),
            "ttft": {
                g: percentiles(r) for g, r in sorted(self._ttft.items())
            },
            "itl": {
                g: percentiles(r) for g, r in sorted(self._itl.items())
            },
        }
        agg_t = percentiles(all_ttft)
        agg_i = percentiles(all_itl)
        if agg_t:
            out["ttft_p50_s"] = agg_t["p50"]
            out["ttft_p99_s"] = agg_t["p99"]
        if agg_i:
            out["itl_p50_s"] = agg_i["p50"]
            out["itl_p99_s"] = agg_i["p99"]
        return out


class _Charge:
    __slots__ = ("_led", "_name", "_t0")

    def __init__(self, led: ServeLedger, name: str):
        if name not in led.buckets:
            raise KeyError(
                f"unknown serve-ledger bucket {name!r} "
                f"(want one of {SERVE_BUCKETS})"
            )
        self._led = led
        self._name = name

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._led._charge(self._name, self._t0, time.monotonic())
        return False


# ------------------------------------------------------------ access log
ACCESS_PREFIX = "access.p"


class AccessLog:
    """Per-request JSONL writer beside the event fragments.

    One line per TERMINAL request (complete or drained). Lines are
    written whole under a lock and flushed immediately — request
    completions are orders of magnitude rarer than token events, and a
    mid-run ``serve-summary`` must see every finished request. Write
    failures are counted, never raised (telemetry must not fail a
    server)."""

    def __init__(self, directory: str, *, proc: int = 0):
        self.directory = os.path.abspath(directory)
        self.proc = int(proc)
        self.path = os.path.join(
            self.directory,
            f"{ACCESS_PREFIX}{self.proc:05d}.{os.getpid()}.jsonl",
        )
        os.makedirs(self.directory, exist_ok=True)
        self.dropped = 0
        self._lock = threading.Lock()

    def write(self, record: dict) -> None:
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            try:
                with open(self.path, "a") as f:
                    f.write(line)
            except OSError:
                self.dropped += 1


def access_paths(run_dir: str) -> list[str]:
    """Every per-process access-log fragment under ``<run_dir>/obs``
    (or under ``run_dir`` itself when pointed straight at an obs dir)."""
    out: list[str] = []
    for d in (os.path.join(run_dir, "obs"), run_dir):
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        out = [
            os.path.join(d, n)
            for n in names
            if n.startswith(ACCESS_PREFIX) and n.endswith(".jsonl")
        ]
        if out:
            return out
    return out


def load_access_log(run_dir: str) -> list[dict]:
    """All access records under the run dir, submit-time ordered.
    Torn tails (a live writer) are skipped, like the event reader."""
    records: list[dict] = []
    for path in access_paths(run_dir):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except OSError:
            continue
    records.sort(key=lambda r: (r.get("ts", 0.0), r.get("request", 0)))
    return records


def summarize_access(records: Iterable[dict]) -> dict[str, Any]:
    """Fold access records into the serving summary: request/token
    counts, finish reasons, SLO violations, and TTFT/ITL percentiles —
    aggregate and split by traffic group — using the SAME ``pctl`` math
    as the live /metrics exporter, so the two surfaces agree on the
    numbers they share."""
    records = list(records)
    ttft_all: list[float] = []
    itl_all: list[float] = []
    by_group: dict[str, dict[str, list[float]]] = {}
    reasons: dict[str, int] = {}
    tokens = 0
    slo = 0
    for r in records:
        g = r.get("group") or group_key(
            bool(r.get("quant")), bool(r.get("spec"))
        )
        slot = by_group.setdefault(g, {"ttft": [], "itl": []})
        t = r.get("ttft_s")
        if isinstance(t, (int, float)):
            ttft_all.append(float(t))
            slot["ttft"].append(float(t))
        for v in r.get("itl_s") or ():
            if isinstance(v, (int, float)):
                itl_all.append(float(v))
                slot["itl"].append(float(v))
        reason = r.get("finish_reason") or "unknown"
        reasons[reason] = reasons.get(reason, 0) + 1
        tokens += int(r.get("tokens", 0) or 0)
        slo += int(r.get("slo_violations", 0) or 0)
    out: dict[str, Any] = {
        "requests": len(records),
        "tokens": tokens,
        "finish_reasons": dict(sorted(reasons.items())),
        "slo_violations": slo,
        "ttft": percentiles(ttft_all),
        "itl": percentiles(itl_all),
        "by_group": {
            g: {
                "requests": len(v["ttft"]),
                "ttft": percentiles(v["ttft"]),
                "itl": percentiles(v["itl"]),
            }
            for g, v in sorted(by_group.items())
        },
    }
    return out
