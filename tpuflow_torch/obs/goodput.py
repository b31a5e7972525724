"""Goodput: where did the run's wall-clock go? (counterpart of
``tpuflow/obs/goodput.py``).

- ``compute_goodput(events)``: the authoritative, event-derived ledger of
  a run. Wall time (first event to last) is decomposed into labeled
  buckets by an interval sweep: every instant is charged to exactly one
  bucket, so the buckets sum to the measured wall by construction
  (residual time lands in ``other``, never vanishes). Bucket semantics,
  highest sweep priority first: ``requeue_gap`` (between one launch
  attempt's last event and the next's first; attempts are the recorder's
  ``launch`` field), ``resize`` (``flow.gang_resize`` spans),
  ``compile`` (``train.compile``: the cold first step, kernel builds and
  allocator warm-up), ``restore`` (``ckpt.restore``), ``data_wait``
  (``data.host_wait_s`` / ``data.batch_wait_s``, carved out of the step
  containing them), ``replay`` (steps re-run after a
  ``health.rollback``), ``step`` (``train.step_s`` fences: the productive
  bucket), ``ckpt`` (the exposed part of ``ckpt.save`` /
  ``ckpt.upload``), ``other``.

- ``ProcessLedger`` / ``live()``: the incremental per-process view the
  live export endpoint (``obs/export.py``) serves, fed by the training
  loops' ``StepClock`` (``train/step.py``: ``note_step`` /
  ``note_compile`` at the fences they already pay) and the serving
  engine: cumulative productive seconds, rolling step and token rates,
  rolling MFU from the model's FLOP estimate against the card's peak,
  goodput so far, the device-memory notes, and the serving engine's view
  (queue, slots, pages, TTFT/ITL percentiles and mergeable histograms,
  the engine-time ledger's fractions, SLO counts, the drain flag and the
  replica's ``/generate`` URL). Its snapshot carries the JAX ledger's
  keys and values for the same note sequence, so a fleet observatory of
  either package reads a port replica as it reads a JAX one.
"""

from __future__ import annotations

import collections
import importlib
import time
from typing import Any, Iterable

from tpuflow_torch.obs import fleet as _fleet
from tpuflow_torch.obs.serve_ledger import pctl as _pctl

# The recorder submodule, not the package's ``recorder()`` accessor that
# shadows it once ``tpuflow_torch.obs`` is initialised.
_rec = importlib.import_module("tpuflow_torch.obs.recorder")

# Sweep priority, highest first: when labeled intervals overlap, each
# instant of wall time is charged to the highest-priority label covering
# it, so a data wait inside a step fence reduces the step bucket, while
# an async checkpoint save hiding under compute charges nothing.
_PRIORITY = (
    "requeue_gap",
    "resize",
    "compile",
    "restore",
    "data_wait",
    "replay",
    "step",
    "ckpt",
)
BUCKETS: tuple[str, ...] = _PRIORITY + ("other",)


def _nonneg(ev: dict, key: str) -> float:
    try:
        return max(float(ev.get(key, 0.0) or 0.0), 0.0)
    except (TypeError, ValueError):
        return 0.0


def compute_goodput(events: Iterable[dict]) -> dict[str, Any]:
    """Fold a (merged) event stream into the per-run goodput ledger::

        {"wall_s": float,          # first event -> last event
         "fraction": float,        # buckets["step"] / wall_s
         "buckets": {bucket: seconds, ...},   # sums exactly to wall_s
         "attempts": [{"attempt", "start_s", "dur_s", "procs"}, ...],
         "steps_timed": int}

    Tolerant of partial streams (a still-running or crashed run): an
    event without a usable timestamp is skipped, unknown names are
    ignored, and an empty stream yields an all-zero ledger."""
    evs = sorted(
        (e for e in events if isinstance(e.get("ts"), (int, float))),
        key=lambda e: (e.get("ts", 0.0), e.get("proc", 0)),
    )
    intervals: list[tuple[float, float, str]] = []
    pending_replay: dict[int, int] = {}
    lanes: dict[int, list] = {}  # attempt -> [start, end, procs]
    steps_timed = 0
    t_lo: float | None = None
    t_hi: float | None = None
    spans = {"flow.gang_resize": "resize", "train.compile": "compile",
             "ckpt.restore": "restore", "ckpt.save": "ckpt",
             "ckpt.upload": "ckpt"}

    for ev in evs:
        ts = float(ev["ts"])
        kind = ev.get("kind")
        name = ev.get("name")
        try:
            proc = int(ev.get("proc", 0) or 0)
        except (TypeError, ValueError):
            proc = 0
        end = ts + _nonneg(ev, "dur_s")
        t_lo = ts if t_lo is None else min(t_lo, ts)
        t_hi = end if t_hi is None else max(t_hi, end)

        launch = ev.get("launch")
        if launch is not None:
            try:
                a = int(launch)
            except (TypeError, ValueError):
                a = None
            if a is not None:
                lane = lanes.setdefault(a, [ts, end, set()])
                lane[0] = min(lane[0], ts)
                lane[1] = max(lane[1], end)
                lane[2].add(proc)

        if kind == "histogram" and name == "train.step_s":
            v = _nonneg(ev, "value")
            label = "step"
            if pending_replay.get(proc, 0) > 0:
                pending_replay[proc] -= 1
                label = "replay"
            # Recorded at the fence: the interval it measures ends there.
            intervals.append((ts - v, ts, label))
            t_lo = min(t_lo, ts - v)
            steps_timed += 1
        elif kind == "span" and name in spans:
            intervals.append((ts, end, spans[name]))
        elif (name in ("data.host_wait_s", "data.batch_wait_s")
              and kind in ("gauge", "histogram")):
            v = _nonneg(ev, "value")
            if v > 0.0:
                intervals.append((ts - v, ts, "data_wait"))
                t_lo = min(t_lo, ts - v)
        elif kind == "event" and name == "health.rollback":
            try:
                replayed = (int(ev.get("from_step", 0) or 0)
                            - int(ev.get("step", 0) or 0))
            except (TypeError, ValueError):
                replayed = 0
            if replayed > 0:
                pending_replay[proc] = pending_replay.get(proc, 0) + replayed

    if t_lo is None or t_hi is None or t_hi <= t_lo:
        return {"wall_s": 0.0, "fraction": 0.0,
                "buckets": {b: 0.0 for b in BUCKETS}, "attempts": [],
                "steps_timed": 0}

    # Inter-attempt requeue gaps: uncovered wall between one attempt
    # lane's envelope end and the next lane's start.
    ordered = sorted(lanes.items(), key=lambda kv: kv[1][0])
    attempts_out = [
        {"attempt": a, "start_s": round(lane[0] - t_lo, 6),
         "dur_s": round(lane[1] - lane[0], 6), "procs": sorted(lane[2])}
        for a, lane in ordered
    ]
    for (_a0, l0), (_a1, l1) in zip(ordered, ordered[1:]):
        if l1[0] > l0[1]:
            intervals.append((l0[1], l1[0], "requeue_gap"))

    # Priority sweep: charge each elementary segment of [t_lo, t_hi] to
    # the highest-priority label active over it; uncovered time -> other.
    marks: list[tuple[float, int, str]] = []
    for s, e, label in intervals:
        s, e = max(s, t_lo), min(e, t_hi)
        if e > s:
            marks.append((s, 0, label))
            marks.append((e, 1, label))
    marks.sort(key=lambda m: (m[0], m[1]))
    buckets = {b: 0.0 for b in BUCKETS}
    active = {label: 0 for label in _PRIORITY}
    prev = t_lo
    for t, closing, label in marks:
        seg = t - prev
        if seg > 0:
            for b in _PRIORITY:
                if active[b] > 0:
                    buckets[b] += seg
                    break
            else:
                buckets["other"] += seg
            prev = t
        active[label] += -1 if closing else 1
    if t_hi > prev:
        # No mark is open past the last close: the residual is other.
        buckets["other"] += t_hi - prev

    wall = t_hi - t_lo
    return {
        "wall_s": wall,
        "fraction": buckets["step"] / wall if wall > 0 else 0.0,
        "buckets": buckets,
        "attempts": attempts_out,
        "steps_timed": steps_timed,
    }


# Dense bf16 peak FLOP/s per card for the rolling-MFU gauge, matched in
# order against ``torch.cuda.get_device_name(0)`` (lower-cased). A card
# off the table reports no MFU rather than an invented one.
_PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),
    ("h200", 989e12),
    ("a100", 312e12),
)
_UNSET = object()
_PEAK_CACHE: Any = _UNSET


def _peak_flops_per_device() -> float | None:
    """Dense bf16 peak FLOP/s of the local card, or None without one (the
    rolling MFU is then omitted rather than invented, as the JAX package
    omits it off its accelerator)."""
    global _PEAK_CACHE
    if _PEAK_CACHE is not _UNSET:
        return _PEAK_CACHE
    try:
        import torch

        if not torch.cuda.is_available():
            _PEAK_CACHE = None
        else:
            name = torch.cuda.get_device_name(0).lower()
            _PEAK_CACHE = next(
                (v for k, v in _PEAK_FLOPS if k in name), None
            )
    except Exception:
        _PEAK_CACHE = None
    return _PEAK_CACHE


def _device_count() -> int:
    try:
        import torch

        return max(torch.cuda.device_count(), 1)
    except Exception:
        return 1


class ProcessLedger:
    """Incremental per-process goodput accounting, fed at fences a loop
    already pays (the serving engine's scheduler iterations; the training
    loops' ``StepClock`` fences). The live export endpoint
    serves ``snapshot()``; it exists so ``/metrics`` can answer mid-run
    without re-reading any file. Its TTFT/ITL histograms use
    ``fleet.DEFAULT_HIST_EDGES``, the JAX package's default edges, so a
    fleet that mixes both packages' replicas merges every bucket."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        """Restart the accounting (a fresh window)."""
        self._t0 = time.monotonic()
        self.started_ts = time.time()
        self.steps = 0
        self.tokens = 0
        self.reports = 0
        self.step = 0
        self.productive_s = 0.0
        self.compile_s = 0.0
        self.flops_per_token: float | None = None
        self.health: dict[str, float] = {}
        self.nonfinite_steps = 0
        # Device observatory: the latest throttled device-memory poll
        # (the device observatory feeds these at the fences
        # the loops already pay). None = no device has reported — the
        # snapshot omits the hbm_* keys entirely (CPU backends).
        self.hbm_used_bytes: int | None = None
        self.hbm_peak_bytes: int | None = None
        self.hbm_limit_bytes: int | None = None
        # Serving view (infer/serve.py feeds these each scheduler
        # iteration); zero serve_max_slots = no engine in this process,
        # and the snapshot omits the serve_* keys entirely.
        self.serve_requests = 0
        self.serve_tokens = 0
        self.serve_queue_depth = 0
        self.serve_live_slots = 0
        self.serve_max_slots = 0
        # Drain flag: set by serve_forever the moment SIGTERM
        # flips it to admit=False, exported on /status so the front-door
        # router stops admitting to this replica BEFORE it goes dark.
        self.serve_draining = False
        # Forwarding address: the replica-side /generate URL
        # (serve_forever's ReplicaGateway), exported verbatim on
        # /status — the fleet row copies it and http_forward POSTs to
        # it. None = no gateway, the row is status-only.
        self.serve_generate_url: str | None = None
        # Paged-KV view: page-pool headroom, prefix-cache
        # reuse, and speculative acceptance — zero serve_pages_total =
        # a contiguous (non-paged) engine, keys omitted.
        self.serve_pages_free = 0
        self.serve_pages_total = 0
        self.serve_prefix_hits = 0
        self.serve_prefix_lookups = 0
        self.serve_spec_committed = 0
        self.serve_spec_forwards = 0
        # Disaggregated serving: the engine's phase role
        # ("prefill" / "decode" / "both" — placement advice the router
        # reads off the fleet row) and the tiered prefix cache's
        # lower-tier page counts. Role "both" with no tier pages is the
        # classic engine; the serve_role key is exported whenever an
        # engine runs, the tier keys only when a tier is armed.
        self.serve_role: str | None = None
        self.serve_pages_host = 0
        self.serve_pages_disk = 0
        self.serve_tier_hits = 0
        self.serve_tiers_armed = False
        # Serving observatory: engine-time ledger fractions,
        # efficiency gauges, and declared-SLO violation count, fed by
        # the engine each scheduler iteration; ITL observations ride a
        # bounded deque exactly like the TTFTs.
        self.serve_ledger_fractions: dict[str, float] = {}
        self.serve_decode_utilization: float | None = None
        self.serve_masked_row_waste: float | None = None
        self.serve_slo_violations = 0
        # Fleet observatory: cumulative fixed-edge TTFT/ITL
        # histograms beside the windowed percentile reservoirs — bucket
        # counts are never dropped, so summing them across replicas
        # reproduces the pooled distribution exactly (the windowed
        # gauges below answer "now", the buckets answer "the fleet").
        # Plus the per-traffic-group SLO/request splits the fleet SLO
        # rates aggregate over.
        self._serve_ttft_hist = _fleet.MergeableHistogram()
        self._serve_itl_hist = _fleet.MergeableHistogram()
        self.serve_slo_by_group: dict[str, int] = {}
        self.serve_requests_by_group: dict[str, int] = {}
        self._serve_itls: collections.deque = collections.deque(maxlen=2048)
        self._serve_ttfts: collections.deque = collections.deque(maxlen=512)
        self._serve_recent: collections.deque = collections.deque(maxlen=128)
        # (monotonic, cumulative steps+reports, cumulative tokens) marks
        # for the rolling rates: the window spans the last 128 fences.
        self._recent: collections.deque = collections.deque(maxlen=128)
        self._mark()

    def _mark(self) -> None:
        self._recent.append(
            (time.monotonic(), self.steps + self.reports, self.tokens)
        )

    def set_model_flops_per_token(self, flops: float | None) -> None:
        """The model's FLOP/token estimate (dense transformer: 6·N) —
        the numerator of the rolling MFU gauge."""
        self.flops_per_token = float(flops) if flops else None

    def note_compile(self, dur_s: float) -> None:
        self.compile_s += max(float(dur_s), 0.0)
        self._mark()

    def note_step(
        self, dur_s: float, tokens: int = 0, step: int | None = None
    ) -> None:
        self.steps += 1
        self.tokens += int(tokens)
        self.productive_s += max(float(dur_s), 0.0)
        if step is not None:
            try:
                self.step = int(step)
            except (TypeError, ValueError):
                pass
        self._mark()

    def note_report(self, step: int, loss: float | None = None) -> None:
        """A ``TrainContext.report`` fence (custom Trainer loops have no
        step clock; the report cadence is their liveness signal)."""
        self.reports += 1
        try:
            self.step = max(self.step, int(step))
        except (TypeError, ValueError):
            pass
        if isinstance(loss, (int, float)):
            self.health["loss"] = float(loss)
        self._mark()

    def note_device_hbm(
        self,
        used: int | None,
        peak: int | None,
        limit: int | None,
    ) -> None:
        """One device-memory poll: bytes in use / peak on the
        busiest local device, limit of the tightest. Peak is kept as a
        running max so a between-polls spike the runtime reported once
        is never lost from the snapshot."""
        if used is not None:
            self.hbm_used_bytes = int(used)
        if peak is not None:
            self.hbm_peak_bytes = max(int(peak), self.hbm_peak_bytes or 0)
        if limit is not None:
            self.hbm_limit_bytes = int(limit)

    def note_health(
        self, loss: float, grad_norm: float, nonfinite: bool
    ) -> None:
        self.health["loss"] = float(loss)
        self.health["grad_norm"] = float(grad_norm)
        if nonfinite:
            self.nonfinite_steps += 1

    # ------------------------------------------------------------- serving
    def note_serve_state(
        self, queue_depth: int, live_slots: int, max_slots: int
    ) -> None:
        """One serving-scheduler iteration's instantaneous state."""
        self.serve_queue_depth = int(queue_depth)
        self.serve_live_slots = int(live_slots)
        self.serve_max_slots = max(int(max_slots), self.serve_max_slots)

    def note_serve_tokens(self, n: int) -> None:
        if n:
            self.serve_tokens += int(n)
        self._serve_recent.append((time.monotonic(), self.serve_tokens))

    def note_serve_ttft(
        self, ttft_s: float | None, trace_id: str | None = None
    ) -> None:
        if isinstance(ttft_s, (int, float)):
            self._serve_ttfts.append(float(ttft_s))
            self._serve_ttft_hist.observe(float(ttft_s), exemplar=trace_id)

    def note_serve_complete(self, group: str | None = None) -> None:
        self.serve_requests += 1
        if group:
            self.serve_requests_by_group[group] = (
                self.serve_requests_by_group.get(group, 0) + 1
            )

    def note_serve_draining(self, draining: bool = True) -> None:
        """The serve loop entered (or left) its SIGTERM drain: no new
        admissions; the fleet row carries ``serve_draining`` so a router
        re-routes this replica's queued work instead of waiting for
        staleness to prove the death."""
        self.serve_draining = bool(draining)

    def note_serve_generate_url(self, url: str | None) -> None:
        """Advertise (or retract) this replica's /generate endpoint.
        The /status snapshot carries it as ``generate_url``; the fleet
        observatory copies it onto the replica row, which is what the
        front-door router's ``http_forward`` POSTs to."""
        self.serve_generate_url = url if url is None else str(url)

    def note_serve_pages(self, free: int, total: int) -> None:
        """Paged-KV pool headroom (free includes idle-evictable pages)."""
        self.serve_pages_free = int(free)
        self.serve_pages_total = max(int(total), self.serve_pages_total)

    def note_serve_prefix(self, hits: int, lookups: int) -> None:
        """Cumulative shared-prefix page cache hits / lookups."""
        self.serve_prefix_hits = int(hits)
        self.serve_prefix_lookups = int(lookups)

    def note_serve_role(self, role: str) -> None:
        """The engine's disaggregation role, exported on
        /status so the router can place prefill vs decode traffic."""
        self.serve_role = str(role)

    def note_serve_tiers(self, host: int, disk: int, hits: int) -> None:
        """Tiered prefix-cache state: pages currently parked
        per lower tier plus cumulative lower-tier admission hits."""
        self.serve_tiers_armed = True
        self.serve_pages_host = int(host)
        self.serve_pages_disk = int(disk)
        self.serve_tier_hits = int(hits)

    def note_serve_spec(self, committed: int, forwards: int) -> None:
        """Cumulative speculative tokens committed / per-row verifies."""
        self.serve_spec_committed = int(committed)
        self.serve_spec_forwards = int(forwards)

    def note_serve_itl(
        self, itl_s: float | None, trace_id: str | None = None
    ) -> None:
        """One decode tick's per-token latency observation (tick wall /
        tokens committed) for the live ITL percentiles."""
        if isinstance(itl_s, (int, float)):
            self._serve_itls.append(float(itl_s))
            self._serve_itl_hist.observe(float(itl_s), exemplar=trace_id)

    def note_serve_ledger(
        self,
        fractions: dict[str, float],
        *,
        utilization: float | None = None,
        masked_waste: float | None = None,
        slo_violations: int = 0,
        slo_by_group: dict[str, int] | None = None,
    ) -> None:
        """The engine-time ledger's live view (obs/serve_ledger.py):
        bucket fractions of serve wall, decode utilization, masked-row
        waste, and the SLO violation counts (total + per traffic group,
        the split the fleet SLO rates aggregate)."""
        self.serve_ledger_fractions = dict(fractions)
        self.serve_decode_utilization = utilization
        self.serve_masked_row_waste = masked_waste
        self.serve_slo_violations = int(slo_violations)
        if slo_by_group is not None:
            self.serve_slo_by_group = dict(slo_by_group)

    def snapshot(self) -> dict[str, Any]:
        """Point-in-time view for the export endpoint. Rolling rates come
        from the recent-fence window; MFU only when both the model FLOP
        estimate and the chip's peak are known."""
        now = time.monotonic()
        wall = max(now - self._t0, 1e-9)
        step_rate = tokens_per_s = None
        if len(self._recent) >= 2:
            t_a, n_a, tok_a = self._recent[0]
            t_b, n_b, tok_b = self._recent[-1]
            dt = t_b - t_a
            if dt > 0:
                step_rate = (n_b - n_a) / dt
                tokens_per_s = (tok_b - tok_a) / dt
        mfu = None
        peak = _peak_flops_per_device()
        if self.flops_per_token and tokens_per_s and peak:
            ndev = _device_count()
            mfu = self.flops_per_token * tokens_per_s / (peak * ndev)
        out: dict[str, Any] = {
            "uptime_s": round(wall, 3),
            "started_ts": self.started_ts,
            "steps": self.steps,
            "reports": self.reports,
            "step": self.step,
            "tokens": self.tokens,
            "productive_s": round(self.productive_s, 4),
            "compile_s": round(self.compile_s, 4),
            "goodput_fraction": round(self.productive_s / wall, 4),
            "nonfinite_steps": self.nonfinite_steps,
        }
        # Device observatory: HBM residency keys only when a
        # device has reported memory stats — absent otherwise, never 0.
        if self.hbm_used_bytes is not None:
            out["hbm_used_bytes"] = self.hbm_used_bytes
        if self.hbm_peak_bytes is not None:
            out["hbm_peak_bytes"] = self.hbm_peak_bytes
        if self.hbm_limit_bytes is not None:
            out["hbm_limit_bytes"] = self.hbm_limit_bytes
            if self.hbm_used_bytes is not None:
                out["hbm_used_frac"] = round(
                    self.hbm_used_bytes / self.hbm_limit_bytes, 4
                )
            if self.hbm_peak_bytes is not None:
                out["hbm_peak_frac"] = round(
                    self.hbm_peak_bytes / self.hbm_limit_bytes, 4
                )
        # Outside the serve_max_slots guard on purpose: the gateway
        # starts before the engine's first scheduler iteration feeds
        # note_serve_state, and the router must be able to forward from
        # the very first fleet poll.
        if self.serve_generate_url:
            out["generate_url"] = self.serve_generate_url
        if self.serve_max_slots:
            out["serve_requests"] = self.serve_requests
            out["serve_tokens"] = self.serve_tokens
            out["serve_queue_depth"] = self.serve_queue_depth
            out["serve_slot_occupancy"] = round(
                self.serve_live_slots / self.serve_max_slots, 4
            )
            if len(self._serve_recent) >= 2:
                t_a, tok_a = self._serve_recent[0]
                t_b, tok_b = self._serve_recent[-1]
                if t_b > t_a:
                    out["serve_tokens_per_s"] = round(
                        (tok_b - tok_a) / (t_b - t_a), 2
                    )
            # Nearest-rank percentiles via the shared pctl so the
            # access-log summary reproduces these exact numbers.
            if self._serve_ttfts:
                ts = sorted(self._serve_ttfts)
                out["serve_ttft_p50_s"] = round(_pctl(ts, 0.50), 6)
                out["serve_ttft_p95_s"] = round(_pctl(ts, 0.95), 6)
                out["serve_ttft_p99_s"] = round(_pctl(ts, 0.99), 6)
            if self._serve_itls:
                its = sorted(self._serve_itls)
                out["serve_itl_p50_s"] = round(_pctl(its, 0.50), 6)
                out["serve_itl_p95_s"] = round(_pctl(its, 0.95), 6)
                out["serve_itl_p99_s"] = round(_pctl(its, 0.99), 6)
            # Engine-time ledger view: bucket fractions,
            # efficiency gauges, SLO count — keys only when an engine
            # has fed the ledger at least once.
            for b, v in sorted(self.serve_ledger_fractions.items()):
                out[f"serve_{b}_fraction"] = round(float(v), 4)
            if self.serve_decode_utilization is not None:
                out["serve_decode_utilization"] = round(
                    self.serve_decode_utilization, 4
                )
            if self.serve_masked_row_waste is not None:
                out["serve_masked_row_waste"] = round(
                    self.serve_masked_row_waste, 4
                )
            out["serve_slo_violations"] = self.serve_slo_violations
            if self.serve_draining:
                out["serve_draining"] = True
            # Mergeable histogram view: cumulative bucket
            # counts /metrics renders in the Prometheus histogram
            # convention and the fleet observatory SUMS across replicas
            # — the per-replica percentile gauges above cannot merge.
            if self._serve_ttft_hist.count:
                out["serve_ttft_hist"] = self._serve_ttft_hist.to_dict()
            if self._serve_itl_hist.count:
                out["serve_itl_hist"] = self._serve_itl_hist.to_dict()
            if self.serve_slo_by_group:
                out["serve_slo_by_group"] = dict(
                    sorted(self.serve_slo_by_group.items())
                )
            if self.serve_requests_by_group:
                out["serve_requests_by_group"] = dict(
                    sorted(self.serve_requests_by_group.items())
                )
            if self.serve_role is not None:
                out["serve_role"] = self.serve_role
            if self.serve_pages_total:
                out["serve_pages_free"] = self.serve_pages_free
                if self.serve_prefix_lookups:
                    out["serve_prefix_hit_rate"] = round(
                        self.serve_prefix_hits / self.serve_prefix_lookups,
                        4,
                    )
            if self.serve_tiers_armed:
                out["serve_pages_host"] = self.serve_pages_host
                out["serve_pages_disk"] = self.serve_pages_disk
                out["serve_tier_hits"] = self.serve_tier_hits
            if self.serve_spec_forwards:
                out["serve_spec_accept_rate"] = round(
                    self.serve_spec_committed / self.serve_spec_forwards, 4
                )
        if step_rate is not None:
            out["step_rate"] = round(step_rate, 4)
            out["tokens_per_s"] = round(tokens_per_s, 2)
        if mfu is not None:
            out["mfu"] = round(mfu, 4)
        if self.flops_per_token:
            out["flops_per_token"] = self.flops_per_token
        for k, v in self.health.items():
            out[k] = v
        return out


_LEDGER = ProcessLedger()


def live() -> ProcessLedger:
    """This process's live goodput ledger (one per process)."""
    return _LEDGER


def emit_gauges() -> None:
    """Record the goodput-so-far gauges into the event stream (no-ops
    when telemetry is disabled: the gauge calls check that themselves)."""
    led = _LEDGER
    wall = max(time.monotonic() - led._t0, 1e-9)
    _rec.gauge("goodput.productive_s", round(led.productive_s, 4))
    _rec.gauge(
        "goodput.lost_s", round(max(wall - led.productive_s, 0.0), 4)
    )
    _rec.gauge("goodput.fraction", round(led.productive_s / wall, 4))
