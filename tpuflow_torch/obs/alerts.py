"""Declarative SLO and health alert engine (counterpart of
``tpuflow/obs/alerts.py``).

Seven rules judged against live ``/status`` snapshots and fleet
aggregations, the decision side of the serving, fleet and device
observatories:

- ``slo_burn_rate``: the multi-window burn rate over the SLO-violation
  counters: the fast AND the slow trailing windows must both exceed the
  budget before the page fires (the slow window proves the burn is
  sustained, the fast one that it is still happening). An empty or
  single-sample window never fires.
- ``hbm_headroom``: the tightest replica's free device-memory fraction
  fell under the budget line.
- ``goodput_drop``: the run's goodput-so-far fraction fell under the
  floor after the run settled (steps > 0).
- ``health_collapse``: the fleet's worst replica health score fell under
  the floor.
- ``stale_replicas``: replicas stopped answering ``/status``.
- ``reroute_spike``: the front door's reroute rate (reroutes per
  completed request over the fast window, the burn gate's
  cumulative-counter construction) exceeded ``reroute_rate``.
- ``ttft_router_dominance``: the router-side wait per completed request
  over the fast window exceeded ``router_ttft_frac`` of the fleet TTFT
  p95: requests sit in the router, not in the replicas.

Lifecycle: a rule entering its firing condition emits ONE
``alert.fired`` event; while it keeps firing nothing more is emitted;
when the condition clears, ``alert.resolved`` is emitted, but only once
the alert has been active for ``cooldown_s`` (a condition oscillating
faster than the cooldown stays one alert).

The JAX engine takes its thresholds from the ``TPUFLOW_ALERT_*`` knobs;
here they are :class:`AlertEngine`'s arguments, defaulting to those
knobs' defaults. Host-only: the engine consumes snapshot dicts and its
clock is injectable.
"""

from __future__ import annotations

import importlib
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

# The recorder submodule, not the package's ``recorder()`` accessor that
# shadows it once ``tpuflow_torch.obs`` is initialised.
_rec = importlib.import_module("tpuflow_torch.obs.recorder")

# Severity ladder (ordered): page > ticket > info.
SEVERITIES = ("page", "ticket", "info")


@dataclass(frozen=True)
class Rule:
    """One declarative alert rule: identity, severity and the README
    runbook anchor an operator lands on. The firing conditions live in
    ``AlertEngine._evaluate`` (they need the engine's counter windows);
    the rows here are the operator-facing contract."""

    name: str
    severity: str
    runbook: str
    doc: str


RULES: tuple[Rule, ...] = (
    Rule(
        "slo_burn_rate", "page", "regression--alerting-runbook",
        "fast AND slow trailing windows both burning the SLO "
        "violation-rate budget",
    ),
    Rule(
        "hbm_headroom", "page", "device-observatory-runbook",
        "tightest replica's free-HBM fraction under the budget line",
    ),
    Rule(
        "goodput_drop", "ticket", "goodput--live-monitoring-runbook",
        "goodput-so-far fraction under the floor after the run settled",
    ),
    Rule(
        "health_collapse", "page", "fleet-observability-runbook",
        "worst replica health score under the floor",
    ),
    Rule(
        "stale_replicas", "ticket", "fleet-observability-runbook",
        "one or more replicas stopped answering /status",
    ),
    Rule(
        "reroute_spike", "ticket", "router--failover-runbook",
        "front-door reroute rate over the fast window past the "
        "threshold — replicas dying/stalling faster than the fleet "
        "absorbs",
    ),
    Rule(
        "ttft_router_dominance", "ticket", "distributed-tracing-runbook",
        "router-side wait per request over the fast window exceeds the "
        "knob-set fraction of fleet TTFT p95 — latency lives in the "
        "router, not the replicas",
    ),
)


# ------------------------------------------------- burn-rate math (pure)
def window_rate(
    samples: list[tuple[float, float, float]],
    now: float,
    window_s: float,
) -> float | None:
    """Violation rate over the trailing window of cumulative ``(ts,
    requests, violations)`` counter samples. None ("cannot judge", which
    never fires) when the window holds fewer than two samples or no
    request flowed across it. A counter reset (a replica restart) clamps
    to 0 instead of going negative."""
    if window_s <= 0:
        return None
    cut = now - window_s
    win = [s for s in samples if s[0] >= cut]
    if len(win) < 2:
        return None
    d_req = win[-1][1] - win[0][1]
    d_vio = win[-1][2] - win[0][2]
    if d_req <= 0:
        return None
    return max(d_vio, 0.0) / d_req


def burn_gate(
    samples: list[tuple[float, float, float]],
    now: float,
    fast_s: float,
    slow_s: float,
    budget: float,
) -> tuple[bool, dict[str, Any]]:
    """The two-window AND-gate: fires iff BOTH the fast and the slow
    trailing windows' violation rates exceed ``budget``. Either window
    empty or short never fires."""
    fast = window_rate(samples, now, fast_s)
    slow = window_rate(samples, now, slow_s)
    detail: dict[str, Any] = {"fast_rate": fast, "slow_rate": slow,
                              "budget": budget}
    if fast is None or slow is None or budget <= 0:
        return False, detail
    detail["fast_burn"] = round(fast / budget, 3)
    detail["slow_burn"] = round(slow / budget, 3)
    return fast > budget and slow > budget, detail


class AlertEngine:
    """Judge the declarative rules against snapshots, with deduplicated
    fired/resolved lifecycle events.

    ``clock`` is injectable. The thresholds are the JAX package's
    ``TPUFLOW_ALERT_*`` knobs with their defaults: ``slo_budget``
    (``_SLO_BUDGET``), ``fast_window_s`` / ``slow_window_s``
    (``_FAST_WINDOW_S`` / ``_SLOW_WINDOW_S``), ``hbm_headroom``,
    ``goodput_min``, ``min_health``, ``cooldown_s``, ``reroute_rate`` and
    ``router_ttft_frac``. :meth:`observe` is safe from the export
    server's handler threads."""

    def __init__(
        self,
        *,
        rules: tuple[Rule, ...] = RULES,
        clock: Callable[[], float] = time.monotonic,
        slo_budget: float = 0.01,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        hbm_headroom: float = 0.08,
        goodput_min: float = 0.5,
        min_health: float = 0.5,
        cooldown_s: float = 60.0,
        reroute_rate: float = 0.1,
        router_ttft_frac: float = 0.5,
    ):
        self.rules = {r.name: r for r in rules}
        self._clock = clock
        self.slo_budget = float(slo_budget)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.hbm_headroom = float(hbm_headroom)
        self.goodput_min = float(goodput_min)
        self.min_health = float(min_health)
        self.cooldown_s = float(cooldown_s)
        self.reroute_rate = float(reroute_rate)
        self.router_ttft_frac = float(router_ttft_frac)
        # Cumulative (ts, requests, violations) samples of the burn gate.
        self._samples: deque[tuple[float, float, float]] = deque()
        # (ts, router_requests, router_reroutes): the same shape, so
        # window_rate() applies verbatim.
        self._router_samples: deque[tuple[float, float, float]] = deque()
        # (ts, router_requests, router_wait_s): window_rate() over it is
        # the mean router-side wait per completed request.
        self._router_wait_samples: deque[tuple[float, float, float]] = (
            deque())
        self._active: dict[str, dict[str, Any]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------ evaluation
    def _trim(self, samples: deque, now: float, keep_s: float) -> None:
        cut = now - keep_s
        while samples and samples[0][0] < cut:
            samples.popleft()

    def _feed_counters(self, now: float, status: dict | None,
                       fleet: dict | None) -> None:
        req = vio = None
        if status is not None:
            req = status.get("serve_requests")
            vio = status.get("serve_slo_violations")
        if req is None and fleet is not None:
            req = fleet.get("requests")
            vio = fleet.get("slo_violations")
        if isinstance(req, (int, float)) and isinstance(vio, (int, float)):
            self._samples.append((now, float(req), float(vio)))
            self._trim(self._samples, now, self.slow_window_s)
        keep = max(self.fast_window_s, self.slow_window_s)
        rr = rq = None
        if status is not None:
            rq = status.get("router_requests")
            rr = status.get("router_reroutes")
        if isinstance(rq, (int, float)) and isinstance(rr, (int, float)):
            self._router_samples.append((now, float(rq), float(rr)))
            self._trim(self._router_samples, now, keep)
        rw = status.get("router_wait_s") if status is not None else None
        if isinstance(rq, (int, float)) and isinstance(rw, (int, float)):
            self._router_wait_samples.append((now, float(rq), float(rw)))
            self._trim(self._router_wait_samples, now, keep)

    def _evaluate(self, now: float, status: dict | None,
                  fleet: dict | None) -> dict[str, tuple[str, Any]]:
        """rule name -> (message, value) for every rule firing NOW."""
        firing: dict[str, tuple[str, Any]] = {}
        burns, detail = burn_gate(list(self._samples), now,
                                  self.fast_window_s, self.slow_window_s,
                                  self.slo_budget)
        if burns:
            firing["slo_burn_rate"] = (
                f"SLO burn: fast {detail['fast_burn']}x / slow "
                f"{detail['slow_burn']}x the "
                f"{self.slo_budget:.4g} violation-rate budget",
                detail.get("fast_rate"),
            )
        frac = None
        if status is not None and isinstance(status.get("hbm_used_frac"),
                                             (int, float)):
            frac = float(status["hbm_used_frac"])
        if frac is None and fleet is not None and isinstance(
                fleet.get("hbm_used_frac_max"), (int, float)):
            frac = float(fleet["hbm_used_frac_max"])
        if frac is not None and (1.0 - frac) < self.hbm_headroom:
            firing["hbm_headroom"] = (
                f"HBM headroom {1.0 - frac:.3f} under the "
                f"{self.hbm_headroom:.3f} budget line "
                f"(used {frac:.3f} of the tightest device)",
                round(1.0 - frac, 4),
            )
        if status is not None:
            gp = status.get("goodput_fraction")
            steps = status.get("steps", 0)
            if (isinstance(gp, (int, float))
                    and isinstance(steps, (int, float))
                    and steps > 0 and gp < self.goodput_min):
                firing["goodput_drop"] = (
                    f"goodput fraction {gp:.3f} under the "
                    f"{self.goodput_min:.2f} floor",
                    float(gp),
                )
        if fleet is not None:
            mh = fleet.get("min_health")
            if (isinstance(mh, (int, float)) and fleet.get("replicas", 0)
                    and mh < self.min_health):
                firing["health_collapse"] = (
                    f"worst replica health {mh:.2f} under the "
                    f"{self.min_health:.2f} floor",
                    float(mh),
                )
            stale = fleet.get("stale")
            if isinstance(stale, (int, float)) and stale > 0:
                firing["stale_replicas"] = (
                    f"{int(stale)} replica(s) stale "
                    f"(of {fleet.get('replicas', '?')})",
                    int(stale),
                )
        rrate = window_rate(list(self._router_samples), now,
                            self.fast_window_s)
        if rrate is not None and rrate > self.reroute_rate:
            firing["reroute_spike"] = (
                f"router reroute rate {rrate:.3f} over the fast "
                f"window exceeds the {self.reroute_rate:.3g} "
                f"threshold — replicas dying/stalling faster than "
                f"the fleet absorbs",
                round(rrate, 4),
            )
        # Mean router-side wait per completed request against the fleet
        # TTFT p95: past the fraction, the latency lives in admission and
        # queueing, not in the replicas.
        wrate = window_rate(list(self._router_wait_samples), now,
                            self.fast_window_s)
        p95 = None
        if fleet is not None and isinstance(fleet.get("ttft"), dict):
            p = fleet["ttft"].get("p95")
            if isinstance(p, (int, float)) and 0 < p != float("inf"):
                p95 = float(p)
        if (wrate is not None and p95 is not None
                and self.router_ttft_frac > 0
                and wrate > self.router_ttft_frac * p95):
            firing["ttft_router_dominance"] = (
                f"router-side wait {wrate:.4f}s/request over the fast "
                f"window exceeds {self.router_ttft_frac:.3g}x the "
                f"fleet TTFT p95 ({p95:.4f}s) — latency lives in the "
                f"router; pull a trace: python -m tpuflow_torch.obs trace "
                f"<request_id>",
                round(wrate, 6),
            )
        return {k: v for k, v in firing.items() if k in self.rules}

    # ------------------------------------------------------- lifecycle
    def observe(self, status: dict | None = None,
                fleet: dict | None = None) -> list[dict[str, Any]]:
        """One evaluation sweep. Returns the lifecycle transitions THIS
        sweep caused (``{"state": "fired"|"resolved", ...}``), each also
        recorded as an event. A rule already active stays silent while it
        keeps firing; a clearing rule resolves only after ``cooldown_s``
        of activity."""
        with self._lock:
            now = self._clock()
            self._feed_counters(now, status, fleet)
            firing = self._evaluate(now, status, fleet)
            transitions: list[dict[str, Any]] = []
            for name, rule in self.rules.items():
                hit = firing.get(name)
                st = self._active.get(name)
                if hit is not None and st is None:
                    message, value = hit
                    st = {"rule": name, "severity": rule.severity,
                          "runbook": rule.runbook, "message": message,
                          "value": value, "since": now}
                    self._active[name] = st
                    _rec.event("alert.fired", rule=name,
                               severity=rule.severity, runbook=rule.runbook,
                               message=message, value=value)
                    transitions.append({"state": "fired", **st})
                elif hit is not None:
                    st["message"], st["value"] = hit
                elif st is not None and now - st["since"] >= self.cooldown_s:
                    del self._active[name]
                    active_s = round(now - st["since"], 3)
                    _rec.event("alert.resolved", rule=name,
                               severity=rule.severity, runbook=rule.runbook,
                               active_s=active_s)
                    transitions.append({"state": "resolved",
                                        "active_s": active_s, **st})
            return transitions

    def active(self) -> list[dict[str, Any]]:
        """The active alerts (the ``/alerts`` body), severity-major."""
        with self._lock:
            rank = {s: i for i, s in enumerate(SEVERITIES)}
            return sorted((dict(a) for a in self._active.values()),
                          key=lambda a: (rank.get(a["severity"],
                                                  len(SEVERITIES)),
                                         a["rule"]))

    def describe(self) -> list[dict[str, str]]:
        """The rule table (the ``/alerts`` endpoint's ``rules``)."""
        return [{"rule": r.name, "severity": r.severity,
                 "runbook": r.runbook, "doc": r.doc}
                for r in self.rules.values()]


def format_transition(t: dict[str, Any]) -> str:
    """One ALERT line for the live watch."""
    if t["state"] == "fired":
        return (f"ALERT [{t['severity']}] {t['rule']} FIRED: {t['message']} "
                f"(runbook #{t['runbook']})")
    return (f"ALERT [{t['severity']}] {t['rule']} RESOLVED "
            f"after {t.get('active_s', 0.0):.1f}s")


_ENGINE: AlertEngine | None = None
_ENGINE_LOCK = threading.Lock()


def engine() -> AlertEngine:
    """The process's shared alert engine, at the default thresholds (the
    export server's ``/alerts`` route judges it against each snapshot it
    serves unless given another)."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = AlertEngine()
        return _ENGINE


def reset() -> None:
    """Drop the shared engine (tests)."""
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = None
