"""The port's alert engine (``tpuflow_torch/obs/alerts.py``), its
``/alerts`` route and the timeline card's Alerts section held to the JAX
package's (oracle ``tests/test_alerts.py``).

Each case of the JAX file feeds the same snapshot script through both
engines under the same injected clock (the JAX engine's thresholds passed
as arguments too, or from its knobs where the case tests a knob) and
returns the transitions, the ``active()`` lists and the ``alert.*``
events each package's recorder wrote: they must be EQUAL, the program
name in the ``ttft_router_dominance`` message aside (``python -m
tpuflow_torch.obs trace`` where the JAX engine names ``python -m
tpuflow.obs trace``). The burn gate runs the JAX file's seeded property
sweep against its oracle on both packages; ``/alerts`` answers the JAX
server's JSON over the same snapshots; the card's HTML is byte-equal."""

import collections
import importlib
import json
import os
import random
import urllib.request

import pytest

from tpuflow_torch import obs as tobs
from tpuflow_torch.flow.cards import CardBuffer as TCard
from tpuflow_torch.flow.cards import timeline_card as tcard
from tpuflow_torch.obs import alerts as talerts
from tpuflow_torch.obs.export import MetricsServer as TServer

jobs = importlib.import_module("tpuflow.obs")
jalerts = importlib.import_module("tpuflow.obs.alerts")
JServer = importlib.import_module("tpuflow.obs.export").MetricsServer
jcards = importlib.import_module("tpuflow.flow.cards")

_KNOBS = ("TPUFLOW_ALERT_SLO_BUDGET", "TPUFLOW_ALERT_FAST_WINDOW_S",
          "TPUFLOW_ALERT_SLOW_WINDOW_S", "TPUFLOW_ALERT_HBM_HEADROOM",
          "TPUFLOW_ALERT_GOODPUT_MIN", "TPUFLOW_ALERT_MIN_HEALTH",
          "TPUFLOW_ALERT_COOLDOWN_S", "TPUFLOW_ALERT_REROUTE_RATE",
          "TPUFLOW_ALERT_ROUTER_TTFT_FRAC")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _engine(mod, clock, **kw):
    """``tests/test_alerts.py::_engine`` on package ``mod``."""
    defaults = dict(slo_budget=0.01, fast_window_s=300.0,
                    slow_window_s=3600.0, hbm_headroom=0.08,
                    goodput_min=0.5, min_health=0.5, cooldown_s=60.0)
    defaults.update(kw)
    return mod.AlertEngine(clock=clock, **defaults)


def _port_name(x):
    """JSON-able ``x`` with the JAX program name written as the port's."""
    return json.loads(json.dumps(x).replace("python -m tpuflow.obs",
                                            "python -m tpuflow_torch.obs"))


@pytest.fixture
def recorders(tmp_path, monkeypatch):
    """Each package's recorder on a directory of its own; yields a
    function returning each one's ``alert.*`` events (a multiset), ts and
    pid left out."""
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    dirs = {"jax": str(tmp_path / "jax"), "torch": str(tmp_path / "torch")}
    jobs.configure(dirs["jax"], proc=0)
    tobs.configure(dirs["torch"], proc=0)

    def events():
        out = {}
        for name, o in (("jax", jobs), ("torch", tobs)):
            o.flush()
            evs = []
            for f in sorted(os.listdir(dirs[name])):
                if f.startswith("events."):
                    evs += [e for e in o.read_events(
                        os.path.join(dirs[name], f))
                        if e["name"].startswith("alert.")]
            out[name] = collections.Counter(
                json.dumps({k: v for k, v in e.items()
                            if k not in ("ts", "pid")}, sort_keys=True)
                for e in evs)
        return out

    yield events
    jobs.configure(None)
    tobs.configure(None)


def _drive(script, **kw):
    """Run ``script(eng, clock)`` (a generator of observe() argument
    dicts, advancing the clock itself) on both engines; returns each
    package's [(clock, transitions)] and final ``active()``."""
    out = {}
    for name, mod in (("jax", jalerts), ("torch", talerts)):
        clock = FakeClock()
        eng = _engine(mod, clock, **kw)
        seq = [(clock.t, eng.observe(**args)) for args in script(clock)]
        out[name] = [seq, eng.active()]
    return out


def _same(got):
    """The port's observations, held equal to the JAX package's."""
    torch_side = _port_name(got["torch"])
    assert _port_name(got["jax"]) == torch_side
    return torch_side


# -------------------------------------------------- burn-rate math
def test_window_rate_short_and_empty_windows_never_judge():
    cases = [([], 100.0, 300.0), ([(100.0, 10, 1)], 100.0, 300.0),
             ([(90.0, 10, 1), (100.0, 10, 1)], 100.0, 300.0),
             ([(0.0, 0, 0), (10.0, 100, 5)], 1000.0, 300.0),
             ([(90.0, 100, 50), (100.0, 200, 0)], 100.0, 300.0),
             ([(90.0, 100, 5), (100.0, 200, 10)], 100.0, 0.0)]
    got = [talerts.window_rate(*c) for c in cases]
    assert got == [jalerts.window_rate(*c) for c in cases]
    assert got == [None, None, None, None, 0.0, None]


def test_burn_gate_requires_both_windows():
    scripts = [
        [(0.0, 0, 0), (600.0, 1000, 900), (3300.0, 2000, 900),
         (3590.0, 3000, 900)],
        [(0.0, 0, 0), (3400.0, 1_000_000, 0), (3590.0, 1_000_100, 90)],
        [(0.0, 0, 0), (1800.0, 1000, 50), (3400.0, 2000, 100),
         (3590.0, 2100, 106)],
    ]
    for s in scripts:
        for budget in (0.01, 0.0):
            args = (s, 3600.0, 300.0, 3600.0, budget)
            assert talerts.burn_gate(*args) == jalerts.burn_gate(*args)
    assert [talerts.burn_gate(s, 3600.0, 300.0, 3600.0, 0.01)[0]
            for s in scripts] == [False, False, True]


def test_burn_gate_property_vs_oracle():
    """The JAX file's seeded sweep on both packages: each gate equals the
    brute-force oracle and the other package's gate, details included."""

    def oracle_rate(samples, now, win):
        inside = [s for s in samples if s[0] >= now - win]
        if len(inside) < 2:
            return None
        dr = inside[-1][1] - inside[0][1]
        dv = inside[-1][2] - inside[0][2]
        return None if dr <= 0 else max(dv, 0.0) / dr

    rng = random.Random(16)
    for _ in range(300):
        n = rng.randrange(0, 8)
        t = req = vio = 0.0
        samples = []
        for _ in range(n):
            t += rng.uniform(1.0, 2000.0)
            dr = rng.choice([0, 0, rng.randrange(1, 500)])
            req += dr
            vio += rng.randrange(0, dr + 1) if dr else 0
            samples.append((t, req, vio))
        now = t + rng.uniform(0.0, 500.0)
        fast_s = rng.choice([60.0, 300.0, 900.0])
        slow_s = rng.choice([900.0, 3600.0])
        budget = rng.choice([0.001, 0.01, 0.1])
        args = (samples, now, fast_s, slow_s, budget)
        fired, d = talerts.burn_gate(*args)
        assert (fired, d) == jalerts.burn_gate(*args)
        f, s = oracle_rate(samples, now, fast_s), oracle_rate(
            samples, now, slow_s)
        assert fired == (f is not None and s is not None and f > budget
                         and s > budget)
        assert d["fast_rate"] == f and d["slow_rate"] == s


# ---------------------------------------------------------- lifecycle
def test_lifecycle_fired_dedup_cooldown_resolved(recorders):
    bad = {"goodput_fraction": 0.2, "steps": 100}
    good = {"goodput_fraction": 0.9, "steps": 100}

    def script(clock):
        for dt, snap in ((0.0, good), (10.0, bad), (10.0, bad),
                         (10.0, good), (10.0, bad), (40.0, good),
                         (10.0, good)):
            clock.t += dt
            yield {"status": snap}

    seq, active = _same(_drive(script, cooldown_s=60.0))
    assert [(t, x["rule"], x["state"]) for t, xs in seq for x in xs] == [
        (10.0, "goodput_drop", "fired"), (80.0, "goodput_drop", "resolved")]
    assert active == []
    ev = recorders()
    assert ev["jax"] == ev["torch"] and sum(ev["torch"].values()) == 2


def test_goodput_rule_needs_settled_run(recorders):
    def script(clock):
        yield {"status": {"goodput_fraction": 0.0, "steps": 0}}
        yield {"status": {"goodput_fraction": 0.1, "steps": 1}}

    seq, _ = _same(_drive(script))
    assert [[x["rule"] for x in xs] for _, xs in seq] == [[],
                                                          ["goodput_drop"]]
    ev = recorders()
    assert ev["jax"] == ev["torch"]


def test_hbm_and_fleet_rules_with_severity_and_runbook(recorders):
    def script(clock):
        yield {"fleet": {"replicas": 3, "stale": 1, "min_health": 0.25,
                         "hbm_used_frac_max": 0.95}}
        clock.t += 1.0
        yield {"fleet": {"replicas": 3, "stale": 0, "min_health": 1.0,
                         "hbm_used_frac_max": 0.5}}
        yield {"status": {"hbm_used_frac": 0.99},
               "fleet": {"hbm_used_frac_max": 0.1}}

    got = _drive(script, cooldown_s=0.0)
    seq, active = _same(got)
    assert {x["rule"] for x in seq[0][1]} == {
        "hbm_headroom", "health_collapse", "stale_replicas"}
    assert sorted(x["state"] for x in seq[1][1]) == ["resolved"] * 3
    # The status key wins over the fleet's: the tightest is this process.
    assert [x["rule"] for x in seq[2][1]] == ["hbm_headroom"]
    assert [a["severity"] for a in active] == ["page"]
    ev = recorders()
    assert ev["jax"] == ev["torch"] and sum(ev["torch"].values()) == 7


def test_reroute_spike_rate_threshold_and_lifecycle(recorders):
    def script(clock):
        for dt, rq, rr in ((0.0, 0, 0), (10.0, 100, 1), (10.0, 200, 31),
                           (1.0, 210, 32), (10.0, 2000, 33)):
            clock.t += dt
            yield {"status": {"router_requests": rq,
                              "router_reroutes": rr}}

    seq, active = _same(_drive(script, cooldown_s=0.0, reroute_rate=0.1))
    assert [[(x["rule"], x["state"]) for x in xs] for _, xs in seq] == [
        [], [], [("reroute_spike", "fired")], [],
        [("reroute_spike", "resolved")]]
    assert seq[2][1][0]["value"] == round(31 / 200, 4)
    assert active == []
    ev = recorders()
    assert ev["jax"] == ev["torch"]


def test_ttft_router_dominance_threshold_and_lifecycle(recorders):
    fleet = {"ttft": {"p50": 0.1, "p95": 0.2, "p99": 0.3}}

    def script(clock):
        for dt, rq, rw in ((0.0, 0, 0.0), (10.0, 100, 2.0),
                           (10.0, 200, 25.0), (1.0, 210, 26.5),
                           (10.0, 2000, 27.0)):
            clock.t += dt
            yield {"status": {"router_requests": rq, "router_wait_s": rw},
                   "fleet": fleet}

    seq, _ = _same(_drive(script, cooldown_s=0.0, router_ttft_frac=0.5))
    fired = seq[2][1]
    assert [x["rule"] for x in fired] == ["ttft_router_dominance"]
    assert "python -m tpuflow_torch.obs trace" in fired[0]["message"]
    assert fired[0]["value"] == pytest.approx(0.125)
    assert [x["state"] for x in seq[4][1]] == ["resolved"]
    ev = recorders()
    assert _port_name(list(ev["jax"].elements())) == list(
        ev["torch"].elements())


def test_ttft_router_dominance_needs_flow_p95_and_positive_frac():
    fleet = {"ttft": {"p95": 0.2}}

    def undefined(clock):
        # No request flow between sweeps, then flow without a usable p95.
        for _ in range(3):
            clock.t += 10.0
            yield {"status": {"router_requests": 500,
                              "router_wait_s": 400.0}, "fleet": fleet}
        for bad in (None, {}, {"ttft": {"p95": 0.0}},
                    {"ttft": {"p95": float("inf")}}, {"ttft": "junk"}):
            clock.t += 10.0
            yield {"status": {"router_requests": 500 + int(clock.t),
                              "router_wait_s": 400.0 + 10.0 * clock.t},
                   "fleet": bad}

    def disarmed(clock):
        # Flagrant dominance under a zeroed fraction; then a status
        # without the wait counter.
        yield {"status": {"router_requests": 0, "router_wait_s": 0.0},
               "fleet": fleet}
        clock.t += 10.0
        yield {"status": {"router_requests": 100, "router_wait_s": 99.0},
               "fleet": fleet}
        clock.t += 10.0
        yield {"status": {"router_requests": 200}, "fleet": fleet}

    for script, frac in ((undefined, 0.5), (disarmed, 0.0)):
        seq, active = _same(_drive(script, cooldown_s=0.0,
                                   router_ttft_frac=frac))
        assert all(xs == [] for _, xs in seq) and active == []


def test_ttft_router_dominance_knob_default(monkeypatch):
    """The JAX engine's knob and the port's argument give the same
    engine; with no knob set, every port default is the JAX knob's."""
    monkeypatch.setenv("TPUFLOW_ALERT_ROUTER_TTFT_FRAC", "0.25")
    j = _engine(jalerts, FakeClock())
    t = _engine(talerts, FakeClock(), router_ttft_frac=0.25)
    assert j.router_ttft_frac == t.router_ttft_frac == 0.25
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    j, t = jalerts.AlertEngine(), talerts.AlertEngine()
    names = ("slo_budget", "fast_window_s", "slow_window_s", "hbm_headroom",
             "goodput_min", "min_health", "cooldown_s", "reroute_rate",
             "router_ttft_frac")
    assert [getattr(t, n) for n in names] == [getattr(j, n) for n in names]
    assert t.describe() == j.describe()
    assert talerts.RULES == tuple(talerts.Rule(*(getattr(r, f) for f in (
        "name", "severity", "runbook", "doc"))) for r in jalerts.RULES)
    assert talerts.SEVERITIES == jalerts.SEVERITIES


def test_reroute_spike_never_fires_without_request_flow():
    def script(clock):
        for _ in range(3):
            clock.t += 10.0
            yield {"status": {"router_requests": 500,
                              "router_reroutes": 499}}
        clock.t += 10.0
        yield {"status": {"goodput_fraction": 0.9, "steps": 5}}

    seq, _ = _same(_drive(script, cooldown_s=0.0, reroute_rate=0.0))
    assert all(xs == [] for _, xs in seq)


def test_slo_burn_fires_through_engine_and_emits_events(recorders):
    def script(clock):
        for i in range(13):
            clock.t = 300.0 * i
            yield {"status": {"serve_requests": 1000 * i,
                              "serve_slo_violations": 50 * i}}
        for i in range(13, 26):
            clock.t = 300.0 * i
            yield {"status": {"serve_requests": 1000 * i,
                              "serve_slo_violations": 50 * 12}}
        # The fleet's counters feed the gate when the status has none.
        clock.t += 300.0
        yield {"fleet": {"requests": 99_999, "slo_violations": 9_999}}

    seq, _ = _same(_drive(script, cooldown_s=0.0))
    assert [(x["rule"], x["state"]) for _, xs in seq for x in xs] == [
        ("slo_burn_rate", "fired"), ("slo_burn_rate", "resolved"),
        ("slo_burn_rate", "fired")]
    ev = recorders()
    assert ev["jax"] == ev["torch"]
    kinds = collections.Counter(json.loads(e)["name"]
                                for e in ev["torch"].elements())
    assert kinds == {"alert.fired": 2, "alert.resolved": 1}


# ------------------------------------------------------------ endpoint
def test_alerts_endpoint_serves_active_and_rules():
    """The same snapshot script and clock through a JAX and a port
    server: equal ``/alerts`` JSON at every scrape; ``/status`` still
    answers beside it; without an engine the route answers 404 on
    both."""
    snap = {"goodput_fraction": 0.1, "steps": 50}
    clocks = {"jax": FakeClock(), "torch": FakeClock()}
    servers = {
        "jax": JServer(port=0, snapshot_fn=lambda: dict(snap),
                       alert_engine=_engine(jalerts, clocks["jax"],
                                            cooldown_s=0.0)),
        "torch": TServer(port=0, snapshot_fn=lambda: dict(snap),
                         alert_engine=_engine(talerts, clocks["torch"],
                                              cooldown_s=0.0)),
    }
    bare = {"jax": JServer(port=0, snapshot_fn=lambda: dict(snap)),
            "torch": TServer(port=0, snapshot_fn=lambda: dict(snap))}
    try:
        def get(name, path, srv=servers):
            with urllib.request.urlopen(srv[name].url + path,
                                        timeout=5) as r:
                return json.loads(r.read().decode())

        bodies = []
        for change in ({}, {}, {"goodput_fraction": 0.95}):
            snap.update(change)
            for c in clocks.values():
                c.t += 1.0
            got = {n: get(n, "/alerts") for n in servers}
            assert got["jax"] == got["torch"]
            bodies.append(got["torch"])
        assert [[a["rule"] for a in b["active"]] for b in bodies] == [
            ["goodput_drop"], ["goodput_drop"], []]
        assert len(bodies[0]["rules"]) == 7
        assert get("torch", "/status")["steps"] == 50
        for name in bare:
            with pytest.raises(urllib.error.HTTPError) as e:
                get(name, "/alerts", bare)
            assert e.value.code == 404
    finally:
        for s in (*servers.values(), *bare.values()):
            s.close()


def test_start_export_answers_alerts_from_the_process_engine():
    """``start_export`` with no engine serves the process engine
    ``alerts.engine()`` (the JAX ``maybe_start_from_env`` does the
    same); a given engine replaces it."""
    from tpuflow_torch.obs import export

    talerts.reset()
    export.stop()
    try:
        srv = export.start_export(0)
        assert srv._httpd._tpuflow_alerts is talerts.engine()
        with urllib.request.urlopen(srv.url + "/alerts", timeout=5) as r:
            body = json.loads(r.read().decode())
        assert body["active"] == [] and len(body["rules"]) == 7
        export.stop()
        eng = talerts.AlertEngine()
        assert export.start_export(0, alert_engine=eng)._httpd.\
            _tpuflow_alerts is eng
    finally:
        export.stop()
        talerts.reset()


def test_timeline_card_alerts_section():
    """The same alert events through both cards: byte-equal HTML, with
    and without the section."""
    events = [
        {"kind": "event", "name": "alert.fired", "ts": 1.0,
         "rule": "hbm_headroom", "severity": "page",
         "message": "HBM headroom 0.05 under the 0.08 budget line" * 3,
         "runbook": "device-observatory-runbook"},
        {"kind": "event", "name": "alert.fired", "ts": 2.0,
         "rule": "stale_replicas", "severity": "ticket",
         "message": "1 replica(s) stale (of 3)",
         "runbook": "fleet-observability-runbook"},
        {"kind": "event", "name": "alert.resolved", "ts": 3.0,
         "rule": "hbm_headroom", "severity": "page", "active_s": 2.0},
        {"kind": "event", "name": "alert.fired", "ts": 4.0,
         "rule": "hbm_headroom"},
        {"kind": "span", "name": "train.compile", "ts": 0.5, "dur_s": 1.0,
         "proc": 0},
    ]
    for evs in (events, [e for e in events if e["kind"] == "span"],
                events[2:3]):
        t, j = TCard(), jcards.CardBuffer()
        tcard(t, evs)
        jcards.timeline_card(j, evs)
        assert t.render_html("run") == j.render_html("run")
    html = t.render_html("run")
    assert "Alerts" in html and "STILL ACTIVE" not in html
    t = TCard()
    tcard(t, events)
    html = t.render_html("run")
    assert "hbm_headroom" in html and "STILL ACTIVE" in html
    assert "#fleet-observability-runbook" in html


def test_module_engine_singleton_and_reset():
    talerts.reset()
    try:
        e = talerts.engine()
        assert e is talerts.engine() and isinstance(e, talerts.AlertEngine)
        talerts.reset()
        assert talerts.engine() is not e
    finally:
        talerts.reset()


def test_format_transition_lines():
    fired = {"state": "fired", "rule": "hbm_headroom",
             "severity": "page", "runbook": "device-observatory-runbook",
             "message": "HBM headroom 0.050 under the 0.080 budget line"}
    res = {"state": "resolved", "rule": "hbm_headroom",
           "severity": "page", "active_s": 12.34}
    for t in (fired, res, {"state": "resolved", "rule": "r",
                           "severity": "info"}):
        assert talerts.format_transition(t) == jalerts.format_transition(t)
    assert talerts.format_transition(fired).startswith(
        "ALERT [page] hbm_headroom FIRED:")
    assert "RESOLVED after 12.3s" in talerts.format_transition(res)


def test_every_alert_case_is_ported():
    """The JAX file's tests, one for one."""
    src = open(os.path.join(os.path.dirname(__file__), "test_alerts.py"),
               encoding="utf-8").read()
    jax_cases = {line[len("def test_"):].split("(")[0]
                 for line in src.splitlines() if line.startswith("def test_")}
    assert len(jax_cases) == 16
    mine = {n[len("test_"):] for n in globals() if n.startswith("test_")}
    assert jax_cases <= mine
