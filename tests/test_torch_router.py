"""The port's front-door router (``tpuflow_torch/infer/router.py``) and the
HTTP faces beside it (``infer/frontdoor.py``: ``FrontDoor``, the gateway's
trace half) held to the JAX package's.

Each case of ``tests/test_router.py`` runs here once on each package: the
same fake fleet snapshots, a scripted ``forward_fn`` and, for the router's
state machine, an injected clock (a step clock: every call advances it by
``STEP`` seconds, so both packages read the same times when they call it
in the same order) and an injected sleep. A case returns what it
observed: the sequence of (replica, timeout) forwards, the sleeps,
``stats()``, the answers and, for traced requests, the spans with their
ids replaced by their order of appearance and their wall-clock times
dropped. The two packages' observations must be EQUAL. Cases whose
threads race a real clock (a grow thread, a held forward, a hung
snapshot) compare the counters of ``stats()`` and leave out the wait
seconds and the budget, which depend on where the race falls. The JAX
side takes its knobs by ``monkeypatch.setenv``, the port its arguments.

Besides: ``prefix_digests`` bit-equal to the JAX router's and to
``kv_store.chain_digests``; ``launch_command`` resolves an existing
script from any working directory.
"""

import importlib
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpuflow_torch import obs as tobs
from tpuflow_torch.infer import frontdoor as tfront
from tpuflow_torch.infer import kv_store as tkv
from tpuflow_torch.infer import router as trouter
from tpuflow_torch.obs import fleet as tfleet
from tpuflow_torch.obs import goodput as tgoodput
from tpuflow_torch.obs import export as texport
from tpuflow_torch.obs import trace as ttrace

jrouter = importlib.import_module("tpuflow.infer.router")
jfront = importlib.import_module("tpuflow.infer.frontdoor")
jfleet = importlib.import_module("tpuflow.obs.fleet")
jtrace = importlib.import_module("tpuflow.obs.trace")
jgoodput = importlib.import_module("tpuflow.obs.goodput")
jexport = importlib.import_module("tpuflow.obs.export")
jserve = importlib.import_module("tpuflow.infer.serve")
jobs = importlib.import_module("tpuflow.obs")

STEP = 0.01  # seconds the step clock advances a call

# The router counters whose values do not depend on where a race between
# threads falls.
COUNTS = ("router_requests", "router_accepted", "router_rejected",
          "router_retries", "router_reroutes", "router_affinity_hits",
          "router_drains", "router_ships", "router_ship_fallbacks",
          "router_inflight", "router_queue_depth", "router_dropped")


class Pkg:
    """One package's router, front door, trace and fleet modules, and how
    its knobs are set: the JAX package's through the environment, the
    port's as arguments."""

    def __init__(self, name, monkeypatch):
        self.name = name
        self.jax = name == "jax"
        self.router = jrouter if self.jax else trouter
        self.front = jfront if self.jax else tfront
        self.trace = jtrace if self.jax else ttrace
        self.fleet = jfleet if self.jax else tfleet
        self.mp = monkeypatch

    def door(self, router, trace_dir=None):
        if self.jax:
            if trace_dir:
                self.mp.setenv("TPUFLOW_TRACE_DIR", trace_dir)
            return self.front.FrontDoor(router, host="127.0.0.1", port=0)
        return self.front.FrontDoor(router, host="127.0.0.1", port=0,
                                    trace_dir=trace_dir)

    def gateway(self, engine, trace_dir=None, **kw):
        if self.jax:
            if trace_dir:
                self.mp.setenv("TPUFLOW_TRACE_DIR", trace_dir)
            return self.front.ReplicaGateway(engine, **kw)
        return self.front.ReplicaGateway(engine, trace_dir=trace_dir, **kw)


@pytest.fixture
def pkgs(monkeypatch):
    for k in ("TPUFLOW_TRACE", "TPUFLOW_TRACE_SAMPLE", "TPUFLOW_TRACE_DIR",
              "TPUFLOW_FLEET_REPLICA_ID", "TPUFLOW_OBS_DIR"):
        monkeypatch.delenv(k, raising=False)
    return [Pkg("jax", monkeypatch), Pkg("torch", monkeypatch)]


class StepClock:
    def __init__(self, t=100.0):
        self.t = t
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            self.t += STEP
            return self.t


class Log:
    """What a case observed: forwards, sleeps and free-form notes."""

    def __init__(self):
        self.forwards = []
        self.sleeps = []
        self._lock = threading.Lock()

    def wrap(self, forward):
        def fwd(row, request, timeout_s):
            with self._lock:
                self.forwards.append((row.get("id"), timeout_s))
            return forward(row, request, timeout_s)

        return fwd


def _row(rid, *, pages=100, health=1.0, trend=0, stale=False,
         draining=False, url=None):
    row = {"id": rid, "stale": stale, "health": health,
           "queue_trend": trend, "serve_pages_free": pages}
    if draining:
        row["serve_draining"] = True
    if url:
        row["generate_url"] = url
    return row


def _snap(rows, **fleet):
    return {"ts": 0.0, "fleet": dict(fleet), "replicas": rows}


def _router(P, state, forward, log, **kw):
    """``tests/test_router.py::_router`` on package ``P``: a router over
    a mutable row list, tuned for fast tests, with the step clock and the
    logged sleep unless the case passes its own."""
    kw.setdefault("page_size", 8)
    kw.setdefault("timeout_s", 5.0)
    kw.setdefault("retries", 2)
    kw.setdefault("backoff_s", 0.01)
    kw.setdefault("queue_timeout_s", 1.0)
    kw.setdefault("refresh_s", 0.0)
    kw.setdefault("wait_tick_s", 0.01)
    kw.setdefault("clock", StepClock())
    kw.setdefault("sleep", log.sleeps.append)
    return P.router.Router(lambda: _snap(state["rows"]), log.wrap(forward),
                           **kw)


def _echo(row, request, timeout_s):
    return {"replica": row["id"], "tokens": [1, 2]}


def _seen(log, r, exact=True, **out):
    """A case's observation: forwards, sleeps, stats (all of them, or the
    race-free counters) and what else the case returns."""
    st = r.stats()
    if not exact:
        st = {k: st[k] for k in COUNTS}
        log.forwards.sort(key=repr)
    return {"forwards": log.forwards, "sleeps": log.sleeps, "stats": st,
            **out}


def _norm_spans(spans):
    """Spans with their ids as ordinals (first appearance) and without the
    wall-clock fields (``ts``; the durations of the spans timed by
    ``time.time()``)."""
    ids = {}

    def oid(v):
        if v is None:
            return None
        return ids.setdefault(v, f"#{len(ids)}")

    out = []
    for s in spans:
        s = dict(s)
        s.pop("ts", None)
        if s["name"] in ("router.ingress", "gateway.hold") or (
                "dur_s" not in s):
            s.pop("dur_s", None)
        s["span"] = oid(s["span"])
        s["parent"] = oid(s.get("parent"))
        out.append(s)
    return out


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _FakeHandle:
    def __init__(self, tokens, state="done"):
        self.state = state
        self.tokens = tokens
        self.finish_reason = "budget"
        self.drained = False


class _FakeEngine:
    """Enough engine for a gateway: submit echoes the prompt length and
    the budget."""

    max_slots = 4
    pool = None

    def __init__(self):
        self.submits = 0
        self.kw = None

    def submit(self, prompt, *, max_new_tokens, eos_id=None, **kw):
        self.submits += 1
        self.kw = kw
        return _FakeHandle([int(len(prompt)), int(max_new_tokens)])


# ======================================================== the cases
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


@case
def pages_needed_and_route_score(P):
    r = P.router
    got = [r.pages_needed(8, 8, 8), r.pages_needed(9, 8, 8),
           r.pages_needed(1, 1, 8), r.route_score(1.0, 0, 0.5),
           r.route_score(1.0, 2, 0.5), r.route_score(0.8, 1, 0.5),
           r.route_score(-0.5, 0, 0.5),
           r.row_tier_pages({"serve_pages_host": 3, "serve_pages_disk": 4}),
           r.row_tier_pages({"serve_pages_host": "x"})]
    assert got[:3] == [2, 3, 1] and got[4] == 0.25 and got[6] == 0.0
    return got


@case
def prefix_digests_bit_equal_to_pagepool(P):
    prompt = np.arange(10, dtype=np.int64)  # the int32 cast matters
    ours = P.router.prefix_digests(prompt, 4)
    assert ours == jserve.PagePool(n_pages=6, page_size=4).prefix_digests(
        prompt)
    assert len(ours) == 2 and P.router.prefix_digests([1, 2, 3], 4) == []
    return [d.hex() for d in ours] + [P.router.prefix_digests(prompt, 0)]


@case
def admission_waits_for_budget_then_admits(P):
    log, state = Log(), {"rows": [_row("a", pages=1)]}
    r = _router(P, state, _echo, log)

    def grow():
        time.sleep(0.1)
        state["rows"] = [_row("a", pages=8)]

    th = threading.Thread(target=grow, daemon=True)
    th.start()
    t0 = time.monotonic()
    resp = r.route({"id": "q1", "prompt": list(range(8)),
                    "max_new_tokens": 8})
    waited = time.monotonic() - t0 >= 0.08
    th.join(5.0)
    assert resp["replica"] == "a" and waited
    return _seen(log, r, exact=False, resp=resp)


@case
def admission_timeout_is_explicit_503(P):
    log, state = Log(), {"rows": [_row("a", pages=1)]}
    r = _router(P, state, _echo, log, queue_timeout_s=0.15)
    with pytest.raises(P.router.FleetBusy) as e:
        r.route({"id": "q1", "prompt": list(range(8)), "max_new_tokens": 8})
    assert r.stats()["router_rejected"] == 1
    return _seen(log, r, err=str(e.value))


@case
def inflight_pages_charged_against_budget(P):
    log, state = Log(), {"rows": [_row("a", pages=3)]}
    hold, started = threading.Event(), threading.Event()

    def forward(row, request, timeout_s):
        if request["id"] == "q1":
            started.set()
            assert hold.wait(5.0)
        return {"replica": row["id"]}

    r = _router(P, state, forward, log, queue_timeout_s=2.0,
                clock=time.monotonic)
    out = {}

    def go(rid):
        out[rid] = r.route({"id": rid, "prompt": list(range(8)),
                            "max_new_tokens": 8})

    t1 = threading.Thread(target=go, args=("q1",), daemon=True)
    t1.start()
    assert started.wait(5.0)
    t2 = threading.Thread(target=go, args=("q2",), daemon=True)
    t2.start()
    time.sleep(0.1)
    blocked = "q2" not in out  # 3 - 2 charged = 1 free < 2 needed
    hold.set()
    t1.join(5.0)
    t2.join(5.0)
    assert blocked and not t1.is_alive() and not t2.is_alive()
    return _seen(log, r, exact=False, out=out, blocked=blocked)


@case
def pick_maximizes_health_times_trend_decay(P):
    log = Log()
    state = {"rows": [_row("hot", health=1.0, trend=2),
                      _row("calm", health=0.9, trend=0)]}
    r = _router(P, state, _echo, log, trend_decay=0.5)
    resp = r.route({"id": "q1", "prompt": [1, 2], "max_new_tokens": 1})
    assert resp["replica"] == "calm"
    return _seen(log, r, resp=resp)


@case
def pick_excludes_stale_draining_and_unhealthy(P):
    log = Log()
    state = {"rows": [_row("dead", stale=True),
                      _row("leaving", draining=True),
                      _row("sick", health=0.1), _row("ok", health=0.6)]}
    r = _router(P, state, _echo, log, min_health=0.25)
    resps = [r.route({"id": f"q{k}", "prompt": [1, 2], "max_new_tokens": 1})
             for k in range(3)]
    assert {x["replica"] for x in resps} == {"ok"}
    assert r.stats()["router_drains"] == 1
    return _seen(log, r, resps=resps)


@case
def affinity_routes_shared_prefix_to_same_replica(P):
    log, pre = Log(), list(range(8))
    state = {"rows": [_row("a", health=0.5)]}
    r = _router(P, state, _echo, log)
    r.route({"id": "q1", "prompt": pre + [9], "max_new_tokens": 1})
    state["rows"] = [_row("a", health=0.5), _row("b", health=1.0)]
    r2 = r.route({"id": "q2", "prompt": pre + [7], "max_new_tokens": 1})
    r3 = r.route({"id": "q3", "prompt": [50, 51, 52], "max_new_tokens": 1})
    assert r2["replica"] == "a" and r3["replica"] == "b"
    assert r.stats()["router_affinity_hits"] == 1
    return _seen(log, r)


@case
def affinity_disabled_follows_score(P):
    log, pre = Log(), list(range(8))
    state = {"rows": [_row("a", health=0.5)]}
    r = _router(P, state, _echo, log, affinity=False)
    r.route({"id": "q1", "prompt": pre + [9], "max_new_tokens": 1})
    state["rows"] = [_row("a", health=0.5), _row("b", health=1.0)]
    resp = r.route({"id": "q2", "prompt": pre + [7], "max_new_tokens": 1})
    assert resp["replica"] == "b"
    return _seen(log, r)


@case
def retry_reroutes_to_surviving_replica(P):
    log = Log()
    state = {"rows": [_row("dying", health=1.0), _row("live", health=0.9)]}

    def forward(row, request, timeout_s):
        if row["id"] == "dying":
            raise RuntimeError("connection reset")
        return {"replica": row["id"], "tokens": [3]}

    r = _router(P, state, forward, log)
    resp = r.route({"id": "q1", "prompt": [1, 2], "max_new_tokens": 1})
    assert resp["replica"] == "live" and log.sleeps == [pytest.approx(0.01)]
    s = r.stats()
    assert s["router_retries"] == 1 and s["router_reroutes"] == 1
    return _seen(log, r, resp=resp)


@case
def retries_exhausted_raises_busy_with_exponential_backoff(P):
    log = Log()

    def forward(row, request, timeout_s):
        raise RuntimeError("refused")

    r = _router(P, {"rows": [_row("a")]}, forward, log, retries=2)
    with pytest.raises(P.router.FleetBusy) as e:
        r.route({"id": "q1", "prompt": [1, 2], "max_new_tokens": 1})
    assert log.sleeps == [pytest.approx(0.01), pytest.approx(0.02)]
    assert r.stats()["router_retries"] == 3
    return _seen(log, r, err=str(e.value))


@case
def hedge_skips_first_retry_backoff(P):
    log, calls = Log(), []

    def forward(row, request, timeout_s):
        calls.append(row["id"])
        if len(calls) == 1:
            raise RuntimeError("reset")
        return {"replica": row["id"]}

    r = _router(P, {"rows": [_row("a"), _row("b")]}, forward, log,
                hedge=True)
    r.route({"id": "q1", "prompt": [1, 2], "max_new_tokens": 1})
    assert log.sleeps == []
    return _seen(log, r)


@case
def failed_replica_backs_off_for_subsequent_requests(P):
    log, calls = Log(), []

    def forward(row, request, timeout_s):
        calls.append(row["id"])
        if row["id"] == "flaky" and len(calls) == 1:
            raise RuntimeError("reset")
        return {"replica": row["id"]}

    r = _router(P, {"rows": [_row("flaky"), _row("good", health=0.8)]},
                forward, log, backoff_s=5.0)
    r.route({"id": "q1", "prompt": [1, 2], "max_new_tokens": 1})
    resp = r.route({"id": "q2", "prompt": [1, 2], "max_new_tokens": 1})
    assert resp["replica"] == "good"
    return _seen(log, r)


@case
def idempotent_replay_by_request_id(P):
    log = Log()

    def forward(row, request, timeout_s):
        return {"replica": row["id"], "tokens": [7]}

    r = _router(P, {"rows": [_row("a")]}, forward, log)
    req = {"id": "q1", "prompt": [1, 2], "max_new_tokens": 1}
    first, second = r.route(req), r.route(dict(req))
    assert first == second and len(log.forwards) == 1
    return _seen(log, r, first=first)


@case
def concurrent_duplicate_waits_for_original(P):
    log, hold = Log(), threading.Event()

    def forward(row, request, timeout_s):
        assert hold.wait(5.0)
        return {"tokens": [9]}

    r = _router(P, {"rows": [_row("a")]}, forward, log)
    req = {"id": "q1", "prompt": [1, 2], "max_new_tokens": 1}
    out = []
    ts = [threading.Thread(target=lambda: out.append(r.route(dict(req))),
                           daemon=True) for _ in range(2)]
    for t in ts:
        t.start()
    time.sleep(0.1)
    hold.set()
    for t in ts:
        t.join(5.0)
    assert len(log.forwards) == 1 and out[0] == out[1] == {"tokens": [9]}
    return _seen(log, r, exact=False, out=out)


@case
def malformed_requests_rejected_eagerly(P):
    log = Log()
    r = _router(P, {"rows": [_row("a")]}, _echo, log)
    errs = []
    for bad in ({"prompt": [1], "max_new_tokens": 1},
                {"id": "q", "prompt": [], "max_new_tokens": 1}):
        with pytest.raises(ValueError) as e:
            r.route(bad)
        errs.append(str(e.value))
    return _seen(log, r, errs=errs)


@case
def autoscale_replaces_stale_and_scales_on_pressure(P):
    clock, launched = {"t": 0.0}, []
    ctl = P.router.AutoscaleController(
        launched.append, enabled=True, occ_high=0.8, slo_rate_max=0.1,
        cooldown_s=60.0, clock=lambda: clock["t"])
    snap = _snap([_row("r0", stale=True)], requests=100, slo_violations=0)
    seen = [ctl.consider(snap), ctl.consider(snap)]
    clock["t"] = 61.0
    seen.append(ctl.consider(snap))
    clock["t"] = 200.0
    seen.append(ctl.consider(_snap([_row("r0")], slot_occupancy=0.95)))
    clock["t"] = 400.0
    seen.append(ctl.consider(_snap([_row("r0")], requests=100,
                                   slo_violations=0)))
    clock["t"] = 500.0
    seen.append(ctl.consider(_snap([_row("r0")], requests=200,
                                   slo_violations=50)))
    assert [a["action"] for a in seen[0]] == ["replace"] and seen[1] == []
    assert any("slo_rate" in a["reason"] for a in seen[-1])
    assert len(launched) == len(ctl.actions)
    # The launch command is each package's own (the JAX one seeds the
    # XLA cache, the port's builds the kernels): held apart below.
    return [[{k: v for k, v in a.items() if k != "command"} for a in s]
            for s in seen]


@case
def autoscale_disabled_is_inert(P):
    ctl = P.router.AutoscaleController(enabled=False)
    out = ctl.consider(_snap([_row("r0", stale=True)]))
    assert out == [] and ctl.actions == []
    return out


@case
def gateway_generate_replay_drain_and_kill(P):
    eng = _FakeEngine()
    gw = P.gateway(eng)
    try:
        body = {"id": "g1", "prompt": [1, 2, 3], "max_new_tokens": 5}
        out = [gw.handle_generate(body), gw.handle_generate(dict(body)),
               eng.submits, gw.handle_generate({"id": "", "prompt": [1]})]
        gw.draining = True
        out.append(gw.handle_generate(
            {"id": "g2", "prompt": [1], "max_new_tokens": 1}))
        gw.draining, gw.aborted = False, True
        out.append(gw.handle_generate(
            {"id": "g3", "prompt": [1], "max_new_tokens": 1}))
    finally:
        gw.close()
    assert out[2] == 1 and out[4] == (503, {"error": "draining"})
    return out


@case
def gateway_drained_handle_returns_503_for_reroute(P):
    class _DrainEngine(_FakeEngine):
        def submit(self, prompt, **kw):
            h = _FakeHandle([], state="queued")
            h.drained = True
            return h

    gw = P.gateway(_DrainEngine())
    try:
        out = gw.handle_generate({"id": "g1", "prompt": [1],
                                  "max_new_tokens": 1})
    finally:
        gw.close()
    assert out == (503, {"error": "drained"})
    return out


def _http_router(P, state, log, **kw):
    return _router(P, state, P.front.http_forward, log,
                   **{"retries": 1, "queue_timeout_s": 0.3, **kw})


@case
def frontdoor_end_to_end_over_http(P):
    log, gw = Log(), P.gateway(_FakeEngine())
    state = {"rows": [_row("a", url=gw.url)]}
    r = _http_router(P, state, log)
    door = P.door(r)
    try:
        out = [_post(door.url + "/generate",
                     {"id": "h1", "prompt": [1, 2, 3, 4],
                      "max_new_tokens": 2})]
        with urllib.request.urlopen(door.url + "/status", timeout=10) as s:
            out.append(json.loads(s.read())["router_requests"])
        with urllib.request.urlopen(door.url + "/healthz", timeout=10) as s:
            out.append(json.loads(s.read()))
        out.append(_post(door.url + "/generate", {"id": "h2", "prompt": []}))
        state["rows"] = []
        code, err = _post(door.url + "/generate",
                          {"id": "h3", "prompt": [1, 2],
                           "max_new_tokens": 1})
        out.append((code, sorted(err)))
    finally:
        door.close()
        gw.close()
    assert out[0] == (200, {"id": "h1", "tokens": [4, 2],
                            "finish_reason": "budget"})
    assert out[3][0] == 400 and out[4] == (503, ["error"])
    return _seen(log, r, exact=False, out=out)


@case
def http_forward_raises_on_replica_503(P):
    gw = P.gateway(_FakeEngine())
    gw.draining = True
    errs = []
    try:
        for row, req in (({"id": "a", "generate_url": gw.url},
                          {"id": "x", "prompt": [1], "max_new_tokens": 1}),
                         ({"id": "b"}, {"id": "x"})):
            with pytest.raises(RuntimeError) as e:
                P.front.http_forward(row, req, 5.0)
            errs.append(str(e.value))
    finally:
        gw.close()
    assert "503" in errs[0] and "generate_url" in errs[1]
    return errs


def _ctx(P, rid="q1", sampled=True):
    return P.trace.TraceContext("a" * 32, "b" * 16, rid, sampled=sampled)


@case
def route_traced_retry_reroute_span_chain(P):
    log = Log()
    state = {"rows": [_row("dying"), _row("live", health=0.9)]}

    def forward(row, request, timeout_s):
        if row["id"] == "dying":
            raise RuntimeError("connection reset")
        return {"replica": row["id"]}

    ctx = _ctx(P)
    r = _router(P, state, forward, log)
    resp = r.route({"id": "q1", "prompt": [1, 2], "max_new_tokens": 1,
                    "_trace_ctx": ctx})
    f0, f1 = [s for s in ctx.spans if s["name"] == "router.forward"]
    assert resp["replica"] == "live" and f1["parent"] == f0["span"]
    assert ctx.span_id == f1["span"] and ctx.escalate_reason == "error"
    return _seen(log, r, spans=_norm_spans(ctx.spans),
                 reason=ctx.escalate_reason,
                 live_is_last=ctx.span_id == f1["span"])


@case
def route_traced_queue_timeout_reject_spans(P):
    log, ctx = Log(), _ctx(P, sampled=False)
    r = _router(P, {"rows": [_row("a", pages=0)]}, _echo, log,
                queue_timeout_s=0.05)
    with pytest.raises(P.router.FleetBusy):
        r.route({"id": "q1", "prompt": [1, 2], "max_new_tokens": 1,
                 "_trace_ctx": ctx})
    assert ctx.recorded and ctx.escalate_reason == "queue_timeout"
    assert ctx.spans[0]["dur_s"] >= 0.04
    return _seen(log, r, spans=_norm_spans(ctx.spans),
                 queue_dur=ctx.spans[0]["dur_s"])


@case
def route_untraced_request_has_no_trace_keys(P):
    log, seen = Log(), {}

    def forward(row, request, timeout_s):
        seen.update(request)
        return {"replica": row["id"]}

    r = _router(P, {"rows": [_row("a")]}, forward, log)
    r.route({"id": "u1", "prompt": [1, 2], "max_new_tokens": 1})
    assert "_trace_ctx" not in seen
    return _seen(log, r, seen=seen)


@case
def gateway_propagates_trace_into_engine_and_attach_span(P):
    eng = _FakeEngine()
    gw = P.gateway(eng)
    out = []
    try:
        out.append((gw.handle_generate(
            {"id": "t0", "prompt": [1], "max_new_tokens": 1}), eng.kw))
        code = gw.handle_generate(
            {"id": "t1", "prompt": [1, 2], "max_new_tokens": 1},
            traceparent=_ctx(P, "t1").to_traceparent())
        out.append((code, eng.kw["trace"].trace_id,
                    eng.kw["trace"].root_id))
        out.append((gw.handle_generate(
            {"id": "t2", "prompt": [1], "max_new_tokens": 1},
            traceparent="garbage"), eng.kw))
    finally:
        gw.close()
    slow = _FakeEngine()
    slow.submit = lambda prompt, **kw: _FakeHandle([], state="queued")
    gw2 = P.gateway(slow, hold_timeout_s=0.05, poll_s=0.01)
    try:
        body = {"id": "d1", "prompt": [1], "max_new_tokens": 1}
        out.append(gw2.handle_generate(
            body, traceparent=_ctx(P, "d1").to_traceparent()))
        ctx2 = P.trace.from_traceparent(_ctx(P, "d1").to_traceparent(), "d1")
        out.append(gw2._handle_generate(dict(body), "d1", ctx2))
        out.append(_norm_spans(ctx2.spans))
    finally:
        gw2.close()
    assert out[0][1] == {} and out[2][1] == {}
    assert any(s["name"] == "gateway.attach" and s["attached"]
               for s in out[-1])
    return out


@case
def frontdoor_trace_end_to_end_over_http(P, tmp):
    log, gw = Log(), P.gateway(_FakeEngine(), trace_dir=tmp)
    r = _http_router(P, {"rows": [_row("a", url=gw.url)]}, log,
                     queue_timeout_s=1.0)
    door = P.door(r, trace_dir=tmp)
    try:
        code, _ = _post(door.url + "/generate",
                        {"id": "e2e-1", "prompt": [1, 2, 3],
                         "max_new_tokens": 2})
    finally:
        door.close()
        gw.close()
    spans = P.trace.spans_for_request(tmp, "e2e-1")
    by = {s["name"]: s for s in spans}
    assert code == 200 and by["gateway.hold"]["parent"] == \
        by["router.forward"]["span"]
    a = P.trace.assemble(spans)
    for s in spans:  # the trace id differs between the two runs
        s["trace"] = "t"
    return _seen(log, r, exact=False, spans=sorted(
        _norm_spans(sorted(spans, key=lambda s: s["name"])),
        key=lambda s: s["name"]),
        writers=len(a["writers"]), path=a["critical_path"][0]["segment"],
        rerouted=a["rerouted"])


@case
def http_forward_strips_ctx_and_sets_traceparent_header(P):
    import http.server as hs

    captured = []

    class _H(hs.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            captured.append((json.loads(self.rfile.read(n)),
                             self.headers.get("traceparent")))
            out = json.dumps({"ok": True}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *args):
            pass

    srv = hs.ThreadingHTTPServer(("127.0.0.1", 0), _H)
    th = threading.Thread(target=srv.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    try:
        h, p = srv.server_address[:2]
        ctx = _ctx(P, "w1")
        ctx.span_id = "c" * 16
        row = {"id": "a", "generate_url": f"http://{h}:{p}/generate"}
        P.front.http_forward(row, {"id": "w1", "prompt": [1],
                                   "max_new_tokens": 1, "_trace_ctx": ctx},
                             5.0)
        P.front.http_forward(row, {"id": "w2", "prompt": [1],
                                   "max_new_tokens": 1}, 5.0)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=2.0)
    assert captured[0][1] == "00-" + "a" * 32 + "-" + "c" * 16 + "-01"
    assert "_trace_ctx" not in captured[0][0] and captured[1][1] is None
    return captured


@case
def route_rejects_malformed_types_as_valueerror(P):
    log = Log()
    r = _router(P, {"rows": [_row("a")]}, _echo, log)
    errs = []
    for bad in ({"id": "m1", "prompt": [1, 2], "max_new_tokens": [64]},
                {"id": "m2", "prompt": "junk", "max_new_tokens": 1}):
        with pytest.raises(ValueError) as e:
            r.route(bad)
        errs.append(str(e.value).split(" (")[0])
    assert r.stats()["router_requests"] == 0
    return _seen(log, r, errs=errs)


@case
def frontdoor_maps_malformed_and_internal_errors_to_json(P):
    log, gw = Log(), P.gateway(_FakeEngine())
    r = _http_router(P, {"rows": [_row("a", url=gw.url)]}, log, retries=2,
                     queue_timeout_s=1.0)
    door = P.door(r)
    out = []
    try:
        for body in ({"id": "f1", "prompt": [1, 2], "max_new_tokens": [64]},
                     {"id": "f2", "prompt": "junk", "max_new_tokens": 1}):
            code, err = _post(door.url + "/generate", body)
            out.append((code, err["error"].split(" (")[0]))

        class _Boom:
            def route(self, body):
                raise RuntimeError("kaboom")

        door.router = _Boom()
        out.append(_post(door.url + "/generate",
                         {"id": "f3", "prompt": [1], "max_new_tokens": 1}))
    finally:
        door.close()
        gw.close()
    assert out[0][0] == out[1][0] == 400
    assert out[2] == (500, {"error": "RuntimeError: kaboom"})
    return out


@case
def slow_snapshot_fn_never_blocks_routing(P):
    hang, entered, calls = threading.Event(), threading.Event(), {"n": 0}

    def snapshot_fn():
        calls["n"] += 1
        if calls["n"] > 1:
            entered.set()
            hang.wait(timeout=10.0)
        return _snap([_row("a")])

    r = P.router.Router(snapshot_fn, _echo, page_size=8, timeout_s=5.0,
                        retries=1, backoff_s=0.01, queue_timeout_s=1.0,
                        refresh_s=0.0)
    r.refresh(force=True)
    stuck = threading.Thread(target=lambda: r.refresh(force=True),
                             daemon=True)
    stuck.start()
    assert entered.wait(timeout=5.0)
    t0 = time.monotonic()
    resp = r.route({"id": "s1", "prompt": [1, 2], "max_new_tokens": 2})
    fast = time.monotonic() - t0 < 2.0
    hang.set()
    stuck.join(timeout=5.0)
    assert fast and not stuck.is_alive()
    return {"resp": resp, "stats": {k: r.stats()[k] for k in COUNTS}}


@case
def fleet_poller_hands_router_a_cached_snapshot(P):
    calls = {"n": 0}

    def fetch(url, timeout_s):
        calls["n"] += 1
        return {"replica": {"id": "p0"}, "serve_pages_free": 4,
                "generate_url": "http://x/generate"}

    obsy = P.fleet.FleetObservatory("http://127.0.0.1:1", timeout_s=0.1,
                                    stale_s=5.0, poll_interval_s=0.01,
                                    fetch=fetch)
    poller = P.fleet.FleetPoller(obsy, interval_s=0.01)
    try:
        row = poller.snapshot()["replicas"][0]
        n0 = calls["n"]
        for _ in range(50):
            poller.snapshot()
        cached = calls["n"] == n0
        deadline = time.monotonic() + 5.0
        while calls["n"] == n0 and time.monotonic() < deadline:
            time.sleep(0.01)
        swept = calls["n"] > n0
    finally:
        poller.close()
    assert cached and swept and not poller._thread.is_alive()
    return [row["id"], row["generate_url"], row["serve_pages_free"]]


@case
def launch_command_is_cwd_independent(P):
    cmd = P.router.launch_command("replace", "r0")
    script = cmd[1]
    assert os.path.isabs(script) and os.path.exists(script)
    # Each package's own script (the JAX one seeds the XLA cache, the
    # port's builds the kernels): the shape of the command is shared.
    return [cmd[0], os.path.isabs(script), os.path.exists(script)]


@case
def serve_forever_exports_generate_url_and_forwards(P, tmp):
    class _LoopEngine(_FakeEngine):
        def __init__(self):
            super().__init__()
            self._iters = 0
            self._live = np.zeros((1,), bool)

            import contextlib

            class _Ledger:
                def bucket(self, name):
                    return contextlib.nullcontext()

            self.ledger = _Ledger()

        def step(self, admit=True):
            self._iters += 1
            return False

        def drain_queued(self):
            return 0

    reg = os.path.join(tmp, "fleet")
    os.makedirs(reg)
    if P.jax:
        serve, export, goodput = jserve, jexport, jgoodput
        P.mp.setenv("TPUFLOW_OBS_HTTP_PORT", "0")
        P.mp.setenv("TPUFLOW_FLEET_REGISTRATION_DIR", reg)
        kw = {}
    else:
        serve = importlib.import_module("tpuflow_torch.infer.serve")
        export, goodput = texport, tgoodput
        kw = {"http_port": 0, "registration_dir": reg}
    export.stop()
    goodput.live().reset()
    stop, eng = threading.Event(), _LoopEngine()
    th = threading.Thread(target=serve.serve_forever, args=(eng,), kwargs={
        "idle_sleep_s": 0.002, "max_s": 60.0, "should_stop": stop.is_set,
        **kw}, daemon=True)
    th.start()
    try:
        obsy = P.fleet.FleetObservatory(reg, timeout_s=2.0, stale_s=10.0,
                                        poll_interval_s=0.01)
        row, deadline = None, time.monotonic() + 15.0
        while row is None and time.monotonic() < deadline:
            row = next((x for x in obsy.poll().get("replicas") or []
                        if x.get("generate_url")), None)
            time.sleep(0.02)
        resp = P.front.http_forward(
            row, {"id": "sf-1", "prompt": [1, 2, 3], "max_new_tokens": 4},
            5.0)
    finally:
        stop.set()
        th.join(timeout=15.0)
        retracted = goodput.live().serve_generate_url is None
        export.stop()
        goodput.live().reset()
    assert not th.is_alive() and retracted and eng.submits == 1
    return resp


NEEDS_TMP = {"frontdoor_trace_end_to_end_over_http",
             "serve_forever_exports_generate_url_and_forwards"}
# Cases whose threads race a real clock: their router and trace
# telemetry is compared by names (``_telemetry``).
RACING = {"admission_waits_for_budget_then_admits",
          "inflight_pages_charged_against_budget",
          "concurrent_duplicate_waits_for_original",
          "slow_snapshot_fn_never_blocks_routing",
          "serve_forever_exports_generate_url_and_forwards"}
_VOLATILE = ("ts", "pid", "dur_s", "trace")


def _telemetry(d, racing):
    """The router.* and trace.* records of the recorder under ``d``: in
    order with the volatile keys dropped, or (``racing``) the sorted
    names of the events and the set of the gauges' and counters' (how
    often a gauge is set depends on how many admission passes a race
    took)."""
    recs = []
    for fn in sorted(os.listdir(d)):
        if fn.startswith("events.") and fn.endswith(".jsonl"):
            with open(os.path.join(d, fn)) as f:
                recs += [json.loads(line) for line in f]
    recs = [r for r in recs if r["name"].split(".")[0] in ("router", "trace")]
    if racing:
        return (sorted(r["name"] for r in recs if r["kind"] == "event"),
                {(r["kind"], r["name"]) for r in recs
                 if r["kind"] != "event"})
    return [{k: v for k, v in r.items() if k not in _VOLATILE}
            for r in recs]


@pytest.mark.parametrize("name", sorted(CASES))
def test_router_case_same_on_both_packages(name, pkgs, tmp_path):
    """One case of tests/test_router.py on each package: EQUAL
    observations (forwards, sleeps, stats, answers, spans) and EQUAL
    router and trace telemetry (events, gauges, counters)."""
    seen, tele = {}, {}
    for P, o in zip(pkgs, (jobs, tobs)):
        args = [str(tmp_path / P.name)] if name in NEEDS_TMP else []
        d = str(tmp_path / f"obs-{P.name}")
        o.configure(d)
        try:
            seen[P.name] = CASES[name](P, *args)
        finally:
            o.configure(None)
        tele[P.name] = _telemetry(d, name in RACING)
    assert seen["torch"] == seen["jax"]
    assert tele["torch"] == tele["jax"]


def test_every_router_case_is_ported():
    """The JAX file's 34 cases, one for one."""
    src = open(os.path.join(os.path.dirname(__file__), "test_router.py"),
               encoding="utf-8").read()
    jax_cases = {line[len("def test_"):].split("(")[0]
                 for line in src.splitlines() if line.startswith("def test_")}
    assert len(jax_cases) == 34 and jax_cases == set(CASES)


# ------------------------------------------------------------- digests
@pytest.mark.parametrize("n,ps", [(0, 4), (3, 4), (10, 4), (64, 16),
                                  (129, 16), (33, 8), (7, 1)])
def test_prefix_digests_bit_equal_to_chain_digests_and_jax(n, ps):
    prompt = np.random.default_rng(n).integers(0, 50257, size=n)
    ours = trouter.prefix_digests(prompt, ps)
    assert ours == tkv.chain_digests(prompt, ps)
    assert ours == jrouter.prefix_digests(prompt, ps)
    assert len(ours) == n // ps


def test_launch_command_builds_the_kernels_from_any_directory(tmp_path):
    cmd = trouter.launch_command("replace", "r0")
    assert cmd[1].endswith(os.path.join("tpuflow_torch", "ops", "_build.py"))
    # The script imports nothing of the package: run by path from another
    # working directory, it gets as far as looking for nvcc (none here).
    import subprocess
    import sys

    code = ("import runpy, sys; m = runpy.run_path(sys.argv[1]); "
            "print(m['BUILD_DIR'], callable(m['build_all']))")
    out = subprocess.run([sys.executable, "-c", code, cmd[1]],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[1] == "True"
