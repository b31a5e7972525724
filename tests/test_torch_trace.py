"""The port's request tracing (``tpuflow_torch/obs/trace.py``) held to the
JAX package's (``tpuflow/obs/trace.py``).

Each case of ``tests/test_trace.py`` runs once on each package and
returns what it observed; the observations must be EQUAL (span ids minted
at random replaced by their order of appearance). The JAX side takes
``TPUFLOW_TRACE*`` by ``monkeypatch.setenv``, the port its ``armed`` /
``sample`` / ``directory`` arguments; where the JAX ``python -m
tpuflow.obs trace`` resolves ``TPUFLOW_TRACE_DIR``, ``python -m
tpuflow_torch.obs trace`` is given the directory.

Across the packages: span files the port writes are the JAX package's
byte for byte; a port-written trail assembles with the JAX ``assemble``
and a JAX-written one with the port's, to equal timelines; a
``traceparent`` header round-trips through both; and with a recorder
configured, both resolve spans to ``<recorder dir>/trace``.
"""

import contextlib
import importlib
import io
import json
import os
import time

import pytest

from tpuflow_torch import obs as tobs
from tpuflow_torch.obs import fleet as tfleet
from tpuflow_torch.obs import goodput as tgoodput
from tpuflow_torch.obs import trace as ttrace

jobs = importlib.import_module("tpuflow.obs")
jtrace = importlib.import_module("tpuflow.obs.trace")
jfleet = importlib.import_module("tpuflow.obs.fleet")
jgoodput = importlib.import_module("tpuflow.obs.goodput")


class Pkg:
    """One package's trace, fleet and goodput modules; its knobs set
    through the environment (JAX) or as arguments (the port)."""

    def __init__(self, name, monkeypatch):
        self.name = name
        self.jax = name == "jax"
        self.trace = jtrace if self.jax else ttrace
        self.fleet = jfleet if self.jax else tfleet
        self.goodput = jgoodput if self.jax else tgoodput
        self.mp = monkeypatch

    def mint(self, rid, armed=True, sample=1.0):
        if self.jax:
            self.mp.setenv("TPUFLOW_TRACE", "1" if armed else "0")
            self.mp.setenv("TPUFLOW_TRACE_SAMPLE", str(sample))
            return self.trace.maybe_mint(rid)
        return self.trace.maybe_mint(rid, armed=armed, sample=sample)

    def parse(self, header, rid, armed=True):
        if self.jax:
            self.mp.setenv("TPUFLOW_TRACE", "1" if armed else "0")
            return self.trace.from_traceparent(header, rid)
        return self.trace.from_traceparent(header, rid, armed=armed)

    def ctx(self, trace_id, span_id, rid, sampled, directory=None):
        """A context whose flush writes to ``directory``."""
        if self.jax:
            if directory:
                self.mp.setenv("TPUFLOW_TRACE_DIR", directory)
            return self.trace.TraceContext(trace_id, span_id, rid,
                                           sampled=sampled)
        return self.trace.TraceContext(trace_id, span_id, rid,
                                       sampled=sampled, directory=directory)


@pytest.fixture
def pkgs(monkeypatch):
    for k in ("TPUFLOW_TRACE", "TPUFLOW_TRACE_SAMPLE", "TPUFLOW_TRACE_DIR",
              "TPUFLOW_FLEET_REPLICA_ID", "TPUFLOW_OBS_DIR"):
        monkeypatch.delenv(k, raising=False)
    jobs.configure(None)
    tobs.configure(None)
    yield [Pkg("jax", monkeypatch), Pkg("torch", monkeypatch)]
    jobs.configure(None)
    tobs.configure(None)


def _ids(spans):
    """Spans with their (random) span ids as ordinals."""
    ids = {}
    out = []
    for s in spans:
        s = dict(s)
        for k in ("span", "parent"):
            if s.get(k) is not None:
                s[k] = ids.setdefault(s[k], f"#{len(ids)}")
        out.append(s)
    return out


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


@case
def mint_parse_roundtrip(P, tmp):
    ctx = P.mint("req-1")
    header = ctx.to_traceparent()
    back = P.parse(header, "req-1")
    assert header == f"00-{ctx.trace_id}-{ctx.span_id}-01"
    assert back.trace_id == ctx.trace_id and back.root_id == ctx.span_id
    return [ctx.sampled, ctx.recorded, len(ctx.trace_id), len(ctx.span_id),
            ctx.root_id == ctx.span_id, back.sampled, back.request_id]


@case
def disarmed_is_none_from_both_constructors(P, tmp):
    good = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"
    return [P.mint("r", armed=False), P.parse(good, "r", armed=False)]


MALFORMED = [
    None, "", "garbage",
    "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 15 + "-01",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16,
]


@case
def malformed_traceparent_fails_closed(P, tmp):
    return [P.parse(h, "r") for h in MALFORMED]


@case
def header_is_case_and_whitespace_tolerant(P, tmp):
    ctx = P.parse("  00-" + "A" * 32 + "-" + "B" * 16 + "-00  ", "r")
    assert ctx.trace_id == "a" * 32 and not ctx.sampled
    return [ctx.trace_id, ctx.span_id, ctx.sampled]


@case
def head_sampling_zero_still_propagates(P, tmp):
    ctx = P.mint("r", sample=0.0)
    assert ctx is not None and not ctx.recorded
    return [ctx.sampled, ctx.recorded, ctx.to_traceparent()[-3:]]


@case
def escalation_forces_recording_and_dedups(P, tmp):
    ctx = P.trace.TraceContext("a" * 32, "b" * 16, "r", sampled=False)
    out = [ctx.recorded]
    ctx.escalate("reroute")
    out += [ctx.recorded, ctx.escalate_reason, ctx.to_traceparent()]
    ctx.escalate("error")
    assert ctx.escalate_reason == "reroute"
    return out + [ctx.escalate_reason]


@case
def unrecorded_flush_discards_silently(P, tmp):
    ctx = P.ctx("a" * 32, "b" * 16, "r", False, directory=tmp)
    ctx.add_span("router.queue", ts=1.0, dur_s=0.1)
    ok = P.trace.flush(ctx, writer="w")
    assert ok and ctx.spans == [] and P.trace.read_spans(tmp) == []
    return [ok, ctx.spans, os.listdir(tmp)]


@case
def write_read_roundtrip_and_torn_tail(P, tmp):
    ctx = P.trace.TraceContext("a" * 32, "b" * 16, "req-7", sampled=True)
    ctx.add_span("router.queue", ts=10.0, dur_s=0.5, attempt=0,
                 span_id="s1")
    ctx.add_span("router.forward", ts=10.5, dur_s=1.0, attempt=0,
                 replica="rep-0", ok=True, span_id="s2", parent="s1")
    assert P.trace.write_spans(ctx.spans, writer="frontdoor", directory=tmp)
    ctx2 = P.trace.TraceContext("a" * 32, "c" * 16, "req-7", sampled=True)
    ctx2.add_span("gateway.hold", ts=10.6, dur_s=0.9, status=200,
                  span_id="s3", parent="s2")
    assert P.trace.write_spans(ctx2.spans, writer="rep/0", directory=tmp)
    files = {fn: open(os.path.join(tmp, fn), "rb").read()
             for fn in sorted(os.listdir(tmp))}
    with open(os.path.join(tmp, "trace-frontdoor.jsonl"), "a") as f:
        f.write("not json\n")
        f.write(json.dumps({"no": "trace key"}) + "\n")
        f.write('{"trace": "a", "name": "torn", "ts": 1')  # no newline
    spans = P.trace.read_spans(tmp)
    assert len(spans) == 3
    return [files, spans, P.trace.spans_for_request(tmp, "req-7") == spans,
            P.trace.spans_for_request(tmp, "other"),
            len(P.trace.spans_for_trace(tmp, "a" * 32)),
            P.trace.read_spans(os.path.join(tmp, "nope"))]


@case
def write_without_directory_counts_dropped(P, tmp):
    td = P.trace.trace_dir()
    ok = P.trace.write_spans([{"trace": "a", "name": "x", "ts": 1.0}],
                             writer="w")
    return [td, ok]


PHASES = [
    {"phase": "submitted", "t": 0.0},
    {"phase": "queued", "t": 0.01, "reason": "slots"},
    {"phase": "admitted", "t": 0.05, "bucket": 32},
    {"phase": "first_token", "t": 0.20},
    {"phase": "tick", "t": 0.25, "tokens": 4},
    {"phase": "tick", "t": 0.30, "tokens": 4},
    {"phase": "complete", "t": 0.30},
]


@case
def flush_lifecycle_converts_phases_to_spans(P, tmp):
    t = time.monotonic()
    phases = [{**p, "t": t + p["t"]} for p in PHASES]
    ctx = P.ctx("d" * 32, "e" * 16, "req-9", True, directory=tmp)
    assert P.trace.flush_lifecycle(ctx, phases, engine_request=42,
                                   writer="rep-1")
    spans = P.trace.read_spans(tmp)
    assert all(abs(s["ts"] - time.time()) < 60.0 for s in spans)
    assert {s["parent"] for s in spans} == {"e" * 16}
    # ts is wall clock at the flush: each package's own instant.
    return _ids([{k: v for k, v in s.items() if k not in ("ts", "span")}
                 for s in spans])


@case
def flush_lifecycle_empty_phases_is_false(P, tmp):
    ctx = P.trace.TraceContext("d" * 32, "e" * 16, "r", sampled=True)
    return P.trace.flush_lifecycle(ctx, [])


def _reroute_spans():
    """``tests/test_trace.py::_reroute_spans``: a rerouted request's
    spans across the front door and two replicas."""
    t = 1000.0
    base = {"trace": "t" * 32, "request": "req-3"}
    rows = [
        ("s0", None, "router.ingress", t, 1.0, "frontdoor",
         {"status": 200}),
        ("s1", "s0", "router.queue", t, 0.05, "frontdoor", {"attempt": 0}),
        ("f0", "s0", "router.forward", t + 0.05, 0.2, "frontdoor",
         {"attempt": 0, "replica": "rep-0", "ok": False,
          "error": "connection refused", "backoff_s": 0.02}),
        ("h0", "f0", "gateway.hold", t + 0.06, 0.1, "rep-0",
         {"status": 503}),
        ("s2", "s0", "router.queue", t + 0.27, 0.03, "frontdoor",
         {"attempt": 1}),
        ("f1", "f0", "router.forward", t + 0.30, 0.7, "frontdoor",
         {"attempt": 1, "replica": "rep-1", "ok": True, "reroute": True}),
        ("h1", "f1", "gateway.hold", t + 0.31, 0.68, "rep-1",
         {"status": 200}),
        ("q1", "f1", "serve.queue", t + 0.32, 0.08, "rep-1", {}),
        ("p1", "f1", "serve.prefill", t + 0.40, 0.3, "rep-1", {}),
        ("k1", "f1", "serve.first_tick", t + 0.70, 0.1, "rep-1", {}),
        ("d1", "f1", "serve.decode", t + 0.70, 0.28, "rep-1", {"ticks": 3}),
    ]
    return [{**base, "span": sid, "parent": par, "name": name, "ts": ts,
             "dur_s": dur, **attrs, "writer": w}
            for sid, par, name, ts, dur, w, attrs in rows]


@case
def assemble_reroute_critical_path_and_ttft(P, tmp):
    a = P.trace.assemble(_reroute_spans())
    assert a["rerouted"] and a["writers"] == ["frontdoor", "rep-0", "rep-1"]
    return [a, P.trace.format_timeline(a)]


@case
def assemble_empty_and_unrerouted(P, tmp):
    clean = [
        {"trace": "x" * 32, "span": "s1", "request": "r",
         "name": "router.queue", "ts": 1.0, "dur_s": 0.1,
         "writer": "frontdoor"},
        {"trace": "x" * 32, "span": "f1", "request": "r",
         "name": "router.forward", "ts": 1.1, "dur_s": 0.5, "attempt": 0,
         "replica": "rep-0", "ok": True, "writer": "frontdoor"},
    ]
    a = P.trace.assemble(clean)
    assert a["rerouted"] is False and a["wall_s"] == pytest.approx(0.6)
    return [P.trace.assemble([]), a, P.trace.critical_path(clean)]


@case
def histogram_exemplars_observe_to_dict_merge(P, tmp):
    h = P.fleet.MergeableHistogram(edges=(0.1, 1.0))
    h.observe(0.05)
    out = [h.to_dict()]
    h.observe(0.06, exemplar="traceA")
    h.observe(0.5, exemplar="traceB")
    h.observe(0.07, exemplar="traceC")
    d = h.to_dict()
    legacy = P.fleet.MergeableHistogram(edges=(0.1, 1.0))
    legacy.observe(0.08)
    ld = legacy.to_dict()
    m = P.fleet.merge_hists([ld, d])
    assert m["exemplars"] == ["traceC", "traceB", None]
    return out + [d, ld, m, P.fleet.merge_hists([ld, ld])]


@case
def hist_exemplar_rank_walk_and_guards(P, tmp):
    h = P.fleet.MergeableHistogram(edges=(0.1, 1.0, 5.0))
    for _ in range(98):
        h.observe(0.05, exemplar="fast")
    h.observe(0.5, exemplar="mid")
    h.observe(4.0, exemplar="slow")
    d = h.to_dict()
    bad = dict(d)
    bad["exemplars"] = ["only-one"]
    legacy = {"edges": [0.1], "counts": [1, 0], "count": 1, "sum": 0.05}
    ex = P.fleet.hist_exemplar
    got = [ex(d, 0.5), ex(d, 0.99), ex(d, 1.0), ex(None, 0.99),
           ex({}, 0.99), ex(legacy, 0.99), ex(bad, 0.99)]
    assert got[:3] == ["fast", "mid", "slow"]
    return got


@case
def ledger_ttft_exemplar_rides_snapshot(P, tmp):
    led = P.goodput.ProcessLedger()
    led.note_serve_state(0, 0, 4)
    led.note_serve_ttft(0.2, trace_id="t-1")
    led.note_serve_ttft(0.3)
    hist = led.snapshot()["serve_ttft_hist"]
    assert P.fleet.hist_exemplar(hist, 0.0) is not None
    return [hist, P.fleet.hist_exemplar(hist, 0.0)]


@case
def obs_trace_cli(P, tmp):
    main = (importlib.import_module("tpuflow.obs.__main__") if P.jax else
            importlib.import_module("tpuflow_torch.obs.__main__")).main
    d = os.path.join(tmp, "trace")
    os.makedirs(d)
    spans = _reroute_spans()
    for writer, keep in (("frontdoor", lambda w: w == "frontdoor"),
                         ("reps", lambda w: w != "frontdoor")):
        assert P.trace.write_spans(
            [{k: v for k, v in sp.items() if k != "writer"}
             for sp in spans if keep(sp["writer"])],
            writer=writer, directory=d)

    def run(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(
                err):
            rc = main(argv)
        return rc, out.getvalue().replace(tmp, "<tmp>"), err.getvalue()

    got = [run(["trace", "req-3", d])[:2], run(["trace", "req-3", tmp])[:2],
           run(["trace", "req-3", d, "--json"])[:2]]
    assert "[REROUTED]" in got[0][1] and "reroute: rep-0 -> rep-1" in (
        got[0][1])
    assert json.loads(got[2][1])["rerouted"] is True
    # The JAX CLI resolves TPUFLOW_TRACE_DIR; the port is given the dir.
    if P.jax:
        P.mp.setenv("TPUFLOW_TRACE_DIR", d)
        got.append(run(["trace", "req-3"])[:2])
    else:
        got.append(run(["trace", "req-3", d])[:2])
    rc, out, err = run(["trace", "nope", d])
    assert rc == 1 and "no spans" in err
    if P.jax:
        P.mp.delenv("TPUFLOW_TRACE_DIR")
    return got + [(rc, out), run(["trace", "req-3"])[:2],
                  run(["trace"])[:2]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_case_same_on_both_packages(name, pkgs, tmp_path):
    """One case of tests/test_trace.py on each package: EQUAL
    observations."""
    seen = {}
    for P in pkgs:
        d = tmp_path / P.name
        d.mkdir()
        seen[P.name] = CASES[name](P, str(d))
    assert seen["torch"] == seen["jax"]


def test_every_trace_case_is_ported():
    """The JAX file's cases, one for one."""
    src = open(os.path.join(os.path.dirname(__file__), "test_trace.py"),
               encoding="utf-8").read()
    jax_cases = {line[len("def test_"):].split("(")[0]
                 for line in src.splitlines() if line.startswith("def test_")}
    assert len(jax_cases) == 17
    assert jax_cases - set(CASES) == set()


# ------------------------------------------------- across the packages
@pytest.mark.parametrize("writer_pkg", ["jax", "torch"])
def test_span_files_assemble_across_packages(writer_pkg, pkgs, tmp_path):
    """A trail written by one package (front door + two replicas) reads
    and assembles with the other's ``read_spans`` / ``assemble``, to the
    same timeline the writer's own gives."""
    w = pkgs[0] if writer_pkg == "jax" else pkgs[1]
    d = str(tmp_path)
    spans = _reroute_spans()
    for writer in ("frontdoor", "rep-0", "rep-1"):
        mine = [{k: v for k, v in s.items() if k != "writer"}
                for s in spans if s["writer"] == writer]
        assert w.trace.write_spans(mine, writer=writer, directory=d)
    got = {P.name: P.trace.assemble(P.trace.spans_for_request(d, "req-3"))
           for P in pkgs}
    assert got["jax"] == got["torch"]
    assert got["jax"]["rerouted"] and len(got["jax"]["spans"]) == 11
    assert jtrace.format_timeline(got["jax"]) == ttrace.format_timeline(
        got["torch"])


def test_traceparent_round_trips_across_packages(pkgs):
    """port mint -> header -> JAX context -> header -> port context: the
    trace id, the propagated span and the sampled flag survive, and an
    escalated unsampled context propagates as sampled."""
    t = ttrace.maybe_mint("x-1")
    j = jtrace.from_traceparent(t.to_traceparent(), "x-1")
    back = ttrace.from_traceparent(j.to_traceparent(), "x-1")
    assert (j.trace_id, j.span_id, j.sampled) == (t.trace_id, t.span_id,
                                                   True)
    assert (back.trace_id, back.span_id) == (t.trace_id, t.span_id)
    u = jtrace.TraceContext("c" * 32, "d" * 16, "x-2", sampled=False)
    assert ttrace.from_traceparent(u.to_traceparent(), "x-2").sampled is False
    u.escalate("slo")
    assert ttrace.from_traceparent(u.to_traceparent(), "x-2").sampled


def test_default_directory_is_the_recorders(pkgs, tmp_path):
    """No ``trace_dir``: spans land in ``<recorder dir>/trace`` when a
    recorder is configured (the JAX default), each package with its own
    recorder; the span lines are the same bytes."""
    out = {}
    for P, o in ((pkgs[0], jobs), (pkgs[1], tobs)):
        d = str(tmp_path / P.name)
        o.configure(d)
        try:
            assert P.trace.trace_dir() == os.path.join(d, "trace")
            ctx = P.trace.TraceContext("a" * 32, "b" * 16, "r", sampled=True)
            ctx.add_span("gateway.hold", ts=5.0, dur_s=0.5, span_id="h",
                         parent="b" * 16, status=200)
            assert P.trace.flush(ctx, writer="rep-0")
        finally:
            o.configure(None)
        with open(os.path.join(d, "trace", "trace-rep-0.jsonl"), "rb") as f:
            out[P.name] = f.read()
    assert out["jax"] == out["torch"]
