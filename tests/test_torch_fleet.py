"""The fleet observatory, the live goodput ledger and its export on the
port (``tpuflow_torch/obs/fleet.py``, ``goodput.py``, ``export.py``), held
against the JAX modules case by case of tests/test_fleet.py (its
``tpu_watch`` case aside: a JAX tool): mergeable histogram math,
registration and discovery (the JAX knobs set with ``monkeypatch`` on the
JAX side, the port's arguments on the other), health scores, aggregation,
the poller's hardening and staleness, the snapshot trail, and three live
replicas whose fleet percentiles are bit-equal to pooling their access
logs. Across the packages: a JAX ``FleetObservatory`` polls a port
``MetricsServer`` and the port's polls a JAX one, each with the rows of a
same-package replica, and both ``ProcessLedger``s fed one note sequence
give equal snapshots and equal ``prometheus_text`` but for the clock's
keys. Inputs are made from seeds with numpy."""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from tpuflow.obs import export as jexport
from tpuflow.obs import fleet as jfleet
from tpuflow.obs import serve_ledger as jsl
from tpuflow.obs.goodput import ProcessLedger as JLedger
from tpuflow_torch.obs import export as texport
from tpuflow_torch.obs import fleet as tfleet
from tpuflow_torch.obs import serve_ledger as tsl
from tpuflow_torch.obs.goodput import ProcessLedger as TLedger

MODS = pytest.mark.parametrize("fl", [jfleet, tfleet], ids=["jax", "port"])

# Snapshot keys that read the clock (or the process).
LEDGER_TIME_KEYS = {"uptime_s", "started_ts", "goodput_fraction",
                    "step_rate", "tokens_per_s", "serve_tokens_per_s",
                    "pid", "replica"}
# Fleet-row keys that read the clock, or name the replica's address.
ROW_TIME_KEYS = {"age_s", "qps", "url", "uptime_s", "serve_tokens_per_s",
                 "replica"}


def _untimed(d, keys):
    return {k: v for k, v in d.items() if k not in keys}


# ------------------------------------------------------------ histograms
def test_hist_edges_resolution(monkeypatch):
    """A port replica's histograms use the JAX package's default edges
    (its edges knob unset), so a mixed fleet merges every bucket."""
    assert tfleet.DEFAULT_HIST_EDGES == jfleet.DEFAULT_HIST_EDGES
    monkeypatch.delenv("TPUFLOW_FLEET_HIST_BUCKETS", raising=False)
    assert jfleet.resolve_hist_edges() == tfleet.DEFAULT_HIST_EDGES
    assert tfleet.MergeableHistogram().edges == tfleet.DEFAULT_HIST_EDGES
    jl, tl = JLedger(), TLedger()
    for led in (jl, tl):
        led.note_serve_state(0, 1, 2)
        led.note_serve_ttft(0.02)
        led.note_serve_itl(0.003)
    for key in ("serve_ttft_hist", "serve_itl_hist"):
        t, j = tl.snapshot()[key], jl.snapshot()[key]
        assert t == j and t["edges"] == list(tfleet.DEFAULT_HIST_EDGES)
    assert tfleet.merge_hists([t, j])["count"] == 2


@MODS
def test_mergeable_histogram_counts_and_cumulative(fl):
    h = fl.MergeableHistogram((0.01, 0.1, 1.0))
    for v in (0.005, 0.01, 0.02, 0.5, 2.0):
        h.observe(v)
    assert h.counts == [2, 1, 1, 1] and h.count == 5
    assert h.sum == pytest.approx(2.535)
    assert h.cumulative() == [2, 3, 4, 5]
    assert h.to_dict() == {"edges": [0.01, 0.1, 1.0], "counts": [2, 1, 1, 1],
                           "count": 5, "sum": round(2.535, 9)}


def test_summed_buckets_bit_equal_pooled_and_within_one_bucket():
    rng = np.random.default_rng(7)
    edges = tfleet.DEFAULT_HIST_EDGES
    replicas, pooled = [], []
    for _ in range(3):
        vals = [float(v) for v in rng.lognormal(-4.0, 1.5, size=257)]
        hs = [m.MergeableHistogram(edges) for m in (jfleet, tfleet)]
        for v in vals:
            for h in hs:
                h.observe(v)
        assert hs[1].to_dict() == hs[0].to_dict()
        replicas.append(hs[1])
        pooled.extend(vals)
    merged = tfleet.merge_hists(h.to_dict() for h in replicas)
    assert merged == jfleet.merge_hists(h.to_dict() for h in replicas)
    hp = tfleet.MergeableHistogram(edges)
    for v in pooled:
        hp.observe(v)
    assert merged["counts"] == hp.counts and merged["count"] == len(pooled)
    pooled.sort()
    for q in (0.5, 0.95, 0.99):
        got = tfleet.hist_pctl(merged["edges"], merged["counts"], q)
        assert got == tfleet.hist_pctl(hp.edges, hp.counts, q)
        assert got == jfleet.hist_pctl(merged["edges"], merged["counts"], q)
        raw = tsl.pctl(pooled, q)
        i = next((k for k, e in enumerate(edges) if raw <= e), len(edges))
        lo = 0.0 if i == 0 else edges[i - 1]
        assert raw <= got <= raw + edges[min(i, len(edges) - 1)] - lo + 1e-12


@MODS
def test_pctl_empty_and_single_observation_edges(fl):
    assert tsl.pctl([], 0.99) == jsl.pctl([], 0.99) == 0.0
    assert tsl.percentiles([]) is None
    for q in (0.0, 0.5, 0.99):
        assert tsl.pctl([0.042], q) == 0.042
    assert tsl.percentiles([0.042]) == jsl.percentiles([0.042])
    assert fl.hist_pctl((0.01, 0.1), [0, 0, 0], 0.99) is None
    assert fl.hist_percentiles(None) is None
    assert fl.hist_percentiles({"count": 0}) is None
    h = fl.MergeableHistogram((0.01, 0.1))
    h.observe(0.05)
    for q in (0.0, 0.5, 0.99):
        assert fl.hist_pctl(h.edges, h.counts, q) == 0.1
    h2 = fl.MergeableHistogram((0.01,))
    h2.observe(5.0)
    assert fl.hist_pctl(h2.edges, h2.counts, 0.5) == float("inf")


def test_merge_hists_skips_mismatched_edges():
    a = tfleet.MergeableHistogram((0.01, 0.1))
    b = jfleet.MergeableHistogram((0.02, 0.2))
    a.observe(0.05)
    b.observe(0.05)
    for fl in (jfleet, tfleet):
        merged = fl.merge_hists([a.to_dict(), b.to_dict()])
        assert merged["count"] == 1 and merged["skipped"] == 1
        assert fl.merge_hists([]) is None
        assert fl.merge_hists([{"bogus": 1}]) is None


# ------------------------------------------------- registration/discovery
@pytest.mark.parametrize("writer,reader", [(tfleet, jfleet), (jfleet, tfleet)],
                         ids=["port-writes", "jax-writes"])
def test_registration_roundtrip_and_torn_file(tmp_path, writer, reader):
    d = str(tmp_path / "fleet")
    path = writer.register_replica(
        d, "http://127.0.0.1:9100", identity={"id": "pod-a", "attempt": 2})
    assert os.path.basename(path) == "replica-pod-a.json"
    writer.register_replica(
        d, "http://127.0.0.1:9101", identity={"id": "pod-a", "attempt": 3})
    (reg,) = reader.read_registrations(d)
    assert reg["url"] == "http://127.0.0.1:9101"
    assert reg["replica"]["attempt"] == 3
    with open(os.path.join(d, "replica-torn.json"), "w") as f:
        f.write('{"url": "http://trunca')
    with open(os.path.join(d, "replica-notdict.json"), "w") as f:
        f.write('"just a string"')
    for fl in (jfleet, tfleet):
        assert [r["replica"]["id"] for r in fl.read_registrations(d)] == [
            "pod-a"]
    assert tfleet.read_registrations(str(tmp_path / "missing")) == []


def test_maybe_register_gate_and_identity(tmp_path, monkeypatch):
    assert tfleet.maybe_register("http://x:1") is None
    d = str(tmp_path / "reg")
    path = tfleet.maybe_register("http://127.0.0.1:7777", d)
    (rec,) = jfleet.read_registrations(d)
    assert rec["url"] == "http://127.0.0.1:7777"
    monkeypatch.delenv("TPUFLOW_FLEET_REPLICA_ID", raising=False)
    jid = jfleet.replica_identity()
    assert rec["replica"]["id"] == jid["id"]  # host-pid default
    # The launch attempt: the JAX knob, the port's preempt.configure.
    from tpuflow_torch.utils import preempt

    before = preempt.launch_attempt()
    monkeypatch.setenv("TPUFLOW_ATTEMPT", "3")
    preempt.configure(attempt=3)
    try:
        assert tfleet.replica_identity()["attempt"] == jfleet.replica_identity(
        )["attempt"] == 3
    finally:
        preempt.configure(attempt=before)
    os.remove(path)
    monkeypatch.setenv("TPUFLOW_FLEET_REPLICA_ID", "pod-7")
    tfleet.maybe_register("http://127.0.0.1:7778", d, replica_id="pod-7")
    (rec,) = jfleet.read_registrations(d)
    assert rec["replica"]["id"] == jfleet.replica_identity()["id"] == "pod-7"


def test_discover_replicas_modes(tmp_path, monkeypatch):
    for k in ("TPUFLOW_FLEET_REPLICAS", "TPUFLOW_FLEET_REGISTRATION_DIR"):
        monkeypatch.delenv(k, raising=False)
    assert tfleet.discover_replicas() == jfleet.discover_replicas() == []
    target = "127.0.0.1:8080/, http://127.0.0.1:8081"
    assert tfleet.discover_replicas(target) == jfleet.discover_replicas(
        target)
    assert [u for u, _ in tfleet.discover_replicas(target)] == [
        "http://127.0.0.1:8080", "http://127.0.0.1:8081"]
    monkeypatch.setenv("TPUFLOW_FLEET_REPLICAS", "127.0.0.1:9000")
    assert tfleet.discover_replicas(
        replicas="127.0.0.1:9000") == jfleet.discover_replicas() == [
        ("http://127.0.0.1:9000", None)]
    d = str(tmp_path / "reg")
    tfleet.register_replica(d, "http://127.0.0.1:9001", identity={"id": "r1"})
    assert tfleet.discover_replicas(
        d, replicas="127.0.0.1:9000") == jfleet.discover_replicas(d)
    monkeypatch.delenv("TPUFLOW_FLEET_REPLICAS", raising=False)
    monkeypatch.setenv("TPUFLOW_FLEET_REGISTRATION_DIR", d)
    assert tfleet.discover_replicas(
        registration_dir=d) == jfleet.discover_replicas() == [
        ("http://127.0.0.1:9001", "r1")]


# ---------------------------------------------------------- health score
def test_health_score_rules():
    cases = [(None, True, 0, False), ({"ok": 1}, True, 0, False),
             ({"serve_queue_depth": 1}, False, 0, False),
             ({"nonfinite_steps": 2}, False, 0, False),
             ({"loss": float("nan")}, False, 0, False),
             ({}, False, 3, False), ({}, False, 0, True),
             ({"nonfinite_steps": 1}, False, 1, True)]
    rng = np.random.default_rng(3)
    for _ in range(20):
        st = {"serve_queue_depth": int(rng.integers(0, 5)),
              "nonfinite_steps": int(rng.integers(0, 2)),
              "loss": float(rng.choice([0.5, np.nan]))}
        cases.append((st, bool(rng.integers(0, 2)), int(rng.integers(-1, 3)),
                      bool(rng.integers(0, 2))))
    for st, stale, slo, q in cases:
        got = tfleet.health_score(st, stale=stale, slo_delta=slo,
                                  queue_growing=q)
        assert got == jfleet.health_score(st, stale=stale, slo_delta=slo,
                                          queue_growing=q)
    assert tfleet.health_score(
        {"nonfinite_steps": 1}, stale=False, slo_delta=1,
        queue_growing=True) == (0.0, ["nonfinite", "slo_violating",
                                      "queue_growing"])


# ------------------------------------------------------------ aggregation
def _status(q=0, occ=0.5, util=0.8, requests=10, slo=0, tps=100.0, pages=4,
            ttft_hist=None, slo_by_group=None, req_by_group=None, **extra):
    st = {"serve_queue_depth": q, "serve_slot_occupancy": occ,
          "serve_decode_utilization": util, "serve_requests": requests,
          "serve_slo_violations": slo, "serve_tokens_per_s": tps,
          "serve_pages_free": pages, **extra}
    if ttft_hist:
        st["serve_ttft_hist"] = ttft_hist
    if slo_by_group:
        st["serve_slo_by_group"] = slo_by_group
    if req_by_group:
        st["serve_requests_by_group"] = req_by_group
    return st


def test_aggregate_sums_weights_and_group_rates():
    rng = np.random.default_rng(4)
    statuses = []
    for i in range(4):
        h = tfleet.MergeableHistogram()
        for v in rng.lognormal(-3.0, 1.0, size=int(rng.integers(1, 30))):
            h.observe(float(v))
        statuses.append(_status(
            q=int(rng.integers(0, 6)), occ=float(rng.random()),
            util=float(rng.random()), requests=int(rng.integers(0, 50)),
            slo=int(rng.integers(0, 4)), tps=float(rng.random() * 500),
            ttft_hist=h.to_dict(),
            slo_by_group={"fp.plain": int(rng.integers(0, 3))},
            req_by_group={"fp.plain": int(rng.integers(1, 20)),
                          "int8.plain": int(rng.integers(0, 9))},
            hbm_used_frac=float(rng.random()),
            serve_pages_host=int(rng.integers(0, 9))))
    assert tfleet.aggregate(statuses) == jfleet.aggregate(statuses)
    assert tfleet.aggregate([]) == jfleet.aggregate([]) == {"replicas": 0}
    h1 = tfleet.MergeableHistogram((0.01, 0.1, 1.0))
    h2 = tfleet.MergeableHistogram((0.01, 0.1, 1.0))
    for v in (0.005, 0.05):
        h1.observe(v)
    for v in (0.5, 0.5, 0.05):
        h2.observe(v)
    out = tfleet.aggregate([
        _status(q=2, occ=1.0, util=0.9, requests=30, slo=3, tps=200.0,
                ttft_hist=h1.to_dict(), slo_by_group={"fp.plain": 3},
                req_by_group={"fp.plain": 20, "int8.plain": 10}),
        _status(q=1, occ=0.0, util=0.1, requests=10, slo=1, tps=50.0,
                ttft_hist=h2.to_dict(), slo_by_group={"int8.plain": 1},
                req_by_group={"int8.plain": 10})])
    assert (out["queue_depth"], out["requests"], out["slo_violations"]) == (
        3, 40, 4)
    assert out["decode_utilization"] == pytest.approx(0.9, abs=1e-6)
    assert (out["ttft"]["p50"], out["ttft"]["p99"]) == (0.1, 1.0)
    assert out["slo_rate_by_group"]["fp.plain"] == pytest.approx(3 / 20)


# ----------------------------------------------------------------- poller
def _both(target, fetch, **kw):
    return [fl.FleetObservatory(target, fetch=fetch, **kw)
            for fl in (jfleet, tfleet)]


def _rows(snap):
    return [_untimed(r, ROW_TIME_KEYS) for r in snap["replicas"]]


def test_poller_marks_malformed_status_stale_never_crashes():
    calls = {"n": 0}

    def fetch(url, timeout_s):
        calls["n"] += 1
        if url.endswith("9001"):
            json.loads('{"steps": 12, "serve_')
        if url.endswith("9002"):
            raise OSError("connection refused")
        return _status(requests=5)

    obs_j, obs_t = _both("127.0.0.1:9000,127.0.0.1:9001,127.0.0.1:9002",
                         fetch, stale_s=10.0, poll_interval_s=5.0)
    sj, st = obs_j.poll(), obs_t.poll()
    assert _rows(st) == _rows(sj)
    assert _untimed(st["fleet"], {"qps"}) == _untimed(sj["fleet"], {"qps"})
    rows = {r["url"].rsplit(":", 1)[1]: r for r in st["replicas"]}
    assert rows["9001"]["stale"] and rows["9001"]["health"] == 0.0
    assert rows["9002"]["stale"] and "error" in rows["9002"]
    assert (st["fleet"]["replicas"], st["fleet"]["healthy"],
            st["fleet"]["stale"]) == (3, 1, 2)
    n = calls["n"]
    obs_t.poll()
    assert calls["n"] == n + 1  # the failed replicas back off


def test_poller_staleness_threshold_and_recovery():
    alive = {"ok": True}

    def fetch(url, timeout_s):
        if not alive["ok"]:
            raise OSError("down")
        return _status(requests=1)

    for obsy in _both("127.0.0.1:9000", fetch, stale_s=0.05,
                      poll_interval_s=0.01):
        alive["ok"] = True
        assert not obsy.poll()["replicas"][0]["stale"]
        alive["ok"] = False
        time.sleep(0.06)
        (row,) = obsy.poll()["replicas"]
        assert row["stale"] and row["age_s"] >= 0.05
        alive["ok"] = True
        time.sleep(0.02)
        assert not obsy.poll()["replicas"][0]["stale"]


def test_poller_qps_queue_trend_and_snapshot_jsonl(tmp_path):
    state = {"requests": 0, "q": 0, "slo": 0}

    def fetch(url, timeout_s):
        return _status(q=state["q"], requests=state["requests"],
                       slo=state["slo"])

    paths = [str(tmp_path / n / "fleet.jsonl") for n in ("j", "t")]
    obs_j, obs_t = (fl.FleetObservatory(
        "127.0.0.1:9000", stale_s=10.0, poll_interval_s=0.01,
        snapshot_path=p, fetch=fetch) for fl, p in zip((jfleet, tfleet),
                                                       paths))
    snaps = []
    for upd in ({}, {"requests": 50, "q": 1}, {"q": 2, "slo": 1}):
        state.update(upd)
        time.sleep(0.01)
        snaps.append((obs_j.poll(), obs_t.poll()))
    for sj, st in snaps:
        assert _rows(st) == _rows(sj)
    (row,) = snaps[-1][1]["replicas"]
    assert "queue_growing" in row["health_reasons"]
    assert "slo_violating" in row["health_reasons"]
    assert row["health"] == pytest.approx(0.5)
    assert snaps[1][1]["replicas"][0]["qps"] > 0
    lines = jfleet.read_snapshots(paths[1])
    assert len(lines) == 3 and lines[-1]["fleet"]["replicas"] == 1
    assert len(tfleet.read_snapshots(paths[0])) == 3


def test_append_snapshot_multi_writer_and_torn_tail(tmp_path):
    path = str(tmp_path / "trail" / "fleet.jsonl")
    n_writers, n_each = 8, 25
    barrier = threading.Barrier(n_writers)
    oks: list[bool] = []

    def writer(k):
        barrier.wait()
        for i in range(n_each):
            oks.append(tfleet.append_snapshot(
                path, {"fleet": {"writer": k, "seq": i}}))

    threads = [threading.Thread(target=writer, args=(k,))
               for k in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(oks)
    snaps = tfleet.read_snapshots(path)
    assert snaps == jfleet.read_snapshots(path)
    assert len(snaps) == n_writers * n_each
    for k in range(n_writers):
        assert [s["fleet"]["seq"] for s in snaps
                if s["fleet"]["writer"] == k] == list(range(n_each))
    with open(path, "a") as f:
        f.write('{"fleet": {"torn": tru')
    assert len(tfleet.read_snapshots(path)) == n_writers * n_each
    tfleet.append_snapshot(path, {"fleet": {"merged_into_torn": True}})
    tfleet.append_snapshot(path, {"fleet": {"clean": True}})
    with open(path, "a") as f:
        f.write('"just a string"\n{"no_fleet": 1}\n')
    snaps = tfleet.read_snapshots(path)
    assert snaps == jfleet.read_snapshots(path)
    assert len(snaps) == n_writers * n_each + 1
    assert snaps[-1]["fleet"] == {"clean": True}
    assert tfleet.read_snapshots(str(tmp_path / "missing.jsonl")) == []


def test_format_lines_smoke():
    fleet_row = {"replicas": 2, "healthy": 1, "stale": 1, "qps": 12.5,
                 "tokens_per_s": 900.0, "queue_depth": 3,
                 "decode_utilization": 0.75, "slo_violations": 2,
                 "ttft": {"p99": 0.25}, "itl": {"p99": 0.012},
                 "hbm_used_frac_max": 0.5, "hbm_peak_frac_max": 0.75}
    rows = [{"id": "pod-b", "stale": True, "health": 0.0,
             "health_reasons": ["stale"], "age_s": 3.2, "error": "down"},
            {"id": "pod-a", "stale": False, "health": 0.75,
             "health_reasons": ["queue_growing"], "serve_queue_depth": 4,
             "hbm_used_frac": 0.3}]
    line = tfleet.format_fleet_line(fleet_row)
    assert line == jfleet.format_fleet_line(fleet_row)
    assert "n=2" in line and "ttft99=0.250s" in line
    for r in rows:
        assert tfleet.format_replica_line(r) == jfleet.format_replica_line(r)
    assert "health=0.75(queue_growing)" in tfleet.format_replica_line(rows[1])


# ----------------------------------------- live ledgers, served and polled
def _feed(led, seed):
    """One note sequence, made from ``seed``: every ``note_*`` of the
    ledger's serving and training views."""
    rng = np.random.default_rng(seed)
    led.set_model_flops_per_token(6 * 124e6)
    led.note_compile(0.5)
    for step in range(3):
        led.note_step(0.1, tokens=8192, step=step)
    led.note_report(3, loss=2.5)
    led.note_health(2.5, 1.25, nonfinite=False)
    led.note_device_hbm(2**30, 3 * 2**29, 80 * 2**30)
    led.note_serve_state(queue_depth=2, live_slots=3, max_slots=8)
    led.note_serve_pages(free=40, total=96)
    led.note_serve_prefix(hits=3, lookups=7)
    led.note_serve_role("both")
    led.note_serve_tiers(host=2, disk=1, hits=4)
    led.note_serve_spec(committed=21, forwards=10)
    led.note_serve_generate_url("http://127.0.0.1:1/generate")
    led.note_serve_draining(True)
    groups = list(jsl.GROUPS)
    for _ in range(30):
        g = groups[int(rng.integers(0, 4))]
        led.note_serve_ttft(float(rng.lognormal(-3.5, 1.0)))
        for v in rng.lognormal(-6.0, 0.8, size=int(rng.integers(1, 4))):
            led.note_serve_itl(float(v))
        led.note_serve_tokens(int(rng.integers(1, 9)))
        led.note_serve_complete(g)
    led.note_serve_ledger(
        {"idle": 0.25, "decode": 0.5, "prefill": 0.125, "insert": 0.0625,
         "host_sched": 0.0625}, utilization=0.75, masked_waste=0.125,
        slo_violations=5, slo_by_group={"fp.plain": 3, "int8.spec": 2})


def test_process_ledgers_equal_on_one_note_sequence():
    jled, tled = JLedger(), TLedger()
    for led in (jled, tled):
        assert "serve_queue_depth" not in led.snapshot()
        _feed(led, 11)
    js, ts = jled.snapshot(), tled.snapshot()
    assert "mfu" not in ts and "mfu" not in js  # no card, no TPU
    assert _untimed(ts, LEDGER_TIME_KEYS) == _untimed(js, LEDGER_TIME_KEYS)
    assert set(ts) == set(js)

    def lines(snap):
        return [ln for ln in texport.prometheus_text(snap).splitlines()
                if not any(k in ln for k in ("uptime", "tokens_per_s",
                                             "step_rate", "goodput"))]

    jlines = [ln for ln in jexport.prometheus_text(js).splitlines()
              if not any(k in ln for k in ("uptime", "tokens_per_s",
                                           "step_rate", "goodput"))]
    assert lines(ts) == jlines
    text = texport.prometheus_text(ts)
    assert 'tpuflow_serve_ttft_seconds_bucket{le="+Inf"} 30' in text
    assert "tpuflow_serve_pages_host 2" in text


def test_process_ledger_histograms_ride_status_and_prometheus():
    led = TLedger()
    led.note_serve_state(queue_depth=0, live_slots=1, max_slots=2)
    for v in (0.004, 0.03, 0.3):
        led.note_serve_ttft(v)
    led.note_serve_itl(0.002)
    led.note_serve_complete("fp.plain")
    led.note_serve_complete("int8.spec")
    led.note_serve_ledger({"idle": 0.5, "decode": 0.5}, slo_violations=2,
                          slo_by_group={"fp.plain": 2})
    snap = led.snapshot()
    assert snap["serve_ttft_hist"]["count"] == 3
    assert snap["serve_itl_hist"]["count"] == 1
    assert snap["serve_requests_by_group"] == {"fp.plain": 1, "int8.spec": 1}
    text = texport.prometheus_text(snap)
    assert "# TYPE tpuflow_serve_ttft_seconds histogram" in text
    assert 'tpuflow_serve_ttft_seconds_bucket{le="+Inf"} 3' in text
    les = [int(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
           if ln.startswith("tpuflow_serve_ttft_seconds_bucket")]
    assert les == sorted(les) and les[-1] == 3


def test_observatories_poll_across_packages():
    """A JAX observatory polls a port MetricsServer, and the port's polls a
    JAX one: each row equals the row of a same-package replica fed the
    same notes; /status carries the JAX keys; /alerts answers 404 (no
    alert engine on either side here)."""
    leds = {"jax": JLedger(), "port": TLedger()}
    for led in leds.values():
        _feed(led, 12)
    servers = {
        "jax": jexport.MetricsServer(0, snapshot_fn=leds["jax"].snapshot),
        "port": texport.MetricsServer(0, snapshot_fn=leds["port"].snapshot),
    }
    try:
        rows = {}
        for obs_name, fl in (("jax", jfleet), ("port", tfleet)):
            for srv_name, srv in servers.items():
                obsy = fl.FleetObservatory(srv.url, stale_s=30.0)
                (row,) = obsy.poll()["replicas"]
                assert not row["stale"], row
                rows[obs_name, srv_name] = row
        same_j = _untimed(rows["jax", "jax"], ROW_TIME_KEYS)
        same_t = _untimed(rows["port", "port"], ROW_TIME_KEYS)
        assert _untimed(rows["jax", "port"], ROW_TIME_KEYS) == same_j
        assert _untimed(rows["port", "jax"], ROW_TIME_KEYS) == same_t
        assert same_j == same_t
        assert rows["jax", "port"]["generate_url"] == (
            "http://127.0.0.1:1/generate")
        assert rows["jax", "port"]["replica"]["id"] == rows[
            "jax", "jax"]["replica"]["id"]
        with urllib.request.urlopen(servers["port"].url + "/status",
                                    timeout=5) as r:
            tstat = json.loads(r.read())
        with urllib.request.urlopen(servers["jax"].url + "/status",
                                    timeout=5) as r:
            jstat = json.loads(r.read())
        assert set(tstat) == set(jstat)
        assert tstat["pid"] == os.getpid()
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(servers["port"].url + "/alerts",
                                   timeout=5)
    finally:
        for srv in servers.values():
            srv.close()


def test_start_export_idempotent_member_zero_and_registers(tmp_path):
    """``start_export``: member 0 only, one server a process, the
    ``obs.export`` event, the registration under ``replica_id``, a bind
    failure printed and export disabled, a bad port a ``ValueError``."""
    from tpuflow_torch import obs as tobs

    texport.stop()
    reg = str(tmp_path / "reg")
    tobs.configure(str(tmp_path / "obs"), proc=0)
    try:
        assert tobs.start_export(0, proc=1) is None
        for bad in ("9100", -1, 1.5, True, None):
            with pytest.raises(ValueError, match="port"):
                tobs.start_export(bad)
        srv = tobs.start_export(0, registration_dir=reg, replica_id="pod-z")
        assert srv is not None and texport._SERVER is srv
        assert tobs.start_export(0) is srv
        (rec,) = jfleet.read_registrations(reg)
        assert rec["url"] == srv.url and rec["replica"]["id"] == "pod-z"
        with urllib.request.urlopen(srv.url + "/status", timeout=5) as r:
            assert json.loads(r.read())["replica"]["id"] == "pod-z"
        tobs.flush()
        events = tobs.read_events(tobs.recorder().path)
        assert [e["port"] for e in events
                if e["name"] == "obs.export"] == [srv.port]
        texport.stop()
        assert texport._SERVER is None
        taken = texport.MetricsServer(0)
        try:
            assert tobs.start_export(taken.port) is None
        finally:
            taken.close()
    finally:
        texport.stop()
        tobs.configure(None)


def test_three_live_replicas_fleet_summary_bit_equal_and_staleness(
        tmp_path, capsys):
    """Three exporting in-process port replicas (each a MetricsServer over
    its own ledger) and one registered but killed, in a registration
    directory: the JAX ``fleet-summary`` CLI and the port's observatory
    report the same fleet, whose TTFT/ITL percentiles are bit-equal to
    pooling the replicas' access logs on the shared edges, and mark the
    killed replica stale."""
    from tpuflow.obs.__main__ import main as obs_main

    rng = np.random.default_rng(23)
    reg = str(tmp_path / "fleet")
    servers, run_dirs = [], []
    try:
        for i in range(3):
            led = TLedger()
            led.note_serve_state(queue_depth=i, live_slots=1 + i,
                                 max_slots=4)
            run_dir = str(tmp_path / f"run{i}")
            log = tsl.AccessLog(os.path.join(run_dir, "obs"), proc=0)
            run_dirs.append(run_dir)
            for k in range(40):
                ttft = float(rng.lognormal(-3.5, 1.0))
                itls = [float(v) for v in rng.lognormal(
                    -6.0, 0.8, size=int(rng.integers(1, 5)))]
                led.note_serve_ttft(ttft)
                for v in itls:
                    led.note_serve_itl(v)
                led.note_serve_complete("fp.plain")
                log.write({"request": k, "ts": k, "group": "fp.plain",
                           "tokens": len(itls) + 1,
                           "finish_reason": "budget", "ttft_s": ttft,
                           "itl_s": itls})
            ident = {"id": f"replica-{i}", "attempt": 0}
            srv = texport.MetricsServer(
                0, snapshot_fn=(lambda led=led, ident=ident: {
                    **led.snapshot(), "replica": ident}))
            servers.append(srv)
            tfleet.register_replica(reg, srv.url, identity=ident)
        dead = texport.MetricsServer(0)
        tfleet.register_replica(reg, dead.url,
                                identity={"id": "replica-dead",
                                          "attempt": 0})
        dead.close()
        with urllib.request.urlopen(servers[0].url + "/metrics",
                                    timeout=5) as r:
            text = r.read().decode()
        assert 'tpuflow_serve_ttft_seconds_bucket{le="+Inf"} 40' in text
        assert "tpuflow_serve_ttft_seconds_count 40" in text
        assert obs_main(["fleet-summary", reg, "--json"]) == 0
        snap = json.loads(capsys.readouterr().out)
        mine = tfleet.FleetObservatory(reg, stale_s=5.0).poll()
        for s in (snap, mine):
            fl = s["fleet"]
            assert (fl["replicas"], fl["stale"], fl["healthy"]) == (4, 1, 3)
            assert fl["requests"] == 120
            assert fl["requests_by_group"] == {"fp.plain": 120}
        assert _untimed(mine["fleet"], {"qps"}) == _untimed(
            snap["fleet"], {"qps"})
        assert sorted(json.dumps(r, sort_keys=True) for r in _rows(mine)) == \
            sorted(json.dumps(r, sort_keys=True) for r in _rows(snap))
        pooled_ttft, pooled_itl = [], []
        for rd in run_dirs:
            for rec in jsl.load_access_log(rd):
                pooled_ttft.append(rec["ttft_s"])
                pooled_itl.extend(rec["itl_s"])
        for which, pooled in (("ttft", pooled_ttft), ("itl", pooled_itl)):
            hp = tfleet.MergeableHistogram()
            for v in pooled:
                hp.observe(v)
            assert mine["fleet"][f"{which}_hist"]["counts"] == hp.counts
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                want = tfleet.hist_pctl(hp.edges, hp.counts, q)
                assert mine["fleet"][which][key] == want, (which, key)
                assert want >= tsl.pctl(sorted(pooled), q)
        dead_row = next(r for r in mine["replicas"]
                        if r["id"] == "replica-dead")
        assert dead_row["stale"] and dead_row["health"] == 0.0
    finally:
        for srv in servers:
            srv.close()
