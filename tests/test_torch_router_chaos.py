"""The fleet front on the port, end to end over real sockets: port
``LocalReplica``s (``tpuflow_torch/testing/chaos.py``), each a live
``ServeEngine`` with its gateway, ledger and ``/status``, discovered
through a registration directory and polled by the port's fleet
observatory, behind the port's ``Router`` and ``FrontDoor``, on the small
GPT-2 whose weights come from JAX (``tests/torch_parity.py``).

Fast tier:
- ``main`` (the ``python -m tpuflow_torch.infer.frontdoor`` entry) in
  front of two replicas: every answer EQUAL to the JAX ``generate()`` on
  the same weights, a repeated prompt routed by affinity, each request's
  spans across the door and the replica that served it;
- a port replica with default arguments records ``gateway.hold`` and the
  ``serve.*`` lifecycle spans of a traced request, as a JAX replica does
  with the JAX defaults, to the same span structure and tokens.

Slow tier (``-m slow``), the port's counterparts of
``tests/test_router_chaos.py``'s three drives (kill + stall under Poisson
load, a traced reroute, a drain) and of
``tests/test_serve_disagg.py::test_chaos_prefill_worker_dies_mid_ship``:
zero drops and every answer equal to the port's solo ``generate()``
(itself pinned to the JAX one by ``tests/test_torch_generate.py``).
"""

import importlib
import json
import os
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow_torch import obs as tobs
from tpuflow_torch.infer import frontdoor as tfront
from tpuflow_torch.infer.generate import generate
from tpuflow_torch.infer.router import FleetBusy, Router
from tpuflow_torch.infer.serve import ServeEngine
from tpuflow_torch.obs import fleet as tfleet
from tpuflow_torch.obs import trace as ttrace
from tpuflow_torch.testing import faults
from tpuflow_torch.testing.chaos import (
    LocalReplica,
    apply_replica_plan,
    run_poisson,
)

jgen = importlib.import_module("tpuflow.infer.generate")
jserve = importlib.import_module("tpuflow.infer.serve")
jfront = importlib.import_module("tpuflow.infer.frontdoor")
jobs = importlib.import_module("tpuflow.obs")

NEW = 6
STALE_S = 10.0
SERVE_SPANS = {"serve.queue", "serve.prefill", "serve.first_tick",
               "serve.decode", "serve.lifecycle"}


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 512, size=n).astype(
        np.int32)


def _jax_solo(pair, prompt, n=NEW):
    jm, params, _ = pair
    return np.asarray(jgen.generate(
        jm, params, jnp.asarray(np.asarray(prompt, np.int32)[None]),
        max_new_tokens=n, temperature=0.0))[0].tolist()


def _solo(tm, prompt, n=NEW):
    return generate(tm, np.asarray(prompt, np.int32)[None, :],
                    max_new_tokens=n, temperature=0.0)[0].tolist()


def _post(url, obj, timeout=60.0):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _door_submit(door_url, timeout=130.0):
    """The load harness's submit over HTTP: a 503 is an explicit
    FleetBusy, never a drop."""
    def submit(req):
        code, body = _post(door_url + "/generate", req, timeout=timeout)
        if code == 503:
            raise FleetBusy(body.get("error", ""))
        if code != 200:
            raise RuntimeError(f"{code}: {body}")
        return body

    return submit


def _engine(tm, **kw):
    return ServeEngine(tm, max_slots=2, decode_block=4, buckets=[16, 32],
                       page_size=8, **kw)


def _replicas(tm, ids, reg, lock, engine_kw=None, **kw):
    """In-process replicas ``ids`` sharing ``lock`` for device work; each
    engine built with ``engine_kw.get(id, {})``."""
    engine_kw = engine_kw or {}
    return {rid: LocalReplica(rid, _engine(tm, **engine_kw.get(rid, {})),
                              registration_dir=reg, device_lock=lock, **kw)
            for rid in ids}


# ------------------------------------------------------------ fast tier
def test_frontdoor_main_over_two_replicas_equals_jax_generate(pair,
                                                              tmp_path):
    """``main([reg, ...])`` on the main thread (it installs its SIGINT /
    SIGTERM handlers there), clients on threads: three prompts at once
    and a repeat of the first, every answer equal to the JAX
    ``generate()``; the repeat takes the affinity route to the replica
    that served the first; a SIGTERM ends ``main`` with 0."""
    _, _, tm = pair
    prompts = [_prompt(s, 12) for s in range(3)]  # one JAX compile
    want = [_jax_solo(pair, p) for p in prompts]
    reg, tdir = str(tmp_path / "fleet"), str(tmp_path / "trace")
    os.makedirs(reg)
    reps = _replicas(tm, ("rep-0", "rep-1"), reg, threading.Lock(),
                     trace_dir=tdir)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    old = {sig: signal.getsignal(sig) for sig in (signal.SIGINT,
                                                  signal.SIGTERM)}
    got, errors = {}, []

    def client():
        try:
            deadline = time.monotonic() + 30.0
            while signal.getsignal(signal.SIGTERM) is old[signal.SIGTERM]:
                assert time.monotonic() < deadline, "main never started"
                time.sleep(0.01)
            threads = [threading.Thread(target=lambda k=k: got.__setitem__(
                f"q{k}", _post(url + "/generate", {
                    "id": f"q{k}", "prompt": prompts[k].tolist(),
                    "max_new_tokens": NEW}))) for k in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
            got["again"] = _post(url + "/generate", {
                "id": "again", "prompt": prompts[0].tolist(),
                "max_new_tokens": NEW})
            with urllib.request.urlopen(url + "/status", timeout=10) as r:
                got["status"] = json.loads(r.read())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
        finally:
            # Only once main's handler is in: the default one would end
            # the test process.
            if signal.getsignal(signal.SIGTERM) is not old[signal.SIGTERM]:
                os.kill(os.getpid(), signal.SIGTERM)

    th = threading.Thread(target=client)
    try:
        th.start()
        rc = tfront.main([reg, "--port", str(port), "--poll-s", "0.05",
                          "--page-size", "8", "--trace-dir", tdir])
        th.join(60.0)
    finally:
        for sig, h in old.items():
            signal.signal(sig, h)
        for rep in reps.values():
            rep.close()
    assert not errors, errors
    assert rc == 0 and not th.is_alive()
    for k in range(3):
        assert got[f"q{k}"] == (200, {"id": f"q{k}", "tokens": want[k],
                                      "finish_reason": "budget"})
    assert got["again"][1]["tokens"] == want[0]
    st = got["status"]
    assert st["router_requests"] == 4 and st["router_dropped"] == 0
    assert st["router_affinity_hits"] >= 1
    fwd = {rid: [s for s in ttrace.spans_for_request(tdir, rid)
                 if s["name"] == "router.forward"][0]["replica"]
           for rid in ("q0", "again")}
    assert fwd["again"] == fwd["q0"]
    spans = ttrace.spans_for_request(tdir, "again")
    names = {s["name"] for s in spans}
    assert {"router.ingress", "router.queue", "router.forward",
            "gateway.hold"} | SERVE_SPANS <= names
    served = {s["writer"] for s in spans if s["name"].startswith("serve.")}
    assert served == {fwd["again"]}
    a = ttrace.assemble(spans)
    assert a["writers"] == sorted(["frontdoor", fwd["again"]])
    assert [s["segment"] for s in a["critical_path"]] == [
        "router_queue", "replica_queue", "prefill", "first_decode_tick",
        "decode"]


def _stepper(gw, eng, stop):
    def run():
        while not stop.is_set():
            with gw.lock:
                did = eng.step()
            if not did:
                time.sleep(0.002)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def test_default_replica_records_the_spans_jax_does(pair, tmp_path,
                                                    monkeypatch):
    """The JAX default is tracing on: a JAX replica (gateway over a JAX
    engine) under default knobs with a recorder configured writes the
    traced request's ``gateway.hold`` and ``serve.*`` spans to
    ``<recorder dir>/trace``. A port replica built with default arguments
    writes the same spans, parented alike, with equal tokens."""
    for k in ("TPUFLOW_TRACE", "TPUFLOW_TRACE_SAMPLE", "TPUFLOW_TRACE_DIR",
              "TPUFLOW_FLEET_REPLICA_ID", "TPUFLOW_SERVE_TRACE"):
        monkeypatch.delenv(k, raising=False)
    jm, params, tm = pair
    prompt = _prompt(7, 12)
    header = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"
    kw = dict(max_slots=2, decode_block=4, buckets=[16], page_size=8)
    seen = {}
    for name, o, eng, front in (
            ("jax", jobs, jserve.ServeEngine(jm, params, **kw), jfront),
            ("torch", tobs, ServeEngine(tm, **kw), tfront)):
        d = str(tmp_path / name)
        o.configure(d)
        gw = front.ReplicaGateway(eng)
        stop = threading.Event()
        th = _stepper(gw, eng, stop)
        try:
            code, body = gw.handle_generate(
                {"id": "r1", "prompt": prompt.tolist(),
                 "max_new_tokens": NEW}, traceparent=header)
        finally:
            stop.set()
            th.join(10.0)
            gw.close()
            o.configure(None)
        spans = sorted(ttrace.read_spans(os.path.join(d, "trace")),
                       key=lambda s: s["name"])
        seen[name] = (code, body, [
            (s["name"], s["parent"], s["request"], s["trace"],
             s.get("status"), s.get("terminal"), s.get("bucket"),
             s.get("ticks"), s.get("tokens"))
            for s in spans])
    assert seen["torch"] == seen["jax"]
    names = {s[0] for s in seen["torch"][2]}
    assert names == {"gateway.hold"} | SERVE_SPANS
    assert {s[1] for s in seen["torch"][2]} == {"b" * 16}
    assert seen["torch"][1]["tokens"] == _jax_solo(pair, prompt)


# ------------------------------------------------------------ slow tier
@pytest.mark.slow
def test_router_chaos_kill_and_stall_zero_drops(pair, tmp_path):
    """``tests/test_router_chaos.py``'s kill + stall drive on the port:
    three replicas, Poisson load through ``Router.route``, the fault plan
    ``replica_kill:rep-1@0.6,replica_stall:rep-2@0.3``. Zero drops, every
    answer equal to solo ``generate()``, at least one retry and one
    reroute, a finite fleet-merged TTFT p99."""
    _, _, tm = pair
    rng = np.random.default_rng(11)
    R, M = 18, 6
    pre = rng.integers(0, 512, size=8).astype(np.int32)
    prompts = []
    for k in range(R):
        if k % 3 == 0:
            tail = rng.integers(0, 512, size=int(rng.integers(1, 6)))
            prompts.append(np.concatenate([pre, tail.astype(np.int32)]))
        else:
            prompts.append(rng.integers(
                0, 512, size=int(rng.integers(4, 20))).astype(np.int32))
    expected = {f"req-{k}": _solo(tm, p, M) for k, p in enumerate(prompts)}
    reg = str(tmp_path / "fleet")
    reps = _replicas(tm, ("rep-0", "rep-1", "rep-2"), reg, threading.Lock())
    try:
        obsy = tfleet.FleetObservatory(reg, timeout_s=0.5, stale_s=STALE_S,
                                       poll_interval_s=0.02)
        router = Router(obsy.poll, tfront.http_forward, page_size=8,
                        timeout_s=3.0, retries=4, backoff_s=0.02,
                        queue_timeout_s=120.0, refresh_s=0.05)
        router.refresh(force=True)
        assert router.stats()["router_budget_pages"] > 0
        with faults.installing(
                "replica_kill:rep-1@0.6,replica_stall:rep-2@0.3"):
            plan = faults.replica_plan()
        assert plan == [("replica_stall", "rep-2", 0.3),
                        ("replica_kill", "rep-1", 0.6)]
        reqs = [{"id": f"req-{k}", "prompt": prompts[k].tolist(),
                 "max_new_tokens": M} for k in range(R)]
        t0 = time.monotonic()
        chaos = apply_replica_plan(reps, plan, t0=t0)
        results = run_poisson(router.route, reqs, rate_qps=20.0, rng=rng)
        chaos.join(timeout=30.0)
        wall = time.monotonic() - t0
        assert [r for r in results if r["outcome"] == "error"] == []
        stats = router.stats()
        assert stats["router_dropped"] == 0 and stats["router_inflight"] == 0
        oks = [r for r in results if r["outcome"] == "ok"]
        assert len(oks) == R
        for r in oks:
            rid = r["request"]["id"]
            assert r["response"]["tokens"] == expected[rid], rid
        assert stats["router_retries"] >= 1 and stats["router_reroutes"] >= 1
        assert max(r["latency_s"] for r in oks) < 60.0
        assert wall < STALE_S + 60.0
        snap = obsy.poll()
        ttft = snap["fleet"].get("ttft")
        assert ttft and np.isfinite(ttft["p99"])
        assert not {r["id"]: r for r in snap["replicas"]}["rep-0"]["stale"]
    finally:
        for rep in reps.values():
            rep.close()


@pytest.mark.slow
def test_traced_reroute_assembles_cross_replica_timeline(pair, tmp_path):
    """The traced reroute drive on the port: FrontDoor -> Router ->
    http_forward -> gateways -> engines, tracing armed, ``tr-1`` killed
    the moment a request is held there. A rerouted request's assembled
    trace spans both replicas (the failed forward on the dead one, the
    gateway and engine lifecycle on the winner, parented to the winning
    forward), its critical path names the reroute, and the fleet-merged
    p99 TTFT exemplar resolves to spans on disk."""
    _, _, tm = pair
    tdir = str(tmp_path / "trace")
    rng = np.random.default_rng(18)
    R, M = 18, 32
    prompts = [rng.integers(0, 512, size=int(L)).astype(np.int32)
               for L in rng.integers(4, 20, size=R)]
    expected = {f"tr-req-{k}": _solo(tm, p, M)
                for k, p in enumerate(prompts)}
    reg = str(tmp_path / "fleet")
    reps = _replicas(tm, ("tr-0", "tr-1", "tr-2"), reg, threading.Lock(),
                     trace_dir=tdir)
    door = None
    try:
        obsy = tfleet.FleetObservatory(reg, timeout_s=0.5, stale_s=STALE_S,
                                       poll_interval_s=0.02)
        router = Router(obsy.poll, tfront.http_forward, page_size=8,
                        timeout_s=3.0, retries=4, backoff_s=0.02,
                        queue_timeout_s=120.0, refresh_s=0.05)
        router.refresh(force=True)
        door = tfront.FrontDoor(router, port=0, trace_dir=tdir)
        reqs = [{"id": f"tr-req-{k}", "prompt": prompts[k].tolist(),
                 "max_new_tokens": M} for k in range(R)]
        box = {}

        def kill_when_held():
            deadline = time.monotonic() + 30.0
            gw = reps["tr-1"].gateway
            while time.monotonic() < deadline:
                if gw._handles:
                    box["chaos"] = apply_replica_plan(
                        reps, [("replica_kill", "tr-1", 0.0)],
                        t0=time.monotonic())
                    return
                time.sleep(0.002)

        killer = threading.Thread(target=kill_when_held, daemon=True)
        killer.start()
        results = run_poisson(_door_submit(door.url), reqs, rate_qps=30.0,
                              rng=rng)
        killer.join(timeout=35.0)
        assert "chaos" in box, "no request was ever held at tr-1"
        box["chaos"].join(timeout=30.0)
        assert [r for r in results if r["outcome"] == "error"] == []
        oks = {r["request"]["id"]: r for r in results
               if r["outcome"] == "ok"}
        for rid, r in oks.items():
            assert r["response"]["tokens"] == expected[rid], rid
        stats = router.stats()
        assert stats["router_dropped"] == 0 and stats["router_reroutes"] >= 1
        all_spans = ttrace.read_spans(tdir)
        rerouted = None
        for rid in oks:
            fwds = [s for s in all_spans if s.get("request") == rid
                    and s.get("name") == "router.forward"]
            if any(not f.get("ok") for f in fwds) and any(
                    f.get("ok") and f.get("reroute") for f in fwds):
                rerouted = rid
                break
        assert rerouted is not None
        spans = ttrace.spans_for_request(tdir, rerouted)
        a = ttrace.assemble(spans)
        assert a["rerouted"]
        assert {"router.ingress", "router.queue", "router.forward",
                "gateway.hold"} | SERVE_SPANS <= {s["name"] for s in spans}
        fwds = sorted((s for s in spans if s["name"] == "router.forward"),
                      key=lambda s: int(s.get("attempt") or 0))
        failed = [f for f in fwds if not f.get("ok")]
        winner = next(f for f in fwds if f.get("ok"))
        assert failed[0]["replica"] == "tr-1" != winner["replica"]
        assert winner["parent"] == failed[-1]["span"]
        for s in spans:
            if s["name"].startswith("serve."):
                assert s["parent"] == winner["span"], s
                assert s["writer"] == winner["replica"], s
        seg = next(x for x in a["critical_path"]
                   if x["segment"] == "reroute")
        assert (seg["from"], seg["to"]) == ("tr-1", winner["replica"])
        hist = obsy.poll()["fleet"].get("ttft_hist")
        ex = tfleet.hist_exemplar(hist, 0.99)
        assert isinstance(ex, str) and ttrace.spans_for_trace(tdir, ex)
    finally:
        if door is not None:
            door.close()
        for rep in reps.values():
            rep.close()


@pytest.mark.slow
def test_router_drain_reroutes_queued_work(pair, tmp_path):
    """The drain drive on the port: ``dr-0`` drains before a burst; its
    ledger flips ``serve_draining``, the router counts the flip once and
    sends every request to ``dr-1``; every answer equals solo
    ``generate()``."""
    _, _, tm = pair
    rng = np.random.default_rng(5)
    R, M = 8, 5
    prompts = [rng.integers(0, 512, size=int(L)).astype(np.int32)
               for L in rng.integers(4, 16, size=R)]
    expected = [_solo(tm, p, M) for p in prompts]
    reg = str(tmp_path / "fleet")
    reps = _replicas(tm, ("dr-0", "dr-1"), reg, threading.Lock())
    try:
        obsy = tfleet.FleetObservatory(reg, timeout_s=0.5, stale_s=STALE_S,
                                       poll_interval_s=0.02)
        router = Router(obsy.poll, tfront.http_forward, page_size=8,
                        timeout_s=5.0, retries=4, backoff_s=0.02,
                        queue_timeout_s=60.0, refresh_s=0.02)
        router.refresh(force=True)
        reps["dr-0"].drain()
        time.sleep(0.1)
        reqs = [{"id": f"dq-{k}", "prompt": prompts[k].tolist(),
                 "max_new_tokens": M} for k in range(R)]
        results = run_poisson(router.route, reqs, rate_qps=40.0, rng=rng)
        assert [r for r in results if r["outcome"] != "ok"] == []
        for k, r in enumerate(results):
            assert r["response"]["tokens"] == expected[k], k
        stats = router.stats()
        assert stats["router_dropped"] == 0 and stats["router_drains"] == 1
        assert reps["dr-0"].engine.queue_depth == 0
        assert reps["dr-0"].engine._next_id == 0  # admitted nothing
        rows = {r["id"]: r for r in obsy.poll()["replicas"]}
        assert rows["dr-0"].get("serve_draining") is True
    finally:
        for rep in reps.values():
            rep.close()


@pytest.mark.slow
def test_chaos_prefill_worker_dies_mid_ship(pair, tmp_path):
    """The disaggregated chaos drive on the port: one prefill and two
    decode replicas sharing a KV store behind the phase-aware router
    (``ship_min_tokens=8``) and a FrontDoor; the prefill worker killed by
    ``prefill_kill``. Zero drops, every answer equal to solo
    ``generate()``, ships while the worker lived, and every long prompt
    after the kill fell back to local prefill: the counters and the
    ``router.ship`` spans (ok before, not ok after) both show it."""
    _, _, tm = pair
    tdir, kv = str(tmp_path / "trace"), str(tmp_path / "kv")
    rng = np.random.default_rng(11)
    R, M = 16, 6
    prompts = [rng.integers(0, 512, size=int(L)).astype(np.int32)
               for L in rng.integers(4, 20, size=R)]
    expected = {f"dg-{k}": _solo(tm, p, M) for k, p in enumerate(prompts)}
    n_long_post = sum(1 for p in prompts[R // 2:] if len(p) >= 8)
    assert n_long_post >= 1
    reg = str(tmp_path / "fleet")
    reps = _replicas(tm, ("pf-0", "dc-0", "dc-1"), reg, threading.Lock(),
                     trace_dir=tdir, engine_kw={
                         "pf-0": {"role": "prefill", "kv_store_dir": kv},
                         "dc-0": {"role": "decode", "kv_store_dir": kv},
                         "dc-1": {"role": "decode", "kv_store_dir": kv}})
    door = None
    try:
        obsy = tfleet.FleetObservatory(reg, timeout_s=0.5, stale_s=10.0,
                                       poll_interval_s=0.02)
        router = Router(obsy.poll, tfront.http_forward, page_size=8,
                        timeout_s=3.0, retries=4, backoff_s=0.02,
                        queue_timeout_s=60.0, refresh_s=0.02,
                        ship_min_tokens=8)
        router.refresh(force=True)
        rows = {r["id"]: r for r in obsy.poll()["replicas"]}
        assert rows["pf-0"]["serve_role"] == "prefill"
        door = tfront.FrontDoor(router, port=0, trace_dir=tdir)
        submit = _door_submit(door.url, timeout=90.0)

        def batch(lo, hi):
            return [{"id": f"dg-{k}", "prompt": prompts[k].tolist(),
                     "max_new_tokens": M} for k in range(lo, hi)]

        results = run_poisson(submit, batch(0, R // 2), rate_qps=25.0,
                              rng=rng)
        assert [r for r in results if r["outcome"] != "ok"] == []
        ships_live = router.stats()["router_ships"]
        assert ships_live >= 1
        with faults.installing("prefill_kill:pf-0@0.0"):
            plan = faults.replica_plan()
        assert plan == [("prefill_kill", "pf-0", 0.0)]
        apply_replica_plan(reps, plan, t0=time.monotonic()).join(10.0)
        fb0 = router.stats()["router_ship_fallbacks"]
        results += run_poisson(submit, batch(R // 2, R), rate_qps=25.0,
                               rng=rng)
        assert [r for r in results if r["outcome"] != "ok"] == []
        for r in results:
            rid = r["request"]["id"]
            assert r["response"]["tokens"] == expected[rid], rid
        stats = router.stats()
        assert stats["router_dropped"] == 0
        assert stats["router_ship_fallbacks"] - fb0 >= n_long_post
        assert stats["router_ships"] == ships_live
        ships = [s for s in ttrace.read_spans(tdir)
                 if s.get("name") == "router.ship"]
        assert any(s.get("ok") for s in ships)
        assert any(not s.get("ok") for s in ships)
    finally:
        if door is not None:
            door.close()
        for rep in reps.values():
            rep.close()
