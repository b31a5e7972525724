"""The serving replica on the port: ``serve_forever``, the ``/generate``
gateway (``tpuflow_torch/infer/frontdoor.py``) and the engine's serving
observatory, held against their JAX oracles on a small GPT-2 whose weights
are carried from JAX (``models/convert.py``):

- the loop's heartbeat and SIGTERM drain (tests/test_serve.py's
  ``test_serve_forever_heartbeats_and_preempt_drain``), tokens equal to
  the JAX ``generate()``;
- the gateway cases of tests/test_router.py, on both packages' gateways
  over one fake engine, with equal answers, and each package's
  ``http_forward`` against the other's gateway;
- ``test_serve_forever_exports_generate_url_and_forwards`` with a real
  engine: the fleet row (read by both packages' observatories) carries
  ``generate_url``, ``http_forward`` round-trips requests, a replay and a
  ship hop, and the URL is retracted on exit;
- the engine-time ledger on a real engine: the buckets sum to the wall, a
  tiny SLO emits ``serve.slo_violation``, and the access log holds the JAX
  engine's record keys;
- a submit, a ship and a step from other threads (grad mode on there),
  tokens equal to the JAX ``generate()``.
"""

import ast
import importlib
import json
import os
import signal
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow_torch import obs
from tpuflow_torch.infer import frontdoor as tfront
from tpuflow_torch.infer.serve import ServeEngine, serve_forever
from tpuflow_torch.obs import export as texport
from tpuflow_torch.obs import fleet as tfleet
from tpuflow_torch.obs import serve_ledger as tsl
from tpuflow_torch.utils import heartbeat, preempt

jgen = importlib.import_module("tpuflow.infer.generate")
jfront = importlib.import_module("tpuflow.infer.frontdoor")
jfleet = importlib.import_module("tpuflow.obs.fleet")

NEW = 6  # tokens a request: one JAX generate() compile a prompt length


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


_SOLO: dict = {}


def _jax_solo(pair, prompt, n=NEW):
    key = (np.asarray(prompt, np.int32).tobytes(), n)
    if key not in _SOLO:
        jm, params, _ = pair
        _SOLO[key] = np.asarray(jgen.generate(
            jm, params, jnp.asarray(np.asarray(prompt, np.int32)[None]),
            max_new_tokens=n, temperature=0.0))[0].tolist()
    return _SOLO[key]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 512, size=n).astype(
        np.int32)


@pytest.fixture
def sigterm_restored():
    """The SIGTERM handler and the preemption flag put back after the
    test (``serve_forever`` installs its handler on the main thread)."""
    old = signal.getsignal(signal.SIGTERM)
    preempt.clear_preemption()
    try:
        yield
    finally:
        preempt.clear_preemption()
        signal.signal(signal.SIGTERM, old)
        obs.goodput_live().reset()


# ----------------------------------------------------- loop and drain
def test_serve_forever_heartbeats_and_preempt_drain(pair, tmp_path,
                                                    sigterm_restored):
    """Heartbeats stamp every iteration, and a SIGTERM preemption DRAINS:
    the live request finishes exactly, nothing new admits, the queued one
    ends ``drained`` and survives for the requeue, which a later loop
    completes."""
    _, _, tm = pair
    hb = tmp_path / "hb"
    heartbeat.configure(str(hb))
    eng = ServeEngine(tm, max_slots=1, buckets=[8], decode_block=2,
                      page_size=8)
    p1, p2 = _prompt(5, 4), _prompt(6, 6)
    r1 = eng.submit(p1, max_new_tokens=NEW)
    eng.step()  # r1 admitted into the only slot
    r2 = eng.submit(p2, max_new_tokens=NEW)  # waits for the slot
    try:
        preempt.request_preemption()
        serve_forever(eng, max_s=10.0)
        assert r1.done and r1.tokens == _jax_solo(pair, p1)
        assert not r2.done and eng.queue_depth == 1
        assert r1.terminal_phase == "complete"
        assert r2.terminal_phase == "drained" and r2.drained
        assert sum(1 for t in r2.trace
                   if t["phase"] in ("complete", "drained")) == 1
        assert hb.exists() and int(hb.read_text()) == eng._iters
    finally:
        heartbeat.configure(None)
        preempt.clear_preemption()
    serve_forever(eng, max_s=5.0, should_stop=lambda: r2.done)
    assert r2.done and r2.tokens == _jax_solo(pair, p2)


# ------------------------------------------------------------ gateway
class _FakeHandle:
    def __init__(self, tokens, state="done"):
        self.state = state
        self.tokens = tokens
        self.finish_reason = "budget"
        self.drained = False


class _FakeEngine:
    """Just enough engine for the gateway: submit echoes the prompt
    length so responses are distinguishable per request."""

    max_slots = 4
    pool = None

    def __init__(self):
        self.submits = 0

    def submit(self, prompt, *, max_new_tokens, eos_id=None, **kw):
        self.submits += 1
        return _FakeHandle([int(len(prompt)), int(max_new_tokens)])


def _gateway_script(front):
    eng = _FakeEngine()
    gw = front.ReplicaGateway(eng)
    out = []
    try:
        body = {"id": "g1", "prompt": [1, 2, 3], "max_new_tokens": 5}
        out.append(gw.handle_generate(body))
        out.append(gw.handle_generate(dict(body)))  # replay: no submit
        out.append(eng.submits)
        out.append(gw.handle_generate({"id": "", "prompt": [1]}))
        out.append(gw.handle_generate({"id": "g9", "prompt": [1],
                                       "max_new_tokens": [2]}))
        gw.draining = True
        out.append(gw.handle_generate(
            {"id": "g2", "prompt": [1], "max_new_tokens": 1}))
        out.append(gw.handle_generate(
            {"id": "p1", "prompt": [1], "phase": "prefill"}))
        gw.draining = False
        out.append(gw.handle_generate(
            {"id": "p2", "prompt": [1], "phase": "prefill"}))
        gw.aborted = True
        out.append(gw.handle_generate(
            {"id": "g3", "prompt": [1], "max_new_tokens": 1}))
    finally:
        gw.close()
    return out


def test_gateway_generate_replay_drain_and_kill():
    got = _gateway_script(tfront)
    assert got == _gateway_script(jfront)
    assert got[0] == (200, {"id": "g1", "tokens": [3, 5],
                            "finish_reason": "budget"})
    assert got[1] == got[0] and got[2] == 1
    assert got[3][0] == 400 and got[4][0] == 400
    assert got[5] == (503, {"error": "draining"})
    assert got[6] == (503, {"error": "draining"})
    assert got[7] == (503, {"error": "replica cannot ship"})
    assert got[8] == (503, {"error": "killed"})


def test_gateway_drained_handle_returns_503_for_reroute():
    class _DrainEngine(_FakeEngine):
        def submit(self, prompt, **kw):
            self.submits += 1
            h = _FakeHandle([], state="queued")
            h.drained = True  # SIGTERM drained it before it started
            return h

    for front in (jfront, tfront):
        gw = front.ReplicaGateway(_DrainEngine())
        try:
            assert gw.handle_generate(
                {"id": "g1", "prompt": [1], "max_new_tokens": 1}) == (
                503, {"error": "drained"})
        finally:
            gw.close()


@pytest.mark.parametrize("fwd,front", [(tfront, jfront), (jfront, tfront),
                                       (tfront, tfront)],
                         ids=["port-to-jax", "jax-to-port", "port-to-port"])
def test_http_forward_raises_on_replica_503(fwd, front):
    gw = front.ReplicaGateway(_FakeEngine())
    try:
        got = fwd.http_forward(
            {"id": "a", "generate_url": gw.url},
            {"id": "x", "prompt": [1, 2], "max_new_tokens": 3}, 5.0)
        assert got == {"id": "x", "tokens": [2, 3], "finish_reason": "budget"}
        gw.draining = True
        with pytest.raises(RuntimeError, match="503"):
            fwd.http_forward({"id": "a", "generate_url": gw.url},
                             {"id": "y", "prompt": [1],
                              "max_new_tokens": 1}, 5.0)
        with pytest.raises(RuntimeError, match="generate_url"):
            fwd.http_forward({"id": "b"}, {"id": "x"}, 1.0)
    finally:
        gw.close()


# ------------------------------------------------- the replica over HTTP
def test_serve_forever_exports_generate_url_and_forwards(pair, tmp_path,
                                                         sigterm_restored):
    """A bare ``serve_forever`` replica on a real engine: export on port
    0 with a registration, a gateway whose URL both packages'
    observatories read off ``/status``, requests forwarded through
    ``http_forward`` (a replay answered from the cache, a ship hop and a
    forward of its ``kv_key``) with the JAX ``generate()``'s tokens,
    ``/metrics`` with the serve gauges, the URL retracted on exit."""
    _, _, tm = pair
    reg = tmp_path / "fleet"
    reg.mkdir()
    eng = ServeEngine(tm, max_slots=2, buckets=[8, 16], decode_block=4,
                      page_size=8, kv_store_dir=str(tmp_path / "kv"))
    texport.stop()
    obs.goodput_live().reset()
    stop = threading.Event()
    th = threading.Thread(
        target=serve_forever, args=(eng,),
        kwargs=dict(idle_sleep_s=0.002, max_s=60.0, should_stop=stop.is_set,
                    http_port=0, registration_dir=str(reg),
                    replica_id="port-replica-0"),
        daemon=True)
    th.start()
    try:
        row = None
        deadline = time.monotonic() + 15.0
        while row is None and time.monotonic() < deadline:
            rows = tfleet.FleetObservatory(
                str(reg), stale_s=10.0).poll()["replicas"]
            row = next((r for r in rows if r.get("generate_url")), None)
            time.sleep(0.02)
        assert row is not None, "the fleet row never carried generate_url"
        assert row["id"] == "port-replica-0"
        (jrow,) = jfleet.FleetObservatory(str(reg),
                                          stale_s=10.0).poll()["replicas"]
        assert jrow["generate_url"] == row["generate_url"]
        assert jrow["id"] == "port-replica-0" and not jrow["stale"]
        prompts = [_prompt(7, 4), _prompt(8, 9), _prompt(9, 6)]
        got = [tfront.http_forward(
            row, {"id": f"sf-{i}", "prompt": p.tolist(),
                  "max_new_tokens": NEW}, 30.0)
            for i, p in enumerate(prompts[:2])]
        for p, g in zip(prompts, got):
            assert g["tokens"] == _jax_solo(pair, p)
        replay = tfront.http_forward(row, {"id": "sf-0", "prompt": [1]}, 30.0)
        assert replay == got[0]
        hop = tfront.http_forward(row, {"id": "ship-1", "phase": "prefill",
                                        "prompt": prompts[2].tolist()}, 30.0)
        assert hop["kv_key"] and eng.kv_store.contains(hop["kv_key"])
        calls = eng._prefill_calls
        out = tfront.http_forward(
            row, {"id": "sf-2", "prompt": prompts[2].tolist(),
                  "max_new_tokens": NEW, "kv_key": hop["kv_key"]}, 30.0)
        assert out["tokens"] == _jax_solo(pair, prompts[2])
        assert eng._prefill_calls == calls  # the import prefilled nothing
        url = row["url"]  # the export's, registered
        with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
            text = r.read().decode()
        assert "tpuflow_serve_requests_total 3" in text
        assert "tpuflow_serve_ttft_seconds_count 3" in text
        with urllib.request.urlopen(url + "/status", timeout=5) as r:
            status = json.loads(r.read())
        assert status["serve_role"] == "both"
        assert status["replica"]["id"] == "port-replica-0"
    finally:
        stop.set()
        th.join(timeout=15.0)
        try:
            assert not th.is_alive()
            assert obs.goodput_live().serve_generate_url is None
        finally:
            texport.stop()


# ------------------------------------------------ the engine's ledger
def _jax_access_keys():
    """The record keys of the JAX engine's ``_access_write``, read from
    its source (an untraced request adds none)."""
    src = open(importlib.import_module("tpuflow.infer.serve").__file__).read()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "_access_write")
    (d,) = [n for n in ast.walk(fn) if isinstance(n, ast.Dict)]
    return {k.value for k in d.keys if isinstance(k, ast.Constant)}


def test_engine_ledger_slo_and_access_log(pair, tmp_path):
    """A staggered run with tiny SLOs: tokens equal to the JAX
    ``generate()``, one terminal trace phase a request and one ``tick`` a
    decode block, a bad SLO a ``ValueError``, the buckets
    summing to the ledger's wall with real prefill/decode/insert charges,
    SLO violations in the events and the counter, the live ledger's
    observatory keys, and one access-log line a terminal request with the
    JAX engine's keys (a drained one included), read back by the JAX
    ``serve-summary`` CLI."""
    from tpuflow.obs.__main__ import main as obs_main

    _, _, tm = pair
    for bad in (0, -5, "250", float("nan")):
        with pytest.raises(ValueError, match="SLO"):
            ServeEngine(tm, max_slots=1, buckets=[8], page_size=8,
                        slo_ttft_ms=bad)
    run_dir = str(tmp_path / "run")
    obs.configure(os.path.join(run_dir, "obs"), proc=0)
    try:
        eng = ServeEngine(tm, max_slots=2, buckets=[8, 16], decode_block=4,
                          page_size=8, slo_ttft_ms=1e-6, slo_itl_ms=1e-6)
        prompts = [_prompt(7, 4), _prompt(8, 9), _prompt(9, 6)]
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
        eng.run_until_idle(max_iters=200)
        for p, r in zip(prompts, reqs):
            assert r.tokens == _jax_solo(pair, p)
            phases = [t["phase"] for t in r.trace]
            assert phases[0] == "submitted" and phases.count("complete") == 1
            # One tick a decode block the request rode, as the JAX engine.
            assert phases.count("tick") == len(r.itl_s) >= 1
            assert r.terminal_phase == "complete" and r.itl_s
            assert r.slo_violations >= 1 and r.group == "fp.plain"
        assert any(t["phase"] == "queued" and t["reason"] == "slots"
                   for t in reqs[2].trace)
        snap = eng.ledger.snapshot()
        assert sum(snap["buckets"].values()) == pytest.approx(
            snap["wall_s"], rel=1e-9)
        for b in ("prefill", "decode", "insert"):
            assert snap["buckets"][b] > 0, b
        assert snap["slo_violations"] >= 3 and "fp.plain" in snap["itl"]
        live = obs.goodput_live().snapshot()
        for key in ("serve_idle_fraction", "serve_decode_fraction",
                    "serve_prefill_fraction", "serve_itl_p99_s",
                    "serve_slo_violations", "serve_ttft_hist"):
            assert key in live, key
        queued = eng.submit(prompts[0], max_new_tokens=NEW)
        assert eng.drain_queued() == 1 and eng.drain_queued() == 0
        assert queued.terminal_phase == "drained"
        obs.flush()
        events = obs.load_run_events(run_dir)
        names = {(e["kind"], e["name"]) for e in events}
        for want in (("event", "serve.trace"), ("event", "serve.slo_violation"),
                     ("counter", "serve.slo_violations"),
                     ("event", "serve.complete"), ("span", "serve.prefill"),
                     ("span", "serve.decode"),
                     ("gauge", "serve.idle_fraction"),
                     ("gauge", "serve.decode_fraction"),
                     ("gauge", "serve.prefill_fraction"),
                     ("gauge", "serve.ttft_s")):
            assert want in names, want
        records = tsl.load_access_log(run_dir)
        assert [r["terminal"] for r in records] == [
            "complete"] * 3 + ["drained"]
        jkeys = _jax_access_keys()
        assert all(set(r) == jkeys for r in records)
        assert tsl.summarize_access(records)["itl"]["count"] == sum(
            len(r.itl_s) for r in reqs)
        assert obs_main(["serve-summary", run_dir]) == 0
    finally:
        obs.configure(None)
        obs.goodput_live().reset()


def test_ledger_sums_to_wall_with_a_ship_in_the_idle_sleep(
        pair, tmp_path, sigterm_restored):
    """Ship hops through the gateway land while the loop sleeps idle,
    outside the step lock, so the hop's prefill and the sleep overlap:
    the buckets still sum to the ledger's wall, each second counted once."""
    _, _, tm = pair
    eng = ServeEngine(tm, max_slots=2, buckets=[8, 16], decode_block=4,
                      page_size=8, kv_store_dir=str(tmp_path / "kv"))
    obs.goodput_live().reset()
    stop = threading.Event()
    keys: list = []

    def client():
        try:
            deadline = time.monotonic() + 15.0
            while obs.goodput_live().serve_generate_url is None:
                assert time.monotonic() < deadline, "no gateway"
                time.sleep(0.01)
            row = {"id": "r", "generate_url":
                   obs.goodput_live().serve_generate_url}
            for i in range(3):
                keys.append(tfront.http_forward(
                    row, {"id": f"hop-{i}", "phase": "prefill",
                          "prompt": _prompt(30 + i, 9).tolist()},
                    30.0)["kv_key"])
        finally:
            stop.set()

    th = threading.Thread(target=client)
    th.start()
    serve_forever(eng, idle_sleep_s=0.2, max_s=30.0,
                  should_stop=stop.is_set)
    th.join()
    assert len(keys) == 3 and eng._prefill_calls == 3
    snap = eng.ledger.snapshot()
    assert snap["buckets"]["prefill"] > 0 and snap["buckets"]["idle"] > 0
    assert sum(snap["buckets"].values()) == pytest.approx(
        snap["wall_s"], rel=1e-9)


def test_engine_entry_points_from_other_threads(pair, tmp_path):
    """``submit``, ``ship`` and ``step`` on threads whose grad mode is on:
    the engine sets its own scope, tokens equal the JAX ``generate()``,
    and nothing it returns tracks gradients."""
    _, _, tm = pair
    eng = ServeEngine(tm, max_slots=2, buckets=[8, 16], decode_block=4,
                      page_size=8, kv_store_dir=str(tmp_path / "kv"))
    p1, p2 = _prompt(7, 4), _prompt(9, 6)
    out: dict = {}

    def client():
        torch.set_grad_enabled(True)
        out["req"] = eng.submit(p1, max_new_tokens=NEW)
        out["key"] = eng.ship(p2)

    th = threading.Thread(target=client)
    th.start()
    th.join()
    h2 = eng.submit(p2, max_new_tokens=NEW, kv_key=out["key"])

    def stepper():
        torch.set_grad_enabled(True)
        eng.run_until_idle(max_iters=100)

    th = threading.Thread(target=stepper)
    th.start()
    th.join()
    assert out["req"].tokens == _jax_solo(pair, p1)
    assert h2.tokens == _jax_solo(pair, p2) and h2.kv_import is not None
    assert not any(leaf.requires_grad for leaf in eng._cache.k + eng._cache.v)
    assert torch.is_grad_enabled()  # the caller's mode untouched
