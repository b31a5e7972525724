"""The decision observatory wired into the port's run ends (the JAX
package's ``TPUFLOW_REGISTRY_PATH`` appends, as explicit paths):

- ``serve_forever(registry_path=)`` on a small CPU GPT-2 appends one
  ``serve`` record of the live ledger's final snapshot whatever ends the
  loop (an exception included, which it does not mask), none without a
  path; its export's ``/alerts`` judges the ``alert_engine`` it was
  given;
- ``FlowRunner(registry_path=)`` and the flow CLI's ``--registry <path>``:
  an in-process run that succeeds appends one ``train`` record, while
  its recorder is open (the ``registry.append`` event in
  ``events.jsonl``); a failed run, or a runner without a path, appends
  none;
- a two-member gang run (slow tier: two processes that import torch):
  exactly one ``train`` record, written by member 0, none by the runner.
"""

import json
import os
import sys
import time
import urllib.request

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow_torch import obs
from tpuflow_torch.flow import FlowSpec, Run, step, store
from tpuflow_torch.flow.runner import FlowRunner
from tpuflow_torch.flow.runner import main as flow_main
from tpuflow_torch.infer.serve import ServeEngine, serve_forever
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
from tpuflow_torch.obs import alerts, export, fleet, registry
from tpuflow_torch.utils import preempt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_flows as gf  # noqa: E402


@pytest.fixture
def clean_live():
    """The process's export server, live ledger and alert engine put
    back after the test."""
    export.stop()
    obs.goodput_live().reset()
    alerts.reset()
    preempt.clear_preemption()
    yield
    export.stop()
    obs.goodput_live().reset()
    alerts.reset()
    preempt.clear_preemption()


@pytest.fixture(scope="module")
def model():
    return GPT2(GPT2Config.small_test(n_ctx=64, dropout=0.0), seed=0,
                device="cpu")


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, size=n).astype(np.int32) for n in (5, 9)]


def test_serve_forever_appends_one_serve_record(model, tmp_path,
                                                clean_live):
    path = str(tmp_path / "reg.jsonl")
    eng = ServeEngine(model, max_slots=2, page_size=8, buckets=[16])
    reqs = [eng.submit(p, max_new_tokens=4) for p in _prompts()]
    scrapes = []
    # Fires on any card's used fraction; the CPU reports none.
    judge = alerts.AlertEngine(hbm_headroom=1.5)

    def done():
        srv = export.server()
        if srv is not None and not scrapes:
            with urllib.request.urlopen(srv.url + "/alerts",
                                        timeout=5) as r:
                scrapes.append(json.loads(r.read()))
        return all(r.done for r in reqs)

    serve_forever(eng, max_s=30.0, should_stop=done, gateway=False,
                  http_port=0, registry_path=path, alert_engine=judge)
    assert all(r.done for r in reqs)
    (rec,) = registry.read_registry(path)
    snap = obs.goodput_live().snapshot()
    assert rec["kind"] == "serve" and rec["source"] == "serve:live"
    assert rec["metrics"]["serve_requests"] == 2 == snap["serve_requests"]
    want = fleet.hist_percentiles(snap["serve_ttft_hist"])
    for q in ("p50", "p95", "p99"):
        assert rec["metrics"][f"serve_ttft_{q}_s"] == want[q]
    assert "platform" not in rec  # no card's memory on the CPU
    assert rec.get("git") == registry.git_stamp()[0]
    # /alerts judged the engine serve_forever was given (no memory keys
    # off the card: nothing fires), with the seven rules.
    assert export.server()._httpd._tpuflow_alerts is judge
    assert scrapes and all(b["active"] == [] for b in scrapes)
    assert [r["rule"] for r in scrapes[0]["rules"]] == [
        r.name for r in alerts.RULES]


def test_serve_forever_appends_on_an_exception_and_none_without_path(
        model, tmp_path, clean_live):
    path = str(tmp_path / "reg.jsonl")
    eng = ServeEngine(model, max_slots=1, page_size=8, buckets=[16])

    def boom():
        raise KeyboardInterrupt("stop")

    with pytest.raises(KeyboardInterrupt):
        serve_forever(eng, max_s=5.0, should_stop=boom, gateway=False,
                      registry_path=path)
    (rec,) = registry.read_registry(path)
    assert rec["kind"] == "serve"
    serve_forever(eng, max_s=0.05, gateway=False)
    assert len(registry.read_registry(path)) == 1


class FedFlow(FlowSpec):
    """Two steps in process; ``start`` feeds the live ledger a compile
    and two steps, as a training loop's clock does."""

    @step
    def start(self):
        led = obs.goodput_live()
        led.reset()
        time.sleep(0.2)  # a wall the two steps' 0.04 s do not fill
        led.note_compile(0.01)
        led.note_step(0.02, tokens=64, step=1)
        led.note_step(0.02, tokens=64, step=2)
        self.next(self.end)

    @step
    def end(self):
        pass


class FailingFlow(FlowSpec):
    @step
    def start(self):
        raise RuntimeError("no")

    @step
    def end(self):
        pass


def test_runner_appends_one_train_record_in_process(tmp_path, clean_live,
                                                    monkeypatch):
    seen = []
    real = registry.snapshot_metrics
    monkeypatch.setattr(registry, "snapshot_metrics",
                        lambda snap: seen.append(snap) or real(snap))
    store.set_home(str(tmp_path / "home"))
    try:
        path = str(tmp_path / "reg.jsonl")
        spec = FlowRunner(FedFlow, registry_path=path).run({})
        (rec,) = registry.read_registry(path)
        assert rec["kind"] == "train" and rec["source"] == "train:live"
        assert rec["run_id"].endswith(f"-{os.getpid()}")
        # The live ledger's snapshot at the append, the flow's steps in it.
        (snap,) = seen
        assert snap["steps"] == 2 and snap["tokens"] == 128
        assert rec["metrics"] == real(snap)
        assert 0.0 < rec["metrics"]["goodput_fraction"] < 1.0
        run = Run(spec)
        events = obs.read_events(os.path.join(
            store.run_dir(run.flow, run.run_id), "events.jsonl"))
        (ev,) = [e for e in events if e["name"] == "registry.append"]
        assert (ev["run_kind"], ev["run_id"]) == ("train", rec["run_id"])
        # No path, a failed run: nothing appended.
        FlowRunner(FedFlow).run({})
        with pytest.raises(RuntimeError):
            FlowRunner(FailingFlow, registry_path=path).run({})
        assert len(registry.read_registry(path)) == 1
        # The CLI's --registry beside --home.
        home2 = str(tmp_path / "home2")
        spec = flow_main(FedFlow, ["run", "--registry", path, "--home",
                                   home2])
        assert spec.startswith("FedFlow/")
        assert len(registry.read_registry(path)) == 2
        with pytest.raises(SystemExit, match="--registry requires a path"):
            flow_main(FedFlow, ["run", "--registry"])
    finally:
        store.set_home(None)


@pytest.mark.slow
def test_gang_run_appends_exactly_one_record_from_member_0(tmp_path,
                                                           clean_live):
    store.set_home(str(tmp_path / "home"))
    try:
        path = str(tmp_path / "reg.jsonl")
        FlowRunner(gf.GangFlow, registry_path=path).run({"device": "cpu"})
        (rec,) = registry.read_registry(path)
        assert rec["kind"] == "train"
        assert not rec["run_id"].endswith(f"-{os.getpid()}")  # a member's
    finally:
        store.set_home(None)
