"""The port's run observatory against the JAX package's (oracles
``tests/test_obs.py`` and ``tests/test_train_step.py``):

- ``compute_goodput`` and ``summarize`` (``obs/goodput.py``,
  ``obs/timeline.py``) give equal dicts for one stream, exactly (the same
  float operations in the same order): the JAX tests' bucket, replay,
  empty and partial streams, and seeded synthetic streams of every kind
  the two functions read.
- ``timeline_card`` (``flow/cards.py``) renders the same HTML, byte for
  byte: the same sections, lanes and bars.
- ``comm_attribution`` with an injected peak and interconnect gives the
  JAX function's numbers (within 1e-12 relative).
- ``train_gpt`` at 2 layers in both packages with the recorder on: the
  same multiset of event kinds and names (``data.*`` left out: JAX's
  prefetch thread counts hits and misses by timing, and the port's loop
  has no prefetch thread), the same ``steps_timed``, equal
  ``train.tokens`` sums (the JAX leg in the slow tier, its compiles take
  ~20 s; the fast test holds the port to the JAX leg's recorded
  multiset); the port's losses bit-equal to the same call with the
  recorder off.
- A flow run writes ``timeline.html``, stamps the headline into run.json,
  and ``Run.telemetry()`` / ``Run.goodput()`` read it.
"""

import collections
import glob
import os

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow import obs as jobs
from tpuflow.flow.cards import CardBuffer as JCard
from tpuflow.flow.cards import timeline_card as jcard
from tpuflow_torch import obs as tobs
from tpuflow_torch.flow.cards import CardBuffer as TCard
from tpuflow_torch.flow.cards import timeline_card as tcard

T = 1000.0
# tests/test_obs.py's goodput stream: compile, steps, a data wait inside
# a step, an overlapped save, a requeue gap, a restore.
BUCKETS_STREAM = [
    {"kind": "span", "name": "train.compile", "ts": T + 0.0, "dur_s": 2.0,
     "proc": 0, "launch": 0},
    {"kind": "histogram", "name": "train.step_s", "ts": T + 3.0,
     "value": 1.0, "proc": 0, "launch": 0},
    {"kind": "gauge", "name": "data.host_wait_s", "ts": T + 3.6,
     "value": 0.4, "proc": 0, "launch": 0},
    {"kind": "histogram", "name": "train.step_s", "ts": T + 4.0,
     "value": 1.0, "proc": 0, "launch": 0},
    {"kind": "span", "name": "ckpt.save", "ts": T + 3.5, "dur_s": 1.0,
     "proc": 0, "launch": 0, "bytes": 4e9, "gbps": 4.0},
    {"kind": "span", "name": "ckpt.restore", "ts": T + 6.5, "dur_s": 0.5,
     "proc": 0, "launch": 1, "bytes": 1e9},
    {"kind": "histogram", "name": "train.step_s", "ts": T + 8.0,
     "value": 1.0, "proc": 0, "launch": 1},
    {"kind": "counter", "name": "train.tokens", "ts": T + 8.0,
     "value": 100, "proc": 0},
]
REPLAY_STREAM = [
    {"kind": "histogram", "name": "train.step_s", "ts": 1.0, "value": 1.0,
     "proc": 0},
    {"kind": "event", "name": "health.rollback", "ts": 1.5, "step": 2,
     "from_step": 4, "proc": 0},
] + [{"kind": "histogram", "name": "train.step_s", "ts": t, "value": 1.0,
      "proc": 0} for t in (3.0, 4.0, 5.0)]
PARTIAL_STREAM = [{"kind": "event", "name": "x"},
                  {"kind": "gauge", "name": "health.loss", "ts": "bad"},
                  {"kind": "histogram", "name": "train.step_s", "ts": 2.0,
                   "value": "nan-ish", "proc": "p1"}]

_SPANS = ("train.compile", "ckpt.restore", "ckpt.save", "ckpt.upload",
          "flow.gang_resize", "train.epoch", "train.validation", "flow.step")
_GAUGES = ("data.host_wait_s", "device.hbm_used", "device.hbm_peak",
           "device.hbm_limit", "health.loss", "health.grad_norm",
           "fleet.size", "serve.queue_depth")
_COUNTERS = ("train.tokens", "data.prefetch_hit", "data.prefetch_miss",
             "serve.requests", "serve.slo_violations", "health.nonfinite",
             "infer.spec.forwards", "infer.spec.committed")


def _seeded_stream(seed: int, n: int = 160) -> list[dict]:
    """Events of every kind the summaries read, two processes, three
    launches with gaps, rollbacks, waits inside steps."""
    rng = np.random.default_rng(seed)
    out, t = [], 100.0
    for i in range(n):
        t += float(rng.exponential(0.3))
        launch = min(i * 3 // n, 2)
        if i in (n // 3, 2 * n // 3):
            t += float(rng.uniform(1.0, 3.0))  # the requeue gap
        ev = {"ts": round(t, 6), "proc": int(rng.integers(0, 2)),
              "launch": launch}
        r = rng.random()
        if r < 0.35:
            ev.update(kind="histogram", name="train.step_s",
                      value=float(rng.uniform(0.05, 0.4)))
        elif r < 0.45:
            ev.update(kind="histogram", name="data.batch_wait_s",
                      value=float(rng.uniform(0.0, 0.05)))
        elif r < 0.6:
            ev.update(kind="span", name=str(rng.choice(_SPANS)),
                      dur_s=float(rng.uniform(0.0, 1.5)),
                      bytes=float(rng.integers(0, 10**9)), step=i)
        elif r < 0.78:
            ev.update(kind="gauge", name=str(rng.choice(_GAUGES)),
                      value=float(rng.uniform(0, 10**9)))
        elif r < 0.93:
            ev.update(kind="counter", name=str(rng.choice(_COUNTERS)),
                      value=float(rng.integers(1, 500)))
        elif r < 0.97:
            step = int(rng.integers(1, 20))
            ev.update(kind="event", name="health.rollback", step=step,
                      from_step=step + int(rng.integers(0, 4)),
                      detector="nonfinite")
        else:
            ev.update(kind="event", name="health.anomaly",
                      detector="loss_spike", step=i)
        out.append(ev)
    rng.shuffle(out)  # the functions sort; a merge need not be ordered
    return out


STREAMS = {"buckets": BUCKETS_STREAM, "replay": REPLAY_STREAM, "empty": [],
           "partial": PARTIAL_STREAM, "seeded0": _seeded_stream(0),
           "seeded1": _seeded_stream(1), "seeded2": _seeded_stream(2, 40)}


@pytest.mark.parametrize("name", list(STREAMS))
def test_goodput_and_summary_equal_jax(name):
    events = STREAMS[name]
    if name == "partial":
        # The JAX ledger skips a bad timestamp; a bad value reads as 0 in
        # both (its summarize is for well-formed streams only).
        assert tobs.compute_goodput(events) == jobs.compute_goodput(events)
        return
    gp = tobs.compute_goodput(events)
    assert gp == jobs.compute_goodput(events)
    assert sum(gp["buckets"].values()) == pytest.approx(gp["wall_s"],
                                                        rel=1e-12)
    assert tobs.summarize(events) == jobs.summarize(events)
    if name == "buckets":
        b = gp["buckets"]
        assert (b["step"], b["data_wait"], b["ckpt"], b["requeue_gap"]) == \
            pytest.approx((2.6, 0.4, 0.5, 2.0))


@pytest.mark.parametrize("name", ["buckets", "replay", "seeded0"])
def test_timeline_card_same_html(name):
    events = STREAMS[name] + [
        {"kind": "span", "name": "flow.run", "ts": 0.0, "dur_s": 2e3,
         "proc": 0},
        {"kind": "span", "name": "flow.step", "ts": 0.1, "dur_s": 8.0,
         "proc": 0, "step": "train"},
    ]
    j, t = JCard(), TCard()
    jcard(j, events)
    tcard(t, events)
    html = t.render_html("run")
    assert html == j.render_html("run")
    assert "Run timeline" in html and "flow.run [" not in html
    if name == "buckets":
        assert "## Goodput" not in html and "Goodput</h2>" in html


def test_comm_attribution_matches_jax(monkeypatch):
    """``tests/test_train_step.py:403``'s arithmetic with the JAX peak and
    interconnect injected, the port's passed: the same numbers."""
    import jax

    import tpuflow.train.step as jstep
    from tpuflow.obs import goodput as jgp
    from tpuflow_torch.train.step import comm_attribution

    assert comm_attribution(0.1, tokens=1024, n_params=10**6) is None
    monkeypatch.setattr(jgp, "_PEAK_CACHE", 1e12)
    monkeypatch.setattr(jstep, "_ici_gbps", lambda: 100.0)
    ndev = jax.device_count()
    for kw in (dict(), dict(accum_steps=2, fsdp_world=4, overlapped=True),
               dict(accum_steps=3, fsdp_world=2, overlapped=False)):
        want = jstep.comm_attribution(0.1, tokens=1024, n_params=10**9, **kw)
        got = comm_attribution(0.1, tokens=1024, n_params=10**9,
                               peak_flops=1e12, link_gbps=100.0,
                               devices=ndev, **kw)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
    assert comm_attribution(0.1, tokens=1024, n_params=10**9,
                            peak_flops=1e12, fsdp_world=4)["ideal_comm_s"] \
        == 0.0  # no link figure off the card: no comm roofline


def _names_and_tokens(o, d):
    o.flush()
    evs = [e for p in glob.glob(os.path.join(d, "events.p*.jsonl"))
           for e in o.read_events(p)]
    names = collections.Counter((e["kind"], e["name"]) for e in evs
                                if not e["name"].startswith("data."))
    tokens = sum(e["value"] for e in evs if e["name"] == "train.tokens")
    return names, tokens, o.compute_goodput(evs)["steps_timed"]


# What the JAX ``train_gpt`` records for ``TRAIN_KW`` (2 epochs of 2
# steps with a checkpoint directory), ``data.*`` left out: held to the JAX
# leg itself by the slow test below.
TRAIN_KW = dict(preset="test", epochs=2, steps_per_epoch=2, batch_size=8,
                seq_len=16)
JAX_TRAIN_EVENTS = collections.Counter({
    ("span", "train.compile"): 1, ("histogram", "train.step_s"): 3,
    ("counter", "train.tokens"): 3, ("span", "train.epoch"): 2,
    ("span", "train.validation"): 2, ("span", "ckpt.save"): 2,
    ("event", "train.remat_policy"): 1, ("gauge", "train.dispatch_depth"): 1,
    ("event", "device.program"): 1, ("gauge", "goodput.productive_s"): 3,
    ("gauge", "goodput.lost_s"): 3, ("gauge", "goodput.fraction"): 3,
    ("gauge", "health.loss"): 4, ("gauge", "health.grad_norm"): 4,
    ("gauge", "health.update_norm"): 4, ("gauge", "health.param_norm"): 4,
})


@pytest.fixture
def two_layers(tmp_path, monkeypatch):
    """Both packages' GPT configs at 2 layers, the JAX knobs cleared."""
    import dataclasses

    from tpuflow.train import gpt as jgpt
    from tpuflow_torch.train import gpt as tgpt

    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path / "data"))
    for k in ("TPUFLOW_PROF_TRIGGER", "TPUFLOW_DEVICE_LEDGER",
              "TPUFLOW_HEALTH", "TPUFLOW_FAULT"):
        monkeypatch.delenv(k, raising=False)
    for mod in (jgpt, tgpt):
        real = mod.GptTrainConfig.model_config
        monkeypatch.setattr(
            mod.GptTrainConfig, "model_config",
            lambda self, real=real: dataclasses.replace(real(self),
                                                        n_layer=2))
    return jgpt, tgpt


def test_train_gpt_telemetry_moves_no_bit(tmp_path, two_layers):
    """The port's 2-layer call with the recorder off and on: bit-equal
    losses, and on the JAX leg's event multiset, tokens and steps."""
    _, tgpt = two_layers
    td = str(tmp_path / "tobs")
    tcfg = tgpt.GptTrainConfig(data_axis=1, fsdp_axis=1, **TRAIN_KW)
    off = tgpt.train_gpt(tcfg, str(tmp_path / "ck0"), device="cpu",
                         log=lambda *a: None)
    tobs.configure(td, proc=0)
    on = tgpt.train_gpt(tcfg, str(tmp_path / "ck1"), device="cpu",
                        log=lambda *a: None)
    tobs.configure(None)
    assert on.step_losses == off.step_losses  # telemetry moves no bit
    assert on.loss_history == off.loss_history
    names, tokens, steps = _names_and_tokens(tobs, td)
    assert names == JAX_TRAIN_EVENTS
    assert (tokens, steps) == (3 * 8 * 16, 3)


@pytest.mark.slow
def test_train_gpt_telemetry_matches_jax(tmp_path, two_layers):
    """The JAX leg on the suite's 8 CPU devices records what
    ``JAX_TRAIN_EVENTS`` says (~20 s, its compiles)."""
    jgpt, _ = two_layers
    jd = str(tmp_path / "jobs")
    jobs.configure(jd, proc=0)
    jgpt.train_gpt(jgpt.GptTrainConfig(data_axis=8, fsdp_axis=1,
                                       **TRAIN_KW),
                   str(tmp_path / "jck"), log=lambda *a: None)
    jobs.configure(None)
    names, tokens, steps = _names_and_tokens(jobs, jd)
    assert names == JAX_TRAIN_EVENTS
    assert (tokens, steps) == (3 * 8 * 16, 3)


def test_flow_run_writes_timeline_and_goodput(tmp_path):
    from tpuflow_torch.flow import FlowSpec, Run, step, store
    from tpuflow_torch.flow.runner import FlowRunner

    class TinyGpt(FlowSpec):
        @step
        def start(self):
            from tpuflow_torch.train import gpt as tgpt

            res = tgpt.train_gpt(
                tgpt.GptTrainConfig(preset="test", epochs=1,
                                    steps_per_epoch=3, batch_size=8,
                                    seq_len=16, data_axis=1, fsdp_axis=1),
                device="cpu", log=lambda *a: None)
            self.losses = res.step_losses
            self.next(self.end)

        @step
        def end(self):
            pass

    store.set_home(str(tmp_path / "home"))
    try:
        pathspec = FlowRunner(TinyGpt).run({})
        rdir = store.run_dir(*pathspec.split("/"))
        with open(os.path.join(rdir, "timeline.html")) as f:
            html = f.read()
        assert "Goodput</h2>" in html and "train.compile" in html
        run = Run(pathspec)
        gp = run.goodput()
        assert 0.0 < gp["fraction"] <= 1.0 and gp["steps_timed"] == 2
        assert sum(gp["buckets"].values()) == pytest.approx(gp["wall_s"],
                                                            rel=1e-9)
        head = run.telemetry()["headline"]
        assert head["steps_timed"] == 2 and head["step_time_p50_s"] > 0
        assert run.meta["telemetry"] == head
        assert "health" not in run.meta  # a clean run stays small
    finally:
        store.set_home(None)
    assert not tobs.enabled()


def test_live_export_serves_the_training_legs():
    """``train_gpt(http_port=0)`` and ``RunConfig(http_port=0)`` serve the
    live ledger on ``/status``: the loop's timed steps (fed by its
    ``StepClock`` with the recorder off), then ``Trainer.fit``'s reports
    (the report cadence of a custom loop) in a fresh window."""
    import json
    import urllib.request

    from tpuflow_torch.obs import export
    from tpuflow_torch.train import gpt as tgpt
    from tpuflow_torch.train.trainer import (
        RunConfig,
        ScalingConfig,
        Trainer,
        get_context,
    )

    def status():
        with urllib.request.urlopen(export.server().url + "/status",
                                    timeout=10) as r:
            return json.loads(r.read())

    def loop(config):
        for step in (1, 2):
            get_context().report({"loss": 1.0 / step}, step=step)

    export.stop()
    try:
        tgpt.train_gpt(tgpt.GptTrainConfig(
            preset="test", epochs=1, steps_per_epoch=3, batch_size=8,
            seq_len=16, data_axis=1, fsdp_axis=1), device="cpu",
            log=lambda *a: None, http_port=0)
        s = status()
        assert (s["steps"], s["step"], s["tokens"]) == (2, 3, 2 * 8 * 16)
        assert s["goodput_fraction"] > 0
        Trainer(loop, scaling_config=ScalingConfig(device="cpu"),
                run_config=RunConfig(http_port=0)).fit()
        s = status()
        assert (s["steps"], s["reports"], s["step"]) == (0, 2, 2)
    finally:
        export.stop()
        tobs.goodput_live().reset()
