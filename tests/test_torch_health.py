"""The port's training-health layer (``tpuflow_torch/obs/health.py``)
against the JAX package's (``tpuflow/obs/health.py``), on the same inputs:
the monitor over seeded observation sequences (nonfinite streaks under
budgets 1-3, loss spikes after warmup, grad explosions), equal
``Anomaly``s and ``health.anomaly`` events; ``handle_anomaly``'s four
outcomes on managers of each package holding the same steps;
``health_summary`` of one event list; the profile window
(``tests/test_health.py``'s parse and capture cases); and
``Trainer.report``'s divergence watch (its two Trainer cases). The JAX
side takes ``TPUFLOW_HEALTH*``/``TPUFLOW_PROFILE``; the port, arguments."""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow import obs as jobs
from tpuflow.ckpt import CheckpointManager as JManager
from tpuflow.obs import health as jhealth
from tpuflow_torch import obs as tobs
from tpuflow_torch.ckpt import CheckpointManager as TManager
from tpuflow_torch.obs import health as thealth

KNOBS = ("TPUFLOW_HEALTH", "TPUFLOW_HEALTH_ROLLBACK", "TPUFLOW_PROFILE",
         "TPUFLOW_PROFILE_DIR", "TPUFLOW_FAULT")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    yield
    jobs.configure(None)
    tobs.configure(None)


def _events(o, d, name=None):
    o.flush()
    out = [e for p in sorted(glob.glob(os.path.join(d, "events.p*")))
           for e in o.read_events(p)]
    return [e for e in out if name is None or e["name"] == name]


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "pid", "proc")}


def _sequence(seed: int, n: int = 80):
    """(step, loss, grad_norm) observations: a noisy falling loss with
    NaN/Inf runs, finite spikes and grad explosions at seeded places."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(1, n + 1):
        loss = float(4.0 * math.exp(-step / 60) + 0.05 * rng.standard_normal())
        gn = float(abs(1.0 + 0.3 * rng.standard_normal()))
        u = rng.random()
        if u < 0.06:
            loss = float("nan")
        elif u < 0.09:
            gn = float("inf")
        elif u < 0.13:
            loss *= float(rng.uniform(3.0, 30.0))
        elif u < 0.16:
            gn *= float(rng.uniform(50.0, 500.0))
        out.append((step, loss, gn))
    return out


CONFIGS = [
    dict(nan_budget=1),
    dict(nan_budget=2, window=8, warmup=3, spike_mads=8.0),
    dict(nan_budget=3, window=16, warmup=5, grad_norm_max=100.0),
    dict(window=4, warmup=2, spike_mads=4.0, grad_norm_max=20.0),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_monitor_matches_jax(cfg, seed, tmp_path):
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jobs.configure(jd, proc=0)
    tobs.configure(td, proc=0)
    jm = jhealth.HealthMonitor(jhealth.HealthConfig(**cfg))
    tm = thealth.HealthMonitor(thealth.HealthConfig(**cfg))
    jgot, tgot = [], []
    for step, loss, gn in _sequence(seed):
        for mon, got in ((jm, jgot), (tm, tgot)):
            a = mon.observe(step, loss, gn)
            got.append(None if a is None else (a.kind, a.step, a.detail,
                                               a.describe()))
            if a is not None and step % 3 == 0:
                mon.rolled_back()
    assert any(g is not None for g in jgot)
    assert json.dumps(tgot) == json.dumps(jgot)
    assert tm.rollbacks == jm.rollbacks
    assert json.dumps(tm.last) == json.dumps(jm.last)
    jev = [_strip(e) for e in _events(jobs, jd, "health.anomaly")]
    tev = [_strip(e) for e in _events(tobs, td, "health.anomaly")]
    assert jev and tev == jev


def test_monitor_units_match_jax():
    """``tests/test_health.py``'s detector cases, run on both packages."""
    for h in (jhealth, thealth):
        mon = h.HealthMonitor(h.HealthConfig(nan_budget=2))
        assert mon.observe(1, float("nan"), 1.0) is None
        assert mon.observe(2, 2.0, 1.0) is None
        assert mon.observe(3, float("nan"), 1.0) is None
        a = mon.observe(4, 2.0, float("inf"))
        assert (a.kind, a.step, a.detail["streak"]) == ("nonfinite", 4, 2)
        mon = h.HealthMonitor(h.HealthConfig(window=8, warmup=4,
                                             spike_mads=8.0))
        for i, v in enumerate([2.0, 2.1, 1.9, 2.0, 2.05]):
            assert mon.observe(i, v, 1.0) is None
        assert mon.observe(6, 2.2, 1.0) is None
        assert mon.observe(7, 50.0, 1.0).kind == "loss_spike"
        assert mon.observe(8, 50.0, 1.0).kind == "loss_spike"
        mon = h.HealthMonitor(h.HealthConfig(grad_norm_max=100.0,
                                             warmup=1000))
        assert mon.observe(1, 2.0, 50.0) is None
        assert mon.observe(2, 2.0, 500.0).kind == "grad_explosion"
        assert h.HealthMonitor(h.HealthConfig()).observe(1, 2.0, 1e12) is None
    assert thealth.HealthMonitor.of(True).cfg == thealth.HealthConfig()
    assert thealth.HealthMonitor.of(False) is None
    assert thealth.HealthMonitor.of(thealth.HealthConfig(enabled=False)) \
        is None
    assert dataclasses_equal(thealth.HealthConfig(), jhealth.HealthConfig())


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _flip(ckdir, step):
    (shard,) = glob.glob(os.path.join(ckdir, f"step_{step}", "state",
                                      "*.bin"))
    size = os.path.getsize(shard)
    with open(shard, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def test_handle_anomaly_outcomes_match_jax(tmp_path):
    """Rollback off, the budget spent, nothing verified, and a corrupt
    newest step falling back to the older one: the same verdicts and
    the same diagnostic form on managers of each package."""
    w = np.arange(64, dtype=np.float32)
    mgrs = {}
    for name, Mgr, mk in (("j", JManager, lambda a: a),
                          ("t", TManager, torch.from_numpy)):
        m = Mgr(str(tmp_path / name), async_save=False)
        m.save(1, {"w": mk(w.copy())}, metrics={})
        m.save(2, {"w": mk(w * 2)}, metrics={})
        m.wait_until_finished()
        mgrs[name] = m
    empty = {"j": JManager(str(tmp_path / "je")),
             "t": TManager(str(tmp_path / "te"))}
    pkgs = {"j": jhealth, "t": thealth}
    verdicts = {}
    for k, h in pkgs.items():
        anomaly = h.Anomaly("nonfinite", 3, {"loss": float("nan")})
        out = []
        mon = h.HealthMonitor(h.HealthConfig(rollback=False))
        with pytest.raises(h.TrainingDiverged) as e:
            h.handle_anomaly(mon, anomaly, mgrs[k])
        out.append(str(e.value).split(". ")[0])
        mon = h.HealthMonitor(h.HealthConfig(max_rollbacks=1))
        out.append(h.handle_anomaly(mon, anomaly, mgrs[k]))
        out.append(mon.rollbacks)
        with pytest.raises(h.TrainingDiverged, match="budget exhausted"):
            h.handle_anomaly(mon, anomaly, mgrs[k])
        with pytest.raises(h.TrainingDiverged,
                           match="no verified checkpoint"):
            h.handle_anomaly(h.HealthMonitor(h.HealthConfig()), anomaly,
                             empty[k])
        verdicts[k] = out
    assert verdicts["t"] == verdicts["j"] == [
        "training diverged: nonfinite at step 3 (loss=nan)", 2, 1]
    # The JAX hint names its knob, the port's its argument.
    with pytest.raises(thealth.TrainingDiverged,
                       match=r"HealthConfig\(rollback=False\)"):
        thealth.handle_anomaly(
            thealth.HealthMonitor(thealth.HealthConfig(rollback=False)),
            thealth.Anomaly("nonfinite", 3, {}), mgrs["t"])
    for k in pkgs:
        _flip(str(tmp_path / k), 2)
        mon = pkgs[k].HealthMonitor(pkgs[k].HealthConfig())
        assert pkgs[k].last_verified_step(mgrs[k]) == 1
        assert pkgs[k].handle_anomaly(
            mon, pkgs[k].Anomaly("nonfinite", 3, {}), mgrs[k]) == 1
    assert thealth.last_verified_step(None) is None
    for m in (*mgrs.values(), *empty.values()):
        m.close()


def test_health_summary_matches_jax():
    events = [
        {"kind": "event", "name": "health.anomaly", "ts": 1.0, "proc": 0,
         "pid": 5, "detector": "nonfinite", "step": 3},
        {"kind": "event", "name": "health.rollback", "ts": 2.0, "proc": 0,
         "step": 2, "from_step": 3, "lr_scale": 0.5},
        {"kind": "gauge", "name": "health.grad_norm", "ts": 3.0,
         "value": 1.5},
        {"kind": "gauge", "name": "health.loss", "ts": 3.0, "value": 2.5},
        {"kind": "counter", "name": "health.nonfinite", "ts": 3.1,
         "value": 1},
        {"kind": "counter", "name": "health.nonfinite", "ts": 3.2},
        {"kind": "event", "name": "health.profile", "ts": 4.0,
         "start_step": 2, "stop_step": 3, "dir": "/x"},
        {"kind": "event", "name": "obs.dropped", "ts": 9.0, "value": 7},
        {"kind": "span", "name": "flow.step", "ts": 0.0, "dur_s": 1.0},
    ]
    got = thealth.health_summary(events)
    assert got == jhealth.health_summary(events)
    assert got["nonfinite_steps"] == 2 and got["last"]["grad_norm"] == 1.5
    assert tobs.health_summary is thealth.health_summary


def test_profile_window_make(tmp_path):
    """``tests/test_health.py::test_profile_window_parse``'s cases with
    the window as an argument."""
    assert thealth.ProfileWindow.make(None) is None
    assert thealth.ProfileWindow.make((5, 3), str(tmp_path)) is None
    assert thealth.ProfileWindow.make((0, 3), str(tmp_path)) is None
    assert thealth.ProfileWindow.make((3, 5)) is None  # no obs, no dir
    pw = thealth.ProfileWindow.make((3, 5), str(tmp_path / "prof"))
    assert (pw.start, pw.stop, pw.out_dir) == (3, 5, str(tmp_path / "prof"))
    tobs.configure(str(tmp_path / "obs"), proc=0)
    pw = thealth.ProfileWindow.make((3, 5))
    assert pw.out_dir == os.path.join(str(tmp_path / "obs"), "profile")


def test_profile_window_captures_trace_like_jax(tmp_path, monkeypatch):
    """``tests/test_health.py::test_profile_window_captures_trace``: the
    window 2:3 over steps 1-4 traces steps 2 and 3 only and records one
    ``health.profile`` event, the same in both packages."""
    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("TPUFLOW_PROFILE", "2:3")
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jobs.configure(jd, proc=0)
    jpw = jhealth.ProfileWindow.from_env()
    f = jax.jit(lambda x: x * 2)
    tobs.configure(td, proc=0)
    tpw = thealth.ProfileWindow.make((2, 3))
    x = torch.ones(8)
    for step in range(1, 5):
        jpw.maybe_start(step)
        tpw.maybe_start(step)
        jax.block_until_ready(f(jnp.ones(8)))
        x = x * 2 + step
        jpw.maybe_stop(step)
        tpw.maybe_stop(step)
    assert tpw._done and not tpw._active and jpw._done
    (trace,) = glob.glob(os.path.join(td, "profile", "*.json"))
    assert trace == tpw.path
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert {"aten::mul", "aten::add"} <= names
    (jev,) = _events(jobs, jd, "health.profile")
    (tev,) = _events(tobs, td, "health.profile")
    assert (tev["start_step"], tev["stop_step"]) == (
        jev["start_step"], jev["stop_step"]) == (2, 3)
    assert tev["dir"] == os.path.join(td, "profile")
    assert jev["dir"] == os.path.join(jd, "profile")
    tpw.close()  # closed already: nothing more
    assert len(_events(tobs, td, "health.profile")) == 1


# ------------------------------------------------------------- Trainer
def _jtrainer(loop, storage, monkeypatch, health=True):
    from tpuflow.train import RunConfig, ScalingConfig, Trainer

    if not health:
        monkeypatch.setenv("TPUFLOW_HEALTH", "0")
    return Trainer(loop, scaling_config=ScalingConfig(num_workers=1),
                   run_config=RunConfig(storage_path=storage))


def _ttrainer(loop, storage, health=True):
    from tpuflow_torch.train.trainer import RunConfig, ScalingConfig, Trainer

    return Trainer(loop, scaling_config=ScalingConfig(device="cpu"),
                   run_config=RunConfig(storage_path=storage, health=health))


def test_trainer_report_divergence_skips_save(tmp_path, monkeypatch):
    """``tests/test_health.py::test_trainer_report_divergence_skips_save``
    in both packages: the NaN report raises ``TrainingDiverged`` naming
    the detector and never becomes a checkpoint."""
    from tpuflow.train import get_context as jctx
    from tpuflow_torch.train.trainer import get_context as tctx

    def loop_of(ctx_fn, arr):
        def loop(cfg):
            ctx = ctx_fn()
            ctx.report({"val_loss": 1.0}, state={"w": arr(1.0)}, step=1)
            ctx.report({"val_loss": float("nan")},
                       state={"w": arr(float("nan"))}, step=2)
        return loop

    msgs = {}
    for k, trainer, h in (
            ("j", _jtrainer(loop_of(jctx, lambda v: np.full(8, v, np.float32)),
                            str(tmp_path / "j"), monkeypatch), jhealth),
            ("t", _ttrainer(loop_of(tctx, lambda v: torch.full((8,), v)),
                            str(tmp_path / "t")), thealth)):
        with pytest.raises(h.TrainingDiverged, match="nonfinite") as e:
            trainer.fit()
        msgs[k] = str(e.value).split(". No rollback")[0]
        assert "report skipped the checkpoint save" in str(e.value)
    assert msgs["t"] == msgs["j"]
    for k, Mgr in (("j", JManager), ("t", TManager)):
        mgr = Mgr(str(tmp_path / k / "checkpoints"))
        assert mgr.latest_step() == 1
        assert np.isfinite(np.asarray(mgr.restore(1)["w"])).all()
        mgr.close()


def test_trainer_report_health_disabled(tmp_path, monkeypatch):
    """``tests/test_health.py::test_trainer_report_health_disabled``: with
    the monitor off a NaN report is reported like any value."""
    from tpuflow.train import get_context as jctx
    from tpuflow_torch.train.trainer import get_context as tctx

    def loop_of(ctx_fn):
        def loop(cfg):
            ctx_fn().report({"val_loss": float("nan")}, step=1)
        return loop

    jres = _jtrainer(loop_of(jctx), str(tmp_path / "j"), monkeypatch,
                     health=False).fit()
    tres = _ttrainer(loop_of(tctx), str(tmp_path / "t"), health=False).fit()
    assert math.isnan(jres.metrics["val_loss"])
    assert math.isnan(tres.metrics["val_loss"])
