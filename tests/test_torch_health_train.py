"""Training health through ``train_gpt`` against the JAX package's
(``tests/test_health.py``'s chaos cases): its small config (the test
preset, 2 epochs of 2 steps at batch 8 x 16), the same JAX-initialised
weights in both packages (``models/convert.py``), dropout off. With the
fault plan ``nan_grad:0@step3`` both packages flag step 3 (nonfinite),
roll back to the verified step 2 and finish with finite per-epoch losses
within 1e-4 of each other (``test_train_gpt_matches_jax_train_gpt``'s
limit), no duplicate step in the checkpoints' history; the port's
replayed steps are bit-equal to an unpoisoned run's. ``loss_spike`` (x
1e3 on every parameter) at window 8, warmup 3 trips the spike detector in
both at one process. The port's diagnostic with rollback off and its
learning-rate backoff are checked alone. The JAX side takes
``TPUFLOW_FAULT`` and ``TPUFLOW_HEALTH*``; the port, arguments. The slow
cases roll back the pipeline leg (data 1 x stage 2) and FSDP at two
processes, whose ranks restore one target and keep bit-equal losses."""

import dataclasses
import glob
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow import obs as jobs
from tpuflow.ckpt import CheckpointManager as JManager
from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow.testing import faults as jfaults
from tpuflow.train import gpt as jgpt
from tpuflow_torch import obs as tobs
from tpuflow_torch.ckpt import CheckpointManager as TManager
from tpuflow_torch.models.convert import params_from_jax
from tpuflow_torch.models.gpt2 import GPT2
from tpuflow_torch.obs.health import HealthConfig, TrainingDiverged
from tpuflow_torch.train import gpt as tgpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_flows as gf  # noqa: E402

KW = dict(preset="test", epochs=2, steps_per_epoch=2, batch_size=8,
          seq_len=16)
HEALTH_KNOBS = ("TPUFLOW_HEALTH", "TPUFLOW_HEALTH_ROLLBACK",
                "TPUFLOW_HEALTH_WINDOW", "TPUFLOW_HEALTH_WARMUP",
                "TPUFLOW_HEALTH_LR_BACKOFF", "TPUFLOW_PROFILE",
                "TPUFLOW_FAULT")


@pytest.fixture
def clean(tmp_path, monkeypatch):
    for k in HEALTH_KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path / "data"))
    for mod in (jgpt, tgpt):
        real = mod.GptTrainConfig.model_config
        monkeypatch.setattr(
            mod.GptTrainConfig, "model_config",
            lambda self, real=real: dataclasses.replace(real(self),
                                                        dropout=0.0))
    jfaults.reset()
    yield
    jfaults.reset()
    jobs.configure(None)
    tobs.configure(None)


def _events(o, d, name):
    o.flush()
    return [e for p in sorted(glob.glob(os.path.join(d, "events.p*")))
            for e in o.read_events(p) if e["name"] == name]


def _from_jax(monkeypatch, jcfg):
    """The port's ``train_gpt`` starting from the JAX init of ``jcfg``."""
    init = JGPT2(jcfg.model_config()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = params_from_jax(jax.device_get(init))

    def from_jax(model_cfg, device, seed=0):
        m = GPT2(model_cfg, seed=None, device=device)
        if seed is not None:
            m.load_state_dict(sd)
        return m

    monkeypatch.setattr(tgpt, "_init_model", from_jax)


def _history_steps(Mgr, d):
    mgr = Mgr(d)
    steps = [m["step"] for m in mgr._metrics_history]
    mgr.close()
    return steps


def _run_both(tmp_path, monkeypatch, fault, kw, jenv=()):
    """The JAX and the port's runs of ``kw`` under ``fault``, each with
    its obs recorder; returns both results, both obs directories and the
    port's raw step losses."""
    for k, v in jenv:
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TPUFLOW_FAULT", fault)
    jd, td = str(tmp_path / "jobs"), str(tmp_path / "tobs")
    jcfg = jgpt.GptTrainConfig(data_axis=4, fsdp_axis=2, **kw)
    jobs.configure(jd, proc=0)
    jres = jgpt.train_gpt(jcfg, str(tmp_path / "jck"), log=lambda m: None)
    jobs.configure(None)
    monkeypatch.delenv("TPUFLOW_FAULT")
    _from_jax(monkeypatch, jcfg)
    raw = gf.record_step_losses(tgpt, monkeypatch.setattr)
    tobs.configure(td, proc=0)
    # Each knob as its field's type (the defaults': int, float, bool).
    fields = {k[len("TPUFLOW_HEALTH_"):].lower(): v for k, v in jenv}
    health = HealthConfig(**{k: type(getattr(HealthConfig(), k))(v)
                             for k, v in fields.items()})
    tres = tgpt.train_gpt(tgpt.GptTrainConfig(data_axis=1, fsdp_axis=1,
                                              **kw),
                          str(tmp_path / "tck"), log=lambda m: None,
                          device="cpu", faults=fault, health=health)
    return jres, tres, jd, td, raw


def _close(tres, jres):
    for res in (jres, tres):
        assert [m["epoch"] for m in res.metrics_history] == [0, 1]
        assert all(math.isfinite(m["train_loss"])
                   and math.isfinite(m["val_loss"])
                   for m in res.metrics_history)
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        [m["val_loss"] for m in tres.metrics_history],
        [m["val_loss"] for m in jres.metrics_history], atol=1e-4, rtol=0)


def test_nan_grad_rollback_matches_jax(tmp_path, monkeypatch, clean):
    jres, tres, jd, td, raw = _run_both(tmp_path, monkeypatch,
                                        "nan_grad:0@step3", KW)
    _close(tres, jres)
    for o, d in ((jobs, jd), (tobs, td)):
        (an,) = _events(o, d, "health.anomaly")
        assert (an["detector"], an["step"]) == ("nonfinite", 3)
        (rb,) = _events(o, d, "health.rollback")
        assert (rb["step"], rb["detector"], rb["lr_scale"],
                rb["rollbacks"]) == (2, "nonfinite", 1.0, 1)
        # JAX: the dispatch frontier (depth 2); the port settles each step.
        assert 3 <= rb["from_step"] <= 4
        assert _events(o, d, "health.nonfinite")
        assert len(_events(o, d, "health.loss")) >= 4
    (rb,) = _events(tobs, td, "health.rollback")
    assert rb["from_step"] == 3
    assert tres.checkpoint_io["restores"][-1]["step"] == 2
    for Mgr, d in ((JManager, "jck"), (TManager, "tck")):
        steps = _history_steps(Mgr, str(tmp_path / d))
        assert steps == sorted(set(steps)) == [2, 4]
    # Steps 1, 2, the NaN step 3, then 3 and 4 replayed: bit-equal to an
    # unpoisoned run, and the result holds no discarded step.
    assert len(raw) == 5 and math.isnan(raw[2])
    raw = list(raw)  # the recorder goes on recording
    clean_run = tgpt.train_gpt(tgpt.GptTrainConfig(data_axis=1, fsdp_axis=1,
                                                   **KW),
                               None, log=lambda m: None, device="cpu")
    assert raw[:2] + raw[3:] == clean_run.step_losses == tres.step_losses
    assert len(tres.step_s) == 4


def test_loss_spike_rollback_matches_jax(tmp_path, monkeypatch, clean):
    """``loss_spike:0@step5`` at window 8, warmup 3 over 2 x 4 steps (the
    JAX ``test_chaos_loss_spike_rollback``): one process each, so both
    packages scale every parameter. Both flag step 5 and roll back to
    step 4. The port's loss at x 1e3 is finite (~5.9e5) and trips the
    spike detector, as the JAX oracle expects; the jitted JAX step returns
    NaN there on the CPU (its eager forward and gradients of the same
    scaled weights are finite), so the JAX side reads nonfinite."""
    kw = dict(KW, steps_per_epoch=4)
    jres, tres, jd, td, raw = _run_both(
        tmp_path, monkeypatch, "loss_spike:0@step5", kw,
        jenv=(("TPUFLOW_HEALTH_WINDOW", "8"), ("TPUFLOW_HEALTH_WARMUP", "3")))
    _close(tres, jres)
    for o, d in ((jobs, jd), (tobs, td)):
        (an,) = _events(o, d, "health.anomaly")
        assert an["step"] == 5
        assert an["detector"] in ("loss_spike", "nonfinite")
        (rb,) = _events(o, d, "health.rollback")
        assert (rb["step"], rb["detector"]) == (4, an["detector"])
    (tan,) = _events(tobs, td, "health.anomaly")
    assert (tan["detector"], tan["window"]) == ("loss_spike", 4)
    # The window the spike was judged against: the JAX run's steps 1-4.
    jl = [e["value"] for e in _events(jobs, jd, "health.loss")][:4]
    np.testing.assert_allclose(tan["median"], np.median(jl), atol=1e-4)
    assert raw[4] == tan["loss"] > tan["threshold"]
    assert all(m["train_loss"] < 20.0 for m in tres.metrics_history)


def test_rollback_off_halts_with_the_diagnostic(tmp_path, clean):
    cfg = tgpt.GptTrainConfig(data_axis=1, fsdp_axis=1, **KW)
    ck = str(tmp_path / "ck")
    with pytest.raises(TrainingDiverged) as e:
        tgpt.train_gpt(cfg, ck, log=lambda m: None, device="cpu",
                       faults="nan_grad:0@step3",
                       health=HealthConfig(rollback=False))
    msg = str(e.value)
    assert msg.startswith("training diverged: nonfinite at step 3 (")
    assert "HealthConfig(rollback=False)" in msg
    assert e.value.anomaly.step == 3
    # The halt left only committed steps: epoch 0's.
    assert [n for n in sorted(os.listdir(ck))
            if n.startswith("step_")] == ["step_2"]
    # health=False: the NaN run carries on, as with TPUFLOW_HEALTH=0.
    res = tgpt.train_gpt(cfg, None, log=lambda m: None, device="cpu",
                         faults="nan_grad:0@step3", health=False)
    assert math.isnan(res.step_losses[2])


def test_lr_backoff_scales_the_replay(tmp_path, monkeypatch, clean):
    """``nan_grad:0@step3`` with the backoff 0.5: both packages roll back
    to step 2 at ``lr_scale`` 0.5 and replay steps 3 and 4 at half the
    learning rate, to per-epoch losses within 1e-4 of each other; the
    backoff moves epoch 1 by more than that limit."""
    jres, tres, jd, td, raw = _run_both(
        tmp_path, monkeypatch, "nan_grad:0@step3", KW,
        jenv=(("TPUFLOW_HEALTH_LR_BACKOFF", "0.5"),))
    _close(tres, jres)
    for o, d in ((jobs, jd), (tobs, td)):
        (rb,) = _events(o, d, "health.rollback")
        assert (rb["step"], rb["lr_scale"], rb["rollbacks"]) == (2, 0.5, 1)
    cfg = tgpt.GptTrainConfig(data_axis=1, fsdp_axis=1, **KW)
    plain = tgpt.train_gpt(cfg, None, log=lambda m: None, device="cpu")
    # Step 3's loss is read before its (halved) update; step 4 moved less.
    assert tres.step_losses[:3] == plain.step_losses[:3]
    assert tres.step_losses[3] != plain.step_losses[3]
    assert abs(tres.metrics_history[1]["val_loss"]
               - plain.metrics_history[1]["val_loss"]) > 1e-3
    sched = cfg.schedule(0.5)
    assert sched(0) == cfg.learning_rate * 0.5


def _world_rollback(tmp_path, world, cfg):
    ck = str(tmp_path / "ck")
    got = gf.spawn_world(world, "health_train", cfg=cfg, ckpt_dir=ck,
                         faults="nan_grad:0@step3")
    whole = gf.spawn_world(world, "health_train", cfg=cfg, ckpt_dir=None)
    for g, w in zip(got, whole):
        assert g["restores"] == [(2, "persistent")]
        assert g["step"] == 4 and len(g["loss_history"]) == 2
        assert math.isnan(g["raw"][2])
        assert g["raw"][:2] + g["raw"][3:] == w["step_losses"]
        assert g["step_losses"] == w["step_losses"]
    # Every rank restored the one target and kept the same losses.
    assert all(g["step_losses"] == got[0]["step_losses"] for g in got)


@pytest.mark.slow
def test_pipeline_nan_grad_rollback(tmp_path):
    _world_rollback(tmp_path, 2, dict(KW, data_axis=1, stage_axis=2,
                                      microbatches=2))


@pytest.mark.slow
def test_fsdp_nan_grad_rollback_one_target(tmp_path):
    _world_rollback(tmp_path, 2, dict(KW, data_axis=1, fsdp_axis=2))
