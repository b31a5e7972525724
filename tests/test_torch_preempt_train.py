"""The preemption drain of ``train_gpt`` against the JAX package's
(``tests/test_faults.py::test_gpt_preempt_emergency_save_and_midepoch_resume``):
the test preset, 2 epochs of 4 steps at batch 8 x 16, a grace budget of
0 s and the fault plan ``preempt:0@step3``, so the drain at step 3 takes
``emergency_save`` on the node-local tier. Both packages leave a
local-only ``step_3`` holding the mid-epoch cursor; the requeued call
restores it from the local tier and ends at step 8 with epochs [0, 1].
The port's preempted and resumed losses are bit-equal to its
uninterrupted run's; its loss and validation histories are within 1e-4
of the JAX run's (``test_train_gpt_matches_jax_train_gpt``'s limit),
from the same JAX-initialised weights, dropout off on both sides. The
JAX side takes ``TPUFLOW_FAULT``, ``TPUFLOW_PREEMPT_GRACE_S`` and
``TPUFLOW_CKPT_LOCAL_DIR``; the port, arguments. The slow cases run the
port's drain through the pipeline leg (data 1 x stage 2) and FSDP at two
processes, each member flagged at the same step (as the JAX oracles do:
neither package agrees on a drain step across ranks)."""

import dataclasses
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuflow import obs as jobs
from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow.testing import faults as jfaults
from tpuflow.train import gpt as jgpt
from tpuflow.utils import preempt as jpreempt
from tpuflow_torch import obs as tobs
from tpuflow_torch.models.convert import params_from_jax
from tpuflow_torch.models.gpt2 import GPT2
from tpuflow_torch.train import gpt as tgpt
from tpuflow_torch.utils import preempt as tpreempt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_flows as gf  # noqa: E402
from torch_parity import one_torch_thread  # noqa: F401

KW = dict(preset="test", epochs=2, steps_per_epoch=4, batch_size=8,
          seq_len=16)
CURSOR = {"epoch": 0, "batch_index": 3, "seed": 0}


@pytest.fixture
def clean(tmp_path, monkeypatch):
    for k in ("TPUFLOW_FAULT", "TPUFLOW_CKPT_LOCAL_DIR",
              "TPUFLOW_PREEMPT_GRACE_S"):
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
    jpreempt.clear_preemption()
    tpreempt.clear_preemption()
    jobs.configure(None)
    tobs.configure(None)


def _events(o, d):
    o.flush()
    return [e for p in sorted(glob.glob(os.path.join(d, "events.p*")))
            for e in o.read_events(p)]


def _local_only_step3(local_root, ckpt_dir):
    (meta,) = glob.glob(os.path.join(local_root, "*", "step_3",
                                     "metadata.json"))
    assert not os.path.exists(os.path.join(ckpt_dir, "step_3",
                                           "metadata.json"))
    with open(meta) as f:
        return json.load(f)["data_state"]


def test_preempt_emergency_save_and_midepoch_resume_matches_jax(
        tmp_path, monkeypatch, clean):
    # --- the JAX package, its knobs in the environment.
    jck, jlocal = str(tmp_path / "jck"), str(tmp_path / "jlocal")
    monkeypatch.setenv("TPUFLOW_CKPT_LOCAL_DIR", jlocal)
    monkeypatch.setenv("TPUFLOW_PREEMPT_GRACE_S", "0")
    monkeypatch.setenv("TPUFLOW_FAULT", "preempt:0@step3")
    jobs.configure(str(tmp_path / "jobs"), proc=0)
    jcfg = jgpt.GptTrainConfig(data_axis=4, fsdp_axis=2, **KW)
    with pytest.raises(jpreempt.Preempted):
        jgpt.train_gpt(jcfg, jck, log=lambda m: None)
    assert _local_only_step3(jlocal, jck) == CURSOR
    jpreempt.clear_preemption()
    monkeypatch.delenv("TPUFLOW_FAULT")
    jfaults.reset()
    jres = jgpt.train_gpt(jcfg, jck, log=lambda m: None)
    jev = _events(jobs, str(tmp_path / "jobs"))

    # --- the port, from the same initial weights, its knobs arguments.
    init = JGPT2(jcfg.model_config()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = params_from_jax(jax.device_get(init))

    def from_jax(model_cfg, device, seed=0):
        m = GPT2(model_cfg, seed=None, device=device)
        m.load_state_dict(sd)
        return m

    monkeypatch.setattr(tgpt, "_init_model", from_jax)
    losses = gf.record_step_losses(tgpt, monkeypatch.setattr)
    tck, tlocal = str(tmp_path / "tck"), str(tmp_path / "tlocal")
    tcfg = tgpt.GptTrainConfig(data_axis=1, fsdp_axis=1, **KW)
    tobs.configure(str(tmp_path / "tobs"), proc=0)
    with pytest.raises(tpreempt.Preempted, match="step 3"):
        tgpt.train_gpt(tcfg, tck, log=lambda m: None, device="cpu",
                       faults="preempt:0@step3", preempt_grace_s=0,
                       ckpt_local_dir=tlocal)
    assert _local_only_step3(tlocal, tck) == CURSOR
    assert len(losses) == 3
    tpreempt.clear_preemption()
    tres = tgpt.train_gpt(tcfg, tck, log=lambda m: None, device="cpu",
                          ckpt_local_dir=tlocal)
    tev = _events(tobs, str(tmp_path / "tobs"))

    for res in (jres, tres):
        # Only the epoch's unconsumed tail ran: 3 + 1 + 4 = 8 steps.
        assert res.checkpoint.metadata["step"] == 8
        assert [m["epoch"] for m in res.metrics_history] == [0, 1]
    for ev in (jev, tev):
        (em,) = [e for e in ev if e["name"] == "ckpt.emergency_save"]
        assert (em["step"], em["tier"], em["ok"]) == (3, "local", True)
        assert ("local", 3) in {(e["tier"], e["step"]) for e in ev
                                if e["name"] == "ckpt.restore_tier"}
    # Bit for bit against the port's own uninterrupted run.
    assert len(losses) == 8
    preempted = list(losses)
    losses.clear()
    tgpt.train_gpt(tcfg, None, log=lambda m: None, device="cpu")
    assert preempted == losses
    # Within the train-parity limit of the JAX run.
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        [m["val_loss"] for m in tres.metrics_history],
        [m["val_loss"] for m in jres.metrics_history], atol=1e-4, rtol=0)


def test_full_save_drain_and_a_drain_at_the_epoch_end(tmp_path, monkeypatch,
                                                       clean):
    """With grace to spare the drain takes the full save, on the
    persistent tier. A drain at an epoch's last step runs before that
    epoch's validation and save (as the JAX loop's), so it commits the
    step with the cursor at the epoch's end and the requeue starts the
    next epoch. The preempted and resumed losses are bit-equal to an
    uninterrupted run's."""
    losses = gf.record_step_losses(tgpt, monkeypatch.setattr)
    cfg = tgpt.GptTrainConfig(data_axis=1, fsdp_axis=1, **KW)
    ck = str(tmp_path / "ck")
    with pytest.raises(tpreempt.Preempted):
        tgpt.train_gpt(cfg, ck, log=lambda m: None, device="cpu",
                       faults="preempt:0@step5", preempt_grace_s=30)
    with open(os.path.join(ck, "step_5", "metadata.json")) as f:
        meta = json.load(f)
    assert meta["data_state"] == {"epoch": 1, "batch_index": 1, "seed": 0}
    assert meta["metrics"] == {}
    tpreempt.clear_preemption()
    with pytest.raises(tpreempt.Preempted):
        tgpt.train_gpt(cfg, ck, log=lambda m: None, device="cpu",
                       faults="preempt:0@step8")
    assert json.load(open(os.path.join(ck, "step_8", "metadata.json")))[
        "data_state"] == {"epoch": 1, "batch_index": 4, "seed": 0}
    tpreempt.clear_preemption()
    res = tgpt.train_gpt(cfg, ck, log=lambda m: None, device="cpu")
    assert res.step_losses == [] and res.checkpoint.metadata["step"] == 8
    preempted = list(losses)
    losses.clear()
    tgpt.train_gpt(cfg, None, log=lambda m: None, device="cpu")
    assert preempted == losses


def _world_case(tmp_path, world, cfg):
    """Preempted at step 3 on every rank, requeued, and uninterrupted, on
    a world of ``world`` gloo processes: the checks of the one-process
    case that hold for the port alone."""
    ck, local = str(tmp_path / "ck"), str(tmp_path / "local")
    plan = ",".join(f"preempt:{r}@step3" for r in range(world))
    first = gf.spawn_world(world, "preempt_train", cfg=cfg, ckpt_dir=ck,
                           local_dir=local, faults=plan, grace_s=0.0)
    assert all(r["preempted"] for r in first)
    assert _local_only_step3(local, ck) == CURSOR
    second = gf.spawn_world(world, "preempt_train", cfg=cfg, ckpt_dir=ck,
                            local_dir=local)
    whole = gf.spawn_world(world, "preempt_train", cfg=cfg, ckpt_dir=None)
    for a, b, w in zip(first, second, whole):
        assert (b["step"], b["epochs"]) == (8, [0, 1])
        assert a["step_losses"] + b["step_losses"] == w["step_losses"]


@pytest.mark.slow
def test_pipeline_drain_and_resume(tmp_path):
    _world_case(tmp_path, 2, dict(KW, data_axis=1, stage_axis=2,
                                  microbatches=2))


@pytest.mark.slow
def test_fsdp_drain_and_resume(tmp_path):
    _world_case(tmp_path, 2, dict(KW, data_axis=1, fsdp_axis=2))
