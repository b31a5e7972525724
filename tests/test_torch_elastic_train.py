"""The elastic re-form through the port's train loops, in process, held to
the JAX package's. A mesh generation of one member (the degenerate world
that needs no subprocess: the drain, the restore and the continuation
are the same machinery a shrink or a grow runs) is announced mid-run:

- ``Trainer.fit``: the twin of ``tests/test_membership.py::
  test_trainer_inprocess_mesh_reform``, run beside the JAX test's loop on
  the same inputs: the report fence unwinds the loop at step 4, the loop
  resumes from step 3, the history is steps 1-6 once each, the member is
  in generation 1, acked it, and recorded ``dist.mesh_generation`` 1;
- ``train_gpt`` (the test preset, 2 epochs of 4 steps, dropout off, the
  same JAX-initialised weights): a grow announced between epochs commits
  the fence's step and resumes from it; the final step, the per-epoch
  history and every step's loss within 1e-4 of the JAX package's own
  in-process run (``test_torch_health_train.py::_close``'s limit), the
  port's step losses bit-equal to an uninterrupted run's;
- the pipeline's fence: a grow commits the step with its cursor and
  raises ``Preempted`` (a lost stage cannot be absorbed);
- the failure check: a collective error without a plan re-raises
  unchanged, with one it becomes ``MeshReform``.
"""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from test_torch_health_train import (  # noqa: F401
    _close,
    _events,
    _from_jax,
    clean,
)
from torch_parity import one_torch_thread  # noqa: F401
from tpuflow import obs as jobs
from tpuflow.dist import membership as jms
from tpuflow.train import gpt as jgpt
from tpuflow_torch import obs as tobs
from tpuflow_torch.ckpt import CheckpointManager
from tpuflow_torch.dist import membership as tms
from tpuflow_torch.train import gpt as tgpt
from tpuflow_torch.utils.preempt import Preempted

KW = dict(preset="test", epochs=2, steps_per_epoch=4, batch_size=8,
          seq_len=16)


@pytest.fixture(autouse=True)
def isolated(monkeypatch):
    monkeypatch.delenv("TPUFLOW_MEMBERSHIP_DIR", raising=False)
    jms.reset()
    tms.configure(None)
    yield
    jms.reset()
    tms.configure(None)
    jobs.configure(None)
    tobs.configure(None)


def _grow(ms, mdir):
    """The supervisor's announcement: generation 1 over the same roster
    (capacity returning elsewhere in a bigger picture)."""
    ms.announce(mdir, ms.Generation(1, (0,), "127.0.0.1:0", reason="grow",
                                    deadline=time.time() + 60))


def _gauges(d):
    events = []
    for path in glob.glob(os.path.join(d, "events.p*.jsonl")):
        with open(path) as f:
            events += [json.loads(line) for line in f if line.strip()]
    return [e["value"] for e in events if e["name"] == "dist.mesh_generation"]


def _reform_loop(ms, get_context, mdir, calls, state_of):
    def loop(cfg):
        ctx = get_context()
        calls["n"] += 1
        start = ctx.latest_step()
        calls["resumes"].append(start)
        for stp in range(start + 1, 7):
            if stp == 4 and calls["n"] == 1:
                _grow(ms, mdir)
            ctx.report({"val_loss": 1.0 / stp}, state=state_of(stp),
                       step=stp)

    return loop


def test_trainer_mesh_reform_matches_jax(tmp_path, monkeypatch):
    from tpuflow.train import RunConfig as JRunConfig
    from tpuflow.train import Trainer as JTrainer
    from tpuflow.train import get_context as jget
    from tpuflow_torch.train.trainer import (
        RunConfig,
        ScalingConfig,
        Trainer,
        get_context,
    )

    got = {}
    for name in ("jax", "port"):
        mdir, od = str(tmp_path / name / "ms"), str(tmp_path / name / "obs")
        calls = {"n": 0, "resumes": []}
        if name == "jax":
            monkeypatch.setenv("TPUFLOW_MEMBERSHIP_DIR", mdir)
            jms.reset()
            jobs.configure(od, proc=0)
            res = JTrainer(_reform_loop(
                jms, jget, mdir, calls,
                lambda s: {"w": np.full((4,), float(s), np.float32)}),
                run_config=JRunConfig(
                    storage_path=str(tmp_path / name / "run"))).fit()
            jobs.flush()
            jobs.configure(None)
            ms = jms
        else:
            tms.configure(mdir, member=0)
            tobs.configure(od, proc=0)
            res = Trainer(_reform_loop(
                tms, get_context, mdir, calls,
                lambda s: {"w": torch.full((4,), float(s))}),
                scaling_config=ScalingConfig(device="cpu"),
                run_config=RunConfig(
                    storage_path=str(tmp_path / name / "run"))).fit()
            tobs.flush()
            tobs.configure(None)
            ms = tms
        got[name] = dict(
            calls=calls, steps=[m["step"] for m in res.metrics_history],
            generation=ms.current_generation(),
            joined=ms.joined_members(mdir, 1), gauges=_gauges(od))
    assert got["port"] == got["jax"]
    assert got["port"]["calls"] == {"n": 2, "resumes": [0, 3]}
    assert got["port"]["steps"] == [1, 2, 3, 4, 5, 6]
    assert got["port"]["generation"] == 1
    assert got["port"]["joined"] == {0}
    assert got["port"]["gauges"][-1] == 1.0


def test_train_gpt_reform_matches_jax(tmp_path, monkeypatch,
                                     clean):  # noqa: F811
    # The JAX package's own in-process run (its slow oracle,
    # tests/test_membership.py::test_gpt_fsdp_inprocess_mesh_reform).
    jdir, jd = str(tmp_path / "jms"), str(tmp_path / "jobs")
    monkeypatch.setenv("TPUFLOW_MEMBERSHIP_DIR", jdir)
    jms.reset()
    jcfg = jgpt.GptTrainConfig(data_axis=4, fsdp_axis=2, **KW)

    def announcing(ms, mdir, logs):
        def log(msg, *a, **k):
            logs.append(str(msg))
            if "epoch 0" in str(msg) and not ms.read_plan(mdir):
                _grow(ms, mdir)
        return log

    jlogs, tlogs = [], []
    jobs.configure(jd, proc=0)
    jres = jgpt.train_gpt(jcfg, str(tmp_path / "jck"),
                          log=announcing(jms, jdir, jlogs))
    jobs.configure(None)
    monkeypatch.delenv("TPUFLOW_MEMBERSHIP_DIR")
    _from_jax(monkeypatch, jcfg)
    cfg = tgpt.GptTrainConfig(data_axis=1, fsdp_axis=1, **KW)
    plain = tgpt.train_gpt(cfg, None, log=lambda m: None, device="cpu")
    tdir = str(tmp_path / "tms")
    tms.configure(tdir, member=0)
    tres = tgpt.train_gpt(cfg, str(tmp_path / "tck"),
                          log=announcing(tms, tdir, tlogs), device="cpu",
                          elastic=True)
    for res, ms, logs in ((jres, jms, jlogs), (tres, tms, tlogs)):
        assert res.checkpoint.metadata["step"] == 8
        assert ms.current_generation() == 1
        assert any("mesh re-form" in m for m in logs)
    _close(tres, jres)
    # The grow fence committed step 5 (epoch 1's first) with its cursor,
    # and the next generation resumed from it mid-epoch.
    assert [(r["step"], r["tier"]) for r in
            tres.checkpoint_io["restores"]] == [(5, "persistent")]
    assert any("replaying from batch 1" in m for m in tlogs)
    jl = [e["value"] for e in _events(jobs, jd, "health.loss")]
    assert len(jl) == 8  # no step ran twice in the JAX run either
    np.testing.assert_allclose(tres.step_losses, jl, atol=1e-4, rtol=0)
    assert tres.step_losses == plain.step_losses


def test_pipeline_grow_fence_commits_and_requeues(tmp_path):
    tms.configure(str(tmp_path / "ms"), member=0)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tree = lambda: {"w": torch.arange(4.0)}  # noqa: E731
    cursor = {"epoch": 1, "batch_index": 1, "seed": 0}
    # No plan: the fence returns and the loop steps on.
    tgpt._reform_fence(mgr, 5, tree, cursor, pipeline=True)
    _grow(tms, str(tmp_path / "ms"))
    with pytest.raises(Preempted, match="generation 1"):
        tgpt._reform_fence(mgr, 5, tree, cursor, pipeline=True)
    after = CheckpointManager(str(tmp_path / "ck"))
    assert after.latest_step() == 5
    assert after.restore_metadata(5)["data_state"] == cursor
    assert torch.equal(after.restore(5)["w"], torch.arange(4.0))
    after.close()


def test_collective_failure_check(tmp_path, monkeypatch):
    from tpuflow_torch.train.trainer import TrainContext

    err = RuntimeError("Connection closed by peer")

    def boom():
        raise err

    # Outside an elastic gang, and in one without a plan, the error is
    # re-raised unchanged.
    with pytest.raises(RuntimeError) as e:
        tgpt._member_lost(err, None)
    assert e.value is err
    monkeypatch.setattr(tms, "REFORM_WAIT_S", 0.1)
    tms.configure(str(tmp_path / "ms"), member=0)
    for check in (lambda: tgpt._member_lost(err, None),
                  lambda: TrainContext._reforming(boom)):
        with pytest.raises(RuntimeError) as e:
            check()
        assert e.value is err
    # With the supervisor's plan it is a member loss: MeshReform.
    plan = tms.Generation(1, (0,), "127.0.0.1:0", reason="shrink")
    tms.announce(str(tmp_path / "ms"), plan)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"w": torch.ones(2)})
    for check in (lambda: tgpt._member_lost(err, mgr),
                  lambda: TrainContext._reforming(boom)):
        with pytest.raises(tms.MeshReform) as e:
            check()
        assert e.value.plan == plan and e.value.__cause__ is err
