"""Elastic gangs through the port's flow layer: gangs of 3 gloo processes
on the CPU under ``FlowRunner(elastic=True)``, the twins of the JAX
suite's acceptance chaos (``tests/test_membership.py``; the JAX tests set
``TPUFLOW_ELASTIC``, ``TPUFLOW_FAULT`` and ``TPUFLOW_KILL_GRACE_S``, the
port takes arguments). The goodput assertions of the JAX tests (the
``resize`` bucket, no requeue gap) wait for the port's goodput ledger,
ROADMAP Queue 1 item 15.

Fast tier: member 1 lost for good at step 2 (``member_lost:1@step2``);
the survivors shrink to a generation of 2, resume and finish in one
attempt. The port's ``Trainer`` commits each report's step on rank 0
once every member has passed the report's fence, so the shrunk gang
resumes from step 2, which member 1 completed before it died; the JAX
gang's multi-host commit of step 2 waits for the next report and dies
with the member, so its resume is step 1 (``[[0, 3], [1, 2]]`` there).

Slow tier: a crashed member shrinks the gang, is relaunched and grows it
back; ``train_gpt``'s FSDP leg (``TorchGptTrain``) shrinking from 3 to 2
processes, its post-shrink losses within 1e-5 relative of an
uninterrupted 3-process run's and every restored region bit-equal to the
committed step; and the four fallbacks to the classic verdict: the
coordinator lost, the survivors below the floor, the resize budget
spent, a re-form's deadline missed."""

import json
import os
import sys

import numpy as np
import pytest

from tpuflow_torch.flow import Run, store
from tpuflow_torch.flow import runner as runner_mod
from tpuflow_torch.flow.runner import FlowRunner, StepFailed
from tpuflow_torch.obs import read_events

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_flows as gf  # noqa: E402


@pytest.fixture(autouse=True)
def isolated_home(tmp_path, monkeypatch):
    monkeypatch.setattr(runner_mod, "KILL_GRACE_S", 2.0)
    home = store.set_home(str(tmp_path / "home"))
    yield home
    store.set_home(None)


def _events(flow: str, run_id: int = 1) -> list[dict]:
    return read_events(os.path.join(store.run_dir(flow, run_id),
                                    "events.jsonl"))


def _named(events, name):
    return [e for e in events if e["name"] == name]


def test_elastic_shrink_on_member_lost():
    pathspec = FlowRunner(gf.Elastic, faults="member_lost:1@step2",
                          elastic=True).run({"device": "cpu", "total": 8,
                                             "step_sleep": 0.1})
    run = Run(pathspec)
    assert run.successful
    assert run.data.invocations == 2
    assert run.data.resumes == [[0, 3], [2, 2]]
    assert run.data.history_steps == list(range(1, 9))
    assert run.data.final_world == 2
    events = _events("Elastic")
    names = {e["name"] for e in events}
    # The loss was a resize, not a failure, and no stall was pinned on a
    # draining survivor (heartbeat_timeout=6).
    assert "flow.member_failed" not in names
    assert "flow.heartbeat_stall" not in names
    (lost,) = _named(events, "flow.member_lost")
    assert (lost["member"], lost["survivors"]) == (1, 2)
    (resize,) = _named(events, "flow.gang_resize")  # no relaunch
    assert resize["reason"] == "shrink"
    assert (resize["from_members"], resize["to_members"]) == (3, 2)
    gens = {e["value"] for e in _named(events, "dist.mesh_generation")}
    assert gens == {0.0, 1.0}


@pytest.mark.slow
def test_elastic_shrink_then_regrow():
    pathspec = FlowRunner(gf.Elastic,
                          faults="member_exit:1@step2,rejoin_delay:1.0@1",
                          elastic=True).run({"device": "cpu", "total": 40,
                                             "step_sleep": 0.3})
    run = Run(pathspec)
    assert run.successful
    assert run.data.history_steps == list(range(1, 41))
    events = _events("Elastic")
    resizes = sorted(_named(events, "flow.gang_resize"),
                     key=lambda e: e["generation"])
    assert [e["reason"] for e in resizes] == ["shrink", "grow"]
    assert [e["to_members"] for e in resizes] == [2, 3]
    # Start, shrink, grow: the grow resumed from the step its fence
    # committed (everyone was alive to commit it).
    assert run.data.invocations == 3
    (s0, w0), (s1, w1), (s2, w2) = run.data.resumes
    assert (s0, w0) == (0, 3) and (s1, w1) == (2, 2)
    assert w2 == 3 and s2 >= 3
    assert run.data.final_world == 3
    assert "flow.member_failed" not in {e["name"] for e in events}


def _gpt_run(faults, elastic):
    params = {a: p.default for a, p in gf.ElasticGpt.parameters().items()}
    params.update(device="cpu", preset="test", data_axis=3, fsdp_axis=1,
                  batch_size=12, seq_len=16, epochs=2, steps_per_epoch=4,
                  attn_impl="xla")
    run = Run(FlowRunner(gf.ElasticGpt, faults=faults,
                         elastic=elastic).run(params))
    sd = store.storage_dir("ElasticGpt", run.run_id, "train")
    records = {}
    for m in range(3):
        with open(os.path.join(sd, f"elastic.p{m}.jsonl")) as f:
            records[m] = [json.loads(line) for line in f]
    return run, records


@pytest.mark.slow
def test_train_gpt_fsdp_shrink_resumes_resharded():
    ref, ref_recs = _gpt_run(None, False)
    run, recs = _gpt_run("member_lost:1@step5", True)
    assert run.successful
    assert [m["epoch"] for m in run.data.metrics_history] == [0, 1]
    want = {r["step"]: r["loss"] for r in ref_recs[0] if "loss" in r}
    for m in (0, 2):
        steps = [r for r in recs[m] if "loss" in r]
        # Generation 0 at world 3: bit-equal to the uninterrupted run.
        assert all(r["loss"] == want[r["step"]] for r in steps
                   if r["gen"] == 0)
        # The shrunk gang (world 2) replays from the epoch-0 checkpoint.
        after = [r for r in steps if r["gen"] == 1]
        assert [r["step"] for r in after] == [5, 6, 7, 8]
        assert all(r["world"] == 2 for r in after)
        np.testing.assert_allclose([r["loss"] for r in after],
                                   [want[r["step"]] for r in after],
                                   rtol=1e-5, atol=0)
        (restore,) = [r for r in recs[m] if "restored" in r]
        assert (restore["gen"], restore["world"], restore["restored"]) == \
            (1, 2, 4)
        assert restore["regions"] and all(
            got == committed for *_, got, committed in restore["regions"])
    np.testing.assert_allclose(run.data.loss_history[0],
                               ref.data.loss_history[0], rtol=1e-5)
    events = _events("ElasticGpt", run.run_id)
    (resize,) = _named(events, "flow.gang_resize")
    assert (resize["reason"], resize["to_members"]) == ("shrink", 2)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["coordinator", "floor", "budget",
                                  "deadline"])
def test_elastic_fallbacks_keep_the_classic_verdict(case):
    flow, faults, kw = gf.Elastic, "member_lost:1@step2", {}
    why = {"coordinator": "the coordinator", "floor": "below the floor of 3",
           "budget": "the resize budget", "deadline": "re-form deadline"}
    if case == "coordinator":
        faults = "member_lost:0@step2"
    elif case == "floor":
        flow = gf.ElasticFloor
    elif case == "budget":
        kw = dict(max_resizes=0)
    else:
        kw = dict(reform_timeout_s=0.0)
    with pytest.raises(StepFailed, match=why[case]):
        FlowRunner(flow, faults=faults, elastic=True, **kw).run(
            {"device": "cpu", "total": 8, "step_sleep": 0.1})
    events = _events(flow.__name__)
    names = [e["name"] for e in events]
    if case == "deadline":
        # The shrink was announced, missed its deadline, and the step
        # failed as without elasticity.
        assert "flow.member_lost" in names
        assert "flow.gang_resize" not in names
    else:
        assert "flow.member_lost" not in names
        (failed,) = _named(events, "flow.member_failed")
        assert failed["member"] == (0 if case == "coordinator" else 1)
