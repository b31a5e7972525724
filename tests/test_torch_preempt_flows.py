"""The preemption path through the port's flow layer: the twin of the JAX
suite's ``DuraChaos`` chaos test
(``tests/test_faults.py::test_chaos_flaky_io_partial_commit_preempt_local_tier``)
through ``FlowRunner`` with a gang of 2 over gloo on the CPU. The fault
plan ``ckpt_io_flaky:p1,ckpt_partial_commit,preempt:0@step2,
preempt:1@step2`` (every checkpoint I/O fails once, the first commit is
torn, both members preempted at step 2) and the node-local tier are the
runner's arguments (the JAX test sets ``TPUFLOW_FAULT`` and
``TPUFLOW_CKPT_LOCAL_DIR``). The members drain and exit with the requeue
code; the rerun, which spends no ``@retry(times=0)`` budget, reclaims the
torn ``step_1.tmp`` (``ckpt.gc``), restores the drained step 2 from the
local tier and ends with the metrics history [1, 2, 3]."""

import os
import sys

import pytest

from tpuflow_torch.flow import Run, store
from tpuflow_torch.flow import runner as runner_mod
from tpuflow_torch.flow.runner import FlowRunner

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_flows as gf  # noqa: E402

PLAN = ("ckpt_io_flaky:p1,ckpt_partial_commit,preempt:0@step2,"
        "preempt:1@step2")


@pytest.fixture(autouse=True)
def isolated_home(tmp_path):
    home = store.set_home(str(tmp_path / "home"))
    yield home
    store.set_home(None)


def test_chaos_flaky_io_partial_commit_preempt_local_tier(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(runner_mod, "KILL_GRACE_S", 2.0)
    requeues = []
    real = FlowRunner._exec_gang

    def counting(self, *a, **kw):
        requeues.append(kw.get("attempt"))
        return real(self, *a, **kw)

    monkeypatch.setattr(FlowRunner, "_exec_gang", counting)
    pathspec = FlowRunner(gf.DuraChaos, faults=PLAN,
                          ckpt_local_dir=str(tmp_path / "localtier")
                          ).run({"device": "cpu"})
    run = Run(pathspec)
    assert run.successful
    # Launched twice, the second launch the first's requeue: with no
    # retry budget at all, the requeue spent none.
    assert requeues == [0, 1]
    # The requeue resumed from the drained step 2 (step 1's commit was
    # torn), and the history is continuous: step 1's metrics ride the
    # embedded history of the committed step 2.
    assert run.data.resumed_from == 2
    assert run.data.history_steps == [1, 2, 3]
    events = gf_events(store.run_dir("DuraChaos", 1))
    names = {e["name"] for e in events}
    assert {"flow.run", "flow.step", "flow.gang_member", "flow.preempt",
            "train.report", "ckpt.io_retry"} <= names
    assert "ckpt.save_failed" not in names  # the retries absorbed each blip
    gc = [e for e in events if e["name"] == "ckpt.gc"]
    assert any(d.endswith("step_1.tmp") for e in gc for d in e["dirs"])
    tiers = {(e["step"], e["tier"]) for e in events
             if e["name"] == "ckpt.restore_tier"}
    assert (2, "local") in tiers
    # Both members' reports before the drain are in the merged stream,
    # stamped with their launch.
    pre = {(e["proc"], e["launch"]) for e in events
           if e["name"] == "train.report" and e["step"] == 2}
    assert pre == {(0, 0), (1, 0)}


def gf_events(run_dir):
    from tpuflow_torch.obs import read_events

    return read_events(os.path.join(run_dir, "events.jsonl"))
