"""The port's gang steps as 2-process gloo gangs on the CPU
(``flow/runner.py::_exec_gang`` and ``flow/gang_exec.py``): head-only
artifacts and the tolerant join, a failing member failing the step fast,
a formation timeout failing within its deadline, and a requeue exit
rerunning the step without spending a retry. The flows live in
``tests/torch_gang_flows.py``, which the members load by path."""

import json
import os
import sys
import time

import pytest

from tpuflow_torch.flow import Run, store
from tpuflow_torch.flow.runner import FlowRunner, StepFailed

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_flows as gf  # noqa: E402


@pytest.fixture(autouse=True)
def isolated_home(tmp_path):
    home = store.set_home(str(tmp_path / "home"))
    yield home
    store.set_home(None)


def test_gang_head_artifacts_and_tolerant_join():
    pathspec = FlowRunner(gf.GangFlow).run({"device": "cpu"})
    run = Run(pathspec)
    assert run.successful
    # The world formed: an all-reduce over ranks 1 and 2.
    assert run.data.total == 3.0
    assert (run.data.rank_seen, run.data.size_seen) == (0, 2)
    assert run.data.task_seen == 1 and run.data.inherited == 5
    # Only the head persisted artifacts; the join tolerated the other.
    assert run.data.found == [3.0] and run.data.missing == 1
    assert store.load_artifacts("GangFlow", 1, "work", 2) == {}
    tdir = store.task_dir("GangFlow", 1, "work", 1)
    assert all(os.path.exists(os.path.join(tdir, f"joined_{i}"))
               for i in (0, 1))
    assert run.meta["steps"][1] == {"step": "work", "head_task": 1,
                                    "tasks": 2}


def test_failing_member_fails_the_step_fast():
    t0 = time.monotonic()
    with pytest.raises(StepFailed, match="member 1 exited 1") as ei:
        FlowRunner(gf.FailingGangFlow).run({"device": "cpu"})
    # The survivor sleeps 60 s: it was killed, not waited for.
    assert time.monotonic() - t0 < 40
    assert "member 1 fails" in str(ei.value)
    assert store.read_run_meta("FailingGangFlow", 1)["status"] == "failed"


def test_formation_timeout_fails_within_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(StepFailed, match="member 0 exited"):
        FlowRunner(gf.SlowJoinFlow).run({"device": "cpu"})
    # The 2 s rendezvous timeout, plus the members' start, well inside the
    # supervisor's deadline (2 s + 60 s) and member 1's 60 s sleep.
    assert time.monotonic() - t0 < 40
    tdir = store.task_dir("SlowJoinFlow", 1, "work", 1)
    assert not os.path.exists(os.path.join(tdir, "joined_1"))


def test_requeue_reruns_without_spending_a_retry():
    pathspec = FlowRunner(gf.RequeueFlow).run({"device": "cpu"})
    run = Run(pathspec)
    assert run.successful and run.data.done
    storage = store.storage_dir("RequeueFlow", 1, "work")
    assert os.path.exists(os.path.join(storage, "preempted_once"))
    marker = json.load(open(os.path.join(
        store.task_dir("RequeueFlow", 1, "work", 1), "artifacts.ok")))
    assert marker["attempt"] == 1  # the second launch wrote the artifacts
