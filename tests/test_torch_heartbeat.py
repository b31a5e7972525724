"""The port's gang heartbeats (``tpuflow_torch/utils/heartbeat.py``) and
the supervisor's stall verdict (``flow/runner.py``) against the JAX
package's: ``beat`` leaves the same file content for the same calls (the
JAX side finds its file in ``TPUFLOW_HEARTBEAT_FILE``, the port's is
``configure``d); the supervisor reads the stamped step as the JAX one
does (``tests/test_obs.py::
test_heartbeat_stamps_step_and_supervisor_reads_it``);
it judges only members that stamped and names the oldest stamp; and a
two-member gloo gang whose member 1 hangs in its first beat
(``heartbeat_stall:1`` under ``@gpu(heartbeat_timeout=2)``) fails with
"heartbeat stalled" and one ``flow.heartbeat_stall`` event for member 1
(the oracle ``tests/test_faults.py::
test_heartbeat_stall_detected_and_killed``)."""

import os
import subprocess
import sys
import time

import pytest

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow.flow.runner import FlowRunner as JRunner
from tpuflow.utils import heartbeat as jhb
from tpuflow_torch import obs as tobs
from tpuflow_torch.flow import store
from tpuflow_torch.flow import runner as runner_mod
from tpuflow_torch.flow.runner import FlowRunner, StepFailed
from tpuflow_torch.testing import faults as tfaults
from tpuflow_torch.utils import heartbeat as thb

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_flows as gf  # noqa: E402


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("TPUFLOW_FAULT", raising=False)
    monkeypatch.delenv("TPUFLOW_HEARTBEAT_FILE", raising=False)
    yield
    thb.configure(None)
    tfaults.install(None)
    tobs.configure(None)
    store.set_home(None)


CALLS = [7, None, None, 0, 12, None, 3]


def test_beat_content_matches_jax(tmp_path, monkeypatch):
    jpath, tpath = tmp_path / "j" / "heartbeat_0", tmp_path / "t" / "hb"
    jpath.parent.mkdir()
    tpath.parent.mkdir()
    thb.beat(5)  # no file configured: nothing
    jhb.beat(5)
    assert not jpath.exists() and not tpath.exists()
    monkeypatch.setenv("TPUFLOW_HEARTBEAT_FILE", str(jpath))
    thb.configure(str(tpath))
    for step in CALLS:
        before = time.time() - 1
        jhb.beat(step)
        thb.beat(step)
        assert tpath.read_text() == jpath.read_text()
        assert os.path.getmtime(tpath) >= before
    assert tpath.read_text() == "3"
    # A file that cannot be written never raises.
    thb.configure(str(tmp_path / "missing" / "hb"))
    thb.beat(1)


def test_supervisor_reads_the_stamped_step_like_jax(tmp_path):
    thb.configure(str(tmp_path / "heartbeat_0"))
    thb.beat(7)
    for R in (JRunner, FlowRunner):
        assert R._heartbeat_step(str(tmp_path), 0) == 7
        assert R._heartbeat_step(str(tmp_path), 1) is None  # absent
    (tmp_path / "heartbeat_0").write_text("")
    assert FlowRunner._heartbeat_step(str(tmp_path), 0) is None


def _sleepers(tdir, n, secs):
    procs = []
    for i in range(n):
        open(os.path.join(tdir, f"joined_{i}"), "w").close()
        log = open(os.path.join(tdir, f"gang_{i}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", f"import time; time.sleep({secs})"],
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def test_supervisor_judges_only_stamped_members(tmp_path, monkeypatch):
    """Members that never stamp are never judged: two silent members
    outliving a 0.3 s timeout finish cleanly. Of stamped members past the
    timeout, the oldest stamp is the culprit (JAX runner :985-1030)."""
    monkeypatch.setattr(runner_mod, "KILL_GRACE_S", 1.0)
    run = FlowRunner(gf.GangFlow)
    d1 = tmp_path / "silent"
    d1.mkdir()
    procs = _sleepers(str(d1), 2, 1.0)
    assert run._supervise_gang(procs, str(d1), timeout=30, step_name="w",
                               stall_timeout=0.3) is None
    d2 = tmp_path / "stale"
    d2.mkdir()
    now = time.time()
    for i, (age, step) in enumerate([(6.0, 4), (10.0, 2)]):
        p = d2 / f"heartbeat_{i}"
        p.write_text(str(step))
        os.utime(p, (now - age, now - age))
    tobs.configure(str(tmp_path / "obs"), proc=0)
    procs = _sleepers(str(d2), 2, 30)
    t0 = time.monotonic()
    kind, member, detail = run._supervise_gang(
        procs, str(d2), timeout=30, step_name="w", stall_timeout=5)
    assert time.monotonic() - t0 < 10
    assert (kind, member) == ("heartbeat_stall", 1)
    assert detail.startswith("member 1 heartbeat stalled 10.")
    assert detail.endswith("(> 5s) at step 2")
    assert all(p.poll() is not None for p, _ in procs)  # survivors killed
    tobs.flush()
    (ev,) = [e for e in tobs.read_events(tobs.recorder().path)
             if e["name"] == "flow.heartbeat_stall"]
    assert (ev["member"], ev["last_step"], ev["step"]) == (1, 2, "w")
    assert ev["age_s"] >= 10.0


def test_gang_heartbeat_stall_detected_and_killed(tmp_path, monkeypatch):
    monkeypatch.setattr(runner_mod, "KILL_GRACE_S", 2.0)
    store.set_home(str(tmp_path / "home"))
    t0 = time.monotonic()
    with pytest.raises(StepFailed, match="heartbeat stalled") as e:
        FlowRunner(gf.HeartbeatStall,
                   faults="heartbeat_stall:1").run({"device": "cpu"})
    elapsed = time.monotonic() - t0
    assert elapsed < 90, f"stall detection took {elapsed:.0f}s"
    assert "member 1 heartbeat stalled" in str(e.value)
    assert "at step 1" in str(e.value)
    events = tobs.read_events(os.path.join(
        store.run_dir("HeartbeatStall", 1), "events.jsonl"))
    stalls = [e for e in events if e["name"] == "flow.heartbeat_stall"]
    assert len(stalls) == 1 and stalls[0]["member"] == 1
    # >= not >: the 50 ms poll can land at age 2.00x s, which
    # round(age, 2) records as 2.0.
    assert stalls[0]["age_s"] >= 2.0 and stalls[0]["last_step"] == 1
    assert "heartbeat_stall: hanging" in stalls[0]["log_tail"]
    tdir = store.task_dir("HeartbeatStall", 1, "work", 1)
    assert int(open(os.path.join(tdir, "heartbeat_0")).read()) > 1
