"""The port's fault plan (``tpuflow_torch/testing/faults.py``) against the
JAX package's (``tpuflow/testing/faults.py``): the same grammar with the
same errors, and the hooks firing the same way. The JAX side reads its
plan from ``TPUFLOW_FAULT`` and its rank from ``TPUFLOW_PROCESS_ID``; the
port's plan is installed with its rank."""

import dataclasses
import errno
import math

import pytest

from tpuflow.testing import faults as jfaults
from tpuflow_torch.testing import faults as tfaults
from tpuflow_torch.utils import preempt as tpreempt
from tpuflow.utils import preempt as jpreempt

# The JAX test's plan (tests/test_faults.py::test_fault_spec_parsing) plus
# the serving-chaos and elastic kinds.
SPEC = ("member_exit:1@step3,heartbeat_stall:0,rendezvous_delay:2.5@1,"
        "ckpt_flip_byte,preempt:0@step2,rendezvous_delay:7,"
        "nan_grad:0@step4,loss_spike:1@step6,"
        "ckpt_io_flaky:p3,ckpt_partial_commit,upload_stall:1.5,upload_stall,"
        "member_lost:2@step9,rejoin_delay:0.5@1,replica_kill:r-1@0.4,"
        "replica_stall:r-2@0.2,prefill_kill:p-0@1")

BAD = ["explode:1", "member_exit:1@epoch3", "ckpt_truncate:5",
       "nan_grad:0@epoch3", "ckpt_io_flaky:3", "ckpt_partial_commit:1",
       "rejoin_delay:0.5", "replica_kill", "replica_kill:r1",
       "replica_kill:@0.4", "replica_stall:r1@soon", "preempt:x@step1"]


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("TPUFLOW_FAULT", raising=False)
    monkeypatch.delenv("TPUFLOW_PROCESS_ID", raising=False)
    jfaults.reset()
    tfaults.install(None)
    yield
    jfaults.reset()
    tfaults.install(None)
    tpreempt.clear_preemption()
    jpreempt.clear_preemption()


def _jax_plan(monkeypatch, plan: str, rank: int = 0) -> None:
    monkeypatch.setenv("TPUFLOW_FAULT", plan)
    monkeypatch.setenv("TPUFLOW_PROCESS_ID", str(rank))
    jfaults.reset()


def test_parse_matches_jax_field_for_field():
    got = [dataclasses.asdict(f) for f in tfaults.parse(SPEC)]
    want = [dataclasses.asdict(f) for f in jfaults.parse(SPEC)]
    assert got == want and len(got) == 17
    assert tfaults.KINDS == jfaults.KINDS
    by_kind = {}
    for f in tfaults.parse(SPEC):
        by_kind.setdefault(f.kind, []).append(f)
    assert by_kind["member_exit"][0] == tfaults.Fault("member_exit", rank=1,
                                                      step=3)
    assert by_kind["upload_stall"][1].value == 5.0  # the default stall
    assert by_kind["ckpt_io_flaky"][0].value == 3.0


@pytest.mark.parametrize("bad", BAD)
def test_malformed_plans_rejected_by_both(bad):
    with pytest.raises(ValueError):
        jfaults.parse(bad)
    with pytest.raises(ValueError):
        tfaults.parse(bad)
    with pytest.raises(ValueError):
        tfaults.install(bad)
    assert tfaults.installed() is None


def _io_outcomes(fault, ops):
    out = []
    for op, path in ops:
        try:
            fault(op, path)
            out.append("ok")
        except OSError as e:
            assert e.errno == errno.EIO
            out.append("EIO")
    return out


def test_ckpt_io_fault_is_per_op_path_and_bounded(monkeypatch):
    """``ckpt_io_flaky:p2``: exactly two transient EIOs per distinct (op,
    path), then clean; the same sequence as the JAX hook's."""
    ops = [("write_shard", "/a/b.bin")] * 3 + [("write_shard", "/a/o.bin"),
                                              ("commit", "/a/b.bin")] * 3
    _jax_plan(monkeypatch, "ckpt_io_flaky:p2")
    want = _io_outcomes(jfaults.ckpt_io_fault, ops)
    tfaults.install("ckpt_io_flaky:p2")
    got = _io_outcomes(tfaults.ckpt_io_fault, ops)
    assert got == want == ["EIO", "EIO", "ok", "EIO", "EIO", "EIO", "EIO",
                           "ok", "ok"]
    tfaults.install(None)  # no plan: no fault
    assert _io_outcomes(tfaults.ckpt_io_fault, ops) == ["ok"] * len(ops)


def test_grad_poison_fires_once_per_spec(monkeypatch):
    plan = "nan_grad:0@step3,loss_spike:0@step5"
    steps = [2, 3, 3, 5, 5, 6]

    def seq(poison):
        return ["nan" if v is not None and math.isnan(v) else v
                for v in map(poison, steps)]

    _jax_plan(monkeypatch, plan)
    want = seq(jfaults.grad_poison)
    tfaults.install(plan)
    assert seq(tfaults.grad_poison) == want == [None, "nan", None, 1e3,
                                                None, None]
    # Other ranks never fire.
    _jax_plan(monkeypatch, plan, rank=1)
    tfaults.install(plan, rank=1)
    assert seq(tfaults.grad_poison) == seq(jfaults.grad_poison) == [None] * 6


def test_partial_commit_fires_once(monkeypatch):
    _jax_plan(monkeypatch, "ckpt_partial_commit")
    want = [jfaults.partial_commit() for _ in range(3)]
    tfaults.install("ckpt_partial_commit")
    assert [tfaults.partial_commit() for _ in range(3)] == want == [
        True, False, False]
    tfaults.install(None)
    assert not tfaults.partial_commit()


@pytest.mark.parametrize("kind", ["ckpt_flip_byte", "ckpt_truncate"])
def test_corrupt_after_write_fires_once(tmp_path, monkeypatch, kind):
    """The first file written after the plan is installed is corrupted,
    the next is not, in both packages, to the same bytes."""
    def run(hook, root):
        paths = []
        for i in range(2):
            p = root / f"shard{i}.bin"
            p.write_bytes(bytes(range(64)))
            hook(str(p))
            paths.append(p.read_bytes())
        return paths

    _jax_plan(monkeypatch, kind)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = run(jfaults.corrupt_after_write, tmp_path / "j")
    tfaults.install(kind)
    got = run(tfaults.corrupt_after_write, tmp_path / "t")
    assert got == want
    assert got[0] != bytes(range(64)) and got[1] == bytes(range(64))


def test_step_boundary_preempts_its_rank_only(monkeypatch):
    plan = "preempt:1@step2"
    for rank, step, fires in ((0, 2, False), (1, 1, False), (1, 2, True)):
        _jax_plan(monkeypatch, plan, rank=rank)
        tfaults.install(plan, rank=rank)
        jfaults.step_boundary(step)
        tfaults.step_boundary(step)
        assert jpreempt.preemption_requested() is fires
        assert tpreempt.preemption_requested() is fires
        jpreempt.clear_preemption()
        tpreempt.clear_preemption()


def test_member_exit_dies_after_flushing(tmp_path, monkeypatch):
    """``member_exit`` at its step: the flight dump and the flushed
    events are on disk when the process exits with 1."""
    from tpuflow_torch import obs

    obs.configure(str(tmp_path / "obs"), proc=1)
    obs.recorder()._flush_interval = 3600  # only an explicit flush writes
    obs.event("train.report", step=3)
    seen = {}

    def fake_exit(code):
        seen["code"] = code
        seen["events"] = [e["name"] for f in (tmp_path / "obs").glob(
            "events.p*.jsonl") for e in obs.read_events(str(f))]
        raise SystemExit(code)

    monkeypatch.setattr(tfaults.os, "_exit", fake_exit)
    tfaults.install("member_exit:1@step3", rank=1)
    try:
        tfaults.step_boundary(2)  # not its step
        with pytest.raises(SystemExit):
            tfaults.step_boundary(3)
    finally:
        obs.configure(None)
    assert seen["code"] == 1
    assert seen["events"] == ["train.report", "obs.flight"]
    assert (tmp_path / "obs" / "flight" / "p00001.json").exists()


def test_installing_restores_the_previous_plan():
    tfaults.install("ckpt_partial_commit", rank=3)
    assert tfaults.partial_commit()
    with tfaults.installing("upload_stall:0", rank=1):
        assert tfaults.installed() == "upload_stall:0"
        assert not tfaults.partial_commit()
    # The outer plan back, its single shot still spent.
    assert tfaults.installed() == "ckpt_partial_commit"
    assert not tfaults.partial_commit()
    with tfaults.installing(None):
        assert tfaults.installed() == "ckpt_partial_commit"
