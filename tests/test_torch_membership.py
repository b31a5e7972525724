"""The elastic gang's membership protocol (``tpuflow_torch/dist/
membership.py``) against the JAX package's (``tpuflow/dist/
membership.py``), case for case with the protocol units of
``tests/test_membership.py``: the ``Generation`` round trip and process
ids, ``roster_diff``, the ordering of pending plans, the formation acks
and their timeout, the plan wait's timeout, the join and done
bookkeeping, plan files crossing between the packages both ways, the
elastic fault specs, and ``ShardedLoader.reshard`` giving the JAX
loader's batches (oracle ``tests/test_membership.py:187-211``). Every
comparison is exact. The JAX side reads ``TPUFLOW_MEMBERSHIP_DIR`` and
``TPUFLOW_PROCESS_ID`` from its environment; the port is
``configure``d."""

import dataclasses
import os
import time

import numpy as np
import pytest

from tpuflow.dist import membership as jms
from tpuflow.testing import faults as jfaults
from tpuflow_torch.dist import membership as tms
from tpuflow_torch.testing import faults as tfaults


@pytest.fixture(autouse=True)
def isolated(monkeypatch):
    for var in ("TPUFLOW_MEMBERSHIP_DIR", "TPUFLOW_PROCESS_ID",
                "TPUFLOW_FAULT"):
        monkeypatch.delenv(var, raising=False)
    jms.reset()
    tms.configure(None)
    jfaults.reset()
    tfaults.install(None)
    yield
    jms.reset()
    tms.configure(None)
    jfaults.reset()
    tfaults.install(None)


def _both(monkeypatch, mdir: str, member: int = 0) -> None:
    """Make this process member ``member`` of the gang in ``mdir`` in
    both packages."""
    monkeypatch.setenv("TPUFLOW_MEMBERSHIP_DIR", mdir)
    monkeypatch.setenv("TPUFLOW_PROCESS_ID", str(member))
    jms.reset()
    tms.configure(mdir, member=member)


def test_generation_round_trip_and_process_ids():
    kw = dict(generation=3, roster=(2, 0), coordinator="127.0.0.1:7001",
              reason="shrink", deadline=123.0)
    g, jg = tms.Generation(**kw), jms.Generation(**kw)
    assert g.roster == jg.roster == (0, 2)
    assert g.num_processes == jg.num_processes == 2
    assert [g.process_id(m) for m in (0, 2)] == [jg.process_id(m)
                                                 for m in (0, 2)] == [0, 1]
    assert g.to_json() == jg.to_json()
    assert tms.Generation.from_json(jg.to_json()) == g
    assert jms.Generation.from_json(g.to_json()) == jg
    # Defaults of a plan without reason and deadline.
    bare = {"generation": 1, "roster": [1, 0], "coordinator": "h:1"}
    assert (dataclasses.asdict(tms.Generation.from_json(bare))
            == dataclasses.asdict(jms.Generation.from_json(bare)))


@pytest.mark.parametrize("old,new", [((0, 1, 2), (0, 2)), ((0, 2), (0, 1, 2)),
                                     ((0, 1), (0, 1)), ((3, 1), (0, 2))])
def test_roster_diff(old, new):
    assert tms.roster_diff(old, new) == jms.roster_diff(old, new)


def test_pending_reform_generation_ordering(tmp_path, monkeypatch):
    mdir = str(tmp_path / "ms")
    _both(monkeypatch, mdir)
    seen = lambda: (tms.pending_reform(), jms.pending_reform())  # noqa: E731
    assert seen() == (None, None)  # no plan at all
    # A plan at the member's current generation is stale, not pending.
    tms.announce(mdir, tms.Generation(0, (0, 1), "127.0.0.1:7002"))
    assert seen() == (None, None)
    plan = dict(generation=1, roster=(0, 2), coordinator="127.0.0.1:7003",
                reason="shrink")
    jms.announce(mdir, jms.Generation(**plan))
    got, want = seen()
    assert got == tms.Generation(**plan) and want == jms.Generation(**plan)
    assert got.to_json() == want.to_json()
    # ... but not for a member the roster counted out.
    _both(monkeypatch, mdir, member=1)
    assert seen() == (None, None)
    # Outside an elastic gang there is nothing to read, and the fence
    # (a collective in a world of several) is the same None.
    tms.configure(None)
    assert tms.pending_reform() is None and tms.fence() is None


def test_await_formed_acks_and_timeout(tmp_path):
    mdir = str(tmp_path / "ms")
    os.makedirs(mdir)
    for ms in (tms, jms):
        plan = ms.Generation(2, (0, 2), "127.0.0.1:7004",
                             deadline=time.time() + 60)
        for m in (0, 2):
            ms._touch(mdir, f"gen_2.joined.{m}")
        ms.await_formed(mdir, plan)
        assert ms.joined_members(mdir, 2) == {0, 2}
        late = ms.Generation(3, (0, 2), "127.0.0.1:7005",
                             deadline=time.time() - 1)
        with pytest.raises(ms.MembershipTimeout, match="generation 3"):
            ms.await_formed(mdir, late)
    # Each package's acks read in the other: the files are one format.
    tms._touch(mdir, "gen_4.joined.1")
    jms._touch(mdir, "gen_4.joined.3")
    assert tms.joined_members(mdir, 4) == jms.joined_members(mdir, 4) \
        == {1, 3}


def test_await_plan_including_timeout(tmp_path, monkeypatch):
    mdir = str(tmp_path / "ms")
    _both(monkeypatch, mdir)
    tms.announce(mdir, tms.Generation(1, (0, 2), "127.0.0.1:7006"))
    for ms in (tms, jms):
        with pytest.raises(ms.MembershipTimeout):
            ms.await_plan_including(1, timeout_s=0.2)
    jms.announce(mdir, jms.Generation(2, (0, 1, 2), "127.0.0.1:7007",
                                      reason="grow"))
    got = tms.await_plan_including(1, timeout_s=5)
    assert (got.generation, got.reason) == (2, "grow")
    assert got.to_json() == jms.await_plan_including(1, 5).to_json()
    tms.configure(None)
    with pytest.raises(tms.MembershipTimeout):
        tms.await_plan_including(1, timeout_s=0.1)


def test_join_and_done_bookkeeping(tmp_path, monkeypatch):
    mdir = str(tmp_path / "ms")
    _both(monkeypatch, mdir)
    tms.request_join(1)
    jms.request_join(3)
    assert tms.join_requests(mdir) == jms.join_requests(mdir) == {1, 3}
    tms.clear_join_request(mdir, 1)
    jms.clear_join_request(mdir, 3)
    assert tms.join_requests(mdir) == jms.join_requests(mdir) == set()
    tms.mark_done(0)
    jms.mark_done(2)
    assert tms.done_members(mdir) == jms.done_members(mdir) == {0, 2}
    assert tms.await_done({0, 2}, timeout_s=1)
    assert not tms.await_done({0, 1, 2}, timeout_s=0.1)
    assert jms.await_done({0, 2}, timeout_s=1)
    # The configured member's own marks (no argument).
    tms.request_join()
    tms.mark_done()
    assert 0 in tms.join_requests(mdir) and 0 in jms.done_members(mdir)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_plan_file_crosses_between_packages(tmp_path, monkeypatch, writer):
    mdir = str(tmp_path / "ms")
    _both(monkeypatch, mdir, member=2)
    kw = dict(generation=5, roster=(2, 0, 4), coordinator="10.0.0.7:29500",
              reason="grow", deadline=1.5e9)
    if writer == "jax":
        jms.announce(mdir, jms.Generation(**kw))
    else:
        tms.announce(mdir, tms.Generation(**kw))
    got, want = tms.read_plan(mdir), jms.read_plan(mdir)
    assert got.to_json() == want.to_json() == {
        "generation": 5, "roster": [0, 2, 4],
        "coordinator": "10.0.0.7:29500", "reason": "grow",
        "deadline": 1.5e9}
    assert tms.pending_reform() == got
    assert jms.pending_reform() == want
    assert got.process_id(2) == want.process_id(2) == 1
    assert tms.roster_diff((0, 2), got.roster) == ([], [4])


def test_reform_after_failure_waits_for_the_plan(tmp_path, monkeypatch):
    assert tms.reform_after_failure(RuntimeError("x")) is None  # no gang
    mdir = str(tmp_path / "ms")
    monkeypatch.setattr(tms, "REFORM_WAIT_S", 0.2)
    tms.configure(mdir)
    t0 = time.monotonic()
    assert tms.reform_after_failure(RuntimeError("x")) is None
    assert time.monotonic() - t0 >= 0.2
    plan = tms.Generation(1, (0,), "127.0.0.1:0", reason="shrink")
    tms.announce(mdir, plan)
    assert tms.reform_after_failure(RuntimeError("x")) == plan


@pytest.mark.parametrize("device,backend", [
    ("cpu", "nccl"), ("cuda:0", None), ("cuda", "nccl")])
def test_elastic_world_over_nccl_is_refused(tmp_path, device, backend):
    """An elastic world runs over gloo only: a generation whose backend
    resolves to NCCL raises before any world forms or any card is
    touched, and a gloo one is kept for the next generation."""
    from tpuflow_torch.dist import mesh

    tms.configure(str(tmp_path / "ms"), member=0)
    plan = tms.Generation(0, (0, 1), "127.0.0.1:1")
    with pytest.raises(ValueError, match="gloo only.*12c-4"):
        tms.elastic_initialize(plan, device=device, backend=backend)
    assert not mesh.is_initialized() and tms.current_generation() == 0
    tms.check_world()  # no world: nothing to refuse
    one = tms.Generation(1, (0,), "127.0.0.1:1", reason="shrink")
    tms.elastic_initialize(one, device="cpu", backend="gloo")
    assert tms.current_generation() == 1
    with pytest.raises(ValueError, match="gloo only"):
        tms.elastic_initialize(one, backend="nccl")
    tms.elastic_initialize(tms.Generation(2, (0,), "127.0.0.1:1"))
    assert tms._STATE["device"] == "cpu" and tms._STATE["backend"] == "gloo"


def test_elastic_fault_specs_parse_as_jax():
    spec = "member_lost:1@step2,rejoin_delay:1.5@1"
    got = [dataclasses.asdict(f) for f in tfaults.parse(spec)]
    want = [dataclasses.asdict(f) for f in jfaults.parse(spec)]
    assert got == want
    assert tfaults.parse(spec) == [
        tfaults.Fault("member_lost", rank=1, step=2),
        tfaults.Fault("rejoin_delay", rank=1, value=1.5)]
    for bad in ("member_lost:1@epoch2", "rejoin_delay:1.5"):
        for faults in (tfaults, jfaults):
            with pytest.raises(ValueError):
                faults.parse(bad)


@pytest.mark.parametrize("rank", [0, 1])
def test_rejoin_delay_sleeps_on_its_rank_only(monkeypatch, rank):
    spec = "rejoin_delay:1.5@1"
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)  # both modules' time
    tfaults.install(spec, rank=rank)
    monkeypatch.setenv("TPUFLOW_FAULT", spec)
    monkeypatch.setenv("TPUFLOW_PROCESS_ID", str(rank))
    jfaults.reset()
    tfaults.maybe_rejoin_delay()
    port = list(slept)
    jfaults.maybe_rejoin_delay()
    assert port == slept[len(port):] == ([1.5] if rank == 1 else [])


def _loaders(shard_index, num_shards):
    from tpuflow.data.datasets import Split as JSplit
    from tpuflow.data.loader import ShardedLoader as JLoader
    from tpuflow_torch.data.datasets import Split as TSplit
    from tpuflow_torch.data.loader import ShardedLoader as TLoader

    images = np.arange(48, dtype=np.int64).reshape(48, 1)
    labels = np.arange(48, dtype=np.int64)
    kw = dict(batch_size=4, shuffle=True, seed=7, shard_index=shard_index,
              num_shards=num_shards)
    return (TLoader(TSplit(images=images, labels=labels), **kw),
            JLoader(JSplit(images=images, labels=labels), **kw))


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return [b["y"].tolist() for b in loader]


def test_sharded_loader_reshard_matches_jax():
    tl, jl = _loaders(1, 3)
    before = _batches(tl, 1)
    assert before == _batches(jl, 1)
    # Re-keyed to a 2-way world: the same (seed, epoch) permutation, the
    # new stride; both packages give the same batches.
    for loader in (tl, jl):
        loader.reshard(0, 2)
    after = _batches(tl, 1)
    assert after == _batches(jl, 1)
    assert len(after) == 48 // 2 // 4 and after != before[:len(after)]
    # A mid-epoch cursor from the old world resumes under the new map.
    for loader in (tl, jl):
        loader.skip_batches(2)
    assert _batches(tl, 1) == _batches(jl, 1) == after[2:]
    # Resharding back reproduces the original stream.
    for loader in (tl, jl):
        loader.reshard(1, 3)
    assert _batches(tl, 1) == _batches(jl, 1) == before
    for bad in ((2, 2), (-1, 2), (0, 0)):
        for loader in (tl, jl):
            with pytest.raises(ValueError, match="out of range"):
                loader.reshard(*bad)
    assert (tl.shard_index, tl.num_shards) == (1, 3)
