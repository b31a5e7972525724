"""The node-local checkpoint tier, ``emergency_save``, the restore ladder,
the startup GC and the retrying I/O's events of the port's
``CheckpointManager``, held against the JAX package's manager driven
through the same sequence on the same state: a test-preset GPT-2's
params, JAX-initialised and carried into the port with
``params_from_jax`` and laid out as the JAX tree by ``params_to_jax``.
The JAX side takes its tier from ``TPUFLOW_CKPT_LOCAL_DIR`` /
``TPUFLOW_CKPT_LOCAL_KEEP``, its plan from ``TPUFLOW_FAULT`` and its
retry budget from ``TPUFLOW_CKPT_IO_RETRIES``; the port takes each as an
argument (the plan installed)."""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2
from tpuflow import obs as jobs
from tpuflow.ckpt import CheckpointManager as JManager
from tpuflow.ckpt.manager import _local_tier_root as j_local_root
from tpuflow.testing import faults as jfaults
from tpuflow_torch import obs as tobs
from tpuflow_torch.ckpt import CheckpointManager as TManager
from tpuflow_torch.ckpt import CorruptShardError, raw
from tpuflow_torch.ckpt.manager import local_tier_root
from tpuflow_torch.ckpt.tree import params_to_jax
from tpuflow_torch.obs.catalog import CATALOG
from tpuflow_torch.testing import faults as tfaults


@pytest.fixture(scope="module")
def trees():
    """The same state in both packages' leaf types."""
    _, params, tm = jax_and_port_gpt2()
    jtree = {"params": jax.device_get(params)}
    ttree = {"params": params_to_jax(tm.state_dict(), scan_layers=False)}
    return jtree, ttree


def _state(tree, step: int, numpy: bool):
    """``tree`` as step ``step``'s payload: the step counter, the params
    scaled by the step (each step's bytes differ)."""
    if numpy:
        return {"step": np.int32(step), "params": jax.tree_util.tree_map(
            lambda a: np.asarray(a) * np.float32(step), tree["params"])}
    return {"step": torch.tensor(step, dtype=torch.int32),
            "params": raw.map_leaves(lambda t: t * step, tree["params"])}


@pytest.fixture
def sides(tmp_path, monkeypatch, trees):
    """Makers of each package's manager on its own directory with the
    local tier under ``tmp_path/local``, their obs streams and fault
    plans."""
    for k in ("TPUFLOW_FAULT", "TPUFLOW_CKPT_LOCAL_DIR",
              "TPUFLOW_CKPT_LOCAL_KEEP", "TPUFLOW_CKPT_IO_RETRIES",
              "TPUFLOW_CKPT_IO_BACKOFF_S", "TPUFLOW_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    local = str(tmp_path / "local")
    monkeypatch.setenv("TPUFLOW_CKPT_IO_BACKOFF_S", "0.001")
    jobs.configure(str(tmp_path / "jobs"), proc=0)
    tobs.configure(str(tmp_path / "tobs"), proc=0)
    jfaults.reset()
    tfaults.install(None)

    def jax_mgr(keep=2, retries=4, **kw):
        monkeypatch.setenv("TPUFLOW_CKPT_LOCAL_DIR", local)
        monkeypatch.setenv("TPUFLOW_CKPT_LOCAL_KEEP", str(keep))
        monkeypatch.setenv("TPUFLOW_CKPT_IO_RETRIES", str(retries))
        return JManager(str(tmp_path / "j" / "ck"), async_save=False, **kw)

    def port_mgr(keep=2, retries=4, **kw):
        return TManager(str(tmp_path / "t" / "ck"), async_save=False,
                        local_dir=local, local_keep=keep, io_retries=retries,
                        io_backoff_s=0.001, **kw)

    def jax_plan(plan):
        if plan:
            monkeypatch.setenv("TPUFLOW_FAULT", plan)
        else:
            monkeypatch.delenv("TPUFLOW_FAULT", raising=False)
        jfaults.reset()

    def events(o, side):
        o.flush()
        out = []
        for p in sorted(glob.glob(str(tmp_path / side / "events.p*"))):
            out += o.read_events(p)
        return out

    jtree, ttree = trees
    yield {"jax": (jax_mgr, jax_plan, lambda: events(jobs, "jobs"),
                   lambda s: _state(jtree, s, True)),
           "port": (port_mgr, lambda plan: tfaults.install(plan),
                    lambda: events(tobs, "tobs"),
                    lambda s: _state(ttree, s, False)),
           "local": local}
    jobs.configure(None)
    tobs.configure(None)
    jfaults.reset()
    tfaults.install(None)


def _tiers(mgr):
    return (mgr._committed_in(mgr.directory),
            mgr._committed_in(mgr.local_dir), mgr.all_steps())


def test_local_root_is_the_jax_key(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUFLOW_CKPT_LOCAL_DIR", str(tmp_path / "nvme"))
    for d in ("ck", "runs/a/ck", "/abs/ck"):
        assert local_tier_root(str(tmp_path / "nvme"), d) == j_local_root(d)
    assert local_tier_root(None, "ck") is None
    assert TManager(str(tmp_path / "m"), local_dir=str(
        tmp_path / "nvme")).local_dir == j_local_root(str(tmp_path / "m"))


def test_steps_per_tier_match_jax(sides):
    """Saves (committed locally, then uploaded), an emergency save (local
    only), retention on both tiers: the same steps on each tier after
    every operation, and the same shard bytes."""
    record = {}
    for side in ("jax", "port"):
        mk, _, events, state = sides[side]
        mgr = mk(keep=2, max_to_keep=2)
        seen = []
        for step in (1, 2):
            mgr.save(step, state(step), metrics={"val_loss": 1.0 / step})
            seen.append(_tiers(mgr))
        mgr.emergency_save(3, state(3), data_state={
            "epoch": 0, "batch_index": 3, "seed": 0})
        seen.append(_tiers(mgr))
        mgr.close()
        mgr = mk(keep=2, max_to_keep=2)  # the requeued attempt
        seen.append((mgr.latest_step(),
                     mgr.restore_metadata()["data_state"]))
        for step in (4, 5):
            mgr.save(step, state(step), metrics={"val_loss": 1.0 / step})
            seen.append(_tiers(mgr))
        mgr.close()
        # The port's names, the ckpt.save spans among them.
        ev = [(e["name"], e.get("step"), e.get("tier"), e.get("ok"))
              for e in events() if e["name"] in CATALOG]
        record[side] = (seen, ev, mgr)
    assert record["port"][0] == record["jax"][0]
    assert record["port"][0] == [
        ([1], [1], [1]), ([1, 2], [1, 2], [1, 2]),
        ([2], [2, 3], [2, 3]),
        (3, {"epoch": 0, "batch_index": 3, "seed": 0}),
        ([4], [3, 4], [3, 4]), ([4, 5], [4, 5], [4, 5])]
    assert record["port"][1] == record["jax"][1]
    assert [e[0] for e in record["port"][1]] == [
        "ckpt.save", "ckpt.upload", "ckpt.save", "ckpt.upload",
        "ckpt.save", "ckpt.emergency_save", "ckpt.save", "ckpt.upload",
        "ckpt.save", "ckpt.upload"]
    # The same bytes: the newest step's manifests agree leaf for leaf.
    jm, tm = (raw.read_manifest(os.path.join(record[s][2].directory,
                                             "step_5", "state"))
              for s in ("jax", "port"))
    assert tm["leaves"] == jm["leaves"]


def test_corrupt_local_copy_falls_to_persistent(sides):
    served = {}
    for side in ("jax", "port"):
        mk, _, events, state = sides[side]
        mgr = mk(max_to_keep=None)
        for step in (1, 2):
            mgr.save(step, state(step), metrics={"val_loss": 1.0 / step})
        shard = sorted(glob.glob(os.path.join(mgr.local_dir, "step_2",
                                              "state", "*.bin")))[0]
        with open(shard, "r+b") as f:
            f.seek(0)
            b = f.read(1)
            f.seek(0)
            f.write(bytes([b[0] ^ 0xFF]))
        out = mgr.restore(2)
        mgr.close()
        served[side] = ([(e["name"], e["step"], e["tier"]) for e in events()
                         if e["name"] in ("ckpt.corrupt",
                                          "ckpt.restore_tier")], out)
    assert served["port"][0] == served["jax"][0] == [
        ("ckpt.corrupt", 2, "local"), ("ckpt.restore_tier", 2, "persistent")]
    # Never the corrupt weights: the step's own.
    want = {"/".join(p): t for p, t in raw.flatten(sides["port"][3](2))}
    got = {"/".join(p): t for p, t in raw.flatten(served["port"][1])}
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_every_copy_corrupt_raises(sides):
    mk, _, _, state = sides["port"]
    mgr = mk(max_to_keep=None)
    mgr.save(1, state(1), metrics={})
    for root in (mgr.local_dir, mgr.directory):
        shard = sorted(glob.glob(os.path.join(root, "step_1", "state",
                                              "*.bin")))[0]
        with open(shard, "r+b") as f:
            f.write(b"\xff\xff\xff\xff")
    with pytest.raises(CorruptShardError):
        mgr.restore(1)
    mgr.close()


def test_partial_commit_is_reclaimed_by_the_next_manager(sides):
    gcs = {}
    for side in ("jax", "port"):
        mk, plan, events, state = sides[side]
        plan("ckpt_partial_commit")
        mgr = mk()
        mgr.save(1, state(1), metrics={"val_loss": 1.0})
        assert mgr.all_steps() == []
        staged = os.listdir(mgr.local_dir)
        mgr.close()
        plan(None)
        mgr2 = mk()
        left = os.listdir(mgr2.local_dir)
        mgr2.close()
        gcs[side] = (staged, left, [e["dirs"] for e in events()
                                    if e["name"] == "ckpt.gc"])
    assert gcs["port"] == gcs["jax"] == (["step_1.tmp"], [],
                                         [["local:step_1.tmp"]])


def test_flaky_io_is_retried_and_exhaustion_fails_the_save(sides):
    """``ckpt_io_flaky:p1``: every operation fails once and is retried
    (``ckpt.io_retry``), the save commits; with p above the budget the
    save fails cleanly (``ckpt.save_failed``) and the next one commits."""
    out = {}
    for side in ("jax", "port"):
        mk, plan, events, state = sides[side]
        plan("ckpt_io_flaky:p1")
        mgr = mk(retries=1)
        mgr.save(1, state(1), metrics={"val_loss": 1.0})
        first = _tiers(mgr)
        plan("ckpt_io_flaky:p3")
        mgr.save(2, state(2), metrics={"val_loss": 0.5})
        failed = _tiers(mgr)
        plan(None)
        mgr.save(3, state(3), metrics={"val_loss": 0.3})
        after = _tiers(mgr)
        mgr.close()
        ev = events()
        out[side] = (first, failed, after,
                     sorted({e["op"] for e in ev
                             if e["name"] == "ckpt.io_retry"}),
                     [e["step"] for e in ev
                      if e["name"] == "ckpt.save_failed"])
    assert out["port"] == out["jax"]
    assert out["port"][:3] == (([1], [1], [1]), ([1], [1], [1]),
                               ([1, 3], [1, 3], [1, 3]))
    assert {"write_shard", "commit", "upload"} <= set(out["port"][3])
    assert out["port"][4] == [2]
