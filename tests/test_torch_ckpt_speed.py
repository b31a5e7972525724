"""The checkpoint speed machinery of the port (tpuflow_torch.ckpt.raw and
.manager): the recycle pool, the restore arena and its prewarm, zero-copy
(mapped) restores, the threaded restore and the crc32 computed in each
write task. Counterparts of tests/test_ckpt.py's cases (named at each),
then the cross-package contract:
- a port save through a warm pool gives the JAX ``save_raw``'s manifest
  and shard bytes for the same state, and the JAX ``restore_raw`` reads it
  bit-equal;
- either package's pool adopts the other's ``.recycle``;
- the threaded restore of a JAX checkpoint sharded over 8 devices equals
  the one-thread restore and the saved values.
Then the wiring: ``TrainContext.prewarm_checkpoints`` and ``train_gpt``
leave pools the saves draw from, and ``TorchEval`` loads a finished run
zero-copy with the same predictions. Leaves are 64 KiB or more wherever
the pool must act (smaller ones never touch it)."""

import gc
import json
import os
import shutil
import threading
import zlib

import jax
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow import dist as jdist
from tpuflow.ckpt import CheckpointManager as JCheckpointManager
from tpuflow.ckpt import raw as jraw
from tpuflow_torch.ckpt import (
    Checkpoint,
    CheckpointManager,
    RecyclePool,
    RestoreArena,
    prewarm_restore_handle,
    restore_from_handle,
)
from tpuflow_torch.ckpt import raw

BIG = 1 << 20  # a pool file size in the pool's own tests


def _state(i: float, shape=(64, 1024)):
    """One 256 KiB float32 leaf (the pool's business) and a tiny one."""
    return {"params": {"w": torch.full(shape, float(i)),
                       "b": torch.full((4,), float(i))}}


def _assert_trees_equal(a, b):
    fa, fb = raw.flatten(a), raw.flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def _pool_files(root) -> list[str]:
    d = os.path.join(str(root), ".recycle")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _cores(monkeypatch, n: int) -> None:
    """Make the prewarms see ``n`` spare cores (0 parks them)."""
    monkeypatch.setattr(raw, "_spare_cores", lambda: n)


@pytest.fixture
def tmpfs(monkeypatch):
    """Checkpoint storage taken for memory-backed, where the manager
    prewarms its pool (a disk gets no warm files)."""
    monkeypatch.setattr(raw, "_fs_is_memory_backed", lambda path: True)


@pytest.fixture
def arena():
    """The process-wide arena, empty before and after the test."""
    raw._ARENA.clear()
    yield raw._ARENA
    raw._ARENA.clear()


# ------------------------------------------------------------ the pool
def test_recycled_files_never_corrupt_restores(tmp_path):
    """(:154) Retired files are overwritten in place by later saves, and a
    restored state never aliases their pages."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1, async_save=True)
    for step in range(1, 5):
        mgr.save(step, _state(step), metrics={"val_loss": 1.0 / step})
    mgr.wait_until_finished()
    restored = mgr.restore(4)
    before = restored["params"]["w"].clone()
    assert torch.equal(before, torch.full((64, 1024), 4.0))
    taken = mgr._pool.taken
    for step in (5, 6):
        mgr.save(step, _state(1), metrics={"val_loss": 1.0 / step})
    mgr.wait_until_finished()
    assert mgr._pool.taken > taken  # the later saves drew retired files
    assert torch.equal(restored["params"]["w"], before)
    _assert_trees_equal(mgr.restore(6), _state(1))
    mgr.close()


def test_zero_copy_restore_is_correct_and_recycle_safe(tmp_path):
    """(:193) A zero-copy restore maps the shard files; retention adopting
    its step and later saves reusing the pool must not change it: its
    inodes are unlinked, never overwritten. The registration is released
    with the mapping."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1, async_save=False)
    mgr.save(1, _state(1), metrics={"val_loss": 1.0})
    restored = mgr.restore(1, zero_copy=True)
    w = restored["params"]["w"]
    assert torch.equal(w, torch.full((64, 1024), 1.0))
    assert len(raw._ALIASED_INODES) >= 2
    for step in (2, 3, 4):
        mgr.save(step, _state(step), metrics={"val_loss": 1.0 / step})
    assert mgr._pool.taken > 0  # step 2's retired files were recycled
    assert torch.equal(w, torch.full((64, 1024), 1.0)), \
        "a zero-copy restore was mutated by recycled saves"
    params = restore_from_handle(mgr.checkpoint(4), weights_only=True,
                                 zero_copy=True)
    assert torch.equal(params["w"], torch.full((64, 1024), 4.0))
    mgr.close()
    del restored, w, params
    gc.collect()
    assert raw._ALIASED_INODES == {}


def test_prewarm_backs_pool_files_and_the_first_save_recycles(tmp_path,
                                                              tmpfs):
    """(:231) ``prewarm`` creates pool files at the saved sizes for the
    retention footprint; a repeat adds none; the first save draws them and
    restores bit-equal."""
    state = _state(3)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1, async_save=False)
    mgr.prewarm(state)
    mgr.prewarm_wait()
    warmed = _pool_files(tmp_path)
    # One 256 KiB leaf (the 16-byte one is under 64 KiB) x (max_to_keep +
    # the best step + one in flight).
    assert len(warmed) == 3, warmed
    assert all(os.path.getsize(tmp_path / ".recycle" / f) == 64 * 1024 * 4
               for f in warmed)
    mgr.prewarm(state)
    mgr.prewarm_wait()
    assert _pool_files(tmp_path) == warmed
    mgr.save(1, state, metrics={"val_loss": 1.0})
    assert mgr._pool.taken == 1 and len(_pool_files(tmp_path)) == 2
    assert mgr.saves[-1]["recycled"] == 1
    _assert_trees_equal(mgr.restore(1), state)
    # save_dtype: the pool files take the saved (downcast) size.
    half = CheckpointManager(str(tmp_path / "half"), max_to_keep=1,
                             save_dtype="bfloat16")
    half.prewarm(state)
    half.prewarm_wait()
    assert {os.path.getsize(tmp_path / "half" / ".recycle" / f)
            for f in _pool_files(tmp_path / "half")} == {64 * 1024 * 2}
    half.close()
    mgr.close()


def test_manager_prewarms_the_pool_only_on_memory_backed_storage(
        tmp_path, monkeypatch):
    """On a disk ``prewarm`` writes no warm files and the first save
    writes fresh ones; on tmpfs the first save draws prewarmed files. The
    save records count the files drawn."""
    state = _state(4)
    for memory, want in ((False, 0), (True, 1)):
        monkeypatch.setattr(raw, "_fs_is_memory_backed",
                            lambda path, m=memory: m)
        d = tmp_path / str(memory)
        mgr = CheckpointManager(str(d), max_to_keep=1, async_save=False)
        mgr.prewarm(state)
        mgr.prewarm_wait()
        assert len(_pool_files(d)) == 3 * want
        mgr.save(1, state, metrics={"val_loss": 1.0})
        assert mgr.saves[-1]["recycled"] == want
        _assert_trees_equal(mgr.restore(1), state)
        mgr.close()


def test_pool_take_prefers_exact_then_smallest_larger(tmp_path,
                                                      monkeypatch):
    _cores(monkeypatch, 0)
    pool = RecyclePool(str(tmp_path / "p"))
    pool.prewarm([BIG, 2 * BIG, 4 * BIG])
    pool.prewarm_wait()
    assert pool.take(1000) is None  # under 64 KiB: never
    assert os.path.getsize(pool.take(2 * BIG)) == 2 * BIG
    assert os.path.getsize(pool.take(3 * BIG)) == 4 * BIG
    assert os.path.getsize(pool.take(BIG // 2)) == BIG
    assert pool.take(BIG) is None and pool.taken == 3


def test_prewarm_parks_without_spare_cores(tmp_path, monkeypatch):
    """(:641) With no spare core a background prewarm spawns nothing: its
    work runs only in ``prewarm_wait`` and is dropped by cancel/clear."""
    _cores(monkeypatch, 0)
    pool = RecyclePool(str(tmp_path / "pool"))
    pool.prewarm([BIG, BIG])
    assert not pool._warm_threads
    assert pool.take(BIG) is None
    pool.prewarm_wait()
    assert pool.take(BIG) is not None and pool.take(BIG) is not None

    pool2 = RecyclePool(str(tmp_path / "pool2"))
    pool2.prewarm([BIG])
    pool2.cancel_prewarm()
    pool2.prewarm_wait()
    assert pool2.take(BIG) is None and not pool2._warm_promised
    pool2.prewarm([BIG])  # re-booked after the cancel
    pool2.prewarm_wait()
    assert pool2.take(BIG) is not None

    arena = RestoreArena()
    arena.prewarm([BIG])
    assert arena.take(BIG) is None
    arena.prewarm_wait()
    assert arena.take(BIG) is not None
    arena.prewarm([BIG])
    arena.clear()  # drops parked work without running it
    arena.prewarm_wait()
    assert arena.take(BIG) is None


def test_prewarm_runs_in_the_background_with_spare_cores(tmp_path,
                                                         monkeypatch):
    """(:684)"""
    _cores(monkeypatch, 1)
    pool = RecyclePool(str(tmp_path / "pool"))
    pool.prewarm([BIG])
    assert len(pool._warm_threads) == 1
    pool.prewarm_wait()
    assert not pool._warm_threads  # joined
    assert pool.take(BIG) is not None
    arena = RestoreArena()
    arena.prewarm([BIG])
    arena.prewarm_wait()
    buf = arena.take(BIG)
    assert buf is not None and buf.dtype == torch.uint8
    assert buf.numel() == BIG and buf.data_ptr() % 4096 == 0


def test_prewarm_goes_through_retry_io(tmp_path, monkeypatch):
    """(:1123) A transient error while writing a warm file is retried, not
    left as a missing file."""
    ops = []
    real_retry = raw.retry_io

    def recording(fn, *, op, **kw):
        ops.append(op)
        return real_retry(fn, op=op, **kw)

    monkeypatch.setattr(raw, "retry_io", recording)
    real_open, failed = open, []

    def flaky_open(path, *a, **kw):
        if ".recycle" in str(path) and not failed:
            failed.append(path)
            raise OSError(5, "hiccup", path)  # EIO: transient
        return real_open(path, *a, **kw)

    monkeypatch.setattr(raw, "open", flaky_open, raising=False)
    _cores(monkeypatch, 0)
    pool = RecyclePool(str(tmp_path / ".recycle"),
                       policy=raw.RetryPolicy(retries=2, backoff_s=0.0))
    pool.prewarm([BIG])
    pool.prewarm_wait()
    assert failed and ops == ["prewarm"]
    assert pool.take(BIG) is not None, "warm file silently absent"


def test_prewarm_that_fails_for_good_leaves_the_save_its_own_cost(
        tmp_path, monkeypatch, tmpfs):
    """A prewarm whose writes fail permanently books nothing; the save then
    writes fresh files and its bytes are unchanged."""
    real_open = open

    def denied(path, *a, **kw):
        if ".recycle" in str(path):
            raise PermissionError(13, "denied", path)
        return real_open(path, *a, **kw)

    monkeypatch.setattr(raw, "open", denied, raising=False)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    _cores(monkeypatch, 0)
    mgr.prewarm(_state(2))
    mgr.prewarm_wait()
    monkeypatch.undo()
    assert _pool_files(tmp_path) == [] and not mgr._pool._warm_promised
    mgr.save(1, _state(2), metrics={"val_loss": 1.0})
    assert mgr._pool.taken == 0
    _assert_trees_equal(mgr.restore(1), _state(2))
    mgr.close()


# ----------------------------------------------------------- the arena
def test_arena_buffers_are_used_and_correct(tmp_path, arena):
    """(:386) Each prewarmed buffer is handed out once, the restore is
    bit-equal, and with the arena empty a restore allocates its own."""
    state = _state(5)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state, metrics={"val_loss": 1.0})
    sizes = raw.manifest_shard_sizes(
        os.path.join(str(tmp_path), "step_1", "state"))
    assert sorted(sizes) == [16, 64 * 1024 * 4]
    mgr.prewarm_restore(1, background=False)
    assert sum(len(v) for v in arena._buffers.values()) == len(sizes)
    taken = arena.taken
    tmpl = {"params": {"w": torch.empty(64, 1024, device="meta"),
                       "b": torch.empty(4, device="meta")}}
    _assert_trees_equal(mgr.restore(1, abstract_state=tmpl), state)
    assert arena.taken - taken == len(sizes) and arena._buffers == {}
    assert mgr.restores[-1]["arena_buffers"] == len(sizes)
    assert mgr.restores[-1]["pinned"] == 0
    _assert_trees_equal(mgr.restore(1, abstract_state=tmpl), state)
    assert arena.taken - taken == len(sizes)
    # Unconsumed buffers die with the restore that did not take them.
    mgr.prewarm_restore(1, background=False)
    mgr.restore(1, weights_only=True, zero_copy=True)
    assert arena._buffers == {}
    mgr.close()


def test_prewarm_restore_handle_and_the_non_raw_noop(tmp_path, arena):
    """(:425)"""
    state = _state(7)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, state, metrics={"val_loss": 0.5})
    handle = mgr.checkpoint()
    prewarm_restore_handle(handle, weights_only=True)
    arena.prewarm_wait()
    assert sum(len(v) for v in arena._buffers.values()) == 2
    taken = arena.taken
    _assert_trees_equal(restore_from_handle(handle, weights_only=True),
                        state["params"])
    assert arena.taken - taken == 2
    prewarm_restore_handle(Checkpoint(path=str(tmp_path / "nope")))
    arena.prewarm_wait()
    assert arena._buffers == {}
    if not torch.cuda.is_available():  # asking to pin is never swallowed
        with pytest.raises(RuntimeError, match="need CUDA"):
            prewarm_restore_handle(handle, pinned=True)
    mgr.close()


def test_concurrent_restores_are_serialized_and_correct(tmp_path):
    """(:516) Two threads restoring different checkpoints, each with its
    own background prewarm, both get exact bytes; closing leaves nothing
    in the process arena."""
    g = torch.Generator().manual_seed(7)
    payloads, mgrs = [], []
    for i in range(2):
        state = {"w": torch.randn(64, 1024, generator=g)}
        mgr = CheckpointManager(str(tmp_path / f"ck{i}"), max_to_keep=1)
        mgr.save(1, state)
        mgr.wait_until_finished()
        payloads.append(state)
        mgrs.append(mgr)
    results, errors = {}, []

    def restore(i):
        try:
            mgrs[i].prewarm_restore(1, background=True)
            results[i] = mgrs[i].restore(1)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=restore, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    for i in (0, 1):
        _assert_trees_equal(results[i], payloads[i])
    for m in mgrs:
        m.close()
    raw._ARENA.prewarm_wait()
    assert raw._ARENA._buffers == {}


def test_arena_abandon_discards_in_flight(monkeypatch):
    """(:1161) ``abandon`` returns without joining an in-flight prewarm,
    which then lands nothing; a later prewarm lands again."""
    _cores(monkeypatch, 1)
    arena = RestoreArena()
    gate = threading.Event()
    real = raw.aligned_empty

    def slow(n):
        gate.wait(5)
        return real(n)

    monkeypatch.setattr(raw, "aligned_empty", slow)
    try:
        arena.prewarm([BIG])
        arena.abandon()
        gate.set()
        arena.prewarm_wait()
        assert arena.take(BIG) is None
        arena.prewarm([BIG])
        arena.prewarm_wait()
        assert arena.take(BIG) is not None
    finally:
        gate.set()
        arena.clear()


# ------------------------------------------------------- the IO paths
def test_write_tasks_crc_and_threaded_restore_equal_serial(tmp_path):
    """Each shard's crc32, computed in its write task, equals the serial
    crc32 of the leaf's bytes; the manifest lists the leaves in order; a
    restore on one thread and on the default pool give the same tensors,
    and so does a zero-copy one."""
    g = torch.Generator().manual_seed(1)
    tree = {f"l{i}": torch.randn(64 + i, 300, generator=g)
            for i in range(9)}
    tree["h"] = torch.randn(8, 8, generator=g).to(torch.bfloat16)
    tree["n"] = torch.tensor(5, dtype=torch.int32)
    raw.save_raw(str(tmp_path), tree)
    manifest = raw.read_manifest(str(tmp_path))
    flat = raw.flatten(tree)
    assert [e["path"] for e in manifest["leaves"]] == [p for p, _ in flat]
    for e, (_, t) in zip(manifest["leaves"], flat):
        assert e["shards"][0]["crc32"] == zlib.crc32(raw._bytes(t).tobytes())
    one = raw.restore_raw(str(tmp_path), io_threads=1)
    _assert_trees_equal(one, tree)
    _assert_trees_equal(raw.restore_raw(str(tmp_path)), one)
    _assert_trees_equal(raw.restore_raw(str(tmp_path), zero_copy=True), one)
    _assert_trees_equal(raw.restore_raw(str(tmp_path), verify=False), one)


def test_a_corrupt_shard_fails_every_read_path(tmp_path):
    raw.save_raw(str(tmp_path), {"w": torch.ones(64, 1024)})
    path = tmp_path / "leaf_00000_0x0.bin"
    data = bytearray(path.read_bytes())
    data[100] ^= 0xFF
    path.write_bytes(bytes(data))
    for kw in ({}, {"zero_copy": True}, {"io_threads": 1}):
        with pytest.raises(raw.CorruptShardError, match="crc32"):
            raw.restore_raw(str(tmp_path), **kw)
    got = raw.restore_raw(str(tmp_path), verify=False)["w"]
    assert int((got != 1.0).sum()) == 1


def test_write_width_follows_the_storage(tmp_path, monkeypatch):
    """One file at a time on tmpfs, four on a disk, or the width asked
    for (the JAX package's TPUFLOW_WRITE_CONCURRENCY)."""
    widths = []
    real = raw.ThreadPoolExecutor

    def spy(max_workers):
        widths.append(max_workers)
        return real(max_workers=max_workers)

    monkeypatch.setattr(raw, "ThreadPoolExecutor", spy)
    host = raw._gather_host({f"l{i}": torch.ones(4) for i in range(6)})
    for memory, workers in ((True, None), (False, None), (False, 2)):
        monkeypatch.setattr(raw, "_fs_is_memory_backed", lambda p, m=memory: m)
        d = tmp_path / f"{memory}{workers}"
        d.mkdir()
        raw._write_entries(str(d), host, raw.RetryPolicy(), workers=workers)
    assert widths == [1, 4, 2]


# ------------------------------------------------------ cross-package
def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((128, 512), np.float32),
                       "b": rng.standard_normal(7).astype(np.float32)},
            "opt_state": {"mu": rng.standard_normal((300, 200),
                                                    np.float32)},
            "step": np.int32(9)}


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in os.listdir(d)}


def test_port_save_through_a_warm_pool_equals_the_jax_save(tmp_path,
                                                           monkeypatch):
    """The same state saved by ``tpuflow.ckpt.raw.save_raw`` and by the
    port through a recycled pool (larger and smaller retired files): the
    same manifest bytes and shard bytes; the JAX restore reads the port's
    bit-equal."""
    tree = _np_tree()
    jraw.save_raw(str(tmp_path / "jax"), tree)
    _cores(monkeypatch, 0)
    pool = RecyclePool(str(tmp_path / "pool"))
    pool.prewarm([128 * 512 * 4, 300 * 200 * 4 + 4096, 1 << 20])
    pool.prewarm_wait()
    ttree = raw.unflatten([(p, torch.from_numpy(np.asarray(x)))
                           for p, x in raw.flatten(tree)])
    raw.save_raw(str(tmp_path / "port"), ttree, pool=pool)
    assert pool.taken == 2  # the two leaves of 64 KiB or more
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    back = jraw.restore_raw(str(tmp_path / "port"))
    for (p, want), (_, got) in zip(raw.flatten(tree), raw.flatten(back)):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), p


def test_the_packages_adopt_each_others_recycle_dirs(tmp_path):
    """A ``.recycle`` one package's pool filled is the other's to draw
    from, and its name counter starts past the files there."""
    jdir = str(tmp_path / "jpool")
    jpool = jraw.RecyclePool(jdir)
    jpool.prewarm([BIG, 2 * BIG])
    jpool.prewarm_wait()
    port = RecyclePool(jdir)
    assert port._counter == 2
    assert os.path.getsize(port.take(2 * BIG)) == 2 * BIG
    os.makedirs(tmp_path / "step" / "state")
    with open(tmp_path / "step" / "state" / "leaf_00000_0.bin", "wb") as f:
        f.write(b"\0" * BIG)
    port.adopt_dir(str(tmp_path / "step"))
    assert not os.path.exists(tmp_path / "step")
    assert os.path.getsize(os.path.join(jdir, "r00000003.bin")) == BIG

    pdir = str(tmp_path / "ppool")
    pool = RecyclePool(pdir)
    pool.prewarm([BIG, BIG])
    pool.prewarm_wait()
    again = jraw.RecyclePool(pdir)
    assert again._counter == 2 and again.take(BIG) is not None
    # A JAX manager on a port-written run directory adopts its pool too.
    mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=1,
                            async_save=False)
    for step in (1, 2):
        mgr.save(step, _state(step), metrics={"val_loss": 1.0 / step})
    mgr.close()
    jmgr = JCheckpointManager(str(tmp_path / "run"), max_to_keep=1,
                              async_save=False)
    assert jmgr._pool.take(64 * 1024 * 4) is not None
    jmgr.close()


def test_threaded_restore_of_a_sharded_jax_checkpoint(tmp_path, mesh8,
                                                      arena):
    """A JAX checkpoint whose leaves are sharded over 8 devices (8 shard
    files a leaf): the threaded restore, the one-thread one, the
    zero-copy one and one into prewarmed buffers equal the saved values."""
    sharding = jdist.batch_sharding(mesh8)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    m = rng.standard_normal((32, 100)).astype(np.float32)
    state = {"params": {"w": jax.device_put(w, sharding)},
             "opt_state": {"m": jax.device_put(m, sharding)}}
    jm = JCheckpointManager(str(tmp_path), async_save=False)
    jm.save(1, state, metrics={"val_loss": 1.0})
    jm.close()
    state_dir = str(tmp_path / "step_1" / "state")
    manifest = raw.read_manifest(state_dir)
    assert [len(e["shards"]) for e in manifest["leaves"]] == [8, 8]
    want = {"params": {"w": torch.from_numpy(w)},
            "opt_state": {"m": torch.from_numpy(m)}}
    _assert_trees_equal(raw.restore_raw(state_dir, io_threads=1), want)
    _assert_trees_equal(raw.restore_raw(state_dir), want)
    _assert_trees_equal(raw.restore_raw(state_dir, zero_copy=True), want)
    mgr = CheckpointManager(str(tmp_path))
    mgr.prewarm_restore(1, background=False)
    taken = arena.taken
    _assert_trees_equal(mgr.restore(1), want)
    assert arena.taken - taken == 2  # one buffer a leaf
    mgr.close()


# ------------------------------------------------------------- wiring
def _count_takes(monkeypatch):
    hits = []
    real = RecyclePool.take

    def take(self, nbytes):
        path = real(self, nbytes)
        hits.append((nbytes, path is not None))
        return path

    monkeypatch.setattr(RecyclePool, "take", take)
    return hits


def _big_shards(step_dir) -> int:
    leaves = raw.read_manifest(os.path.join(step_dir, "state"))["leaves"]
    return sum(1 for e in leaves
               if raw._nbytes(e["shape"], raw.torch_dtype(e["dtype"]))
               >= 64 * 1024)


def test_train_gpt_prewarms_a_pool_every_save_draws_from(tmp_path,
                                                         monkeypatch, tmpfs):
    from tpuflow_torch.train.gpt import GptTrainConfig, train_gpt

    hits = _count_takes(monkeypatch)
    cfg = GptTrainConfig(preset="test", epochs=2, steps_per_epoch=2,
                         batch_size=2, seq_len=32, data_axis=1,
                         fsdp_axis=1, learning_rate=1e-3)
    res = train_gpt(cfg, str(tmp_path), log=lambda *a: None, device="cpu")
    n_big = _big_shards(res.checkpoint.path)
    big = [ok for n, ok in hits if n >= 64 * 1024]
    # The first save may race the background prewarm; the second finds
    # every file warm.
    assert n_big > 0 and len(big) == 2 * n_big and all(big[n_big:]), hits
    assert _pool_files(tmp_path)  # the rest of the footprint stays warm


def test_train_gpt_resume_waits_for_its_restore_prewarm(tmp_path,
                                                       monkeypatch):
    """The in-run resume's restore starts only once the background
    prewarm has backed its buffers, however slow: it takes one a leaf."""
    import time

    from tpuflow_torch.train.gpt import GptTrainConfig, train_gpt

    cfg = GptTrainConfig(preset="test", epochs=2, steps_per_epoch=2,
                         batch_size=2, seq_len=32, data_axis=1,
                         fsdp_axis=1, learning_rate=1e-3)
    full = train_gpt(cfg, str(tmp_path / "a"), log=lambda *a: None,
                     device="cpu")
    shutil.copytree(tmp_path / "a", tmp_path / "b",
                    ignore=shutil.ignore_patterns("step_4", ".recycle"))
    _cores(monkeypatch, 1)
    real = RestoreArena._back

    def slow(self, sizes, gen, pinned):
        time.sleep(2)
        real(self, sizes, gen, pinned)

    monkeypatch.setattr(RestoreArena, "_back", slow)
    again = train_gpt(cfg, str(tmp_path / "b"), log=lambda *a: None,
                      device="cpu")
    (rec,) = again.checkpoint_io["restores"]
    n = len(raw.read_manifest(
        os.path.join(full.checkpoint.path, "state"))["leaves"])
    assert rec["step"] == 2 and rec["arena_buffers"] == n
    assert raw._ARENA._buffers == {}


def test_trainer_prewarm_checkpoints_feeds_every_save(tmp_path,
                                                      monkeypatch, tmpfs):
    from tpuflow_torch.flows import my_torch_module as m

    hits = _count_takes(monkeypatch)
    res = m.train_model(device="cpu", n_train=64, n_test=32, epochs=2,
                        global_batch_size=32,
                        checkpoint_storage_path=str(tmp_path))
    n_big = _big_shards(res.checkpoint.path)
    big = [ok for n, ok in hits if n >= 64 * 1024]
    assert n_big > 0 and len(big) == 2 * n_big and all(big[n_big:]), hits


def test_torch_eval_loads_a_finished_run_zero_copy(tmp_path, monkeypatch):
    """The triggered eval of a successful run maps its checkpoint, and its
    predictions are those of a reading predictor."""
    from tpuflow_torch.flow import Run, store
    from tpuflow_torch.flows import eval_flow, train_flow
    from tpuflow_torch.flows import my_torch_module as m

    store.set_home(str(tmp_path / "home"))
    try:
        common = ["--device", "cpu", "--home", str(tmp_path / "home")]
        train = Run(train_flow.main([
            "run", "--epochs", "1", "--batch-size", "64", "--n-train", "128",
            "--n-test", "64", *common]))
        made = []
        real = m.TorchPredictor

        def spy(*a, **kw):
            made.append(kw.get("zero_copy"))
            return real(*a, **kw)

        monkeypatch.setattr(m, "TorchPredictor", spy)
        erun = Run(eval_flow.main(["run", "--triggered", "--batch-size",
                                   "64", *common]))
        assert made == [True] and erun.successful
        ckpt = train.data.result
        rows = m.get_dataloaders(64, as_rows=True, n_train=0, n_test=64)
        model = m.build_model("mlp")
        read = real(ckpt.best_checkpoint, model=model, device="cpu")
        mapped = real(ckpt.best_checkpoint, model=m.build_model("mlp"),
                      device="cpu", zero_copy=True)
        for a, b in zip(m.map_batches(rows, read, batch_size=64),
                        m.map_batches(rows, mapped, batch_size=64)):
            np.testing.assert_array_equal(a["logits"], b["logits"])
        labels = np.array([r["labels"] for r in rows])
        pred = np.array([int(o["predicted_values"]) for o in
                         m.map_batches(rows, mapped, batch_size=64)])
        assert erun.data.n_misclassified == int((pred != labels).sum())
    finally:
        store.set_home(None)


def test_manifest_bytes_unchanged_by_the_pool(tmp_path, tmpfs):
    """The same state saved fresh, through a prewarmed pool, and after
    retention recycled a step: identical manifests and shard bytes."""
    state = _state(9)
    fresh = CheckpointManager(str(tmp_path / "fresh"), async_save=False)
    fresh.save(1, state)
    warm = CheckpointManager(str(tmp_path / "warm"), max_to_keep=1,
                             async_save=False)
    warm.prewarm(state)
    warm.prewarm_wait()
    warm.save(1, state)
    warm.save(2, _state(8))
    warm.save(3, state)
    fresh.close()
    warm.close()
    want = _files(tmp_path / "fresh" / "step_1" / "state")
    assert _files(tmp_path / "warm" / "step_3" / "state") == want
    assert json.loads(want["manifest.json"])["process_count"] == 1
