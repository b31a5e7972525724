"""Checkpoints in the PyTorch port (tpuflow_torch.ckpt):
twins of the JAX package's tests/test_ckpt.py cases that apply to the raw
format on one process, and the cross-framework contract.

The cross-framework cases train a test-preset GPT-2 one AdamW (or SGD)
step on each side, so the moments are non-zero, from the same weights and
batch, then:
- a checkpoint written by the JAX ``CheckpointManager`` restores into the
  port with params, moments, counts and EMA weights exactly equal, and
  the next step's loss agrees within atol 2e-5 (test_torch_train.py's
  per-step limit: f32 through a 2-layer model summed in another order);
- a checkpoint written by the port restores through the JAX
  ``tpuflow.ckpt.raw.restore_raw`` exactly;
- the same state saved by both packages gives manifests equal leaf for leaf
  (path, shape, dtype, shard file, crc32).
The leaf paths and their order are those of the manifest the JAX package
writes; the port's tree is never compared against a hand-typed list.
"""

import errno
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.ckpt import CheckpointManager as JCheckpointManager
from tpuflow.ckpt import raw as jraw
from tpuflow.train.optim import make_optimizer as j_make_optimizer
from tpuflow.train.step import TrainState as JTrainState
from tpuflow.train.step import make_train_step as j_make_train_step
from tpuflow.train.step import with_ema as j_with_ema
from tpuflow_torch.ckpt import (
    Checkpoint,
    CheckpointIOError,
    CheckpointManager,
    CorruptShardError,
    restore_from_handle,
)
from tpuflow_torch.ckpt import raw
from tpuflow_torch.ckpt.tree import (
    checkpoint_tree,
    load_checkpoint_tree,
    params_to_jax,
)
from tpuflow_torch.data.lm import make_lm_loaders
from tpuflow_torch.models.convert import params_from_jax
from tpuflow_torch.models.gpt2 import GPT2
from tpuflow_torch.train.optim import make_optimizer
from tpuflow_torch.train.step import TrainState, make_train_step, with_ema


def _tree(seed=0):
    """A small training-state-shaped tree: int32 step, f32 params and
    moments."""
    g = torch.Generator().manual_seed(seed)
    w = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return {"step": torch.tensor(seed, dtype=torch.int32),
            "params": {"dense": {"kernel": w(8, 4), "bias": w(4)}},
            "opt_state": {"0": {"count": torch.tensor(3, dtype=torch.int32),
                                "mu": {"dense": {"kernel": w(8, 4),
                                                 "bias": w(4)}}}}}


def _assert_trees_equal(a, b):
    fa, fb = raw.flatten(a), raw.flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


# ------------------------------------------------------- manager (port only)
def test_save_restore_roundtrip(tmp_path):
    state = _tree()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state, metrics={"val_loss": 0.5, "accuracy": 0.8})
    _assert_trees_equal(mgr.restore(1), state)
    assert mgr.restores[-1]["step"] == 1 and mgr.saves[-1]["bytes"] > 0
    mgr.close()


def test_best_latest_policies_and_retention(tmp_path):
    """val_loss 0.9, 0.4, 0.7, 0.6 with max_to_keep=2: latest 4, best 2,
    and step 2 survives retention beside the newest two."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_save=False)
    for step, vl in [(1, 0.9), (2, 0.4), (3, 0.7), (4, 0.6)]:
        mgr.save(step, _tree(), metrics={"val_loss": vl})
    assert mgr.latest_step() == 4
    assert mgr.best_step() == 2
    assert mgr.all_steps() == [2, 3, 4]
    meta = mgr.restore_metadata(best=True)
    assert meta["metrics"]["val_loss"] == 0.4
    assert [m["val_loss"] for m in meta["metrics_history"]] == [0.9, 0.4]
    mgr.close()


def test_history_rebuilt_on_reopen(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree(), metrics={"val_loss": 0.9})
    mgr.save(2, _tree(), metrics={"val_loss": 0.2})
    mgr.close()
    mgr2 = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr2.latest_step() == 2 and mgr2.best_step() == 2
    assert [m["step"] for m in mgr2._metrics_history] == [1, 2]
    mgr2.save(3, _tree(), metrics={"val_loss": 0.5})
    assert mgr2.best_step() == 2
    assert [m["val_loss"] for m in
            mgr2.restore_metadata(3)["metrics_history"]] == [0.9, 0.2, 0.5]
    mgr2.close()


def test_weights_only_restore_through_handle(tmp_path):
    """A handle that crossed JSON restores the params subtree only."""
    state = _tree(seed=1)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    ckpt = mgr.save(1, state, metrics={"val_loss": 0.1})
    mgr.close()
    handle = Checkpoint.from_json(json.loads(json.dumps(ckpt.to_json())))
    _assert_trees_equal(restore_from_handle(handle, weights_only=True),
                        state["params"])
    _assert_trees_equal(mgr.restore(1, weights_only=True), state["params"])


def test_async_save_completes(tmp_path):
    """The host copy is taken in save(): changing the tensors afterwards
    does not reach the checkpoint."""
    state = _tree()
    want = {"params": {"dense": {k: v.clone() for k, v in
                                 state["params"]["dense"].items()}}}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, state, metrics={"val_loss": 1.0})
    state["params"]["dense"]["kernel"].add_(1.0)
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1]
    _assert_trees_equal(mgr.restore(1, weights_only=True), want["params"])
    mgr.close()


def test_missing_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    with pytest.raises(FileNotFoundError):
        mgr.checkpoint(best=True)
    mgr.close()
    with pytest.raises(FileNotFoundError):
        Checkpoint.from_directory(str(tmp_path / "nope"))


def test_handle_json_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    ckpt = mgr.save(7, _tree(), metrics={"val_loss": 0.7})
    mgr.close()
    obj = ckpt.to_json()
    assert isinstance(obj["path"], str) and obj["metadata"]["step"] == 7
    again = Checkpoint.from_json(obj)
    with again.as_directory() as d:
        assert os.path.isdir(os.path.join(d, "state"))
    assert Checkpoint.from_directory(obj["path"]).metadata["step"] == 7


def test_orphan_staging_swept_on_next_manager(tmp_path):
    """A killed writer's ``step_K.tmp`` and a step directory without
    metadata.json are invisible and deleted by the next manager."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree(), metrics={"val_loss": 1.0})
    mgr.close()
    os.makedirs(tmp_path / "step_2.tmp" / "state")
    os.makedirs(tmp_path / "step_3" / "state")
    mgr2 = CheckpointManager(str(tmp_path), async_save=False)
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    assert mgr2.all_steps() == [1]
    mgr2.close()


def test_bfloat16_leaf_dtype_roundtrips(tmp_path):
    """bf16 is spelled "bfloat16" in the manifest (as ml_dtypes names it)
    and restores as bf16 with identical bytes."""
    state = {"w": (torch.arange(64, dtype=torch.bfloat16) / 7.0).reshape(8, 8)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state, metrics={"val_loss": 1.0})
    got = mgr.restore(1)["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, state["w"])
    manifest = raw.read_manifest(str(tmp_path / "step_1" / "state"))
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    mgr.close()


def test_save_dtype_halves_bytes_and_restores_to_template(tmp_path):
    """save_dtype='bfloat16': f32 leaves are written half-size, integer
    leaves stay exact, and an f32 template restores the bf16-rounded
    values in f32."""
    w = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    state = {"w": w, "step": torch.tensor(7, dtype=torch.int32)}
    full = CheckpointManager(str(tmp_path / "full"), async_save=False)
    full.save(1, state)
    half = CheckpointManager(str(tmp_path / "half"), async_save=False,
                             save_dtype="bfloat16")
    half.save(1, state)

    def payload(root):
        return sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(root) for f in fs
                   if f.endswith(".bin"))

    assert payload(tmp_path / "half") < 0.6 * payload(tmp_path / "full")
    abstract = {"w": torch.empty(64, 64, device="meta"),
                "step": torch.empty((), dtype=torch.int32, device="meta")}
    restored = half.restore(1, abstract_state=abstract)
    assert restored["w"].dtype == torch.float32
    assert int(restored["step"]) == 7
    assert torch.equal(restored["w"], w.bfloat16().float())
    assert half.restore_metadata(1)["save_dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="save_dtype"):
        CheckpointManager(str(tmp_path / "bad"), save_dtype="int8")
    full.close()
    half.close()


def test_data_state_persists_in_metadata(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    cursor = {"epoch": 1, "batch_index": 3, "seed": 0}
    mgr.save(4, _tree(), metrics={"val_loss": 1.0}, data_state=cursor)
    mgr.close()
    again = CheckpointManager(str(tmp_path))
    assert again.restore_metadata(4)["data_state"] == cursor
    assert again.checkpoint().metadata["data_state"] == cursor


def _flip_byte(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(os.path.getsize(path) // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def test_flipped_byte_raises_and_restore_falls_back(tmp_path, capsys):
    """A flipped byte in a shard: verify_step and a direct raw restore
    report it as CorruptShardError; restore() of that step falls back to
    the previous committed step; with no step before it, it raises."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=None,
                            async_save=False)
    a, b = _tree(seed=1), _tree(seed=2)
    mgr.save(1, a, metrics={"val_loss": 1.0})
    mgr.save(2, b, metrics={"val_loss": 0.5})
    state_dir = tmp_path / "step_2" / "state"
    leaf = raw.read_manifest(str(state_dir))["leaves"][1]["shards"][0]["file"]
    _flip_byte(str(state_dir / leaf))
    assert mgr.verify_step(2) is False and mgr.verify_step(1) is True
    with pytest.raises(CorruptShardError, match="crc32"):
        raw.restore_raw(str(state_dir))
    _assert_trees_equal(mgr.restore(2), a)
    assert "falling back to step 1" in capsys.readouterr().out
    _flip_byte(str(tmp_path / "step_1" / "state" / leaf))
    with pytest.raises(CorruptShardError):
        mgr.restore(2)
    # A truncated shard is corruption too, not an IO error.
    os.truncate(state_dir / leaf, 3)
    with pytest.raises(CorruptShardError, match="truncated"):
        raw.restore_raw(str(state_dir))
    mgr.close()


# --------------------------------------------------------------- retry_io
def test_retry_io_transient_backoff_then_success():
    """Transient OSErrors are retried with growing jittered backoff; the
    wrapped operation's result comes through."""
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) <= 2:
            raise OSError(errno.EIO, "blip")
        return 42

    assert raw.retry_io(flaky, op="t", path="/x/y.bin",
                        sleep=sleeps.append) == 42
    assert len(calls) == 3 and len(sleeps) == 2
    # Exponential envelope with 50-100% jitter on a 0.05 base.
    assert 0.025 <= sleeps[0] <= 0.05 and 0.05 <= sleeps[1] <= 0.1


def test_retry_io_permanent_and_structural_errors():
    """A permanent errno raises CheckpointIOError on the first attempt;
    structural absence (ENOENT) and corruption re-raise unchanged."""
    sleeps = []

    def denied():
        raise OSError(errno.EACCES, "nope")

    with pytest.raises(CheckpointIOError, match="permanent"):
        raw.retry_io(denied, op="t", sleep=sleeps.append)

    def missing():
        raise FileNotFoundError(errno.ENOENT, "gone")

    with pytest.raises(FileNotFoundError) as ei:
        raw.retry_io(missing, op="t", sleep=sleeps.append)
    assert not isinstance(ei.value, CheckpointIOError)

    def corrupt():
        raise CorruptShardError("bad bytes")

    with pytest.raises(CorruptShardError):
        raw.retry_io(corrupt, op="t", sleep=sleeps.append)
    assert not sleeps  # nothing of these is retried


def test_retry_io_exhaustion_raises():
    calls = []

    def always():
        calls.append(1)
        raise OSError(errno.EIO, "down")

    with pytest.raises(CheckpointIOError, match="3 attempts"):
        raw.retry_io(always, op="t", retries=2, sleep=lambda s: None)
    assert len(calls) == 3


def test_save_exhausting_retries_fails_the_step_cleanly(tmp_path,
                                                       monkeypatch):
    """A save whose shard writes keep failing fails that step's save only:
    staging removed, history entry dropped, and the next save commits."""
    real = raw.write_file
    monkeypatch.setattr(raw, "write_file", lambda *a, **kw: (_ for _ in
                        ()).throw(OSError(errno.EIO, "down")))
    mgr = CheckpointManager(str(tmp_path), async_save=False, io_retries=1,
                            io_backoff_s=0.0)
    mgr.save(1, _tree(), metrics={"val_loss": 1.0})
    assert mgr.all_steps() == [] and mgr._metrics_history == []
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    monkeypatch.setattr(raw, "write_file", real)
    mgr.save(2, _tree(seed=2), metrics={"val_loss": 0.5})
    assert mgr.all_steps() == [2]
    _assert_trees_equal(mgr.restore(2), _tree(seed=2))
    mgr.close()


# --------------------------------------------------------------- file IO
def test_file_io_roundtrip_and_short_read(tmp_path):
    """write_file and read_file round-trip bytes (an empty buffer too); a
    short file reads as EIO (transient, so retried), a missing one as
    ENOENT (structural, so not)."""
    buf = np.random.default_rng(0).integers(0, 256, 100_003, dtype=np.uint8)
    path = str(tmp_path / "x.bin")
    raw.write_file(path, buf)
    assert os.path.getsize(path) == buf.nbytes
    np.testing.assert_array_equal(raw.read_file(path, buf.nbytes), buf)
    np.testing.assert_array_equal(raw.read_file(path, 10), buf[:10])
    raw.write_file(path, buf[:0])
    assert raw.read_file(path, 0).nbytes == 0
    with pytest.raises(OSError) as ei:
        raw.read_file(path, 11)
    assert ei.value.errno == errno.EIO and raw.io_transient(ei.value)
    with pytest.raises(OSError) as ei:
        raw.read_file(str(tmp_path / "missing.bin"), 4)
    assert ei.value.errno == errno.ENOENT


def test_shard_read_retries_a_transient_error(tmp_path, monkeypatch):
    """A shard read that fails once with a transient errno is retried and
    the restore completes with the saved values."""
    raw.save_raw(str(tmp_path), _tree(seed=3))
    real, calls = raw.read_file, []

    def flaky(path, nbytes, **kw):
        calls.append(path)
        if len(calls) == 1:
            raise OSError(errno.EIO, "hiccup", path)
        return real(path, nbytes, **kw)

    monkeypatch.setattr(raw, "read_file", flaky)
    _assert_trees_equal(raw.restore_raw(
        str(tmp_path), policy=raw.RetryPolicy(retries=2, backoff_s=0.0)),
        _tree(seed=3))
    # The failed shard was read again (the shards are read on a thread
    # pool, so other shards' reads may come between the two).
    assert calls.count(calls[0]) == 2


# --------------------------------------------------------- cross-framework
# name -> (JAX and port optimizer arguments, EMA decay).
OPTIMIZERS = {
    "adamw": (dict(optimizer="adamw"), None),
    "adamw_clip_cosine_ema": (dict(optimizer="adamw", grad_clip_norm=1.0,
                                   warmup_steps=2, decay_steps=8,
                                   schedule="cosine"), 0.9),
    "sgd_warmup": (dict(optimizer="sgd", warmup_steps=2, decay_steps=8,
                        schedule="linear"), None),
}
LR = 1e-3


def _batches(n):
    loader, _ = make_lm_loaders(4, n, 32, 512)
    return list(loader)


def _jax_and_port_states(scan_layers: bool, opt: str, port_seed: int = 0):
    """The JAX state after one step and its jitted step, and a fresh port
    state (its own random weights when ``port_seed`` is not 0) of the same
    model with its step."""
    kw, ema = OPTIMIZERS[opt]
    jm, params, tm = jax_and_port_gpt2(attn_impl="xla",
                                       scan_layers=scan_layers)
    if port_seed:
        tm = GPT2(tm.config, seed=port_seed, device="cpu")
    jstate = JTrainState.create(apply_fn=jm.apply, params=params,
                                tx=j_make_optimizer(LR, **kw))
    if ema:
        jstate = j_with_ema(jstate)
    b = _batches(1)[0]
    jstep = j_make_train_step(donate=False, ema_decay=ema)
    jstate, _ = jstep(jstate, {k: jnp.asarray(b[k]) for k in "xy"},
                      jax.random.PRNGKey(1))
    tstate = TrainState(model=tm, tx=make_optimizer(tm.parameters(), LR,
                                                    **kw))
    if ema:
        tstate = with_ema(tstate)
    return jstate, jstep, tstate, make_train_step(ema_decay=ema), ema


def _jax_payload(jstate, ema):
    payload = {"step": jstate.step, "params": jstate.params,
               "opt_state": jstate.opt_state}
    if ema:
        payload["ema_params"] = jstate.ema_params
    return payload


def _save_jax(directory, jstate, ema):
    mgr = JCheckpointManager(str(directory), async_save=False)
    mgr.save(int(jstate.step), _jax_payload(jstate, ema),
             metrics={"val_loss": 1.0})
    mgr.close()


def _sd(state, tensors):
    names = [n for n, _ in state.model.named_parameters()]
    return dict(zip(names, tensors))


def _leaves(tree) -> list:
    """A restored JAX tree (nested dicts of arrays) as (path, f32 numpy)
    in flatten order."""
    return [(p, np.asarray(x)) for p, x in raw.flatten(tree)]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("scan_layers", [False, True])
def test_jax_checkpoint_restores_into_the_port(tmp_path, scan_layers, opt):
    """A checkpoint of the JAX state written by tpuflow.ckpt restores into
    a port state of other weights: params, moments, counts, EMA and step
    exactly equal; the next step's loss within atol 2e-5."""
    jstate, jstep, tstate, tstep, ema = _jax_and_port_states(
        scan_layers, opt, port_seed=7)
    _save_jax(tmp_path, jstate, ema)
    mgr = CheckpointManager(str(tmp_path))
    tmpl = checkpoint_tree(tstate, scan_layers=scan_layers, abstract=True)
    load_checkpoint_tree(tstate, mgr.restore(1, abstract_state=tmpl))
    mgr.close()
    assert tstate.step == 1 and tstate.tx.count == 1
    host = jax.device_get(jstate)
    want = params_from_jax(host.params)
    for name, p in _sd(tstate, tstate.params).items():
        assert torch.equal(p, want[name]), name
    inner = host.opt_state[1] if OPTIMIZERS[opt][0].get("grad_clip_norm") \
        else host.opt_state
    for slot, got in tstate.tx.slots().items():
        want = params_from_jax(getattr(inner[0], slot))
        for name, t in _sd(tstate, got).items():
            assert torch.equal(t, want[name]), (slot, name)
    if ema:
        want = params_from_jax(host.ema_params)
        for name, t in _sd(tstate, tstate.ema_params).items():
            assert torch.equal(t, want[name]), ("ema", name)
    b = _batches(2)[1]
    _, jm_ = jstep(jstate, {k: jnp.asarray(b[k]) for k in "xy"},
                   jax.random.PRNGKey(1))
    _, tm_ = tstep(tstate, b, 1)
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("scan_layers", [False, True])
def test_same_state_gives_the_same_manifest(tmp_path, scan_layers, opt):
    """The JAX state saved by tpuflow.ckpt and, restored into the port,
    saved again by tpuflow_torch.ckpt: the manifests agree leaf for leaf
    (path, shape, dtype, shard file and crc32); the JAX restore_raw reads
    the port's checkpoint into the JAX state's structure exactly."""
    jstate, _, tstate, _, ema = _jax_and_port_states(scan_layers, opt,
                                                     port_seed=7)
    _save_jax(tmp_path / "jax", jstate, ema)
    tmpl = checkpoint_tree(tstate, scan_layers=scan_layers, abstract=True)
    load_checkpoint_tree(tstate, CheckpointManager(
        str(tmp_path / "jax")).restore(1, abstract_state=tmpl))
    mgr = CheckpointManager(str(tmp_path / "port"), async_save=False)
    mgr.save(tstate.step, checkpoint_tree(tstate, scan_layers=scan_layers),
             metrics={"val_loss": 1.0})
    mgr.close()
    jm, tm = (raw.read_manifest(str(tmp_path / d / "step_1" / "state"))
              for d in ("jax", "port"))
    assert tm["format"] == jm["format"] and tm["process_count"] == 1
    assert len(tm["leaves"]) == len(jm["leaves"])
    for a, b in zip(tm["leaves"], jm["leaves"]):
        assert a == b, a["path"]
    # The JAX package reads the port's checkpoint into its own structure.
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.asarray(x).dtype),
        _jax_payload(jstate, ema))
    back = jraw.restore_raw(str(tmp_path / "port" / "step_1" / "state"),
                            abstract)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_jax_payload(jstate, ema))):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_port_checkpoint_restores_through_jax_restore_raw(tmp_path,
                                                          scan_layers):
    """The port trains one AdamW step on its own and saves; the JAX
    restore_raw (no template) returns every leaf of the port's checkpoint
    tree exactly, and its params are the port's weights."""
    _, _, tstate, tstep, _ = _jax_and_port_states(scan_layers, "adamw")
    tstep(tstate, _batches(1)[0], 1)
    tree = checkpoint_tree(tstate, scan_layers=scan_layers)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tstate.step, tree, metrics={"val_loss": 1.0})
    mgr.close()
    back = jraw.restore_raw(str(tmp_path / "step_1" / "state"))
    got, want = _leaves(back), raw.flatten(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        np.testing.assert_array_equal(x, y.detach().numpy(), err_msg=path)
    assert ("h" in back["params"]) == scan_layers
    sd = params_from_jax(back["params"])
    for name, p in _sd(tstate, tstate.params).items():
        assert torch.equal(sd[name], p), name
    assert params_to_jax(sd, scan_layers=scan_layers).keys() == \
        back["params"].keys()


def test_sharded_jax_leaf_restores_whole(tmp_path, mesh8):
    """A leaf the JAX package saved as 8 shards (an array sharded over an
    8-device mesh) restores into the port as one whole tensor."""
    from tpuflow import dist

    big = np.arange(64 * 16, dtype=np.float32).reshape(64, 16)
    mgr = JCheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": jax.device_put(big, dist.batch_sharding(mesh8))},
             metrics={"val_loss": 0.3})
    mgr.close()
    entry = raw.read_manifest(str(tmp_path / "step_1" / "state"))["leaves"][0]
    assert len(entry["shards"]) == 8
    got = CheckpointManager(str(tmp_path)).restore(1)["w"]
    assert torch.equal(got, torch.from_numpy(big))
