"""``train_gpt`` with checkpoints on the CPU (tpuflow_torch.train.gpt): the
per-epoch saves, the in-run resume from the newest committed step, the
resume from a handle, and ``ckpt_dtype``.

The test preset trains 2 epochs x 4 steps of 4 x 32 tokens with the flash
attention (its plain versions here) and the split backward. Resumed runs
are held to the uninterrupted run bit for bit: losses, histories and the
final step's shard crc32s. These run on one CPU thread: several threads
may split a CPU matmul's sums differently from one call to the next.
"""

import json
import os
import shutil

import pytest
import torch

from tpuflow_torch.ckpt import Checkpoint
from tpuflow_torch.ckpt import raw
from tpuflow_torch.train.gpt import GptTrainConfig, train_gpt

STEPS = 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return GptTrainConfig(**{"preset": "test", "epochs": 2,
                             "steps_per_epoch": STEPS, "batch_size": 4,
                             "seq_len": 32, "data_axis": 1, "fsdp_axis": 1,
                             "attn_impl": "flash", "learning_rate": 1e-3,
                             **kw})


def _run(cfg, ckpt_dir=None, **kw):
    logs = []
    res = train_gpt(cfg, None if ckpt_dir is None else str(ckpt_dir),
                    log=logs.append, device="cpu", flash_bwd="split", **kw)
    return res, logs


def _shards(step_dir):
    leaves = raw.read_manifest(os.path.join(step_dir, "state"))["leaves"]
    return [(e["path"], e["dtype"], s["crc32"]) for e in leaves
            for s in e["shards"]]


def test_in_run_resume_is_bit_equal_to_the_uninterrupted_run(
        tmp_path, monkeypatch):
    """Two epochs with a ckpt_dir save steps 4 and 8 (res.checkpoint is the
    newest); the same call on a copy without step_8 resumes in-run from
    step 4 at epoch 1: its 4 losses, the histories and step_8's shards
    equal the uninterrupted run's. Every prewarm is on: the storage is
    taken for tmpfs (the pool's), and the restore takes one prewarmed
    arena buffer a leaf."""
    monkeypatch.setattr(raw, "_fs_is_memory_backed", lambda path: True)
    full, _ = _run(_cfg(), tmp_path / "a")
    # Beside the steps, .recycle holds the pool train_gpt prewarmed.
    assert sorted(os.listdir(tmp_path / "a")) == [".recycle", "step_4",
                                                   "step_8"]
    assert full.checkpoint.path == str(tmp_path / "a" / "step_8")
    assert full.checkpoint.metadata["data_state"]["epoch"] == 2
    assert [s["step"] for s in full.checkpoint_io["saves"]] == [4, 8]
    shutil.copytree(tmp_path / "a", tmp_path / "b",
                    ignore=shutil.ignore_patterns("step_8", ".recycle"))
    again, logs = _run(_cfg(), tmp_path / "b")
    assert any("in-run resume from step 4 → epoch 1" in m for m in logs)
    assert again.step_losses == full.step_losses[STEPS:]
    assert again.loss_history == full.loss_history
    assert [r["val_loss"] for r in again.metrics_history] == \
        [r["val_loss"] for r in full.metrics_history]
    assert _shards(again.checkpoint.path) == _shards(full.checkpoint.path)
    assert [r["step"] for r in again.checkpoint_io["restores"]] == [4]
    assert again.checkpoint_io["restores"][0]["arena_buffers"] == len(
        _shards(again.checkpoint.path))
    # A directory whose newest step is the last trains nothing more.
    done, _ = _run(_cfg(), tmp_path / "a")
    assert done.step_losses == [] and done.loss_history == full.loss_history


def test_in_run_resume_past_a_corrupt_newest_step(tmp_path):
    """When the newest step fails its crc32, the restore falls back to the
    step before it, and the loader cursor and histories are that step's:
    the run replays the last epoch bit-equal to the uninterrupted run."""
    full, _ = _run(_cfg(), tmp_path / "a")
    shutil.copytree(tmp_path / "a", tmp_path / "b",
                    ignore=shutil.ignore_patterns(".recycle"))
    state_dir = tmp_path / "b" / "step_8" / "state"
    shard = max((state_dir / f for f in os.listdir(state_dir)
                 if f.endswith(".bin")), key=os.path.getsize)
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    again, logs = _run(_cfg(), tmp_path / "b")
    assert any("in-run resume from step 4 → epoch 1" in m for m in logs)
    assert [r["step"] for r in again.checkpoint_io["restores"]] == [4]
    assert again.step_losses == full.step_losses[STEPS:]
    assert again.loss_history == full.loss_history
    assert _shards(again.checkpoint.path) == _shards(full.checkpoint.path)


def test_resume_from_a_handle_wins_over_in_run_resume(tmp_path):
    """resume_checkpoint restores the handle's state even where the
    ckpt_dir holds a newer step of another run, and training continues
    from its step count (JAX semantics: from the first epoch)."""
    first, _ = _run(_cfg(epochs=1), tmp_path / "a")
    handle = Checkpoint.from_json(json.loads(json.dumps(
        first.checkpoint.to_json())))
    _run(_cfg(), tmp_path / "b")  # leaves step_8 of another run
    res, logs = _run(_cfg(epochs=1), tmp_path / "b",
                     resume_checkpoint=handle)
    assert any("full state restored:" in m for m in logs)
    assert not any("in-run resume" in m for m in logs)
    assert res.checkpoint.metadata["step"] == 2 * STEPS
    assert res.step_losses != first.step_losses
    # Without a ckpt_dir the handle still restores; nothing is saved.
    bare, logs = _run(_cfg(epochs=1), resume_checkpoint=handle)
    assert bare.step_losses == res.step_losses and bare.checkpoint is None


def test_ckpt_dtype_bfloat16_saves_bf16_and_resumes(tmp_path):
    """ckpt_dtype='bfloat16' writes the float leaves as bf16 (the counts
    and step stay int32) and an in-run resume restores them into the f32
    state."""
    cfg = _cfg(ckpt_dtype="bfloat16")
    full, _ = _run(cfg, tmp_path / "a")
    dtypes = {d for _, d, _ in _shards(full.checkpoint.path)}
    assert dtypes == {"bfloat16", "<i4"}
    assert full.checkpoint.metadata["save_dtype"] == "bfloat16"
    shutil.copytree(tmp_path / "a", tmp_path / "b",
                    ignore=shutil.ignore_patterns("step_8", ".recycle"))
    again, logs = _run(cfg, tmp_path / "b")
    assert any("in-run resume from step 4" in m for m in logs)
    assert len(again.step_losses) == STEPS
    # The resumed state is the bf16-rounded one: close to, not equal to,
    # the uninterrupted run.
    for a, b in zip(again.step_losses, full.step_losses[STEPS:]):
        assert abs(a - b) < 5e-2
    with pytest.raises(ValueError, match="no ckpt_dir"):
        _run(cfg)
