"""Sharded checkpoints of the port's FSDP state (``tpuflow-raw-v2`` written
as manifest fragments by every process and merged by process 0), held to
the JAX package's multi-process raw format (``tpuflow/ckpt/raw.py``
``_leaf_shards`` :729, ``_write_entries`` :850, ``merge_manifests`` :928)
and restored at another process count in both packages.

- A 2-process save of a state carried from a JAX checkpoint has JAX's
  manifest at fsdp 2: the same leaves, dtypes, (start, shape) sets and
  crc32s.
- Saved at K processes, restored at K' and saved again, every leaf is
  bit-equal (port 2 -> 1 and 2 -> 3, JAX fsdp 4 -> port 2), and a process
  reads only the shard files that overlap its region.
- The port's 2-process checkpoint restores into JAX at fsdp 4 and on one
  device, bit-equal.
- A merge short of fragments fails with the JAX message; the in-run
  resume at 2 processes is bit for bit; retention keeps each process's
  shard files in its own pool and every process agrees on the steps.

Workers are spawned processes that import torch and the port only; the
JAX side runs in a subprocess on as many CPU devices as it needs.
"""

import json
import os
import shutil

import numpy as np
import pytest

from torch_gang_flows import spawn_world
from torch_parity import one_torch_thread, run_jax  # noqa: F401
from tpuflow_torch.ckpt import raw

ONE_STEP = dict(preset="test", epochs=1, steps_per_epoch=1, batch_size=8,
                seq_len=32)


def _step_dir(ckpt_dir: str) -> str:
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    return os.path.join(ckpt_dir, f"step_{steps[-1]}")


def _full(step_dir: str) -> dict:
    """Every leaf of a checkpoint, assembled whole."""
    tree = raw.restore_raw(os.path.join(step_dir, "state"))
    return {"/".join(p): t.numpy() for p, t in raw.flatten(tree)}


def _assert_bit_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _layout(step_dir: str) -> dict:
    with open(os.path.join(step_dir, "state", "manifest.json")) as f:
        m = json.load(f)
    return m["process_count"], {
        "/".join(e["path"]): (e["dtype"], tuple(e["shape"]), sorted(
            (tuple(s["start"]), tuple(s["shape"]), s["crc32"])
            for s in e["shards"]))
        for e in m["leaves"]}


@pytest.fixture(scope="module")
def jax_fsdp2(tmp_path_factory):
    """A JAX checkpoint of the AdamW state born sharded at fsdp 2 (two
    devices; ``create_sharded_state``, so every leaf is laid out by
    ``make_shardings``, which a step's outputs need not keep: XLA may
    shard a small bias the rule replicates)."""
    work = tmp_path_factory.mktemp("jax2")
    d = str(work / "ckpt")
    run_jax(2, "init_save", str(work),
            cfg={**ONE_STEP, "data_axis": 1, "fsdp_axis": 2}, ckpt_dir=d)
    return _step_dir(d)


@pytest.fixture(scope="module")
def port_fsdp2(tmp_path_factory):
    """The port's checkpoint of one AdamW step at fsdp 2 (two processes,
    the port's own seed-0 init)."""
    d = str(tmp_path_factory.mktemp("port2") / "ckpt")
    spawn_world(2, "fsdp_train",
                cfg={**ONE_STEP, "data_axis": 1, "fsdp_axis": 2},
                ckpt_dir=d, dropout0=False)
    return _step_dir(d)


def test_two_process_manifest_is_jax_fsdp2(jax_fsdp2, tmp_path):
    """The JAX fsdp-2 state restored onto two port processes and saved
    again: its merged manifest lists JAX's leaves with the same dtypes,
    shapes, shard (start, shape) sets and crc32s; its process_count is 2
    (JAX's is 1: one process drove both devices) and each process kept
    its fragment."""
    dst = str(tmp_path / "resaved")
    spawn_world(2, "fsdp_resave", cfg={**ONE_STEP, "data_axis": 1,
                                       "fsdp_axis": 2},
                src=jax_fsdp2, dst=dst)
    step = os.path.join(dst, "step_1")
    count, port = _layout(step)
    jcount, ref = _layout(jax_fsdp2)
    assert (count, jcount) == (2, 1)
    assert list(port) == list(ref)  # the same leaves in the same order
    assert port == ref
    assert any(len(v[2]) > 1 for v in port.values())
    frags = sorted(n for n in os.listdir(os.path.join(step, "state"))
                   if n.startswith("manifest.p"))
    assert frags == ["manifest.p00000.json", "manifest.p00001.json"]
    with open(os.path.join(step, "metadata.json")) as f:
        assert json.load(f)["process_count"] == 2


@pytest.mark.parametrize("world,axes", [
    (1, dict(data_axis=1, fsdp_axis=1)),
    (3, dict(data_axis=1, fsdp_axis=3)),
], ids=["2to1", "2to3"])
def test_port_restores_at_another_world(world, axes, port_fsdp2, tmp_path):
    """Saved by two processes, restored by ``world`` and saved again:
    every leaf bit-equal. At three processes (where the rule shards other
    leaves) a process reads only the shard files that overlap its region:
    the first and the last read less than the whole payload (the middle
    one's regions straddle both halves of the 2-process shards)."""
    dst = str(tmp_path / "resaved")
    got = spawn_world(world, "fsdp_resave", cfg={**ONE_STEP, **axes},
                      src=port_fsdp2, dst=dst)
    _assert_bit_equal(_full(os.path.join(dst, "step_1")), _full(port_fsdp2))
    total = raw.payload_bytes(os.path.join(port_fsdp2, "state"))
    if world > 1:
        assert got[0]["read"] < total and got[-1]["read"] < total
        assert sum(r["wrote"] for r in got) == raw.payload_bytes(
            os.path.join(dst, "step_1", "state"))
    else:
        assert got[0]["read"] == total


@pytest.mark.slow
def test_jax_fsdp4_restores_into_two_port_processes(tmp_path):
    """Slow (the JAX leg compiles on four devices): a JAX checkpoint at
    fsdp 4, restored by two port processes and saved again, bit-equal."""
    d = str(tmp_path / "jax4")
    run_jax(4, "train", str(tmp_path),
            cfg={**ONE_STEP, "data_axis": 1, "fsdp_axis": 4}, ckpt_dir=d)
    dst = str(tmp_path / "resaved")
    spawn_world(2, "fsdp_resave", cfg={**ONE_STEP, "data_axis": 1,
                                       "fsdp_axis": 2},
                src=_step_dir(d), dst=dst)
    _assert_bit_equal(_full(os.path.join(dst, "step_1")),
                      _full(_step_dir(d)))


@pytest.mark.parametrize("devices", [4, 1], ids=["fsdp4", "one_device"])
def test_port_checkpoint_restores_into_jax(devices, port_fsdp2, tmp_path):
    """The port's 2-process checkpoint restored by the JAX package onto
    its sharded state at fsdp ``devices``: every leaf bit-equal."""
    out = str(tmp_path / "jax.npz")
    got = run_jax(devices, "restore", str(tmp_path),
                  cfg={**ONE_STEP, "data_axis": 1, "fsdp_axis": devices},
                  src=port_fsdp2, out_npz=out)
    if devices > 1:
        assert any("fsdp" in spec for spec in got["specs"].values())
    with np.load(out) as z:
        jax_leaves = {k: z[k] for k in z.files}
    port = _full(port_fsdp2)
    assert jax_leaves.keys() == port.keys()
    for k, v in port.items():
        np.testing.assert_array_equal(jax_leaves[k].astype(v.dtype), v,
                                      err_msg=k)
        assert jax_leaves[k].dtype == v.dtype, k


def test_merge_manifests_rejects_missing_fragments(tmp_path):
    """Twin of ``tests/test_ckpt.py::test_merge_manifests_rejects_missing_
    fragments``: merging fewer fragments than the save's process_count
    fails loudly, with the JAX package's message."""
    frag = {
        "format": raw.FORMAT_NAME,
        "process_count": 3,
        "leaves": [{"path": ["w"], "shape": [4], "dtype": "<f4",
                    "shards": []}],
    }
    for i in range(2):
        with open(tmp_path / f"manifest.p{i:05d}.json", "w") as f:
            json.dump(frag, f)
    with pytest.raises(FileNotFoundError, match="3 processes"):
        raw.merge_manifests(str(tmp_path), visibility_timeout_s=0.2)


def test_in_run_resume_is_bit_for_bit_at_two(tmp_path):
    """Two processes, two epochs of two steps with a checkpoint at each;
    the directory without its last step resumed by two processes gives
    the uninterrupted run's second-epoch losses and last step's shard
    crc32s bit for bit. Retention keeps each process's retired shard
    files in its own pool, and every process's restore read only its
    region."""
    cfg = {**ONE_STEP, "epochs": 2, "steps_per_epoch": 2, "data_axis": 1,
           "fsdp_axis": 2}
    d = str(tmp_path / "ckpt")
    first = spawn_world(2, "fsdp_train", cfg=cfg, ckpt_dir=d,
                        dropout0=False)
    _, want = _layout(os.path.join(d, "step_4"))
    shutil.rmtree(os.path.join(d, "step_4"))
    again = spawn_world(2, "fsdp_train", cfg=cfg, ckpt_dir=d,
                        dropout0=False)
    for r in again:
        assert r["step_losses"] == first[0]["step_losses"][2:]
        assert r["io"]["restores"][0]["step"] == 2
    _, got = _layout(os.path.join(d, "step_4"))
    assert got == want
    total = raw.payload_bytes(os.path.join(d, "step_2", "state"))
    assert all(r["io"]["restores"][0]["bytes"] < total for r in again)


def test_retention_recycles_into_each_process_pool(tmp_path):
    """Three epochs with ``max_to_keep=2`` on two processes: the oldest
    step goes, each process's shard files of 64 KiB or more land in its
    own ``.recycle.p<rank>`` pool, and every process saw the same
    committed steps."""
    cfg = {**ONE_STEP, "epochs": 3, "data_axis": 1, "fsdp_axis": 2}
    d = str(tmp_path / "ckpt")
    got = spawn_world(2, "fsdp_train", cfg=cfg, ckpt_dir=d, dropout0=False)
    steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert steps == ["step_2", "step_3"]
    for rank in range(2):
        pool = os.path.join(d, f".recycle.p{rank:05d}")
        assert os.listdir(pool)
    assert got[0]["io"]["saves"][-1]["step"] == got[1]["io"]["saves"][-1][
        "step"] == 3


def test_ckpt_dtype_shards_narrow_and_resume(tmp_path):
    """``ckpt_dtype="bfloat16"`` on two processes: every float shard is
    written bf16 (the leaves the rule keeps whole too), and the in-run
    resume casts the regions back up and trains on at two processes."""
    cfg = {**ONE_STEP, "epochs": 2, "data_axis": 1, "fsdp_axis": 2,
           "ckpt_dtype": "bfloat16"}
    d = str(tmp_path / "ckpt")
    first = spawn_world(2, "fsdp_train", cfg=cfg, ckpt_dir=d,
                        dropout0=False)
    with open(os.path.join(d, "step_1", "state", "manifest.json")) as f:
        dtypes = {e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes == {"bfloat16", "<i4"}
    shutil.rmtree(os.path.join(d, "step_2"))
    again = spawn_world(2, "fsdp_train", cfg=cfg, ckpt_dir=d,
                        dropout0=False)
    assert again[0]["io"]["restores"][0]["step"] == 1
    assert len(again[0]["step_losses"]) == 1
    assert np.isfinite(again[0]["step_losses"]).all()
    assert abs(again[0]["step_losses"][0] - first[0]["step_losses"][1]) \
        < 1e-2
