"""Sharded checkpoints of the port on meshes with a ``tensor`` or
``expert`` axis (regions split on two axes at once, written as manifest
fragments), held to the JAX package's raw format on the same mesh and
restored at other meshes in both packages; and the ``dcp`` format
(``torch.distributed.checkpoint``, the counterpart of JAX's Orbax choice).

- A JAX state born sharded at fsdp 2 x tensor 2 (``create_sharded_state``
  with ``gpt2_tensor_rules``), restored by four port processes on the
  same mesh and saved again: the merged manifest lists the same leaves,
  dtypes, (start, shape) sets and crc32s.
- The port's one-step checkpoint at fsdp 2 x tensor 2 restores bit-equal
  (every leaf, saved again) at fsdp 2, at one process and into JAX at
  fsdp 4; JAX's at fsdp 2 x tensor 2 restores bit-equal into the port at
  fsdp 2. An Adafactor state of the MoE model at fsdp 2 x expert 2 (its
  statistics placed by the rule on their own shapes) restores bit-equal
  at one process.
- An in-run resume at fsdp 2 x tensor 2 gives the uninterrupted run's
  losses and last step's shards bit for bit.
- A DCP save of the fsdp 2 x tensor 2 step restores at fsdp 2 and at one
  process with every leaf bit-equal to the raw restore of the same step.

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
F2T2 = dict(data_axis=1, fsdp_axis=2, tensor_axis=2)
F2 = dict(data_axis=1, fsdp_axis=2)
ONE = dict(data_axis=1, fsdp_axis=1)


def _step_dir(ckpt_dir: str) -> str:
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    return os.path.join(ckpt_dir, f"step_{steps[-1]}")


def _full(step_dir: str) -> dict:
    """Every leaf of a raw checkpoint, assembled whole."""
    tree = raw.restore_raw(os.path.join(step_dir, "state"))
    return {"/".join(p): t.numpy() for p, t in raw.flatten(tree)}


def _assert_bit_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _layout(step_dir: str):
    with open(os.path.join(step_dir, "state", "manifest.json")) as f:
        m = json.load(f)
    return m["process_count"], {
        "/".join(e["path"]): (e["dtype"], tuple(e["shape"]), sorted(
            (tuple(s["start"]), tuple(s["shape"]), s["crc32"])
            for s in e["shards"]))
        for e in m["leaves"]}


def _two_axis_leaves(layout: dict) -> list:
    """The leaves whose shards split two dims at once."""
    out = []
    for k, (_, shape, shards) in layout.items():
        split = {d for start, sh, _ in shards for d in range(len(shape))
                 if sh[d] != shape[d]}
        if len(split) >= 2:
            out.append(k)
    return out


@pytest.fixture(scope="module")
def port_f2t2(tmp_path_factory):
    """The port's checkpoint of one AdamW step at fsdp 2 x tensor 2 (four
    processes, the port's own seed-0 init)."""
    d = str(tmp_path_factory.mktemp("portf2t2") / "ckpt")
    spawn_world(4, "fsdp_train", cfg={**ONE_STEP, **F2T2}, ckpt_dir=d,
                dropout0=False)
    return _step_dir(d)


@pytest.fixture(scope="module")
def jax_f2t2(tmp_path_factory):
    """A JAX checkpoint of the AdamW state born sharded at fsdp 2 x
    tensor 2 (four devices)."""
    work = tmp_path_factory.mktemp("jaxf2t2")
    d = str(work / "ckpt")
    run_jax(4, "init_save", str(work), cfg={**ONE_STEP, **F2T2},
            ckpt_dir=d)
    return _step_dir(d)


def test_manifest_is_jax_at_fsdp2_tensor2(jax_f2t2, tmp_path):
    """JAX's fsdp 2 x tensor 2 state restored onto four port processes of
    the same mesh and saved again: its merged manifest lists JAX's
    leaves, dtypes, shard (start, shape) sets and crc32s, some leaves
    split on two dims at once."""
    dst = str(tmp_path / "resaved")
    spawn_world(4, "fsdp_resave", cfg={**ONE_STEP, **F2T2}, src=jax_f2t2,
                dst=dst)
    count, port = _layout(os.path.join(dst, "step_1"))
    _, ref = _layout(jax_f2t2)
    assert count == 4
    assert port == ref
    assert _two_axis_leaves(port)


@pytest.mark.parametrize("world,axes", [(2, F2), (1, ONE)],
                         ids=["to-fsdp2", "to-one"])
def test_port_f2t2_restores_at_another_mesh(world, axes, port_f2t2,
                                            tmp_path):
    """Saved at fsdp 2 x tensor 2, restored at ``world`` processes and
    saved again: every leaf bit-equal."""
    dst = str(tmp_path / "resaved")
    spawn_world(world, "fsdp_resave", cfg={**ONE_STEP, **axes},
                src=port_f2t2, dst=dst)
    _assert_bit_equal(_full(os.path.join(dst, "step_1")), _full(port_f2t2))


def test_port_f2t2_restores_into_jax_fsdp4(port_f2t2, tmp_path):
    """The port's fsdp 2 x tensor 2 checkpoint restores into JAX's sharded
    state at fsdp 4, every leaf bit-equal."""
    npz = str(tmp_path / "leaves.npz")
    run_jax(4, "restore", str(tmp_path),
            cfg={**ONE_STEP, "data_axis": 1, "fsdp_axis": 4},
            src=port_f2t2, out_npz=npz)
    with np.load(npz) as z:
        got = {k: z[k] for k in z.files}
    _assert_bit_equal(got, _full(port_f2t2))


def test_jax_f2t2_restores_into_port_fsdp2(jax_f2t2, tmp_path):
    """JAX's fsdp 2 x tensor 2 checkpoint restored by two port processes at
    fsdp 2 and saved again: every leaf bit-equal."""
    dst = str(tmp_path / "resaved")
    spawn_world(2, "fsdp_resave", cfg={**ONE_STEP, **F2}, src=jax_f2t2,
                dst=dst)
    _assert_bit_equal(_full(os.path.join(dst, "step_1")), _full(jax_f2t2))


def test_adafactor_moe_f2e2_restores_at_one_process(tmp_path):
    """An Adafactor step of the MoE model at fsdp 2 x expert 2, its
    ``v_row``/``v_col`` placed by the rule on their own shapes, restored at
    one process and saved again: every leaf bit-equal."""
    cfg = {**ONE_STEP, "experts": 4, "optimizer_name": "adafactor"}
    d = str(tmp_path / "ckpt")
    spawn_world(4, "fsdp_train", cfg={**cfg, "data_axis": 1, "fsdp_axis": 2,
                                      "expert_axis": 2}, ckpt_dir=d)
    src = _step_dir(d)
    dst = str(tmp_path / "resaved")
    spawn_world(1, "fsdp_resave", cfg={**cfg, **ONE}, src=src, dst=dst)
    _assert_bit_equal(_full(os.path.join(dst, "step_1")), _full(src))


def test_in_run_resume_at_f2t2_is_bit_for_bit(tmp_path):
    """Two epochs of two steps at fsdp 2 x tensor 2 with a checkpoint each
    epoch; the directory without its last step resumed at the same mesh
    replays epoch 2 with the same losses and writes the same last step
    (every shard's crc32)."""
    cfg = {**ONE_STEP, "epochs": 2, "steps_per_epoch": 2, **F2T2}
    d = str(tmp_path / "ckpt")
    full = spawn_world(4, "fsdp_train", cfg=cfg, ckpt_dir=d)
    resume = str(tmp_path / "resume")
    shutil.copytree(d, resume, ignore=shutil.ignore_patterns(
        ".recycle*", "step_4"))
    got = spawn_world(4, "fsdp_train", cfg=cfg, ckpt_dir=resume)
    for r, f in zip(got, full):
        assert r["step_losses"] == f["step_losses"][2:]
    assert _layout(os.path.join(resume, "step_4")) == _layout(
        os.path.join(d, "step_4"))


@pytest.mark.parametrize("world,axes", [(2, F2), (1, ONE)],
                         ids=["to-fsdp2", "to-one"])
def test_dcp_step_restores_bit_equal_to_raw(world, axes, port_f2t2,
                                            tmp_path):
    """The fsdp 2 x tensor 2 step saved again as DCP by its own mesh, then
    restored at ``world`` processes and saved raw: every leaf bit-equal
    to the raw step's."""
    dcp_dir = str(tmp_path / "dcp")
    spawn_world(4, "fsdp_resave", cfg={**ONE_STEP, **F2T2}, src=port_f2t2,
                dst=dcp_dir, fmt="dcp")
    step = os.path.join(dcp_dir, "step_1")
    assert os.path.exists(os.path.join(step, "state", ".metadata"))
    assert not os.path.exists(os.path.join(step, "state", "manifest.json"))
    with open(os.path.join(step, "metadata.json")) as f:
        assert json.load(f)["process_count"] == 4
    dst = str(tmp_path / "raw")
    spawn_world(world, "fsdp_resave", cfg={**ONE_STEP, **axes}, src=step,
                dst=dst)
    _assert_bit_equal(_full(os.path.join(dst, "step_1")), _full(port_f2t2))


def test_dcp_verify_step_reads_the_metadata_and_files(tmp_path):
    """``verify_step`` of a DCP step is True for a whole save and False
    once a data file is truncated or gone, or the metadata is garbage."""
    import torch

    from tpuflow_torch.ckpt import CheckpointManager

    tree = {"params": {"w": torch.arange(4096.0).reshape(64, 64),
                       "b": torch.ones(64)}}

    def saved(name):
        mgr = CheckpointManager(str(tmp_path / name), format="dcp")
        mgr.save(1, tree)
        mgr.wait_until_finished()
        state = os.path.join(str(tmp_path / name), "step_1", "state")
        return mgr, state, [os.path.join(state, f)
                            for f in os.listdir(state) if f.endswith(".distcp")]

    mgr, state, files = saved("whole")
    assert files and mgr.verify_step(1)
    mgr, state, files = saved("truncated")
    with open(files[0], "r+b") as fh:
        fh.truncate(os.path.getsize(files[0]) - 1)
    assert not mgr.verify_step(1)
    mgr, state, files = saved("missing")
    os.remove(files[0])
    assert not mgr.verify_step(1)
    mgr, state, files = saved("garbage")
    with open(os.path.join(state, ".metadata"), "wb") as fh:
        fh.write(b"not a pickle")
    assert not mgr.verify_step(1)
