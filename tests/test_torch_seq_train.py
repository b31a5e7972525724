"""GPT-2 training in the port on meshes with a ``seq`` axis (gloo on the
CPU) against the JAX package's ``train_gpt`` on a mesh of the same shape.

The port's worlds are spawned processes that import torch and the port
only (``torch_gang_flows.spawn_world``); the JAX reference runs in a
subprocess on as many CPU devices (``torch_parity.run_jax``). Both start
from the same JAX init, train the ``test`` preset on the same global
batches (each step its own epoch, so every history entry is one step)
with dropout off, and save per-epoch checkpoints; the final parameters
are read back from both.

Tolerances (f32): each step's loss and validation loss within 1e-5
relative; the final parameters under ``test_torch_tp_train._compare``
(each leaf's change from the init within 1e-3 of JAX's, every element
within 4 lr, the median |diff| under 1e-6).
"""

import numpy as np
import pytest

from test_torch_tp_train import _compare, _final, _init_npz
from torch_gang_flows import spawn_world
from torch_parity import one_torch_thread, run_jax  # noqa: F401

BASE = dict(preset="test", epochs=3, steps_per_epoch=1, batch_size=8,
            seq_len=32)
LOSS_RTOL = 1e-5

CASES = {
    # id: (world, cfg extras)
    "data2xseq2-ring": (4, dict(data_axis=2, fsdp_axis=1, seq_axis=2,
                                attn_impl="ring")),
    "data2xseq2-ulysses": (4, dict(data_axis=2, fsdp_axis=1, seq_axis=2,
                                   attn_impl="ulysses")),
    "data2xseq2-xla": (4, dict(data_axis=2, fsdp_axis=1, seq_axis=2,
                               attn_impl="xla")),
    "fsdp2xseq2-ring": (4, dict(data_axis=1, fsdp_axis=2, seq_axis=2,
                                attn_impl="ring")),
    "tensor2xseq2-ring": (4, dict(data_axis=1, fsdp_axis=1, tensor_axis=2,
                                  seq_axis=2, attn_impl="ring")),
    "seq2-moe4-ring": (2, dict(data_axis=1, fsdp_axis=1, seq_axis=2,
                               experts=4, attn_impl="ring")),
    # 4 heads: 2 a tensor rank, which seq 4 does not split (all 4 do), so
    # Ulysses gathers the heads over the tensor group first.
    "tensor2xseq4-ulysses": (8, dict(data_axis=1, fsdp_axis=1,
                                     tensor_axis=2, seq_axis=4,
                                     attn_impl="ulysses")),
}


@pytest.mark.parametrize("case", [
    "data2xseq2-ring",
    # The attention paths themselves are held to JAX's in
    # test_torch_seq_attention.py at s = 2 and 4; these train through them.
    pytest.param("data2xseq2-ulysses", marks=pytest.mark.slow),
    pytest.param("data2xseq2-xla", marks=pytest.mark.slow),
    pytest.param("fsdp2xseq2-ring", marks=pytest.mark.slow),
    pytest.param("tensor2xseq2-ring", marks=pytest.mark.slow),
    pytest.param("seq2-moe4-ring", marks=pytest.mark.slow),
    pytest.param("tensor2xseq4-ulysses", marks=pytest.mark.slow),
])
def test_seq_train_gpt_matches_jax(case, tmp_path):
    """``train_gpt`` over the mesh against the JAX ``train_gpt`` on the
    same mesh: every process reports the same losses (bit for bit), each
    step's loss and validation loss agree, the final checkpoints' params
    too (tolerances in the module docstring). The MoE case holds the
    global capacity slot: a token's place in its expert's buffer counts
    the preceding ``seq`` blocks' tokens, and the load-balance loss's
    means run over the whole sequence."""
    world, extra = CASES[case]
    cfg = {**BASE, **extra}
    # The init does not depend on the attention (JAX's ring needs a mesh
    # to trace its init).
    init = _init_npz(tmp_path, **{k: v for k, v in extra.items()
                                  if k != "attn_impl"})
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    got = spawn_world(world, "fsdp_train", cfg=cfg, ckpt_dir=port_dir,
                      init_npz=init)
    ref = run_jax(world, "train", str(tmp_path), cfg=cfg, ckpt_dir=jax_dir)
    for r in got[1:]:
        assert r["step_losses"] == got[0]["step_losses"]
        assert r["val"] == got[0]["val"]
    np.testing.assert_allclose(got[0]["loss_history"], ref["loss_history"],
                               rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got[0]["val"], ref["val"], rtol=LOSS_RTOL,
                               atol=0)
    with np.load(init) as z:
        start = {k: z[k] for k in z.files}
    _compare(_final(port_dir), _final(jax_dir), start,
             cfg.get("learning_rate", 3e-4), adafactor=False)


@pytest.mark.parametrize("world,extra", [
    pytest.param(2, dict(data_axis=1, fsdp_axis=2), marks=pytest.mark.slow),
    (4, dict(data_axis=2, fsdp_axis=1, seq_axis=2, attn_impl="ring")),
], ids=["fsdp2", "data2xseq2"])
def test_dropout_masks_do_not_depend_on_the_split(world, extra):
    """With dropout on (the ``test`` preset's 0.1), a sharded run draws
    each mask over the global batch and keeps its rows and columns, as
    JAX draws dropout over the global array: its per-step losses equal
    the one-process run's within float noise (the masks the same; only
    the reductions' order differs). Before, every data shard drew one
    mask of its own shape, so the rows of different shards shared masks
    and a resume at another world drew others."""
    cfg = {**BASE, "epochs": 1, "steps_per_epoch": 3}
    one = spawn_world(1, "fsdp_train", cfg={**cfg, "data_axis": 1,
                                            "fsdp_axis": 1},
                      dropout0=False)
    got = spawn_world(world, "fsdp_train", cfg={**cfg, **extra},
                      dropout0=False)
    np.testing.assert_allclose(got[0]["step_losses"], one[0]["step_losses"],
                               rtol=LOSS_RTOL, atol=0)
