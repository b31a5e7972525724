"""GPT-2 training in the port on meshes with ``tensor`` and ``expert``
axes, and Adafactor and Switch-MoE under FSDP (gloo on the CPU), against
the JAX package's ``train_gpt`` on a mesh of the same shape.

The port's worlds are spawned processes that import torch and the port
only (``torch_gang_flows.spawn_world``); the JAX reference runs in a
subprocess on as many CPU devices (``torch_parity.run_jax``). Both start
from the same JAX init, train the ``test`` preset on the same global
batches with dropout off and save per-epoch checkpoints; the final
parameters are read back from both checkpoints.

Tolerances (f32; the sides reduce in other orders: GSPMD sums the
whole batch and the tensor-split products its own way):
- the per-epoch losses and validation losses of 2 x 2 steps within
  atol 2e-5;
- each leaf's change from the shared init (final params, and the EMA
  weights) against JAX's: ||d_port - d_jax|| / ||d_jax|| within
  DELTA_RTOL, 1e-3 after AdamW and 5e-2 after Adafactor. The readings
  they were set from (the four cases below): AdamW at most 8.6e-5 on the
  params (wte at data 2 x tensor 2) and 3.3e-4 on the EMA weights (the
  LayerNorm scales: a delta of ~2e-3 on values near 1 keeps few bits);
  Adafactor at most 1.06e-2, on the q and v thirds of the ``c_attn``
  biases (their updates, ~1e-6 an element, are RMS-clipped over the
  whole leaf with the key third's float noise), 1.4e-5 on every other
  leaf. A leaf left un-updated on some rows (a gradient not summed over
  its tensor or expert group, say) reads ~0.7, a leaf not updated 1.
  The key third of each ``c_attn`` bias is left out of that ratio: its
  gradient is float noise around an exact 0 (a key bias adds the same
  q.b to every score of a row), so it moves by noise on either side
  (the ratio reads 1.2-1.4); it is held, like every element, by the
  bound below;
- every element within atol 4 lr (plus 1e-5 relative after Adafactor),
  with the median |diff| under 1e-6;
- the MoE load-balance loss of one forward at fsdp 2 against JAX's on
  the global batch within atol 1e-7, while each rank's own aux averaged
  differs from it by more than 1e-5 (so the test tells the two apart).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_gang_flows import spawn_world
from torch_parity import one_torch_thread, run_jax  # noqa: F401
from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow.train import gpt as jgpt
from tpuflow_torch.ckpt import raw

BASE = dict(preset="test", epochs=2, steps_per_epoch=2, batch_size=8,
            seq_len=32)
LOSS_ATOL = 2e-5
DELTA_RTOL = {"adamw": 1e-3, "adafactor": 5e-2}


def _init_npz(tmp_path, **extra) -> str:
    """The JAX init (PRNGKey(0), as the JAX ``train_gpt`` draws it) of
    ``BASE`` with ``extra``, flattened into an npz for the workers."""
    cfg = jgpt.GptTrainConfig(**{**BASE, **extra}).model_config()
    params = jax.jit(JGPT2(cfg).init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 8), jnp.int32))["params"]
    flat = {"/".join(str(e.key) for e in path): np.asarray(leaf)
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]}
    path = str(tmp_path / "init.npz")
    np.savez(path, **flat)
    return path


def _final(ckpt_dir: str, what: str = "params") -> dict:
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    tree = raw.restore_raw(
        os.path.join(ckpt_dir, f"step_{steps[-1]}", "state"))
    return {"/".join(p): t.numpy() for p, t in raw.flatten(tree[what])}


def _delta_rel(port: np.ndarray, ref: np.ndarray, init: np.ndarray,
               key: str) -> float:
    """||d_port - d_jax|| / ||d_jax|| of a leaf's change from ``init``,
    a ``c_attn`` bias without its key third (see the module docstring)."""
    dp, dj = port - init, ref - init
    if key.endswith("c_attn/bias"):
        C = dj.shape[0] // 3
        dp, dj = np.delete(dp, np.s_[C:2 * C]), np.delete(dj, np.s_[C:2 * C])
    return float(np.linalg.norm(dp - dj) / np.linalg.norm(dj))


def _compare(port: dict, ref: dict, init: dict, lr: float,
             adafactor: bool) -> None:
    assert port.keys() == ref.keys() == init.keys()
    rtol = 1e-5 if adafactor else 0.0
    limit = DELTA_RTOL["adafactor" if adafactor else "adamw"]
    diffs, far = [], {}
    for k in ref:
        d = np.abs(port[k] - ref[k])
        assert (d <= 4 * lr + rtol * np.abs(ref[k])).all(), (k, d.max())
        diffs.append(d.ravel())
        rel = _delta_rel(port[k], ref[k], init[k], k)
        if not rel <= limit:
            far[k] = rel
    assert not far, f"leaves whose change is off JAX's (limit {limit}): {far}"
    assert np.median(np.concatenate(diffs)) < 1e-6


CASES = {
    # id: (world, cfg extras, compare the EMA weights)
    "fsdp2xtensor2-adamw-clip-ema": (
        4, dict(data_axis=1, fsdp_axis=2, tensor_axis=2, grad_clip=0.5,
                ema_decay=0.9), True),
    "fsdp2xexpert2-moe-adafactor": (
        4, dict(data_axis=1, fsdp_axis=2, expert_axis=2, experts=4,
                optimizer_name="adafactor"), False),
    "data2xfsdp2-adafactor": (
        4, dict(data_axis=2, fsdp_axis=2, optimizer_name="adafactor"),
        False),
    "data2xtensor2-moe-adamw": (
        4, dict(data_axis=2, fsdp_axis=1, tensor_axis=2, experts=4), False),
}


@pytest.mark.parametrize("case", [
    "fsdp2xtensor2-adamw-clip-ema",
    "fsdp2xexpert2-moe-adafactor",
    pytest.param("data2xfsdp2-adafactor", marks=pytest.mark.slow),
    pytest.param("data2xtensor2-moe-adamw", marks=pytest.mark.slow),
])
def test_tp_train_gpt_matches_jax(case, tmp_path):
    """``train_gpt`` over the mesh against the JAX ``train_gpt`` on the
    same mesh: every process reports the same losses (bit for bit), the
    state was sharded by the rule, the per-epoch losses, validation
    losses and final checkpoints' params (and EMA weights) agree, each
    leaf's change from the init too (tolerances in the module
    docstring)."""
    world, extra, ema = CASES[case]
    cfg = {**BASE, **extra}
    init = _init_npz(tmp_path, **extra)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    got = spawn_world(world, "fsdp_train", cfg=cfg, ckpt_dir=port_dir,
                      init_npz=init)
    ref = run_jax(world, "train", str(tmp_path), cfg=cfg, ckpt_dir=jax_dir)
    for r in got[1:]:
        assert r["step_losses"] == got[0]["step_losses"]
        assert r["val"] == got[0]["val"]
    assert all(r["sharded"] for r in got)
    np.testing.assert_allclose(got[0]["loss_history"], ref["loss_history"],
                               atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(got[0]["val"], ref["val"], atol=LOSS_ATOL,
                               rtol=0)
    lr = cfg.get("learning_rate", 3e-4)
    adafactor = cfg.get("optimizer_name") == "adafactor"
    with np.load(init) as z:
        start = {k: z[k] for k in z.files}
    _compare(_final(port_dir), _final(jax_dir), start, lr, adafactor)
    if ema:
        _compare(_final(port_dir, "ema_params"),
                 _final(jax_dir, "ema_params"), start, lr, adafactor)


def test_moe_aux_is_the_global_batch_aux(tmp_path):
    """A training forward (and backward) of layer 0's MoE layer of the
    ``test`` preset as a model sharded at fsdp 2 runs it, each rank on
    its half of a seeded global input: each rank's load-balance loss is
    the aux of the whole batch (JAX's ``MoEMLP`` on the global input, the
    same weights), bit-equal on both ranks; the mean of the ranks' own
    per-batch aux is not."""
    from tpuflow.models.moe import MoEMLP as JMoE

    init = _init_npz(tmp_path, experts=4)
    cfg = {**BASE, "data_axis": 1, "fsdp_axis": 2, "experts": 4}
    got = spawn_world(2, "moe_aux", cfg=cfg, init_npz=init)
    assert got[0]["aux"] == got[1]["aux"]
    want = np.array(got[0]["want_input"])  # the global input (B, T, C)
    with np.load(init) as z:
        moe = {k.split("/", 2)[2]: z[k] for k in z.files
               if k.startswith("h0/moe/")}
    params = {"gate": {"kernel": moe["gate/kernel"],
                       "bias": moe["gate/bias"]},
              **{k: moe[k] for k in ("w1", "b1", "w2", "b2")}}
    C = want.shape[-1]
    jm = JMoE(d_model=C, d_ff=4 * C, n_experts=4)
    _, state = jm.apply({"params": params}, jnp.asarray(want), True,
                        mutable=["losses"])
    jaux = float(jax.tree_util.tree_leaves(state["losses"])[0])
    assert abs(got[0]["aux"] - jaux) <= 1e-7
    assert abs(np.mean([r["own_aux"] for r in got]) - jaux) > 1e-5


def test_tp_gang_flow_then_one_process_eval(tmp_path):
    """``TorchGptTrain`` as a gang of tensor 2 x expert 2 members (the
    MoE model with 4 experts, Adafactor, DCP checkpoints): the head's
    artifacts (finite losses, a 4-process DCP checkpoint); ``TorchGptEval``
    restores the run at one process and scores a finite test loss."""
    from tpuflow_torch.flow import Run, store
    from tpuflow_torch.flows import gpt_eval_flow, gpt_flow

    home = store.set_home(str(tmp_path / "home"))
    try:
        port = ["--device", "cpu", "--home", home]
        run = Run(gpt_flow.main([
            "run", "--preset", "test", "--epochs", "1", "--steps-per-epoch",
            "2", "--seq-len", "32", "--data-axis", "1", "--fsdp-axis", "1",
            "--tensor-axis", "2", "--expert-axis", "2", "--experts", "4",
            "--optimizer", "adafactor", "--ckpt-format", "dcp",
            "--dist-backend", "gloo", *port]))
        ckpt = run.data.result_checkpoint
        assert ckpt.metadata["process_count"] == 4
        assert os.path.exists(os.path.join(ckpt.path, "state", ".metadata"))
        assert np.isfinite(run.data.loss_history).all()
        ev = Run(gpt_eval_flow.main(["run", "--checkpoint-run-pathspec",
                                     run.pathspec, *port]))
        assert np.isfinite(ev.data.test_loss)
    finally:
        store.set_home(None)
