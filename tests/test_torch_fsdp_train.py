"""Multi-process GPT-2 training in the port (FSDP over gloo on the CPU)
against the JAX package's ``train_gpt`` on a mesh of the same shape.

The port's worlds are spawned processes that import torch and the port
only (``torch_gang_flows.spawn_world``); the JAX reference runs in a
subprocess whose CPU platform has as many devices as the port has
processes (``torch_parity.run_jax``). Both start from the same JAX init
(``params_from_jax``), train the ``test`` preset on the same global
batches with dropout off, and save per-epoch checkpoints; the final
parameters are read back from both checkpoints.

Tolerances (f32; the two sides reduce in other orders: JAX's GSPMD sums
the whole batch's gradient, the port averages each process's mean):
- losses and validation losses of 2 x 2 steps within atol 2e-5;
- final parameters after SGD within atol 2e-6; after AdamW within
  atol 4 lr, the known trap of elements whose gradient is float noise
  around an exact 0 (the key bias: each side's sign of noise moves it by
  about lr a step), and every other element far closer, which the
  median check pins (median |diff| under 1e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_gang_flows import spawn_world
from torch_parity import one_torch_thread, run_jax  # noqa: F401
from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow.train import gpt as jgpt
from tpuflow_torch.ckpt import raw
from tpuflow_torch.train import gpt as tgpt

BASE = dict(preset="test", epochs=2, steps_per_epoch=2, batch_size=8,
            seq_len=32)
LOSS_ATOL = 2e-5
SGD_PARAM_ATOL = 2e-6


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    """The JAX init of the ``test`` preset (PRNGKey(0), as the JAX
    ``train_gpt`` draws it), flattened into an npz for the workers."""
    cfg = jgpt.GptTrainConfig(**BASE).model_config()
    params = jax.jit(JGPT2(cfg).init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 8), jnp.int32))["params"]
    flat = {"/".join(str(e.key) for e in path): np.asarray(leaf)
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]}
    path = str(tmp_path_factory.mktemp("init") / "init.npz")
    np.savez(path, **flat)
    return path


def _final(ckpt_dir: str, what: str = "params") -> dict:
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    tree = raw.restore_raw(
        os.path.join(ckpt_dir, f"step_{steps[-1]}", "state"))
    return {"/".join(p): t.numpy() for p, t in raw.flatten(tree[what])}


def _compare_params(port: dict, ref: dict, adamw: bool, lr: float) -> None:
    assert port.keys() == ref.keys()
    diffs = []
    for k in ref:
        d = np.abs(port[k] - ref[k])
        if not adamw:
            assert d.max() <= SGD_PARAM_ATOL, (k, d.max())
        else:
            assert d.max() <= 4 * lr, (k, d.max())
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) < 1e-6


CASES = {
    # id: (world, cfg, compare EMA weights, train_gpt's comm_overlap)
    "fsdp2-adamw": (2, dict(data_axis=1, fsdp_axis=2), False, True),
    "data2xfsdp2-sgd": (4, dict(data_axis=2, fsdp_axis=2,
                                optimizer_name="sgd", learning_rate=0.1),
                        False, True),
    "accum2-overlap": (2, dict(data_axis=1, fsdp_axis=2, accum_steps=2),
                       False, True),
    "accum2-sequential": (2, dict(data_axis=1, fsdp_axis=2, accum_steps=2),
                          False, False),
    "clip-ema": (2, dict(data_axis=1, fsdp_axis=2, grad_clip=0.5,
                         ema_decay=0.9, optimizer_name="sgd",
                         learning_rate=0.1), True, True),
}


@pytest.mark.parametrize("case", [
    "fsdp2-adamw",
    pytest.param("data2xfsdp2-sgd", marks=pytest.mark.slow),
    pytest.param("accum2-overlap", marks=pytest.mark.slow),
    pytest.param("accum2-sequential", marks=pytest.mark.slow),
    "clip-ema",
])
def test_fsdp_train_gpt_matches_jax(case, init_npz, tmp_path):
    """``train_gpt`` sharded over the world against the JAX ``train_gpt``
    on the same mesh: every process reports the same global losses (bit
    for bit), they and the validation losses match JAX's per-epoch means,
    the state was sharded by the rule, and the final checkpoints' params
    (and EMA weights) agree (tolerances in the module docstring). JAX
    pins its overlapped and sequential accumulation programs bit-equal;
    the port's sum in other orders, so both are held to JAX instead."""
    world, extra, ema, overlap = CASES[case]
    cfg = {**BASE, **extra}
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    got = spawn_world(world, "fsdp_train", cfg=cfg, ckpt_dir=port_dir,
                      init_npz=init_npz, comm_overlap=overlap)
    ref = run_jax(world, "train", str(tmp_path), cfg=cfg, ckpt_dir=jax_dir)
    for r in got[1:]:
        assert r["step_losses"] == got[0]["step_losses"]
        assert r["val"] == got[0]["val"]
    assert all(r["sharded"] for r in got)
    np.testing.assert_allclose(got[0]["loss_history"], ref["loss_history"],
                               atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(got[0]["val"], ref["val"], atol=LOSS_ATOL,
                               rtol=0)
    adamw = cfg.get("optimizer_name", "adamw") == "adamw"
    lr = cfg.get("learning_rate", 3e-4)
    _compare_params(_final(port_dir), _final(jax_dir), adamw, lr)
    if ema:
        _compare_params(_final(port_dir, "ema_params"),
                        _final(jax_dir, "ema_params"), adamw, lr)


def test_accumulation_programs_agree(init_npz, tmp_path):
    """``accum_steps=2`` with the per-microbatch reduce-scatter (the JAX
    overlap program) and with one after the last microbatch (the
    sequential program) give the same losses within atol 1e-6 and the
    same params within 1e-6 (the accumulated sums add in other
    orders)."""
    cfg = {**BASE, "data_axis": 1, "fsdp_axis": 2, "accum_steps": 2,
           "optimizer_name": "sgd", "learning_rate": 0.1}
    runs = {}
    for overlap in (True, False):
        d = str(tmp_path / f"overlap_{overlap}")
        got = spawn_world(2, "fsdp_train", cfg=cfg, ckpt_dir=d,
                          init_npz=init_npz, comm_overlap=overlap)
        runs[overlap] = (got[0]["step_losses"], _final(d))
    np.testing.assert_allclose(runs[True][0], runs[False][0], atol=1e-6,
                               rtol=0)
    for k, v in runs[True][1].items():
        np.testing.assert_allclose(v, runs[False][1][k], atol=1e-6, rtol=0)


def test_world_smaller_than_the_mesh_raises():
    """data 2 x fsdp 2 wants four processes; one raises, naming both."""
    cfg = tgpt.GptTrainConfig(**{**BASE, "data_axis": 2, "fsdp_axis": 2})
    with pytest.raises(ValueError, match="= 4 processes, but the world has 1"):
        tgpt.train_gpt(cfg, log=lambda m: None, device="cpu")


@pytest.mark.parametrize("extra", [
    {"seq_axis": 2, "fsdp_axis": 1}, {"attn_impl": "ulysses"},
], ids=["seq", "ulysses"])
def test_sharded_recipes_deferred(extra):
    """Nothing two processes ran is deferred any more: a seq axis of 2
    (ring, Ulysses and the gathered attention on it:
    ``tests/test_torch_seq_train.py``) and ``attn_impl="ulysses"`` at
    fsdp 2 (a trivial seq axis: blockwise attention) train, every
    process's losses finite and bit-equal."""
    cfg = {**BASE, "data_axis": 1, "fsdp_axis": 2, **extra}
    got = spawn_world(2, "fsdp_train", cfg=cfg)
    assert got[0]["step_losses"] == got[1]["step_losses"]
    assert np.isfinite(got[0]["step_losses"]).all()


def test_one_world_keeps_the_unsharded_step():
    """A world of one process trains the state whole (no plan): the
    single-device path is unchanged."""
    state = tgpt.init_state(tgpt.GptTrainConfig(**{**BASE, "data_axis": 1,
                                                   "fsdp_axis": 1}),
                            device="cpu")
    assert state.plan is None and state.mesh is None
    assert all(not hasattr(p, "to_local") for p in state.params)
    assert isinstance(state.params[0], torch.nn.Parameter)
