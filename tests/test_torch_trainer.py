"""The port's training slice for the MLP against the JAX package's, and the
trainer's contract.

Parity (weights made from a seed with numpy, batches from the loaders,
dropout off):
- 16 SGD steps (momentum 0.9) against the JAX ``make_train_step``: the
  parameters within atol 2e-6 (f32 products summed in another order,
  compounded over 16 steps at lr 0.05; the weights are of order 0.05);
- the eval step's sums over a padded, masked tail against JAX's:
  ``num_correct`` and ``count`` equal, ``loss_sum`` within 1e-6 relative;
- the slice as a whole: the JAX ``train_model`` and the port's, both
  warm-started (weights only) from one JAX-written checkpoint, 1 epoch at
  batch 32 on 512 synthetic rows, one worker: ``val_loss`` within 1e-6
  relative, ``accuracy`` equal (128 rows: one flipped row would be 1/128),
  the final parameters within atol 2e-6.

Checkpoints cross the packages both ways, and the trainer keeps its
contract: retention, ``metrics.jsonl``, the ``Result`` JSON round trip,
the in-run resume bit for bit (one torch thread), the weights-only warm
start, and no CPU fallback when CUDA is asked for.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "flows"))

import my_tpu_module as jmod  # noqa: E402
from tpuflow.ckpt import CheckpointManager as JCheckpointManager
from tpuflow.ckpt import raw as jraw
from tpuflow.models.mlp import NeuralNetwork as JNeuralNetwork
from tpuflow.train.step import create_train_state as j_create_train_state
from tpuflow.train.step import make_eval_step as j_make_eval_step
from tpuflow.train.step import make_train_step as j_make_train_step
from tpuflow_torch.ckpt import Checkpoint, CheckpointManager, restore_from_handle
from tpuflow_torch.ckpt import raw
from tpuflow_torch.ckpt.tree import checkpoint_tree, load_checkpoint_tree
from tpuflow_torch.data.loader import get_dataloaders
from tpuflow_torch.flows import my_torch_module as tmod
from tpuflow_torch.models import NeuralNetwork
from tpuflow_torch.models.convert import mlp_params_from_jax, mlp_params_to_jax
from tpuflow_torch.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from tpuflow_torch.train.trainer import (
    Result,
    RunConfig,
    ScalingConfig,
    Trainer,
    get_context,
)

N_TRAIN, N_TEST = 512, 128
PARAM_ATOL = 2e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(seed=0):
    r = np.random.default_rng(seed)
    dims = [(784, 512), (512, 512), (512, 10)]
    return {f"dense{i + 1}": {
        "kernel": (r.standard_normal(d) / np.sqrt(d[0])).astype(np.float32),
        "bias": (0.05 * r.standard_normal(d[1])).astype(np.float32),
    } for i, d in enumerate(dims)}


def _jax_state(params, lr):
    state = j_create_train_state(
        JNeuralNetwork(dropout_rate=0.0), jax.random.PRNGKey(0),
        jnp.zeros((1, 28, 28), jnp.float32), optax.sgd(lr, momentum=0.9))
    return state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))


def _port_state(params, lr):
    model = NeuralNetwork(dropout_rate=0.0)
    model.load_state_dict(mlp_params_from_jax(params))
    return create_train_state(model, lr)


def _assert_params_close(port_model, jax_params, atol=PARAM_ATOL):
    tree = mlp_params_to_jax(port_model.state_dict())
    for name, leaves in jax_params.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(tree[name][leaf].detach().numpy(),
                                       np.asarray(want), rtol=0, atol=atol,
                                       err_msg=f"{name}/{leaf}")


def test_sixteen_sgd_steps_match_jax():
    params = _np_params()
    jstate, tstate = _jax_state(params, 0.05), _port_state(params, 0.05)
    jstep, tstep = j_make_train_step(), make_train_step()
    train, _ = get_dataloaders(32, n_train=N_TRAIN, n_test=N_TEST)
    for batch in train:
        xy = {"x": batch["x"], "y": batch["y"]}
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, xy),
                           jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, xy, 1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert tstate.step == int(jstate.step) == 16
    _assert_params_close(tstate.model, jax.device_get(jstate.params))
    trace = tstate.tx.slots()["trace"]
    jtrace = jax.device_get(jstate.opt_state[0].trace)
    np.testing.assert_allclose(trace[0].t().numpy(),
                               jtrace["dense1"]["kernel"], rtol=0,
                               atol=1e-4)


def test_eval_sums_over_a_padded_tail_match_jax():
    params = _np_params(1)
    jstate, tstate = _jax_state(params, 0.01), _port_state(params, 0.01)
    jeval, teval = j_make_eval_step(), make_eval_step()
    _, val = get_dataloaders(32, n_train=64, n_test=100)
    batches = list(val)
    assert batches[-1]["mask"].sum() == 4  # 100 = 3 x 32 + 4
    for batch in batches:
        j = jeval(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        t = teval(tstate, batch)
        assert float(t["count"]) == float(j["count"])
        assert float(t["num_correct"]) == float(j["num_correct"])
        np.testing.assert_allclose(float(t["loss_sum"]),
                                   float(j["loss_sum"]), rtol=1e-6)


def _jax_checkpoint(tmp_path, params, steps=0):
    """A JAX MLP state (after ``steps`` SGD steps, so the trace is
    non-zero) saved by the JAX CheckpointManager as step 1."""
    state = _jax_state(params, 0.05)
    if steps:
        step = j_make_train_step()
        train, _ = get_dataloaders(32, n_train=N_TRAIN, n_test=N_TEST)
        for batch, _ in zip(train, range(steps)):
            state, _ = step(state, jax.tree_util.tree_map(
                jnp.asarray, {"x": batch["x"], "y": batch["y"]}),
                jax.random.PRNGKey(1))
    mgr = JCheckpointManager(str(tmp_path / "jax_ckpt"), async_save=False)
    mgr.save(1, jmod._state_tree(state), metrics={"val_loss": 1.0})
    mgr.wait_until_finished()
    return state, mgr.checkpoint(1)


def test_checkpoints_cross_both_ways(tmp_path):
    """A JAX-written MLP state restores into the port's state (params,
    0/trace, step) exactly; the port's save restores through the JAX
    ``restore_raw`` with the same leaves."""
    jstate, handle = _jax_checkpoint(tmp_path, _np_params(2), steps=2)
    tstate = _port_state(_np_params(9), 0.05)
    restored = restore_from_handle(
        Checkpoint(path=handle.path),
        abstract_state=checkpoint_tree(tstate, abstract=True))
    load_checkpoint_tree(tstate, restored)
    assert tstate.step == 2 and tstate.tx.count == 2
    _assert_params_close(tstate.model, jax.device_get(jstate.params), atol=0)
    jtrace = jax.device_get(jstate.opt_state[0].trace)
    ttrace = mlp_params_to_jax(dict(zip(
        [n for n, _ in tstate.model.named_parameters()],
        tstate.tx.slots()["trace"])))
    for name in jtrace:
        for leaf in jtrace[name]:
            np.testing.assert_array_equal(ttrace[name][leaf].numpy(),
                                          jtrace[name][leaf])
    mgr = CheckpointManager(str(tmp_path / "port_ckpt"), async_save=False)
    mgr.save(2, checkpoint_tree(tstate), metrics={"val_loss": 1.0})
    back = jraw.restore_raw(os.path.join(mgr.checkpoint(2).path, "state"))
    ref = jraw.restore_raw(os.path.join(handle.path, "state"))
    got, want = _leaves(back), _leaves(ref)
    assert list(got) == list(want)
    for path, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(v),
                                      err_msg=path)


def _leaves(tree, prefix=""):
    """A nested dict's leaves by slash path, in key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_train_model_matches_jax_from_one_warm_start(tmp_path, monkeypatch):
    """The slice as a whole (see the module docstring)."""
    monkeypatch.setenv("TPUFLOW_SYNTH_TRAIN_N", str(N_TRAIN))
    monkeypatch.setenv("TPUFLOW_SYNTH_TEST_N", str(N_TEST))
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path / "jax_default"))
    _, handle = _jax_checkpoint(tmp_path, _np_params(3))
    common = dict(num_workers=1, model_kwargs={"dropout_rate": 0.0},
                  epochs=1, global_batch_size=32, lr=0.05)
    jres = jmod.train_model(checkpoint=handle, data_dir=str(tmp_path / "jd"),
                            checkpoint_storage_path=str(tmp_path / "jrun"),
                            **common)
    tres = tmod.train_model(checkpoint=Checkpoint(path=handle.path),
                            device="cpu", n_train=N_TRAIN, n_test=N_TEST,
                            data_dir=str(tmp_path / "td"),
                            checkpoint_storage_path=str(tmp_path / "trun"),
                            **common)
    np.testing.assert_allclose(tres.metrics["val_loss"],
                               jres.metrics["val_loss"], rtol=1e-6)
    assert tres.metrics["accuracy"] == jres.metrics["accuracy"]
    jparams = restore_from_handle(Checkpoint(path=jres.checkpoint.path),
                                  weights_only=True)
    model = NeuralNetwork()
    load = restore_from_handle(tres.checkpoint, weights_only=True)
    model.load_state_dict(mlp_params_from_jax(load))
    _assert_params_close(model, {k: {leaf: v.numpy() for leaf, v in d.items()}
                                 for k, d in jparams.items()})
    assert not (tmp_path / "td").exists()  # the port writes no data cache


def _run(tmp_path, name, **kw):
    return tmod.train_fashion_mnist(
        device="cpu", n_train=256, n_test=64, global_batch_size=32, lr=0.05,
        checkpoint_storage_path=str(tmp_path / name), **kw)


def test_fit_retention_metrics_and_result_json(tmp_path):
    res = _run(tmp_path, "run", epochs=3)
    ckdir = tmp_path / "run" / "checkpoints"
    # Retention recycles the steps it drops into .recycle.
    kept = sorted(int(d.split("_")[1]) for d in os.listdir(ckdir)
                  if d.startswith("step_"))
    best = int(res.best_checkpoint.path.rsplit("_", 1)[1])
    assert kept == sorted({2, 3, best})
    assert res.checkpoint.path.endswith("step_3")
    assert len(res.metrics_history) == 3 and res.mesh_axes == {"data": 1}
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(l)["step"] for l in lines] == [1, 2, 3]
    assert json.loads(lines[-1])["val_loss"] == res.metrics["val_loss"]
    back = Result.from_json(json.loads(json.dumps(res.to_json())))
    assert back.to_json() == res.to_json()
    assert back.checkpoint.path == res.checkpoint.path


def _payload(step_dir):
    return {"/".join(map(str, p)): v for p, v in raw.flatten(
        raw.restore_raw(os.path.join(step_dir, "state")))}


def test_in_run_resume_is_bit_exact(tmp_path, capsys):
    """A rerun over a copy of the storage with its newest step removed
    resumes from step 2, trains epoch 3 only, and writes the uninterrupted
    run's step 3 bit for bit, with its metrics."""
    full = _run(tmp_path, "a", epochs=3)
    shutil.copytree(tmp_path / "a", tmp_path / "b",
                    ignore=shutil.ignore_patterns(".recycle"))
    shutil.rmtree(tmp_path / "b" / "checkpoints" / "step_3")
    capsys.readouterr()
    again = _run(tmp_path, "b", epochs=3)
    out = capsys.readouterr().out
    assert "in-run resume: restored retained step 2" in out
    assert "epoch 2:" in out and "epoch 1:" not in out
    assert again.metrics == full.metrics
    assert [m["val_loss"] for m in again.metrics_history] == \
        [m["val_loss"] for m in full.metrics_history]
    a = _payload(full.checkpoint.path)
    b = _payload(again.checkpoint.path)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_weights_only_warm_start_keeps_the_trace_at_zero(tmp_path):
    jstate, handle = _jax_checkpoint(tmp_path, _np_params(4), steps=2)
    state = _port_state(_np_params(5), 0.05)
    tmod.set_weights_from_checkpoint(state, Checkpoint(path=handle.path))
    _assert_params_close(state.model, jax.device_get(jstate.params), atol=0)
    assert all(torch.count_nonzero(t) == 0
               for t in state.tx.slots()["trace"])
    assert state.step == 0 and state.tx.count == 0
    # resume="full" takes the step and the trace too: 2 restored steps + 8
    # of one epoch (256 rows at batch 32).
    res = _run(tmp_path, "full", epochs=1, checkpoint=Checkpoint(
        path=handle.path), resume="full")
    assert int(_payload(res.checkpoint.path)["step"]) == 10
    res = _run(tmp_path, "warm", epochs=1, checkpoint=Checkpoint(
        path=handle.path))
    assert int(_payload(res.checkpoint.path)["step"]) == 8


def test_cuda_asked_for_raises_without_it():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmod.train_fashion_mnist(epochs=1, n_train=64, n_test=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(lambda c: None, scaling_config=ScalingConfig()).fit()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmod.TorchPredictor(Checkpoint(path="/nonexistent"))


def test_trainer_loop_and_context():
    seen = {}

    def loop(config):
        ctx = get_context()
        seen["world"] = ctx.get_world_size()
        seen["rank"] = ctx.get_world_rank()
        seen["cfg"] = config
        ctx.report({"val_loss": torch.tensor(0.5)})

    res = Trainer(loop, train_loop_config={"a": 1},
                  scaling_config=ScalingConfig(device="cpu"),
                  run_config=RunConfig()).fit()
    assert seen == {"world": 1, "rank": 0, "cfg": {"a": 1}}
    assert res.metrics == {"val_loss": 0.5} and res.checkpoint is None
    with pytest.raises(RuntimeError, match="outside"):
        get_context()
    with pytest.raises(ValueError, match="num_workers=2"):
        Trainer(loop, scaling_config=ScalingConfig(num_workers=2,
                                                   device="cpu")).fit()
