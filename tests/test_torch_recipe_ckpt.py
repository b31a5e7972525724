"""Checkpoints of the training recipes across the two packages: Lion,
Adafactor and a Switch-MoE GPT-2 (``ckpt/tree.py``'s optimizer layouts and
the MoE params).

- A JAX state one step in (the JAX optimizer and jitted step, test-preset
  GPT-2 in both param layouts), saved by the JAX ``CheckpointManager``,
  restores into the port: every param, optimizer leaf and count exactly
  equal, and the next step's loss within atol 1e-5. The port saves it
  again: the manifests agree leaf for leaf (path, shape, dtype, crc32) and
  the JAX ``restore_raw`` reads the port's checkpoint into the JAX
  structure bit for bit.
- The JAX ``train_gpt`` (test preset, dropout off) writes its per-epoch
  checkpoints; the port's ``train_gpt`` resumes from the first epoch's
  in-run and trains the second: its losses within atol 1e-5 of the JAX
  run's. The JAX run spreads its batch over the 8 CPU devices the suite
  gives JAX (``data_axis=8``), so its gradients sum in another order.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.ckpt import CheckpointManager as JCheckpointManager
from tpuflow.ckpt import raw as jraw
from tpuflow.train import gpt as jgpt
from tpuflow.train.optim import make_optimizer as j_make_optimizer
from tpuflow.train.step import TrainState as JTrainState
from tpuflow.train.step import make_train_step as j_make_train_step
from tpuflow_torch.ckpt import CheckpointManager, raw
from tpuflow_torch.ckpt.tree import (
    JaxLeaves,
    checkpoint_tree,
    load_checkpoint_tree,
)
from tpuflow_torch.data.lm import make_lm_loaders
from tpuflow_torch.models.gpt2 import GPT2
from tpuflow_torch.train import gpt as tgpt
from tpuflow_torch.train.optim import make_optimizer
from tpuflow_torch.train.step import TrainState, make_train_step

# name -> (optimizer arguments of both factories, model arguments).
RECIPES = {
    "lion": (dict(optimizer="lion"), {}),
    "lion_clip_cosine": (dict(optimizer="lion", grad_clip_norm=1.0,
                              warmup_steps=1, decay_steps=8,
                              schedule="cosine"), {}),
    "adafactor": (dict(optimizer="adafactor"), {}),
    "adafactor_clip_cosine_wd0": (dict(optimizer="adafactor",
                                       grad_clip_norm=1.0, decay_steps=8,
                                       schedule="cosine", weight_decay=0.0),
                                  {}),
    "moe_adamw": (dict(optimizer="adamw"), dict(n_experts=2)),
    "moe_adafactor": (dict(optimizer="adafactor", schedule="linear",
                           decay_steps=8), dict(n_experts=2)),
}
LR = 1e-3


def _batches(n):
    loader, _ = make_lm_loaders(4, n, 32, 512)
    return list(loader)


def _states(recipe: str, scan_layers: bool):
    """The JAX state after one step and its step, and a port state of the
    same model with other weights (seed 7) and its step."""
    kw, model_kw = RECIPES[recipe]
    jm, params, tm = jax_and_port_gpt2(attn_impl="xla",
                                       scan_layers=scan_layers, **model_kw)
    tm = GPT2(tm.config, seed=7, device="cpu")
    jstate = JTrainState.create(apply_fn=jm.apply, params=params,
                                tx=j_make_optimizer(LR, **kw))
    jstep = j_make_train_step(donate=False)
    b = _batches(1)[0]
    jstate, _ = jstep(jstate, {k: jnp.asarray(b[k]) for k in "xy"},
                      jax.random.PRNGKey(1))
    tstate = TrainState(model=tm, tx=make_optimizer(
        tm.parameters(), LR, leaves=JaxLeaves(tm, scan_layers), **kw))
    return jstate, jstep, tstate, make_train_step()


def _key(k) -> str:
    """One ``jax.tree_util`` path entry as the checkpoint names it: a dict
    key, a tuple index, or (dropped by the checkpoint) a named-tuple
    field, whose name the raw format keeps."""
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _payload(jstate):
    return {"step": jstate.step, "params": jstate.params,
            "opt_state": jstate.opt_state}


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_checkpoints_cross_both_ways(tmp_path, recipe, scan_layers):
    jstate, jstep, tstate, tstep = _states(recipe, scan_layers)
    mgr = JCheckpointManager(str(tmp_path / "jax"), async_save=False)
    mgr.save(1, _payload(jstate), metrics={"val_loss": 1.0})
    mgr.close()
    tmpl = checkpoint_tree(tstate, scan_layers=scan_layers, abstract=True)
    load_checkpoint_tree(tstate, CheckpointManager(
        str(tmp_path / "jax")).restore(1, abstract_state=tmpl))
    assert tstate.step == 1 and tstate.tx.count == 1
    # Every leaf the port now holds is the JAX state's, bit for bit, by
    # the JAX tree's own paths.
    mine = {"/".join(path): t for path, t in
            raw.flatten(checkpoint_tree(tstate, scan_layers=scan_layers))}
    want = {"/".join(_key(k) for k in path): x for path, x in
            jax.tree_util.tree_flatten_with_path(
                jax.device_get(_payload(jstate)))[0]}
    assert mine.keys() == want.keys()
    for path, t in mine.items():
        np.testing.assert_array_equal(t.detach().numpy(),
                                      np.asarray(want[path]), err_msg=path)
    # The next step from the restored state.
    b = _batches(2)[1]
    _, jm_ = jstep(jstate, {k: jnp.asarray(b[k]) for k in "xy"},
                   jax.random.PRNGKey(1))
    # The port saves the restored state before stepping on.
    out = CheckpointManager(str(tmp_path / "port"), async_save=False)
    out.save(1, checkpoint_tree(tstate, scan_layers=scan_layers),
             metrics={"val_loss": 1.0})
    out.close()
    _, tm_ = tstep(tstate, b, 1)
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                               atol=1e-5, rtol=0)
    jm_man, tm_man = (raw.read_manifest(str(tmp_path / d / "step_1" /
                                            "state"))
                      for d in ("jax", "port"))
    assert tm_man["leaves"] == jm_man["leaves"]
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.asarray(x).dtype),
        _payload(jstate))
    back = jraw.restore_raw(str(tmp_path / "port" / "step_1" / "state"),
                            abstract)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_payload(jstate))):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kw", [dict(optimizer_name="lion"),
                                dict(optimizer_name="adafactor",
                                     learning_rate=1e-2),
                                dict(experts=2)],
                         ids=["lion", "adafactor", "moe"])
def test_port_train_gpt_resumes_a_jax_run(tmp_path, monkeypatch, kw):
    """The JAX train_gpt's epoch-1 checkpoint resumed in-run by the port's
    train_gpt: the second epoch's losses within 1e-5 of the JAX run's."""
    for mod in (jgpt, tgpt):
        real = mod.GptTrainConfig.model_config
        monkeypatch.setattr(
            mod.GptTrainConfig, "model_config",
            lambda self, real=real: dataclasses.replace(real(self),
                                                        dropout=0.0))
    args = dict(preset="test", epochs=2, steps_per_epoch=2, seq_len=32,
                batch_size=8, fsdp_axis=1, **kw)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jres = jgpt.train_gpt(jgpt.GptTrainConfig(data_axis=8, **args),
                          str(jdir), log=lambda m: None)
    shutil.copytree(jdir, tdir, ignore=shutil.ignore_patterns(
        "step_4", ".recycle"))
    logs = []
    tres = tgpt.train_gpt(tgpt.GptTrainConfig(data_axis=1, **args),
                          str(tdir), log=logs.append, device="cpu")
    assert any("in-run resume from step 2" in m for m in logs)
    assert len(tres.step_losses) == 2
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               atol=1e-5, rtol=0)
    # The port's step_4 restores in the JAX package with the JAX run's
    # leaf paths and shapes.
    mine = jraw.restore_raw(str(tdir / "step_4" / "state"))
    theirs = jraw.restore_raw(str(jdir / "step_4" / "state"))
    a = jax.tree_util.tree_flatten_with_path(mine)[0]
    b = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [(p, np.shape(x)) for p, x in a] == \
        [(p, np.shape(x)) for p, x in b]
