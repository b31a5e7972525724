"""Shared helpers of the ``test_torch_*`` files: one small GPT-2 in both
packages with the same weights (JAX-initialised, moved into the port
through ``params_from_jax``), a fixture that keeps a module's torch ops
on one thread, and ``run_jax``, which runs the JAX package on a CPU
platform of its own device count in a subprocess."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow.models.gpt2 import GPT2Config as JConfig
from tpuflow_torch.models.convert import params_from_jax
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config


def jax_and_port_gpt2(**kw):
    """``(jax_model, jax_params, port_model)`` at ``small_test`` sizes with
    dropout off; ``kw`` goes to both configs, except ``scan_layers``, which
    only changes the JAX param layout (the port reads either)."""
    kw = {"n_ctx": 64, "dropout": 0.0, **kw}
    jm = JGPT2(JConfig.small_test(**kw))
    kw.pop("scan_layers", None)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    tm = GPT2(GPT2Config.small_test(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    return jm, params, tm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The importing module's torch ops on one intra-op thread, the count
    restored after it. The suite runs in several worker processes, and
    torch's default of one OpenMP thread per core in each of them
    oversubscribes the CPU, the threads' spin-waits starving the other
    workers. These small models gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The JAX side of the FSDP tests, run as ``python -c`` with one JSON
# argument. The suite's process sees 8 CPU devices (conftest) and the JAX
# ``make_mesh`` wants all of them; this process pins its own count
# (``force_cpu_platform(n, exact=True)``) before JAX starts.
_JAX_MAIN = r"""
import dataclasses, json, os, sys
args = json.loads(sys.argv[1])
from tpuflow.dist import force_cpu_platform
force_cpu_platform(args["devices"], exact=True)
import jax
import jax.numpy as jnp
import numpy as np
assert len(jax.devices()) == args["devices"], jax.devices()
from tpuflow.train import gpt as jgpt

real = jgpt.GptTrainConfig.model_config
jgpt.GptTrainConfig.model_config = (
    lambda self: dataclasses.replace(real(self), dropout=0.0))
cfg = jgpt.GptTrainConfig(**args["cfg"])
out = {}
if args["mode"] == "train":
    handle = None
    if args.get("resume"):
        from tpuflow.ckpt import Checkpoint
        handle = Checkpoint.from_directory(args["resume"])
    res = jgpt.train_gpt(cfg, args["ckpt_dir"], resume_checkpoint=handle,
                         log=lambda m: None)
    out = {"loss_history": res.loss_history,
           "val": [m.get("val_loss") for m in res.metrics_history]}
else:
    # "init_save": save the state born sharded (create_sharded_state);
    # "restore": restore a checkpoint onto this mesh's sharded template
    # and write every leaf, gathered, to an npz.
    from tpuflow import dist
    from tpuflow.ckpt.raw import restore_raw
    from tpuflow.models.gpt2 import GPT2
    from tpuflow.parallel import create_sharded_state, gpt2_tensor_rules
    from tpuflow.train import TrainState

    mc = cfg.model_config()
    if args.get("scan"):
        mc = dataclasses.replace(mc, scan_layers=True)
    model = GPT2(mc)
    tx = cfg.optimizer()

    def init_fn(rng):
        params = model.init(rng, jnp.zeros((1, 8), jnp.int32))["params"]
        return TrainState.create(apply_fn=model.apply, params=params,
                                 tx=tx)

    born = args["mode"] == "init_save"
    if cfg.stage_axis > 1:
        # The pipeline leg's template (tpuflow/train/gpt.py:1038-1059).
        from tpuflow.parallel import gpt2_pipeline_shardings

        mesh = dist.make_mesh({"data": cfg.data_axis,
                               "stage": cfg.stage_axis})
        with mesh:
            p_shapes = jax.eval_shape(
                lambda r: model.init(r, jnp.zeros((1, 8), jnp.int32))[
                    "params"], jax.random.PRNGKey(0))
            o_shapes = jax.eval_shape(tx.init, p_shapes)
            spec = lambda shapes: jax.tree_util.tree_map(  # noqa: E731
                lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                                   sharding=sh),
                shapes, gpt2_pipeline_shardings(mesh, shapes))
            tmpl = {"step": jax.ShapeDtypeStruct((), jnp.int32),
                    "params": spec(p_shapes), "opt_state": spec(o_shapes)}
    else:
        mesh = dist.make_mesh({"data": cfg.data_axis, "fsdp": cfg.fsdp_axis,
                               "tensor": cfg.tensor_axis,
                               "seq": cfg.seq_axis,
                               "expert": cfg.expert_axis})
        rules = (gpt2_tensor_rules
                 if cfg.tensor_axis > 1 or cfg.expert_axis > 1 else None)
        with mesh:
            state, _ = create_sharded_state(init_fn, mesh,
                                            jax.random.PRNGKey(0),
                                            tensor_rules=rules,
                                            materialize=born)
            tmpl = {"step": state.step, "params": state.params,
                    "opt_state": state.opt_state}
    if born:
        from tpuflow.ckpt import CheckpointManager
        mgr = CheckpointManager(args["ckpt_dir"], max_to_keep=None)
        mgr.save(1, tmpl)
        mgr.wait_until_finished()
        mgr.close()
        json.dump({}, open(args["out"], "w"))
        sys.exit(0)
    from tpuflow.ckpt.raw import _path_names
    with mesh:
        tree = restore_raw(os.path.join(args["src"], "state"), tmpl)
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        np.savez(args["out_npz"], **{
            "/".join(_path_names(path)): np.asarray(jax.device_get(leaf))
            for path, leaf in flat})
        out = {"specs": {"/".join(_path_names(path)): str(
            getattr(getattr(leaf, "sharding", None), "spec", None))
            for path, leaf in flat}}
json.dump(out, open(args["out"], "w"))
"""


def run_jax(devices: int, mode: str, workdir: str, **args) -> dict:
    """Run the JAX package on ``devices`` CPU devices in a subprocess:
    ``mode="train"`` runs ``train_gpt(GptTrainConfig(**cfg), ckpt_dir)``
    (dropout off, optionally resuming from the checkpoint directory
    ``resume``) and returns its loss and validation histories;
    ``mode="restore"`` restores the checkpoint directory ``src`` onto the
    sharded state of ``cfg``'s mesh and writes its leaves to ``out_npz``;
    ``mode="init_save"`` saves the state born sharded on that mesh as
    step 1 under ``ckpt_dir``. The meshes take ``cfg``'s ``tensor_axis``,
    ``seq_axis`` and ``expert_axis`` with ``gpt2_tensor_rules``, as the
    JAX recipe does, or with ``stage_axis`` > 1 the pipeline leg's
    ``data`` x ``stage`` mesh and ``gpt2_pipeline_shardings`` (restore
    only); ``scan=True`` restores onto the scan-layers model.
    ``workdir`` holds the JAX package's home and data directories."""
    out = os.path.join(workdir, f"jax_{mode}_{len(os.listdir(workdir))}.json")
    env = dict(os.environ, TPUFLOW_HOME=os.path.join(workdir, "home"),
               TPUFLOW_DATA_DIR=os.path.join(workdir, "data"),
               TPUFLOW_OBS="0")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_MAIN,
         json.dumps({"devices": devices, "mode": mode, "out": out, **args})],
        env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"JAX {mode} failed:\n{proc.stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)
