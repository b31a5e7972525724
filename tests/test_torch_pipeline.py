"""The port's GPipe pipeline (``parallel/pipeline.py``, ``train_gpt``'s
pipeline leg) against the JAX package's (``tpuflow/parallel/pipeline.py``,
``tpuflow/train/gpt.py::_train_pipeline``), all at ``stage`` 2.

The port runs in spawned gloo worlds (``torch_gang_flows``); the JAX
loss and gradients run here on ``make_mesh({"data": D, "stage": 2})``
over the suite's CPU devices, the JAX training leg and its restores in a
subprocess on as many CPU devices (``torch_parity.run_jax``). Both sides
start from the same JAX init, dropout off.

Tolerances (f32): the loss within 1e-5 relative and every gradient
within atol 2e-5 plus 2e-4 relative (the JAX pipeline tests' own against
the non-pipelined model, ``tests/test_pipeline.py:62-66``); the training
legs' per-step losses within 1e-5 relative; checkpoints bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_tp_train import _init_npz
from torch_gang_flows import spawn_world
from torch_parity import one_torch_thread, run_jax  # noqa: F401
from tpuflow import dist as jdist
from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow.parallel.pipeline import (
    gpt2_pipeline_loss as jpipeline_loss,
    gpt2_pipeline_shardings as jpipeline_shardings,
)
from tpuflow.train import gpt as jgpt
from tpuflow_torch.ckpt import raw
from tpuflow_torch.models.gpt2 import GPT2Config
from tpuflow_torch.parallel.pipeline import (
    gpt2_pipeline_loss,
    gpt2_pipeline_shardings,
    stage_layers,
)
from tpuflow_torch.train import gpt as tgpt

BASE = dict(preset="test", epochs=2, steps_per_epoch=1, batch_size=8,
            seq_len=32, stage_axis=2, fsdp_axis=1)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4


def _tokens(cfg: dict) -> np.ndarray:
    rng = np.random.default_rng(0)
    vocab = tgpt.GptTrainConfig(**cfg).model_config().vocab_size
    return rng.integers(0, vocab, (cfg["batch_size"], cfg["seq_len"] + 1))


def _jax_loss_grads(cfg: dict, init: str, tokens: np.ndarray):
    """JAX's pipeline loss and gradients on its data x stage mesh."""
    tcfg = jgpt.GptTrainConfig(**cfg)
    mc = dataclasses.replace(tcfg.model_config(), dropout=0.0)
    with np.load(init) as z:
        flat = {k: z[k] for k in z.files}
    params = JGPT2(mc).init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat["/".join(str(e.key) for e in p)]),
        params)
    n = tcfg.data_axis * tcfg.stage_axis
    mesh = jdist.make_mesh({"data": tcfg.data_axis, "stage": tcfg.stage_axis},
                           devices=jax.devices()[:n])
    loss_fn = jpipeline_loss(mc, mesh=mesh, n_microbatches=tcfg.microbatches)
    x, y = jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])
    with mesh:
        placed = jax.device_put(params, jpipeline_shardings(mesh, params))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(placed, x, y)
    flat_g = {"/".join(str(e.key) for e in p): np.asarray(g) for p, g in
              jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(loss), flat_g


CASES = {
    "data1xstage2": (2, dict(data_axis=1, microbatches=2)),
    "data2xstage2": (4, dict(data_axis=2, microbatches=2)),
    "data1xstage2-moe": (2, dict(data_axis=1, microbatches=2, experts=2)),
}


@pytest.mark.parametrize("case", [
    "data1xstage2",
    pytest.param("data2xstage2", marks=pytest.mark.slow),
    pytest.param("data1xstage2-moe", marks=pytest.mark.slow),
])
def test_pipeline_loss_and_grads_match_jax(case, tmp_path):
    """``gpt2_pipeline_loss`` on each stage's process, its gradients
    summed as the train step sums them (a stage's blocks over ``data``,
    the rest over the world), against JAX's on the same mesh and params:
    the loss bit-equal on every rank, within 1e-5 of JAX's, every gradient
    leaf within the stated tolerance. The MoE case collects each stage's
    load-balance aux at its valid ticks (``tests/test_pipeline.py:105``):
    the loss holds it and the router's gradient is not zero."""
    world, extra = CASES[case]
    cfg = {**BASE, **extra}
    init = _init_npz(tmp_path, **{k: v for k, v in cfg.items()
                                  if k in ("experts", "stage_axis")})
    tokens = _tokens(cfg)
    got = spawn_world(world, "pipeline_loss", cfg=cfg, init_npz=init,
                      tokens=tokens.tolist())
    assert len({r["loss"] for r in got}) == 1
    want_loss, want = _jax_loss_grads(cfg, init, tokens)
    assert got[0]["loss"] == pytest.approx(want_loss, rel=LOSS_RTOL)
    grads = got[0]["grads"]
    assert grads.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)
    if cfg.get("experts"):
        assert np.abs(grads["h/block/moe/gate/kernel"]).max() > 0


def test_pipeline_validate_errors():
    """``validate()`` and the pipeline loss refuse what the JAX ones
    refuse, with the JAX messages; a world that is not data x stage
    raises naming both."""
    bad = [
        dict(stage_axis=2, tensor_axis=2),
        dict(stage_axis=2, seq_axis=2),
        dict(stage_axis=2, expert_axis=2, experts=2),
        dict(stage_axis=2, accum_steps=2),
        dict(stage_axis=2, ema_decay=0.9),
    ]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            jgpt.GptTrainConfig(**kw).validate()
        with pytest.raises(ValueError) as terr:
            tgpt.GptTrainConfig(**kw).validate()
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="scan_layers"):
        gpt2_pipeline_loss(
            type("M", (), {"config": GPT2Config.small_test()})(),
            mesh=type("Mesh", (), {"shape": {"stage": 2},
                                   "coord": lambda self, a: 0})(),
            n_microbatches=2)
    with pytest.raises(ValueError, match="not divisible by stage=2"):
        stage_layers(3, 2, 0)
    with pytest.raises(ValueError, match="= 2 processes, but the world"):
        tgpt.train_gpt(tgpt.GptTrainConfig(**BASE, data_axis=1),
                       log=lambda m: None, device="cpu")
    with pytest.raises(ValueError, match="adafactor in pipeline mode"):
        tgpt.train_gpt(tgpt.GptTrainConfig(**BASE, data_axis=1,
                                           optimizer_name="adafactor"),
                       log=lambda m: None, device="cpu")
    specs = gpt2_pipeline_shardings({"h": {"block": {"k": np.zeros((2, 3))}},
                                     "wte": np.zeros((5, 3))})
    assert specs == {"h": {"block": {"k": ("stage", None)}},
                     "wte": (None, None)}


def _leaves(tree) -> dict:
    return {"/".join(p): t.numpy() for p, t in raw.flatten(tree)}


def _step_dir(ckpt_dir: str) -> str:
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    return os.path.join(ckpt_dir, f"step_{steps[-1]}")


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _train_both(tmp_path) -> tuple:
    """The pipeline leg (data 1 x stage 2, AdamW, 2 x 1 steps) in the port
    and in JAX from the same init: (port ranks' results, JAX's, the port's
    and JAX's newest step directories)."""
    cfg = {**BASE, "data_axis": 1, "microbatches": 2}
    init = _init_npz(tmp_path, stage_axis=2)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    got = spawn_world(2, "fsdp_train", cfg=cfg, ckpt_dir=port_dir,
                      init_npz=init)
    ref = run_jax(2, "train", str(tmp_path), cfg=cfg, ckpt_dir=jax_dir)
    return cfg, got, ref, _step_dir(port_dir), _step_dir(jax_dir)


def _jax_restored(tmp_path, devices: int, cfg: dict, src: str,
                  scan: bool = False) -> dict:
    npz = str(tmp_path / f"jax_restore_{devices}.npz")
    run_jax(devices, "restore", str(tmp_path), cfg=cfg, src=src,
            out_npz=npz, scan=scan)
    with np.load(npz) as z:
        return {k: z[k] for k in z.files}


def test_pipeline_train_gpt_matches_jax(tmp_path):
    """``train_gpt``'s pipeline leg (data 1 x stage 2, AdamW) against
    JAX's ``_train_pipeline``: the ranks' losses bit-equal, each step's
    loss within 1e-5 relative of JAX's, and the port's checkpoint,
    restored in JAX's pipeline leg, every leaf bit-equal to the port's
    whole leaves."""
    cfg, got, ref, port_step, _ = _train_both(tmp_path)
    assert got[0]["step_losses"] == got[1]["step_losses"]
    np.testing.assert_allclose(got[0]["loss_history"], ref["loss_history"],
                               rtol=LOSS_RTOL, atol=0)
    _equal(_jax_restored(tmp_path, 2, cfg, port_step),
           _leaves(raw.restore_raw(os.path.join(port_step, "state"))))


@pytest.mark.slow
def test_pipeline_checkpoints_cross_at_one_process(tmp_path):
    """The pipeline checkpoints restore at one process onto the
    scan-layers model in both packages ("checkpoints interchange with the
    non-pipelined scan model"), and JAX's restores in the port's pipeline
    leg (saved again), every leaf bit-equal."""
    cfg, _, _, port_step, jax_step = _train_both(tmp_path)
    port_whole = _leaves(raw.restore_raw(os.path.join(port_step, "state")))
    _equal(_jax_restored(tmp_path, 1, {**cfg, "stage_axis": 1}, port_step,
                         scan=True), port_whole)
    one = str(tmp_path / "one")
    spawn_world(1, "fsdp_resave", cfg={**cfg, "stage_axis": 1}, src=port_step,
                dst=one, scan=True)
    _equal(_leaves(raw.restore_raw(os.path.join(one, "step_1", "state"))),
           port_whole)
    back = str(tmp_path / "back")
    spawn_world(2, "fsdp_resave", cfg=cfg, src=jax_step, dst=back)
    _equal(_leaves(raw.restore_raw(os.path.join(back, "step_1", "state"))),
           _leaves(raw.restore_raw(os.path.join(jax_step, "state"))))


def test_pipeline_gang_flow_then_one_process_eval(tmp_path):
    """``TorchGptTrain --stage-axis 2 --microbatches 4`` as a gang of two
    members (data 1 x stage 2): the head's artifacts (finite losses, a
    2-process checkpoint in the scan layout); ``TorchGptEval`` restores
    the run at one process and scores a finite test loss."""
    from tpuflow_torch.flow import Run, store
    from tpuflow_torch.flows import gpt_eval_flow, gpt_flow

    home = store.set_home(str(tmp_path / "home"))
    try:
        port = ["--device", "cpu", "--home", home]
        run = Run(gpt_flow.main([
            "run", "--preset", "test", "--epochs", "1", "--steps-per-epoch",
            "2", "--seq-len", "32", "--data-axis", "1", "--fsdp-axis", "1",
            "--stage-axis", "2", "--microbatches", "4",
            "--dist-backend", "gloo", *port]))
        ckpt = run.data.result_checkpoint
        assert ckpt.metadata["process_count"] == 2
        assert run.data.model_config["scan_layers"]
        assert np.isfinite(run.data.loss_history).all()
        ev = Run(gpt_eval_flow.main(["run", "--checkpoint-run-pathspec",
                                     run.pathspec, *port]))
        assert np.isfinite(ev.data.test_loss)
    finally:
        store.set_home(None)
