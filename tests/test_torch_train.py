"""Port parity for the GPT training slice as a whole: the model's training
modes, the train step against JAX ``make_train_step``, and ``train_gpt``.

Both packages start from the same weights (JAX-initialised, moved into the
port through ``params_from_jax``) and see the same seeded lm_synth batches,
with dropout off (masks cannot match across frameworks). With
``attn_impl='flash'`` the JAX model runs its Pallas kernels in interpret
mode and the port its kernels' plain versions. Tolerances:
- per-step losses: atol 2e-5 (f32 through a 2-layer model, summed in
  another order);
- params after three SGD steps (lr 0.1, momentum 0.9, linear in the
  gradients): atol 1e-6;
- params after three AdamW steps (lr 3e-4): atol 1e-6 for all but 0.1% of
  the elements, and 3e-3 for every element. Adam divides each gradient
  by its own magnitude, so where the gradient is float noise around an
  exact 0 (the key bias, to which the softmax is invariant; single
  elements of wte) the two sides' noise becomes updates of up to ~3.2 lr
  per step in either direction;
- the bf16 LM head: atol 1e-6 — both sides multiply the same bf16-rounded
  operands exactly in f32 and differ only in summation order, while the
  old expression (f32 wte) misses by ~1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2
from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow.models.gpt2 import GPT2Config as JConfig
from tpuflow.models.losses import cross_entropy_loss as j_cross_entropy_loss
from tpuflow.train import gpt as jgpt
from tpuflow.train.optim import make_optimizer as j_make_optimizer
from tpuflow.train.step import TrainState as JTrainState
from tpuflow.train.step import make_train_step as j_make_train_step
from tpuflow_torch.data.lm import make_lm_loaders
from tpuflow_torch.models import gpt2 as tgpt2
from tpuflow_torch.models.convert import params_from_jax
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
from tpuflow_torch.models.losses import cross_entropy_loss
from tpuflow_torch.ops import flash_attention as tfa
from tpuflow_torch.train import gpt as tgpt
from tpuflow_torch.train.optim import make_optimizer
from tpuflow_torch.train.step import TrainState, make_train_step, with_ema


def _batches(n, batch=4, seq=32, vocab=512):
    loader, _ = make_lm_loaders(batch, n, seq, vocab)
    return list(loader)


def test_bf16_head_matches_jax_op_order():
    """The tied head rounds wte to the compute dtype before the product and
    keeps f32 logits, as the JAX einsum does; the old port expression
    (product with the f32 wte) misses the same limit. f32 (every serving
    default) is unchanged."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 5, 128)), jnp.bfloat16)
    wte = (rng.standard_normal((512, 128)) * 0.02).astype(np.float32)
    want = np.asarray(jnp.einsum("btc,vc->btv", x, jnp.asarray(wte).astype(
        jnp.bfloat16), preferred_element_type=jnp.float32))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    tw = torch.from_numpy(wte)
    got = tgpt2._tied_head(tx, tw, torch.bfloat16, rowwise=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    rows = tgpt2._tied_head(tx, tw, torch.bfloat16, rowwise=True)
    np.testing.assert_allclose(rows.numpy(), want, atol=1e-6, rtol=0)
    old = torch.nn.functional.linear(tx.float(), tw).numpy()
    assert np.abs(old - want).max() > 1e-5
    x32 = tx.float()
    assert torch.equal(tgpt2._tied_head(x32, tw, torch.float32, False),
                       torch.nn.functional.linear(x32, tw))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("mode", ["full", "dots", "none"])
def test_remat_modes_match_no_remat(impl, mode):
    """Every remat selector gives the same loss and gradients as remat off,
    with dropout on: the seeded dropout masks replay exactly when a block
    is recomputed."""
    cfg = GPT2Config.small_test(n_ctx=64, attn_impl=impl)
    x = torch.from_numpy(_batches(1)[0]["x"])
    y = torch.from_numpy(_batches(1)[0]["y"])
    out = {}
    for m, c in (("off", cfg),
                 (mode, tgpt._apply_remat_selector(cfg, mode))):
        model = GPT2(c, seed=0, device="cpu")
        loss = cross_entropy_loss(model(x, train=True, rng=5), y)
        loss.backward()
        out[m] = (loss, [p.grad for p in model.parameters()])
    assert torch.equal(out["off"][0], out[mode][0])
    for a, b in zip(out["off"][1], out[mode][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,calls", [("full", 4), ("dots", 2), ("none", 2)])
def test_dots_policy_saves_the_flash_forward(monkeypatch, mode, calls):
    """Full remat re-runs each layer's flash forward (with lse) in the
    backward; 'dots' saves its outputs, like 'none'."""
    count = []
    real = tfa.flash_fwd_lse
    monkeypatch.setattr(tfa, "flash_fwd_lse",
                        lambda *a, **kw: count.append(1) or real(*a, **kw))
    cfg = tgpt._apply_remat_selector(
        GPT2Config.small_test(n_ctx=64, attn_impl="flash"), mode)
    model = GPT2(cfg, seed=0, device="cpu")
    b = _batches(1)[0]
    loss = cross_entropy_loss(
        model(torch.from_numpy(b["x"]), train=True, rng=1),
        torch.from_numpy(b["y"]))
    loss.backward()
    assert len(count) == calls


def test_seeded_dropout():
    """Dropout draws from fold_in(rng, site): the same rng gives the same
    masks, another rng other masks; train=False is deterministic."""
    model = GPT2(GPT2Config.small_test(n_ctx=64), seed=0, device="cpu")
    x = torch.from_numpy(_batches(1)[0]["x"])
    with torch.no_grad():
        a = model(x, train=True, rng=3)
        b = model(x, train=True, rng=3)
        c = model(x, train=True, rng=4)
        d = model(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)
    assert tgpt2.fold_in(3, 1) != tgpt2.fold_in(3, 2) != tgpt2.fold_in(4, 1)


@pytest.mark.parametrize("opt,lr", [("adamw", 3e-4), ("sgd", 0.1)])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_three_train_steps_match_jax(impl, opt, lr):
    """Three make_train_step steps on a 2-layer GPT-2 from the same weights
    and batches: per-step losses and the final params match the JAX
    step."""
    jm, params, tm = jax_and_port_gpt2(attn_impl=impl)
    batches = _batches(3)
    jstate = JTrainState.create(apply_fn=jm.apply, params=params,
                                tx=j_make_optimizer(lr, optimizer=opt))
    jstep = j_make_train_step(donate=False)
    tstate = TrainState(model=tm, tx=make_optimizer(tm.parameters(), lr,
                                                    optimizer=opt))
    tstep = make_train_step()
    for b in batches:
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(b[k]) for k in "xy"},
                            jax.random.PRNGKey(1))
        tstate, tm_ = tstep(tstate, b, 1)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   atol=2e-5, rtol=0)
        for key in ("accuracy", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-4, err_msg=key)
    assert tstate.step == int(jstate.step) == 3
    want = params_from_jax(jax.device_get(jstate.params))
    diffs = np.concatenate([
        np.abs(p.numpy() - want[name].numpy()).ravel()
        for name, p in tm.state_dict().items()
    ])
    if opt == "sgd":
        assert diffs.max() <= 1e-6
    else:
        assert (diffs > 1e-6).mean() < 1e-3 and diffs.max() <= 3e-3


def test_accum_steps_match_the_full_batch_step():
    """accum_steps=2 (two microbatches, gradients summed then halved) gives
    the full-batch step's loss and params (SGD: linear in the gradients,
    atol 1e-6); EMA follows the params."""
    b = _batches(2)
    out = {}
    for accum in (1, 2):
        model = GPT2(GPT2Config.small_test(n_ctx=64, dropout=0.0), seed=0,
                     device="cpu")
        state = with_ema(TrainState(model=model, tx=make_optimizer(
            model.parameters(), 0.1, optimizer="sgd")))
        step = make_train_step(accum_steps=accum, ema_decay=0.9)
        losses = [float(step(state, x, 1)[1]["loss"]) for x in b]
        out[accum] = (losses, [p.detach().clone() for p in state.params],
                      state.ema_params)
    np.testing.assert_allclose(out[2][0], out[1][0], atol=1e-6, rtol=0)
    for a, c in zip(out[2][1], out[1][1]):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=0)
    for a, c in zip(out[2][2], out[1][2]):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="equal microbatches"):
        make_train_step(accum_steps=3)(state, b[0], 1)
    with pytest.raises(ValueError, match="ema_decay"):
        make_train_step(ema_decay=1.0)


def test_train_gpt_fast():
    """train_gpt on the test preset, 2 epochs x 4 steps: losses fall, the
    histories have the JAX leg's shape, and the greedy sample runs."""
    cfg = tgpt.GptTrainConfig(preset="test", epochs=2, steps_per_epoch=4,
                              data_axis=1, fsdp_axis=1, sample_tokens=3,
                              learning_rate=1e-3)
    logs = []
    res = tgpt.train_gpt(cfg, log=logs.append, device="cpu")
    assert res.checkpoint is None and len(res.loss_history) == 2
    assert res.loss_history[1] < res.loss_history[0]
    assert len(res.step_losses) == len(res.step_s) == 8
    assert all(np.isfinite(res.step_losses))
    assert [set(r) for r in res.metrics_history] == [
        {"epoch", "train_loss", "val_loss", "ppl", "tokens_per_s"}] * 2
    assert res.metrics_history[1]["tokens_per_s"] > 0
    assert len(res.sample) == 3 and all(0 <= t < 512 for t in res.sample)
    assert any("epoch 1" in m for m in logs)


def test_gpt_train_config_matches_jax():
    """The same fields and defaults as the JAX config; model_config maps
    onto the port's GPT2Config the same way."""
    j = {f.name: f.default for f in dataclasses.fields(jgpt.GptTrainConfig)}
    t = {f.name: f.default for f in dataclasses.fields(tgpt.GptTrainConfig)}
    assert j == t
    for kw in ({}, {"preset": "gpt2", "dtype": "bfloat16"},
               {"remat_policy": "dots"}, {"remat_policy": "none",
                                          "preset": "gpt2"}):
        jc = jgpt.GptTrainConfig(**kw).model_config()
        tc = tgpt.GptTrainConfig(**kw).model_config()
        for f in ("n_layer", "n_embd", "n_ctx", "vocab_size", "dropout",
                  "remat", "remat_policy", "attn_impl", "scan_layers"):
            assert getattr(tc, f) == getattr(jc, f), (kw, f)
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
        assert tgpt.active_remat_policy(tc) == jgpt.active_remat_policy(jc)
    with pytest.raises(ValueError, match="full\\|dots\\|none"):
        tgpt.GptTrainConfig(remat_policy="offload_dot").model_config()


@pytest.mark.parametrize("kw,match", [
    ({"data_axis": 2, "fsdp_axis": 2}, "data_axis=2 x fsdp_axis=2"),
    ({"tensor_axis": 2}, "tensor_axis=2"),
    ({"stage_axis": 2}, "pipeline"),
    ({"experts": 2}, "MoE"),
    ({"seq_axis": 2}, "seq_axis=2"),
    ({"dataset": "lm_text"}, "lm_text"),
    ({"optimizer_name": "lion"}, "lion"),
    ({"optimizer_name": "adafactor"}, "adafactor"),
])
def test_train_gpt_deferred_config_raises(kw, match):
    cfg = tgpt.GptTrainConfig(**{"data_axis": 1, "fsdp_axis": 1,
                                 "steps_per_epoch": 1, "epochs": 1, **kw})
    with pytest.raises(NotImplementedError, match=match) as err:
        tgpt.train_gpt(cfg, log=lambda m: None, device="cpu")
    assert "ROADMAP" in str(err.value)


@pytest.mark.parametrize("kw,match", [
    # Checkpointing runs; what still raises does so before the checkpoint
    # directory or the handle is touched.
    ({"ckpt_dir": "/nonexistent", "preemption": True}, "preemption"),
    ({"resume_checkpoint": object(), "health": True}, "health"),
    ({"health": True}, "health"),
    ({"preemption": True}, "preemption"),
    ({"elastic": True}, "elastic"),
])
def test_train_gpt_deferred_arguments_raise(kw, match):
    cfg = tgpt.GptTrainConfig(data_axis=1, fsdp_axis=1)
    with pytest.raises(NotImplementedError, match=match):
        tgpt.train_gpt(cfg, log=lambda m: None, device="cpu", **kw)


@pytest.mark.slow
def test_train_gpt_matches_jax_train_gpt(tmp_path, monkeypatch):
    """Slow (the JAX leg compiles its sharded step on an 8-device CPU
    mesh): the JAX train_gpt on data 4 x fsdp 2 against the port's on one
    device, same init and batches, dropout off on both sides. Loss and
    validation histories agree within atol 1e-4 (f32 over 16 AdamW steps
    on a 2-layer model; the sharded reductions sum in another order)."""
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path / "data"))
    for mod in (jgpt, tgpt):
        real = mod.GptTrainConfig.model_config
        monkeypatch.setattr(
            mod.GptTrainConfig, "model_config",
            lambda self, real=real: dataclasses.replace(real(self),
                                                        dropout=0.0),
        )
    kw = dict(preset="test", epochs=2, steps_per_epoch=8, seq_len=32,
              batch_size=8)
    jres = jgpt.train_gpt(
        jgpt.GptTrainConfig(data_axis=4, fsdp_axis=2, **kw),
        str(tmp_path / "ckpt"), log=lambda m: None,
    )
    jcfg = jgpt.GptTrainConfig(**kw).model_config()
    init = JGPT2(jcfg).init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]

    def from_jax(model_cfg, device):
        m = GPT2(model_cfg, seed=0, device=device)
        m.load_state_dict(params_from_jax(jax.device_get(init)))
        return m

    monkeypatch.setattr(tgpt, "_init_model", from_jax)
    tres = tgpt.train_gpt(
        tgpt.GptTrainConfig(data_axis=1, fsdp_axis=1, **kw),
        log=lambda m: None, device="cpu",
    )
    np.testing.assert_allclose(tres.loss_history, jres.loss_history,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        [r["val_loss"] for r in tres.metrics_history],
        [r["val_loss"] for r in jres.metrics_history], atol=1e-4, rtol=0,
    )


def test_bf16_flash_step_matches_jax():
    """One bf16 forward+backward of a 2-layer GPT-2 with flash attention,
    from the same weights and batch: the port's kernels' plain versions
    against the JAX Pallas kernels in interpret mode (the path
    ``GptTrainConfig(dtype="bfloat16")`` trains on). Every activation and
    product rounds to bf16 on both sides, at other places in the two
    frameworks (XLA fuses and rounds its own way), so the limits are
    bf16-scale, about twice to ten times the readings (loss 1e-4 apart,
    the worst gradient, a bias of the MLP, 2.9e-2 of its max |g|): loss
    atol 1e-3, every gradient tensor within 5e-2 of its own max |g|."""
    kw = dict(n_ctx=64, dropout=0.0, attn_impl="flash")
    jm = JGPT2(JConfig.small_test(dtype=jnp.bfloat16, **kw))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = GPT2(GPT2Config.small_test(dtype=torch.bfloat16, **kw),
              device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    b = _batches(1)[0]

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(b["x"]), train=True,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        return j_cross_entropy_loss(logits, jnp.asarray(b["y"]))

    jl, jg = jax.value_and_grad(jloss)(params)
    n = (tfa.launches_bwd_dq_bf16, tfa.launches_bwd_dkv_bf16)
    tl = cross_entropy_loss(tm(torch.from_numpy(b["x"]), train=True, rng=1),
                            torch.from_numpy(b["y"]))
    tl.backward()
    # The CPU takes the plain versions: no kernel launch is counted.
    assert (tfa.launches_bwd_dq_bf16, tfa.launches_bwd_dkv_bf16) == n
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-3, rtol=0)
    want = params_from_jax(jax.device_get(jg))
    worst = 0.0
    for name, p in tm.named_parameters():
        g, w = p.grad.float(), want[name].float()
        assert torch.isfinite(g).all(), name
        worst = max(worst, float((g - w).abs().max() / w.abs().max()))
    assert worst <= 5e-2
