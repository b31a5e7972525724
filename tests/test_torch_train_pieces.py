"""Port parity for the pieces of the GPT training slice: losses, the
optimizer factory, the LM data loaders, the resume cursor and validation.

Inputs are seeded numpy arrays handed to both packages. Tolerances:
- losses: atol 1e-5 (f32 log-softmax summed in another order);
- optimizer: atol 1e-6 on params of unit scale after three updates
  (the same f32 op order and f32 bias corrections; the port computes the
  scheduled learning rate in float64, optax in float32);
- schedules: rtol 1e-6 (float64 vs float32 arithmetic);
- data: bit-equal;
- validation: rtol 1e-6 on the mean token loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.data.lm import make_lm_loaders as j_make_lm_loaders
from tpuflow.models import losses as jlosses
from tpuflow.train import optim as joptim
from tpuflow.train.gpt import _resume_cursor as j_resume_cursor
from tpuflow.train.step import TrainState as JTrainState
from tpuflow.train.step import make_eval_step as j_make_eval_step
from tpuflow.train.step import per_worker_batch_size as j_per_worker
from tpuflow.train.step import run_validation as j_run_validation
from tpuflow_torch.data.lm import lm_corpus_size, make_lm_loaders
from tpuflow_torch.models import losses as tlosses
from tpuflow_torch.train import optim as toptim
from tpuflow_torch.train.gpt import _resume_cursor
from tpuflow_torch.train.step import (
    TrainState,
    make_eval_step,
    per_worker_batch_size,
    run_validation,
)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :4] = logits[0, :4].argmax(-1)  # some hits for accuracy
    want = float(jlosses.cross_entropy_loss(jnp.asarray(logits),
                                            jnp.asarray(labels)))
    got = tlosses.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    assert abs(float(got) - want) < 1e-5
    assert float(tlosses.accuracy(torch.from_numpy(logits),
                                  torch.from_numpy(labels))) == \
        float(jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_optax(schedule, warmup):
    kw = dict(warmup_steps=warmup, decay_steps=7, schedule=schedule,
              final_scale=0.1)
    j = joptim.make_schedule(3e-4, **kw)
    t = toptim.make_schedule(3e-4, **kw)
    for count in range(14):
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"count {count}")


@pytest.mark.parametrize("name", ["adamw", "sgd", "lion", "adafactor"])
def test_optimizer_matches_optax(name):
    """Three updates with a cosine schedule after one warmup step and a
    global-norm clip that triggers: params after every update, and the
    health statistics, match optax through the JAX factory."""
    rng = np.random.default_rng(1)
    shapes = [(5, 4), (4,), (3, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    kw = dict(optimizer=name, weight_decay=1e-2, grad_clip_norm=0.5,
              warmup_steps=1, decay_steps=4, schedule="cosine")
    tx = joptim.make_optimizer(0.1, **kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = toptim.make_optimizer(tp, 0.1, **kw)
    for g in grads:
        jg = [jnp.asarray(x) for x in g]
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        tu = opt.update([torch.from_numpy(x) for x in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
        jh = joptim.health_stats(jnp.float32(1.0), jg, updates, jp)
        th = toptim.health_stats(torch.tensor(1.0),
                                 [torch.from_numpy(x) for x in g], tu, tp)
        for key in ("grad_norm", "update_norm", "param_norm", "nonfinite"):
            np.testing.assert_allclose(float(th[key]), float(jh[key]),
                                       rtol=1e-5, err_msg=key)
    assert opt.count == 3
    bad = toptim.health_stats(torch.tensor(float("nan")), tu, tu, tp)
    assert float(bad["nonfinite"]) == 1.0


def test_unported_optimizers_raise():
    """Lion and Adafactor are ported (their parity:
    tests/test_torch_optim_recipes.py); an optimizer neither package has
    raises, as does a clip at or below 0."""
    p = [torch.zeros(2)]
    for name in ("adafactor", "lion"):
        assert toptim.make_optimizer(p, 1e-3, optimizer=name).kind == name
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer(p, 1e-3, optimizer="adagrad")
    with pytest.raises(ValueError, match="grad_clip_norm"):
        toptim.make_optimizer(p, 1e-3, grad_clip_norm=-1.0)


def test_lm_loaders_bit_equal_to_jax(tmp_path, monkeypatch):
    """Two epochs of the shuffled train loader and the padded, masked
    validation tail: the same batches bit for bit."""
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path))
    args = (4, 5, 16, 97)  # batch, steps, seq_len, vocab
    jtrain, jval = j_make_lm_loaders(*args)
    ttrain, tval = make_lm_loaders(*args)
    assert lm_corpus_size(4, 5) == 20
    for epoch in range(2):
        jtrain.set_epoch(epoch)
        ttrain.set_epoch(epoch)
        jb, tb = list(jtrain), list(ttrain)
        assert len(jb) == len(tb) == len(ttrain) == 5
        for a, b in zip(jb, tb):
            for key in ("x", "y", "mask"):
                np.testing.assert_array_equal(a[key], b[key])
                assert a[key].dtype == b[key].dtype
    jb, tb = list(jval), list(tval)
    assert len(tb) == 1 and tb[0]["mask"].tolist() == [1, 1, 0, 0]
    for key in ("x", "y", "mask"):
        np.testing.assert_array_equal(jb[0][key], tb[0][key])
    # Mid-epoch skip replays the epoch's tail.
    ttrain.set_epoch(1)
    ttrain.skip_batches(3)
    tail = list(ttrain)
    assert len(tail) == 2
    np.testing.assert_array_equal(tail[0]["x"], list(jtrain)[3]["x"])
    assert ttrain.state_dict(3) == {"epoch": 1, "batch_index": 3, "seed": 0}


def test_lm_text_and_unknown_datasets_raise(tmp_path):
    """lm_text loads (its parity: tests/test_torch_lm_text.py) and raises
    on a requested file that is missing and on a vocab under 256; an
    unknown dataset raises."""
    train, _ = make_lm_loaders(4, 2, 16, 300, dataset="lm_text")
    assert next(iter(train))["x"].shape == (4, 16)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        make_lm_loaders(4, 2, 16, 300, dataset="lm_text",
                        text_path=str(tmp_path / "missing.txt"))
    with pytest.raises(ValueError, match="byte-level"):
        make_lm_loaders(4, 2, 16, 200, dataset="lm_text")
    with pytest.raises(ValueError, match="unknown dataset"):
        make_lm_loaders(4, 2, 16, 300, dataset="imagenet")


def test_resume_cursor_matches_jax():
    states = [None, {}, {"seed": 1, "epoch": 1, "batch_index": 2},
              {"seed": 0, "epoch": 1, "batch_index": 2},
              {"seed": 0, "epoch": 1, "batch_index": 4},
              {"seed": 0, "epoch": 3, "batch_index": 9},
              {"seed": 0, "epoch": 0, "batch_index": -1}]
    for ds in states:
        for step in (0, 3, 4, 11, 40):
            for seed in (0, 1):
                args = (ds, step, 4, 3, seed)
                assert _resume_cursor(*args) == j_resume_cursor(*args), args


def test_per_worker_batch_size_matches_jax():
    for g, n in ((8, 2), (9, 4), (8, 8)):
        assert per_worker_batch_size(g, n) == j_per_worker(g, n)
    with pytest.raises(ValueError, match="too small"):
        per_worker_batch_size(3, 4)


def test_run_validation_with_mask_matches_jax(tmp_path, monkeypatch):
    """A padded, masked tail batch: the eval step's sums and the mean token
    loss over the loader equal the JAX eval path on the same weights."""
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path))
    jm, params, tm = jax_and_port_gpt2()
    _, jval = j_make_lm_loaders(3, 12, 16, 512)  # 36 docs: 4 val, tail 1
    _, tval = make_lm_loaders(3, 12, 16, 512)
    assert [b["mask"].tolist() for b in tval] == [[1, 1, 1], [1, 0, 0]]
    jstate = JTrainState.create(apply_fn=jm.apply, params=params,
                                tx=optax.sgd(0.1))
    tstate = TrainState(model=tm, tx=toptim.make_optimizer(
        tm.parameters(), 0.1, optimizer="sgd"))
    want = j_run_validation(jstate, jval, j_make_eval_step())
    got = run_validation(tstate, tval, make_eval_step())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    b = next(iter(tval))
    batch = {"x": b["x"], "y": b["y"],
             "mask": np.broadcast_to(b["mask"][:, None],
                                     b["y"].shape).astype(np.float32)}
    jm_ = j_make_eval_step()(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    tm_ = make_eval_step()(tstate, batch)
    for key in ("loss_sum", "num_correct", "count"):
        np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                   rtol=1e-6, err_msg=key)
