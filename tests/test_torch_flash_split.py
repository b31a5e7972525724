"""Port parity for the split flash backward pair
(tpuflow_torch.ops.flash_attention: ``flash_bwd_dq_split`` and
``flash_bwd_dkv_split``, which recompute D = rowsum(dO o O) on every block
visit and whose dk/dv reads O) and for the ``bwd`` choice of
``flash_attention``.

The same seeded numpy inputs go through the JAX ``_flash_bwd_split``, its
Pallas kernels run in interpret mode as the JAX package's own tests run
them (T a multiple of block_q = block_k = 16), and through the port's CPU
path (the kernels' plain versions), from the same O and lse.

Tolerances:
- against JAX: ``GRAD_TOL`` of test_torch_flash_bwd.py (f32: the same
  products summed in another order; bf16: P and dS rounded to bf16 at f32
  values that differ in their last bits, outputs rounded to bf16);
- split against fused in the port: bit for bit (atol 0) — D is the same f32
  value whether it is recomputed or read back;
- ``bwd="blockwise"`` (autograd through the plain forward) against the
  default: atol 2e-5 + rtol 1e-5, another summation order.
Bit-equal comparisons run on one CPU thread: several threads may split a
CPU matmul's sums differently from one call to the next.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_bwd import GRAD_TOL
from torch_parity import jax_and_port_gpt2
from tpuflow.ops import flash_attention as jfa
from tpuflow.train.optim import make_optimizer as j_make_optimizer
from tpuflow.train.step import TrainState as JTrainState
from tpuflow.train.step import make_train_step as j_make_train_step
from tpuflow_torch.data.lm import make_lm_loaders
from tpuflow_torch.models.convert import params_from_jax
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
from tpuflow_torch.models.losses import cross_entropy_loss
from tpuflow_torch.ops import flash_attention as tfa
from tpuflow_torch.train.optim import make_optimizer
from tpuflow_torch.train.step import TrainState, make_train_step

BLOCK = 16
SHAPE = (2, 64, 2, 32)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    counters = ("launches_bwd_dq", "launches_bwd_dkv",
                "launches_bwd_dq_split", "launches_bwd_dkv_split")
    before = [getattr(tfa, c) for c in counters]
    yield
    # A CPU call takes the plain versions and never counts a launch.
    assert [getattr(tfa, c) for c in counters] == before


def _arrays(seed, n=4, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_split_plain_matches_jax_split_interpret(causal, dtype):
    """flash_bwd_dq_split_plain and flash_bwd_dkv_split_plain against the
    JAX _flash_bwd_split (its _bwd_dq_kernel and _bwd_dkv_kernel in
    interpret mode), both from the JAX forward's O and lse."""
    q, k, v, g = (jnp.asarray(x).astype(getattr(jnp, dtype))
                  for x in _arrays(0))
    o, lse = jfa._flash_fwd(q, k, v, causal, BLOCK, BLOCK, True,
                            with_lse=True)
    want = jfa._flash_bwd_split(q, k, v, o, lse, g, causal, BLOCK, BLOCK,
                                True)
    tq, tk, tv, to, tg = (torch.from_numpy(_np(x)).to(getattr(torch, dtype))
                          for x in (q, k, v, o, g))
    tlse = torch.from_numpy(np.asarray(lse)[..., 0].copy())
    dq = tfa.flash_bwd_dq_split_plain(tq, tk, tv, to, tlse, tg,
                                      causal=causal)
    dk, dv = tfa.flash_bwd_dkv_split_plain(tq, tk, tv, to, tlse, tg,
                                           causal=causal)
    atol, rtol = GRAD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert a.dtype == tq.dtype, name
        np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_k", [16, 512])
def test_split_plain_pair_bit_equal_to_fused(one_thread, causal, dtype,
                                             block_k):
    """The split plain pair (D per key chunk, dk/dv from O) gives the fused
    plain pair's bits, with one key chunk or several."""
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(x).to(dt) for x in _arrays(1))
    o, lse = tfa.flash_fwd_lse(q, k, v, causal=causal)
    dq, delta = tfa.flash_bwd_dq_plain(q, k, v, o, lse, g, causal=causal,
                                       block_k=block_k)
    dk, dv = tfa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal,
                                     block_k=block_k)
    sdq = tfa.flash_bwd_dq_split_plain(q, k, v, o, lse, g, causal=causal,
                                       block_k=block_k)
    sdk, sdv = tfa.flash_bwd_dkv_split_plain(q, k, v, o, lse, g,
                                             causal=causal, block_k=block_k)
    for name, a, b in (("dq", sdq, dq), ("dk", sdk, dk), ("dv", sdv, dv)):
        assert torch.equal(a, b), name
    # The dispatch functions take the plain versions for CPU tensors.
    for a, b in zip(tfa.flash_bwd_split(q, k, v, o, lse, g, causal=causal),
                    tfa.flash_bwd_plain(q, k, v, o, lse, g, causal=causal)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_modes_on_cpu(one_thread, causal):
    """flash_attention(bwd='split') gives the default (fused) gradients bit
    for bit; bwd='blockwise' (autograd through the plain forward, no
    backward kernel) within another summation order's tolerance; an
    unknown mode raises, and so does blockwise off the CPU."""
    q, k, v, g = (torch.from_numpy(x) for x in _arrays(2))
    grads = {}
    for bwd in tfa.BWD_MODES:
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = tfa.flash_attention(*xs, causal=causal, bwd=bwd)
        grads[bwd] = torch.autograd.grad(out, xs, g)
    for a, b in zip(grads["split"], grads["fused"]):
        assert torch.equal(a, b)
    for a, b in zip(grads["blockwise"], grads["fused"]):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="fused\\|split\\|blockwise"):
        tfa.flash_attention(q, k, v, bwd="unfused")
    qm = q.to("meta").requires_grad_()
    with pytest.raises(ValueError, match="CPU reference"):
        tfa.flash_attention(qm, qm, qm, causal=causal, bwd="blockwise")


def test_gpt2_step_split_equals_fused(one_thread):
    """One forward+backward of the test-preset GPT-2 with
    GPT2Config(flash_bwd='split'): the loss and every gradient equal the
    fused config's, dropout on."""
    loader, _ = make_lm_loaders(4, 1, 32, 512)
    b = next(iter(loader))
    x, y = torch.from_numpy(b["x"]), torch.from_numpy(b["y"])
    out = {}
    for bwd in ("fused", "split"):
        cfg = GPT2Config.small_test(n_ctx=64, attn_impl="flash",
                                    flash_bwd=bwd)
        model = GPT2(cfg, seed=0, device="cpu")
        loss = cross_entropy_loss(model(x, train=True, rng=3), y)
        loss.backward()
        out[bwd] = (loss, [p.grad for p in model.parameters()])
    assert torch.equal(out["split"][0], out["fused"][0])
    for a, c in zip(out["split"][1], out["fused"][1]):
        assert torch.equal(a, c)


def test_train_steps_split_match_jax_split(monkeypatch):
    """Three SGD steps with the split backward on both sides (the JAX
    package's TPUFLOW_FLASH_BWD=split, the port's GPT2Config.flash_bwd):
    losses within atol 2e-5 and params within atol 1e-6, the limits of
    test_torch_train.py's three-step parity."""
    monkeypatch.setenv("TPUFLOW_FLASH_BWD", "split")
    jm, params, fused = jax_and_port_gpt2(attn_impl="flash")
    tm = GPT2(dataclasses.replace(fused.config, flash_bwd="split"),
              device="cpu")
    tm.load_state_dict(fused.state_dict())
    loader, _ = make_lm_loaders(4, 3, 32, 512)
    jstate = JTrainState.create(apply_fn=jm.apply, params=params,
                                tx=j_make_optimizer(0.1, optimizer="sgd"))
    jstep = j_make_train_step(donate=False)
    tstate = TrainState(model=tm, tx=make_optimizer(tm.parameters(), 0.1,
                                                    optimizer="sgd"))
    tstep = make_train_step()
    n = tfa.launches_bwd_dq_split
    calls = []
    real = tfa.flash_bwd_split
    monkeypatch.setattr(tfa, "flash_bwd_split",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for b in loader:
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(b[k]) for k in "xy"},
                            jax.random.PRNGKey(1))
        tstate, tm_ = tstep(tstate, b, 1)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   atol=2e-5, rtol=0)
    assert len(calls) == 3 * tm.config.n_layer
    assert tfa.launches_bwd_dq_split == n
    want = params_from_jax(jax.device_get(jstate.params))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
