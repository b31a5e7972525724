"""Port parity for the training half of flash attention: the forward with
lse and the fused backward pair (tpuflow_torch.ops.flash_attention).

The same seeded numpy inputs go through the JAX Pallas kernels, run in
interpret mode as the JAX package's own tests run them (T a multiple of
block_q = block_k = 16, so the kernels themselves run, over several
blocks), and through the port's CPU path (its kernels' plain versions).

Tolerances:
- lse and D (f32, same math): atol 1e-5 — f32 sums in another order.
- gradients, f32: atol 2e-5 + rtol 1e-5 — the same products summed in
  another order (the JAX kernels walk 16-wide blocks, the port 512-wide
  chunks).
- gradients, bf16: atol 1e-2 + rtol 1.6e-2 — both round P and dS to bf16
  before the products that take them, at f32 values that differ in their
  last bits, and round the outputs to bf16 (2^-8 relative): two bf16
  ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.ops import flash_attention as jfa
from tpuflow_torch.ops import flash_attention as tfa
from tpuflow_torch.ops.attention import xla_attention
from torch_parity import one_torch_thread  # noqa: F401

BLOCK = 16
SHAPE = (2, 64, 2, 32)
GRAD_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-2, 1.6e-2)}


def _arrays(seed, n=4, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _torch(x, dtype, grad=False):
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t.requires_grad_() if grad else t


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not torch.is_tensor(x) else x.detach().float().numpy()


@pytest.fixture(autouse=True)
def _counters_zero():
    tfa.launches = tfa.launches_lse = 0
    tfa.launches_bwd_dq = tfa.launches_bwd_dkv = 0
    yield
    # A CPU call takes the plain versions and never counts a launch.
    assert (tfa.launches, tfa.launches_lse, tfa.launches_bwd_dq,
            tfa.launches_bwd_dkv) == (0, 0, 0, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_pallas_interpret(causal, dtype):
    """The port's compact (B*H, Tq) lse equals lane 0 of the JAX kernel's
    (B*H, Tq, 128) lane-broadcast residual; the outputs agree too."""
    q, k, v = _arrays(0, 3)
    jo, jlse = jfa._flash_fwd(*(_jax(x, dtype) for x in (q, k, v)), causal,
                              BLOCK, BLOCK, True, with_lse=True)
    to, tlse = tfa.flash_fwd_lse(*(_torch(x, dtype) for x in (q, k, v)),
                                 causal=causal)
    assert tlse.shape == (SHAPE[0] * SHAPE[2], SHAPE[1])
    assert tlse.dtype == torch.float32 and to.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               atol=1e-5, rtol=0)
    # Outputs: f32 summation order; bf16 two bf16 ulps, and an atol for
    # rows near 0: both round P to bf16 before P.V, but at the running
    # max of their own key tiles (16 here, 64 for the port).
    tol = dict(atol=1e-5, rtol=0) if dtype == "float32" else \
        dict(atol=4e-3, rtol=8e-3)
    np.testing.assert_allclose(_np(to), _np(jo), **tol)


def test_row_delta_matches_jax_fused_residual(monkeypatch):
    """D = rowsum(dO o O) equals lane 1 of the packed residual the JAX
    fused dq kernel writes for the dk/dv kernel (lane 0 keeps lse)."""
    q, k, v, g = _arrays(1)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, True, BLOCK, BLOCK, True,
                              with_lse=True)
    outputs = []
    real = jfa.pl.pallas_call

    def spy(*args, **kw):
        call = real(*args, **kw)

        def run(*operands):
            out = call(*operands)
            outputs.append(out)
            return out

        return run

    monkeypatch.setattr(jfa.pl, "pallas_call", spy)
    jfa._flash_bwd_fused(jq, jk, jv, jo, jlse, jg, True, BLOCK, BLOCK, True)
    _, res = outputs[0]  # the dq kernel's (dq, packed residual)
    res = np.asarray(res)
    got = tfa.row_delta(torch.from_numpy(np.array(jo)),
                        torch.from_numpy(g))
    assert got.shape == res.shape[:2]
    np.testing.assert_allclose(got.numpy(), res[..., 1], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(res[..., 0], np.asarray(jlse)[..., 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_jax_pallas_interpret(causal, dtype):
    """Gradients through the port's autograd Function (lse forward, then
    the fused pair's plain versions) against jax.vjp through the JAX
    flash_attention (Pallas forward with lse, fused dq and dk/dv kernels)
    with the same random cotangent."""
    q, k, v, g = _arrays(2)
    _, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(
            q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK
        ),
        *(_jax(x, dtype) for x in (q, k, v)),
    )
    want = vjp(_jax(g, dtype))
    tq, tk, tv = (_torch(x, dtype, grad=True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), _torch(g, dtype))
    atol, rtol = GRAD_TOL[dtype]
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tq.dtype, name
        np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_grads_match_einsum_autograd(causal):
    """A T that no tile divides (the kernels mask it; the plain versions
    take a shorter last chunk): gradients equal autograd through the
    einsum attention."""
    q, k, v, g = _arrays(3, shape=(1, 40, 3, 32))
    tq, tk, tv = (_torch(x, "float32", grad=True) for x in (q, k, v))
    do = torch.from_numpy(g)
    got = torch.autograd.grad(tfa.flash_attention(tq, tk, tv, causal=causal),
                              (tq, tk, tv), do)
    want = torch.autograd.grad(xla_attention(tq, tk, tv, causal=causal),
                               (tq, tk, tv), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5)


def test_plain_pair_splits_like_the_kernels():
    """flash_bwd runs dq (with D) then dk/dv from (lse, D) without O: the
    composition equals flash_bwd_plain, and a small key chunk (several
    chunks, like the kernels' tiles) gives the same gradients."""
    q, k, v, g = (torch.from_numpy(x) for x in _arrays(4))
    o, lse = tfa.flash_fwd_lse(q, k, v)
    dq, delta = tfa.flash_bwd_dq(q, k, v, o, lse, g, causal=True)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True)
    for a, b in zip((dq, dk, dv), tfa.flash_bwd_plain(q, k, v, o, lse, g,
                                                      causal=True)):
        assert torch.equal(a, b)
    dq16, _ = tfa.flash_bwd_dq_plain(q, k, v, o, lse, g, causal=True,
                                     block_k=16)
    dk16, dv16 = tfa.flash_bwd_dkv_plain(q, k, v, g, lse, delta,
                                         causal=True, block_k=16)
    for a, b in ((dq16, dq), (dk16, dk), (dv16, dv)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_no_grad_takes_the_forward_without_lse(monkeypatch):
    """The autograd Function (and its lse forward) runs only when a
    gradient is needed; serving calls under no_grad never reach it."""
    calls = []
    real = tfa.flash_fwd_lse
    monkeypatch.setattr(tfa, "flash_fwd_lse",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _arrays(5, 3))
    with torch.no_grad():
        a = tfa.flash_attention(q, k, v)
    assert not calls and not a.requires_grad
    b = tfa.flash_attention(q, k, v)
    assert calls == [1] and b.requires_grad
    torch.testing.assert_close(a, b.detach(), atol=0, rtol=0)
