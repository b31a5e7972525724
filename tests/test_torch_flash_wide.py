"""Port parity for flash attention at wide head dims (D > 256).

Above 256 the port's CUDA wrappers run the wide-head kernels at D
rounded up to a multiple of 128 (``ops/flash_attention.py::_padded``:
320 runs at 384, 512 as it is). Here the same seeded numpy inputs go
through the JAX Pallas kernels in interpret mode, as the JAX package's
own tests run them (block_q = block_k = 16, so the kernels themselves run
over several blocks), and through the port's CPU path: the autograd
Function on CPU tensors, and the kernels' plain versions through
``_padded``, which is what the wrappers hand the kernels.

Tolerances (those of tests/test_torch_flash_bwd.py):
- lse: atol 1e-5 (f32; the same math summed in another order).
- D = rowsum(dO o O), port against the JAX output's: f32 atol 3e-5 +
  rtol 2e-6 (a sum of up to 512 products of order 1, of outputs that
  differ in their last f32 bits: about D * 2^-24 absolute after
  cancellation, and values up to ~20); bf16 atol 2e-2 + rtol 1.6e-2
  (outputs rounded to bf16).
- outputs: f32 atol 1e-5; bf16 atol 4e-3 + rtol 8e-3 (both round P to
  bf16 before P.V, at the running max of their own key tiles, and round
  the output to bf16: two bf16 ulps).
- gradients: f32 atol 2e-5 + rtol 1e-5 (the same products summed in
  another order: the JAX kernels walk 16-wide blocks, the port 512-wide
  chunks); bf16 atol 1e-2 + rtol 1.6e-2 (P and dS rounded to bf16 at f32
  values that differ in their last bits, outputs rounded to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.ops import flash_attention as jfa
from tpuflow_torch.ops import flash_attention as tfa

BLOCK = 16
OUT_TOL = {"float32": dict(atol=1e-5, rtol=0),
           "bfloat16": dict(atol=4e-3, rtol=8e-3)}
GRAD_TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
            "bfloat16": dict(atol=1e-2, rtol=1.6e-2)}
WIDE = [(320, 384), (512, 512)]  # (head dim, kernel width)


def _arrays(D, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 32, 2, D)).astype(np.float32)
            for _ in range(n)]


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _torch(x, dtype, grad=False):
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t.requires_grad_() if grad else t


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("D,width", WIDE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_forward_and_lse_match_jax_pallas_interpret(D, width, dtype,
                                                          causal):
    """The forward with lse: the port's CPU path and the padded plain
    version (the kernel's contract at its width) against the JAX Pallas
    forward; the padded output also equals the unpadded one within f32
    rounding."""
    assert tfa._kernel_dim(D) == width
    q, k, v = _arrays(D, D, 3)
    jo, jlse = jfa._flash_fwd(*(_jax(x, dtype) for x in (q, k, v)), causal,
                              BLOCK, BLOCK, True, with_lse=True)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    for o, lse in (tfa.flash_fwd_lse(tq, tk, tv, causal=causal),
                   tfa._padded(tfa.blockwise_attention_lse, tq, tk, tv,
                               causal=causal)):
        assert o.shape == tq.shape and o.dtype == tq.dtype
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(o), _np(jo), **OUT_TOL[dtype])
    # The no-lse forward (flash_attention without a gradient).
    with torch.no_grad():
        np.testing.assert_allclose(
            _np(tfa.flash_attention(tq, tk, tv, causal=causal)), _np(jo),
            **OUT_TOL[dtype])


@pytest.mark.parametrize("D,width", WIDE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_grads_match_jax_pallas_interpret(D, width, dtype, causal):
    """dq, dk, dv: autograd through the port's Function on CPU tensors, and
    the padded plain pairs (fused and split, the kernels' contract at
    their width), against jax.vjp through the JAX flash_attention (Pallas
    forward with lse, fused dq and dk/dv kernels) with the same
    cotangent; the row delta against rowsum(dO o O) of the JAX output."""
    q, k, v, g = _arrays(D, D + 1)
    jo, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(
            q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK),
        *(_jax(x, dtype) for x in (q, k, v)),
    )
    want = vjp(_jax(g, dtype))
    tq, tk, tv = (_torch(x, dtype, grad=True) for x in (q, k, v))
    do = _torch(g, dtype)
    got = torch.autograd.grad(tfa.flash_attention(tq, tk, tv, causal=causal),
                              (tq, tk, tv), do)
    xs = [x.detach() for x in (tq, tk, tv)]
    o, lse = tfa._padded(tfa.blockwise_attention_lse, *xs, causal=causal)
    dq, delta = tfa._padded(tfa.flash_bwd_dq_plain, *xs, o, lse, do,
                            causal=causal)
    dk, dv = tfa._padded(tfa.flash_bwd_dkv_plain, *xs, do, lse, delta,
                         causal=causal)
    sdq = tfa._padded(tfa.flash_bwd_dq_split_plain, *xs, o, lse, do,
                      causal=causal)
    sdk, sdv = tfa._padded(tfa.flash_bwd_dkv_split_plain, *xs, o, lse, do,
                           causal=causal)
    jdelta = (_np(g.astype(np.float32)) * _np(jo)).sum(-1)  # (B, T, H)
    np.testing.assert_allclose(
        delta.numpy(), jdelta.transpose(0, 2, 1).reshape(delta.shape),
        **(dict(atol=3e-5, rtol=2e-6) if dtype == "float32"
           else dict(atol=2e-2, rtol=1.6e-2)))
    for name, a, b, c, s in zip("qkv", got, want, (dq, dk, dv),
                                (sdq, sdk, sdv)):
        assert a.dtype == tq.dtype and c.shape == a.shape, name
        np.testing.assert_allclose(_np(a), _np(b), **GRAD_TOL[dtype],
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(_np(c), _np(b), **GRAD_TOL[dtype],
                                   err_msg=f"padded d{name}")
        assert torch.equal(s, c), f"split d{name}"


@pytest.mark.parametrize("D,width", WIDE)
def test_wide_plans(D, width):
    """The wide kernels' plans at the padded width: f32 blocks of 32 rows;
    bf16 forward and dq 64 rows where the grid fills the card, else 32;
    dk/dv 32 keys."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert tfa._flash_bq(1, 12, 1024, 132, width, f32) == 32
    assert tfa._flash_bq(1, 12, 1024, 132, width, bf16) == 64
    assert tfa._flash_bq(1, 2, 32, 132, width, bf16) == 32
    assert tfa._flash_bwd_plan(1, 12, 1024, 1024, width, f32, 132) == {
        "dq_rows": 32, "dkv_rows": 32}
    assert tfa._flash_bwd_plan(1, 12, 1024, 1024, width, bf16, 132) == {
        "dq_rows": 64, "dkv_rows": 32}
    assert tfa._flash_bwd_plan(1, 2, 32, 32, width, bf16, 132) == {
        "dq_rows": 32, "dkv_rows": 32}
