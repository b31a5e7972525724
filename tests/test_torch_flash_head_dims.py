"""Flash attention at head dims the kernels are not instantiated at, on the
CPU through the plain versions.

The CUDA wrappers zero-pad q, k, v (and O, dO) over D up to the next of
32, 64, 128, 256 (above 256: the next multiple of 128, the wide-head
kernels' width), pass the scale of the true D and cut the outputs back
(``ops/flash_attention.py::_padded``). Here the same ``_padded`` runs the
plain versions, which take the scale the same way (``scale_dim``), and
the result must equal the unpadded plain version: forward with lse, the
row delta and all three gradients, fused and split, f32. The zero columns
add exact zeros; the only difference is einsum's summation order over
the longer contraction, so the tolerance is a few f32 ulps (1e-6
absolute at values of order 1).
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.ops import flash_attention as fa
from torch_parity import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-6, rtol=1e-6)


def _qkv(D, T=24, B=2, H=2, seed=0):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal((B, T, H, D))
                             .astype(np.float32)) for _ in range(4)]


@pytest.mark.parametrize("D,width", [(16, 32), (48, 64), (96, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_padding_is_exact_through_the_plain_versions(D, width, causal):
    q, k, v, do = _qkv(D)
    assert fa._kernel_dim(D) == width
    o, lse = fa.blockwise_attention_lse(q, k, v, causal=causal)
    po, plse = fa._padded(fa.blockwise_attention_lse, q, k, v, causal=causal)
    assert po.shape == o.shape
    torch.testing.assert_close(po, o, **TOL)
    torch.testing.assert_close(plse, lse, **TOL)
    dq, delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    pdq, pdelta = fa._padded(fa.flash_bwd_dq_plain, q, k, v, o, lse, do,
                             causal=causal)
    torch.testing.assert_close(pdq, dq, **TOL)
    torch.testing.assert_close(pdelta, delta, **TOL)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    pdk, pdv = fa._padded(fa.flash_bwd_dkv_plain, q, k, v, do, lse, delta,
                          causal=causal)
    torch.testing.assert_close(pdk, dk, **TOL)
    torch.testing.assert_close(pdv, dv, **TOL)
    sdq = fa._padded(fa.flash_bwd_dq_split_plain, q, k, v, o, lse, do,
                     causal=causal)
    sdk, sdv = fa._padded(fa.flash_bwd_dkv_split_plain, q, k, v, o, lse, do,
                          causal=causal)
    for got, want in ((sdq, dq), (sdk, dk), (sdv, dv)):
        torch.testing.assert_close(got, want, **TOL)


def test_padding_matches_autograd_of_the_plain_forward():
    """The padded gradients are the gradients of attention at the true D
    (autograd through the einsum attention)."""
    from tpuflow_torch.ops.attention import xla_attention

    q, k, v, do = _qkv(48, T=16)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = xla_attention(*xs, causal=True)
    want = torch.autograd.grad(out, xs, do)
    o, lse = fa._padded(fa.blockwise_attention_lse, q, k, v, causal=True)
    torch.testing.assert_close(o, out.detach(), atol=1e-5, rtol=1e-5)
    dq, delta = fa._padded(fa.flash_bwd_dq_plain, q, k, v, o, lse, do,
                           causal=True)
    dk, dv = fa._padded(fa.flash_bwd_dkv_plain, q, k, v, do, lse, delta,
                        causal=True)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, atol=1e-5, rtol=1e-5)


def test_kernel_widths_and_limit():
    assert [fa._kernel_dim(d) for d in (8, 32, 40, 64, 72, 128, 136, 256)] \
        == [32, 32, 64, 64, 128, 128, 256, 256]
    # Above 256 the wide-head kernels take multiples of 128.
    assert [fa._kernel_dim(d) for d in (264, 320, 384, 512, 520)] \
        == [384, 384, 384, 512, 640]
    assert fa._kernel_dim(fa.MAX_HEAD_DIM) == fa.MAX_HEAD_DIM == 65535 * 128
    with pytest.raises(ValueError, match=f"head_dim up to {fa.MAX_HEAD_DIM}"):
        fa._kernel_dim(fa.MAX_HEAD_DIM + 8)
    # Kernel widths pass through unpadded: the same tensor objects.
    q, k, v, _ = _qkv(64, T=4)
    seen = []
    fa._padded(lambda *a, scale_dim: seen.extend([*a[:3], scale_dim]),
               q, k, v)
    assert seen[0] is q and seen[3] == 64


def test_d256_plans():
    """D = 256: the forward's q tile is 32 rows (64 would overrun shared
    memory); the f32 backward blocks 32 rows, bf16 32 or 64."""
    for B, T in ((1, 128), (8, 1024), (64, 4096)):
        assert fa._flash_bq(B, 12, T, 132, 256) == 32
        f32 = fa._flash_bwd_plan(B, 12, T, T, 256, torch.float32, 132)
        assert f32 == {"dq_rows": 32, "dkv_rows": 32}
        bf16 = fa._flash_bwd_plan(B, 12, T, T, 256, torch.bfloat16, 132)
        assert set(bf16.values()) <= {32, 64}
    assert fa._flash_bwd_plan(8, 12, 1024, 1024, 256, torch.bfloat16,
                              132) == {"dq_rows": 64, "dkv_rows": 64}


@pytest.mark.parametrize("D", [12, 20, 100])
def test_head_dim_not_multiple_of_8_takes_blockwise(D):
    """The reference's dispatch (tpuflow/ops/flash_attention.py:724): the
    blockwise route, with or without a gradient."""
    q, k, v, do = _qkv(D, T=8)
    want = fa.blockwise_attention(q, k, v, causal=True)
    torch.testing.assert_close(fa.flash_attention(q, k, v), want, rtol=0,
                               atol=0)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    n = fa.launches_lse
    out = fa.flash_attention(*xs, causal=True)
    out.backward(do)
    assert fa.launches_lse == n
    assert all(x.grad is not None for x in xs)


def test_head_dim_above_256_raises_on_the_kernel_path():
    """Only a head dim above the wide kernels' stated limit raises, before
    any launch (checked here through the padding rule the CUDA wrappers
    take first); 264 and 512 plan and pad."""
    q = torch.zeros(1, 4, 1, fa.MAX_HEAD_DIM + 8)
    with pytest.raises(ValueError, match=f"head_dim up to {fa.MAX_HEAD_DIM}"):
        fa._padded(fa.blockwise_attention_lse, q, q, q)
    for D in (264, 512):
        x = torch.zeros(1, 4, 1, D)
        o, _ = fa._padded(fa.blockwise_attention_lse, x, x, x)
        assert o.shape == x.shape


@pytest.mark.parametrize("D,width", [(264, 384), (320, 384), (512, 512)])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_head_dims_plan_pad_and_match_plain(D, width, causal):
    """D > 256 runs the wide-head kernels: the plans take 32 rows in f32
    and, where the grid fills the card, 64 q rows (forward, dq) and 32
    keys (dk/dv) in bf16; the wrappers pad to a multiple of 128, and the
    padded plain versions give the unpadded plain result (forward with
    lse, delta, all three gradients, fused and split)."""
    assert fa._kernel_dim(D) == width
    assert fa._kernel_dim(width + 8) == width + 128  # padded: no kernel dim
    assert fa._flash_bq(2, 2, 24, 132, width) == 32
    assert fa._flash_bq(8, 12, 1024, 132, width, torch.bfloat16) == 64
    assert fa._flash_bwd_plan(8, 12, 1024, 1024, width, torch.float32,
                              132) == {"dq_rows": 32, "dkv_rows": 32}
    assert fa._flash_bwd_plan(8, 12, 1024, 1024, width, torch.bfloat16,
                              132) == {"dq_rows": 64, "dkv_rows": 32}
    q, k, v, do = _qkv(D, T=20, seed=D)
    o, lse = fa.blockwise_attention_lse(q, k, v, causal=causal)
    po, plse = fa._padded(fa.blockwise_attention_lse, q, k, v, causal=causal)
    assert po.shape == o.shape
    torch.testing.assert_close(po, o, **TOL)
    torch.testing.assert_close(plse, lse, **TOL)
    dq, delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    pdq, pdelta = fa._padded(fa.flash_bwd_dq_plain, q, k, v, o, lse, do,
                             causal=causal)
    pdk, pdv = fa._padded(fa.flash_bwd_dkv_plain, q, k, v, do, lse, delta,
                          causal=causal)
    sdq = fa._padded(fa.flash_bwd_dq_split_plain, q, k, v, o, lse, do,
                     causal=causal)
    sdk, sdv = fa._padded(fa.flash_bwd_dkv_split_plain, q, k, v, o, lse, do,
                          causal=causal)
    torch.testing.assert_close(pdelta, delta, **TOL)
    for got, want in ((pdq, dq), (pdk, dk), (pdv, dv), (sdq, dq), (sdk, dk),
                      (sdv, dv)):
        assert got.shape == q.shape
        torch.testing.assert_close(got, want, **TOL)
