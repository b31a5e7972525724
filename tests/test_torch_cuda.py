"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where
``torch.cuda.is_available()`` is False, as on a CPU-only machine. On a
machine with the card and without JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX's CPU devices). This
file imports torch and the port only.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from tpuflow_torch.device import pin_f32_matmul_precision

    pin_f32_matmul_precision()
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 77, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, D, T, causal):
    """Every head_dim the kernel takes, ragged T (masked in the kernel),
    both mask modes, and strided q/k/v views of one qkv tensor."""
    from tpuflow_torch.ops import flash_attention as fa

    qkv = torch.randn(2, T, 3 * 3 * D, device="cuda", generator=cuda)
    q, k, v = (x.reshape(2, T, 3, D) for x in qkv.split(3 * D, dim=-1))
    n = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == n + 1
    ref = fa.blockwise_attention(q, k, v, causal=causal)
    # f32, same products summed in another order.
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


def test_flash_kernel_bf16_and_rejects(cuda):
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = (torch.randn(1, 130, 4, 64, device="cuda", generator=cuda)
               .bfloat16() for _ in range(3))
    out = fa.flash_attention(q, k, v)
    ref = fa.blockwise_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    # Both round P to bf16, at the running max of their own key tiles, and
    # the output to bf16: two bf16 ulps, as in chip_smoke.py.
    torch.testing.assert_close(out.float(), ref.float(), atol=4e-3,
                               rtol=8e-3)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros(1, 8, 2, 48, device="cuda")
        fa.flash_attention(x, x, x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        x = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.float16)
        fa.flash_attention(x, x, x)


def _qkv_views(gen, B, T, D, dtype=torch.float32, H=3):
    """Strided q/k/v views of one qkv tensor, as the model splits them."""
    qkv = torch.randn(B, T, 3 * H * D, device="cuda", generator=gen)
    return [x.reshape(B, T, H, D).to(dtype) for x in qkv.split(H * D, dim=-1)]


# Backward tolerances (kernel vs plain version on the same inputs): f32
# sums the same products in another order; bf16 also rounds P and dS to
# bf16 at values that differ in the last f32 bits, and the outputs to bf16
# (2^-8 relative): two bf16 ulps.
BWD_TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (2e-2, 1.6e-2)}


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 77, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_kernel_matches_plain(cuda, D, T, causal):
    """The forward with lse: the same output bits as the no-lse launch,
    and lse within f32 rounding of the plain version."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _qkv_views(cuda, 2, T, D)
    n = fa.launches_lse
    out, lse = fa.flash_fwd_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches_lse == n + 1
    assert lse.shape == (2 * 3, T) and lse.dtype == torch.float32
    assert torch.equal(out, fa.flash_attention(q, k, v, causal=causal))
    ref_out, ref_lse = fa.blockwise_attention_lse(q, k, v, causal=causal)
    torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 77, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_match_plain(cuda, dtype, D, T, causal):
    """The dq and dk/dv kernels against their plain versions on the same
    inputs (strided q/k/v, ragged T), and bit-equal on a second run."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _qkv_views(cuda, 2, T, D, dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(dtype)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=causal)
    n_dq, n_dkv = fa.launches_bwd_dq, fa.launches_bwd_dkv
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dq, fa.launches_bwd_dkv) == (n_dq + 1, n_dkv + 1)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    rdq, rdelta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, rdelta,
                                      causal=causal)
    torch.testing.assert_close(delta, rdelta, atol=1e-4, rtol=1e-5)
    atol, rtol = BWD_TOL[dtype]
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    again = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
    for x, y in zip(again, (dq, dk, dv)):
        assert torch.equal(x, y)


def test_flash_autograd_on_card_matches_xla(cuda):
    """Gradients through the autograd Function (lse forward + fused pair)
    against autograd through the einsum attention, with a random
    cotangent; the no-grad path keeps the no-lse kernel."""
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops.attention import xla_attention

    q, k, v = (x.detach().requires_grad_() for x in _qkv_views(cuda, 2, 130, 64))
    do = torch.randn(q.shape, device="cuda", generator=cuda)
    counts = (fa.launches, fa.launches_lse, fa.launches_bwd_dq,
              fa.launches_bwd_dkv)
    got = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), do)
    assert (fa.launches, fa.launches_lse, fa.launches_bwd_dq,
            fa.launches_bwd_dkv) == (counts[0], counts[1] + 1,
                                     counts[2] + 1, counts[3] + 1)
    want = torch.autograd.grad(xla_attention(q, k, v), (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-4)
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    assert fa.launches == counts[0] + 1


def test_flash_bwd_rejects(cuda):
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _qkv_views(cuda, 1, 16, 64)
    o, lse = fa.flash_fwd_lse(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dq(q, k, v, o, lse[:, :8], o, causal=True)
    with pytest.raises(ValueError, match="do"):
        fa.flash_bwd_dq(q, k, v, o, lse, o.bfloat16(), causal=True)


def test_train_gpt_on_the_card(cuda):
    """A few steps of train_gpt on the test preset with the flash kernels:
    finite falling losses; each step's forward (with lse) and fused
    backward launch once per layer."""
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.train.gpt import GptTrainConfig, train_gpt

    cfg = GptTrainConfig(preset="test", epochs=1, steps_per_epoch=6,
                         seq_len=128, attn_impl="flash", data_axis=1,
                         fsdp_axis=1, learning_rate=1e-3)
    n = (fa.launches_lse, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    res = train_gpt(cfg, log=lambda *a: None)
    losses = res.step_losses
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    # The test preset remats nothing: one lse forward per layer per step.
    assert (fa.launches_lse - n[0], fa.launches_bwd_dq - n[1],
            fa.launches_bwd_dkv - n[2]) == (12, 12, 12)


@pytest.mark.parametrize("M,K,N", [(1, 768, 2304), (8, 3072, 768),
                                   (37, 100, 50), (130, 256, 50257)])
@pytest.mark.parametrize("contract_last", [False, True])
def test_int8_kernel_bit_equal_to_plain(cuda, M, K, N, contract_last):
    from tpuflow_torch.ops import int8_matmul as im

    x = torch.randn(M, K, device="cuda", generator=cuda) * 3
    x[0] = 0.0  # a zero row: scale 1/127, every product 0
    shape = (N, K) if contract_last else (K, N)
    w = torch.randint(-127, 128, shape, device="cuda", generator=cuda,
                      dtype=torch.int32).to(torch.int8)
    ws = torch.rand(N, device="cuda", generator=cuda) * 1e-2
    n = im.launches
    out = im.int8_matmul(x, w, ws, w_contract_last=contract_last)
    torch.cuda.synchronize()
    assert im.launches == n + 1
    ref = im._plain_int8_matmul(x, w, ws, w_contract_last=contract_last,
                                out_dtype=torch.float32)
    assert torch.equal(out, ref)


def test_engine_on_the_card_matches_solo(cuda):
    """A small paged engine on the card, fp and int8 requests, each equal
    to its solo generate(); the int8 path launched the kernel."""
    from tpuflow_torch.infer.generate import generate
    from tpuflow_torch.infer.serve import ServeEngine
    from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
    from tpuflow_torch.ops import int8_matmul as im

    model = GPT2(GPT2Config.small_test(n_ctx=64, dropout=0.0), seed=1)
    eng = ServeEngine(model, max_slots=3, buckets=[8, 16], decode_block=4,
                      page_size=8, quant="fused_native")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=L) for L in (3, 9, 14, 6)]
    flags = [False, True, False, True]
    n = im.launches
    reqs = [eng.submit(p, max_new_tokens=7, quantize=q)
            for p, q in zip(prompts, flags)]
    eng.run_until_idle(max_iters=100)
    assert im.launches > n
    for p, q, r in zip(prompts, flags, reqs):
        solo = generate(eng._qmodel if q else model, p[None], max_new_tokens=7,
                        temperature=0.0)[0].cpu().numpy()
        np.testing.assert_array_equal(r.result(), solo)
