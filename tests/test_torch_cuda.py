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
