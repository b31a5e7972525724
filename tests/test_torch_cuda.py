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
    from tpuflow_torch.device import f32_matmul_precision

    with f32_matmul_precision():
        yield torch.Generator(device="cuda").manual_seed(0)


def _flash_views(gen, B, Tq, Tk, H, D, dtype):
    """q/k/v as strided views of one fused qkv tensor (the model's split),
    q cut to Tq rows and k, v to Tk."""
    qkv = torch.randn(B, max(Tq, Tk), 3 * H * D, device="cuda",
                      generator=gen).to(dtype)
    q, k, v = (x.reshape(B, -1, H, D) for x in qkv.split(H * D, dim=-1))
    return q[:, :Tq], k[:, :Tk], v[:, :Tk]


def _int8_case(gen, M, K, N, contract_last):
    x = torch.randn(M, K, device="cuda", generator=gen) * 3
    x[M // 2] = 0.0  # a zero row: scale 1/127, every product 0
    shape = (N, K) if contract_last else (K, N)
    w = torch.randint(-127, 128, shape, device="cuda", generator=gen,
                      dtype=torch.int32).to(torch.int8)
    ws = torch.rand(N, device="cuda", generator=gen) * 1e-2
    return x, w, ws


_FLASH_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (4e-3, 8e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 77, 200, 256, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, dtype, D, T, causal):
    """Every head_dim the kernel takes, the bf16 tensor-core and f32
    CUDA-core paths, ragged T (masked in the kernel), both mask modes, and
    strided q/k/v views of one qkv tensor: within the stated tolerances,
    the lse launch's output bit for bit the no-lse launch's, and a second
    run bit-equal."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _flash_views(cuda, 2, T, T, 3, D, dtype)
    n = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == n + 1
    o_lse, lse = fa.flash_fwd_lse(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert torch.equal(out, o_lse) and torch.equal(out, again)
    ref, ref_lse = fa.blockwise_attention_lse(q, k, v, causal=causal)
    # f32: the same products summed in another order. bf16: both round P
    # to bf16 at the running max of their own key tiles, and the output to
    # bf16: two bf16 ulps, as in chip_smoke.py.
    atol, rtol = _FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-6)


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
    with pytest.raises(ValueError, match=f"head_dim up to {fa.MAX_HEAD_DIM}"):
        x = torch.zeros(1, 1, 1, fa.MAX_HEAD_DIM + 8, device="cuda")
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 77, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_split_kernels_bit_equal_to_fused(cuda, dtype, D, T, causal):
    """The split dq and dk/dv kernels (D recomputed per block visit, dk/dv
    reading O) give the fused pair's bits, at every head_dim and a ragged
    T, and stay within tolerance of their plain versions."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _qkv_views(cuda, 2, T, D, dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(dtype)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=causal)
    fused = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
    n = (fa.launches_bwd_dq, fa.launches_bwd_dkv,
         fa.launches_bwd_dq_split, fa.launches_bwd_dkv_split)
    dq = fa.flash_bwd_dq_split(q, k, v, o, lse, do, causal=causal)
    dk, dv = fa.flash_bwd_dkv_split(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dq, fa.launches_bwd_dkv, fa.launches_bwd_dq_split,
            fa.launches_bwd_dkv_split) == (n[0], n[1], n[2] + 1, n[3] + 1)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), fused):
        assert got.dtype == dtype
        assert torch.equal(got, want), name
    rdq = fa.flash_bwd_dq_split_plain(q, k, v, o, lse, do, causal=causal)
    rdk, rdv = fa.flash_bwd_dkv_split_plain(q, k, v, o, lse, do,
                                            causal=causal)
    atol, rtol = BWD_TOL[dtype]
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("bwd,launched", [
    ("fused", (1, 1, 0, 0)), ("split", (0, 0, 1, 1)),
    ("blockwise", None),
])
def test_flash_autograd_bwd_modes_on_card(cuda, bwd, launched):
    """flash_attention(bwd=...) launches the named pair; fused and split
    give the same bits. blockwise, the plain version, raises on the card."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = (x.detach().requires_grad_() for x in _qkv_views(cuda, 2, 130, 64))
    do = torch.randn(q.shape, device="cuda", generator=cuda)
    if launched is None:
        with pytest.raises(ValueError, match="CPU reference"):
            fa.flash_attention(q, k, v, bwd=bwd)
        return
    want = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), do)
    n = (fa.launches_bwd_dq, fa.launches_bwd_dkv, fa.launches_bwd_dq_split,
         fa.launches_bwd_dkv_split)
    got = torch.autograd.grad(fa.flash_attention(q, k, v, bwd=bwd),
                              (q, k, v), do)
    assert tuple(a - b for a, b in zip(
        (fa.launches_bwd_dq, fa.launches_bwd_dkv, fa.launches_bwd_dq_split,
         fa.launches_bwd_dkv_split), n)) == launched
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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


def test_train_gpt_split_checkpoint_resume_on_the_card(cuda, tmp_path):
    """train_gpt with the split backward and a ckpt_dir, then an in-run
    resume from a copy without the last step: the resumed steps' losses
    and the final checkpoint's shards equal the uninterrupted run's."""
    import json
    import shutil

    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.train.gpt import GptTrainConfig, train_gpt

    cfg = GptTrainConfig(preset="test", epochs=2, steps_per_epoch=4,
                         seq_len=128, attn_impl="flash", data_axis=1,
                         fsdp_axis=1, learning_rate=1e-3)
    n = (fa.launches_bwd_dq, fa.launches_bwd_dq_split)
    full = train_gpt(cfg, ckpt_dir=str(tmp_path / "a"), flash_bwd="split",
                     log=lambda *a: None)
    assert (fa.launches_bwd_dq - n[0], fa.launches_bwd_dq_split - n[1]) == \
        (0, 2 * 8)
    shutil.copytree(tmp_path / "a", tmp_path / "b",
                    ignore=shutil.ignore_patterns("step_8", ".recycle"))
    logs = []
    again = train_gpt(cfg, ckpt_dir=str(tmp_path / "b"), flash_bwd="split",
                      log=logs.append)
    assert any("in-run resume from step 4" in m for m in logs)
    assert again.step_losses == full.step_losses[4:]
    manifests = [json.load(open(tmp_path / d / "step_8" / "state" /
                                "manifest.json")) for d in ("a", "b")]
    assert manifests[0] == manifests[1]


def test_pinned_resume_hands_its_host_memory_back(cuda, tmp_path):
    """An in-run resume on the card restores into page-locked buffers,
    one a leaf and every leaf pinned; once the state is on the card that
    memory goes back to the system: PyTorch's host allocator then holds
    less than the restored bytes (it caches freed pinned blocks)."""
    import shutil

    from tpuflow_torch.ckpt import raw
    from tpuflow_torch.train.gpt import GptTrainConfig, train_gpt

    cfg = GptTrainConfig(preset="test", epochs=2, steps_per_epoch=2,
                         seq_len=128, attn_impl="flash", data_axis=1,
                         fsdp_axis=1, learning_rate=1e-3)
    full = train_gpt(cfg, ckpt_dir=str(tmp_path / "a"), log=lambda *a: None)
    shutil.copytree(tmp_path / "a", tmp_path / "b",
                    ignore=shutil.ignore_patterns("step_4", ".recycle"))
    again = train_gpt(cfg, ckpt_dir=str(tmp_path / "b"), log=lambda *a: None)
    assert again.step_losses == full.step_losses[2:]
    (rec,) = again.checkpoint_io["restores"]
    n = len(raw.read_manifest(str(tmp_path / "b" / "step_2" / "state"))[
        "leaves"])
    assert rec["arena_buffers"] == n and rec["pinned"] == n, rec
    held = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    assert held < rec["bytes"], (held, rec["bytes"])


_INT8_SHAPES = [(M, K, N) for M in (1, 7, 8, 9, 16, 17, 64, 512)
                for K in (100, 768, 3072) for N in (50, 768, 50257)]


# The grid, the shapes the tile code paths part on, the parent design's
# cases, and the main path's Dense widths (N = 2304 and 3072) at decode,
# prefill and M = 1.
_INT8_MAIN = [(1, 768, 2304), (8, 768, 2304), (8, 768, 3072),
              (512, 768, 3072), (37, 100, 50), (130, 256, 50257)]


@pytest.mark.parametrize("M,K,N", _INT8_SHAPES + _INT8_MAIN)
@pytest.mark.parametrize("contract_last", [False, True])
def test_int8_kernel_bit_equal_to_plain(cuda, M, K, N, contract_last):
    """Decode (M <= 16) and prefill tiles, split K or not, both layouts,
    ragged K and N (masked staging), a zero row: bit-equal to the plain
    version, and to a second run (the split-K atomics sum in any order)."""
    from tpuflow_torch.ops import int8_matmul as im

    x, w, ws = _int8_case(cuda, M, K, N, contract_last)
    n, n_tile = im.launches, dict(im.tile_launches)
    out = im.int8_matmul(x, w, ws, w_contract_last=contract_last)
    again = im.int8_matmul(x, w, ws, w_contract_last=contract_last)
    torch.cuda.synchronize()
    tile = im._int8_plan(M, K, N, im._sm_count(x.device.index))["tile"]
    assert im.launches == n + 2
    assert im.tile_launches[tile] == n_tile[tile] + 2
    ref = im._plain_int8_matmul(x, w, ws, w_contract_last=contract_last,
                                out_dtype=torch.float32)
    assert torch.equal(out, ref)
    assert torch.equal(again, out)


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


@pytest.mark.parametrize("M,K,N,contract_last", [
    (8, 768, 2304, False), (8, 3072, 768, False), (8, 768, 50257, True),
    (512, 768, 768, False), (512, 768, 3072, False)])
def test_int8_call_launches_at_most_two_kernels(cuda, M, K, N,
                                                contract_last):
    """The row scale pass and the product: no memset, no PyTorch op."""
    from torch.profiler import ProfilerActivity, profile

    from tpuflow_torch.ops import int8_matmul as im

    x, w, ws = _int8_case(cuda, M, K, N, contract_last)
    im.int8_matmul(x, w, ws, w_contract_last=contract_last)  # scratch made
    torch.cuda.synchronize()
    # torch.profiler on the H100 now and then returns a trace without the
    # call's kernels (chip_smoke.py retakes such traces too): up to three
    # traces are taken until one records the call.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            im.int8_matmul(x, w, ws, w_contract_last=contract_last)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert 1 <= len(kernels) <= 2, [e.name for e in kernels]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,Tk,causal", [(100, 37, True), (37, 100, False),
                                          (65, 200, True), (200, 65, False)])
def test_flash_fwd_redesign_tq_ne_tk(cuda, dtype, Tq, Tk, causal):
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _flash_views(cuda, 2, Tq, Tk, 3, 64, dtype)
    out, lse = fa.flash_fwd_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.blockwise_attention_lse(q, k, v, causal=causal)
    atol, rtol = _FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_row_bits_independent_of_batch_and_length(cuda, dtype):
    """A row's bits depend on its q and the keys at or before it only: a
    shorter causal sequence and a batch of one (other q tile plans) give
    the same bits for the rows they share."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _flash_views(cuda, 8, 1024, 1024, 12, 64, dtype)
    full = fa.flash_attention(q, k, v, causal=True)
    one = fa.flash_attention(q[:1], k[:1], v[:1], causal=True)
    short = fa.flash_attention(q[:1, :300], k[:1, :300], v[:1, :300],
                               causal=True)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    assert fa._flash_bq(8, 12, 1024, sms) != fa._flash_bq(1, 12, 300, sms)
    assert torch.equal(one, full[:1])
    assert torch.equal(short, full[:1, :300])


_SMEM_MAX = 232448  # dynamic shared memory one block may take on the H100


def _smem_limit():
    props = torch.cuda.get_device_properties(0)
    return min(_SMEM_MAX, getattr(props, "shared_memory_per_block_optin",
                                  _SMEM_MAX))


@pytest.mark.parametrize("dtype", [0, 1])  # float32, bfloat16
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("bq", [32, 64])
def test_flash_fwd_smem_within_the_card(cuda, dtype, D, bq):
    """The shared memory the C entry launches each (dtype, D, q tile) with
    fits one block, and the launch at it runs and agrees."""
    from tpuflow_torch.ops import _build
    from tpuflow_torch.ops import flash_attention as fa

    assert 0 < _build.load("flash_fwd").tpuflow_flash_fwd_smem(
        dtype, D, bq) <= _smem_limit()
    # A grid that takes this q tile height: B*H*ceil(T/64) SMs or more.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B = 1 if bq == 32 else -(-sms // 2)
    torch_dtype = (torch.float32, torch.bfloat16)[dtype]
    q, k, v = _flash_views(cuda, B, 128, 128, 1, D, torch_dtype)
    assert fa._flash_bq(B, 1, 128, sms) == bq
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    atol, rtol = _FLASH_TOL[torch_dtype]
    torch.testing.assert_close(
        out.float(), fa.blockwise_attention(q, k, v, causal=True).float(),
        atol=atol, rtol=rtol)


@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 512, 1023])
@pytest.mark.parametrize("K,N", [(768, 2304), (768, 768), (768, 3072),
                                 (3072, 768), (768, 50257), (3072, 50257)])
def test_int8_smem_within_the_card(cuda, M, K, N):
    """The shared memory the C entry launches each plan of the main paths'
    shapes with fits one block."""
    from tpuflow_torch.ops import _build
    from tpuflow_torch.ops import int8_matmul as im

    plan = im._int8_plan(M, K, N, im._sm_count(0))
    smem = _build.load("int8_matmul").tpuflow_int8_smem(
        0 if plan["tile"] == "decode" else 1, M, plan["cps"], plan["stages"])
    assert 0 < smem <= _smem_limit()


@pytest.mark.parametrize("dtype", [0, 1])  # float32, bfloat16
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("grid", ["small", "half", "full"])
def test_flash_bwd_smem_within_the_card(cuda, dtype, D, grid):
    """The shared memory the C entries launch the dq and dk/dv kernels
    (fused and split) with fits one block for every plan of this dtype and
    D (batches of 1, SMs/2 and SMs at T = 128, one head: each row height
    the plan takes), and the launches at it run and agree with the plain
    versions, split bit-equal to fused."""
    from tpuflow_torch.ops import _build
    from tpuflow_torch.ops import flash_attention as fa

    torch_dtype = (torch.float32, torch.bfloat16)[dtype]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B = {"small": 1, "half": -(-sms // 2), "full": sms}[grid]
    plan = fa._flash_bwd_plan(B, 1, 128, 128, D, torch_dtype, sms)
    lib = _build.load("flash_bwd")
    for kernel, key in ((0, "dq_rows"), (1, "dkv_rows")):
        for split in (0, 1):
            smem = lib.tpuflow_flash_bwd_smem(kernel, split, dtype, D,
                                              plan[key])
            assert 0 < smem <= _smem_limit()
    q, k, v = _flash_views(cuda, B, 128, 128, 1, D, torch_dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(torch_dtype)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=True)
    fused = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
    split = fa.flash_bwd_split(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, causal=True)
    atol, rtol = BWD_TOL[torch_dtype]
    for a, b, c in zip(fused, split, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_bits_independent_of_plan(cuda, dtype):
    """dq, dk and dv bits do not depend on the launch plan: a batch of one
    (64-row blocks) against the batch of eight (128 rows in f32, 64 in
    bf16; so bf16 also takes 32-row blocks at T = 300), and a
    300-token causal sequence against the 1024-token one on the rows they
    share (dq of rows < 300; dk, dv of keys < 300 with dO zero from row
    300 on, which adds exact zeros)."""
    from tpuflow_torch.ops import flash_attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {tuple(fa._flash_bwd_plan(b, 12, t, t, 64, dtype, sms).values())
             for b, t in ((8, 1024), (1, 1024), (1, 300))}
    assert len(plans) >= 2
    q, k, v = _flash_views(cuda, 8, 1024, 1024, 12, 64, dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(dtype)
    do[:1, 300:] = 0
    o, lse = fa.flash_fwd_lse(q, k, v, causal=True)
    full = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
    o1, lse1 = fa.flash_fwd_lse(q[:1], k[:1], v[:1], causal=True)
    one = fa.flash_bwd(q[:1], k[:1], v[:1], o1, lse1, do[:1], causal=True)
    s = (q[:1, :300], k[:1, :300], v[:1, :300])
    os_, lses = fa.flash_fwd_lse(*s, causal=True)
    short = fa.flash_bwd(*s, os_, lses, do[:1, :300].contiguous(),
                         causal=True)
    split = fa.flash_bwd_split(*s, os_, lses, do[:1, :300].contiguous(),
                               causal=True)
    torch.cuda.synchronize()
    for name, a, b, c, d in zip(("dq", "dk", "dv"), full, one, short, split):
        assert torch.equal(b, a[:1]), name
        assert torch.equal(c, a[:1, :300]), name
        assert torch.equal(d, c), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Tq,Tk,causal", [(100, 37, True), (37, 100, False),
                                          (65, 200, True), (200, 65, False),
                                          (37, 100, True)])
def test_flash_bwd_tq_ne_tk(cuda, dtype, D, Tq, Tk, causal):
    """Tq != Tk, ragged, masked in the kernels: the fused pair within the
    backward tolerance of its plain version, the split pair bit-equal."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _flash_views(cuda, 2, Tq, Tk, 3, D, dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(dtype)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=causal)
    got = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
    split = fa.flash_bwd_split(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    atol, rtol = BWD_TOL[dtype]
    for a, b, c in zip(got, split, want):
        assert a.shape == c.shape and torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_bf16_counters(cuda, dtype):
    """launches_bwd_dq_bf16 / launches_bwd_dkv_bf16 count the bf16
    launches of either pair, and nothing else."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _qkv_views(cuda, 1, 64, 64, dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(dtype)
    o, lse = fa.flash_fwd_lse(q, k, v)
    n = (fa.launches_bwd_dq_bf16, fa.launches_bwd_dkv_bf16)
    fa.flash_bwd(q, k, v, o, lse, do, causal=True)
    fa.flash_bwd_split(q, k, v, o, lse, do, causal=True)
    bf16 = int(dtype == torch.bfloat16)
    assert (fa.launches_bwd_dq_bf16 - n[0],
            fa.launches_bwd_dkv_bf16 - n[1]) == (2 * bf16, 2 * bf16)


def test_train_gpt_bf16_on_the_card(cuda):
    """train_gpt with dtype='bfloat16' on the test preset: finite losses,
    and the forward with lse and the backward pair launched once per layer
    and step on the tensor-core (bf16) variants."""
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.train.gpt import GptTrainConfig, train_gpt

    cfg = GptTrainConfig(preset="test", epochs=1, steps_per_epoch=4,
                         seq_len=128, attn_impl="flash", data_axis=1,
                         fsdp_axis=1, learning_rate=1e-3, dtype="bfloat16")
    n = (fa.launches_lse_bf16, fa.launches_bwd_dq_bf16,
         fa.launches_bwd_dkv_bf16)
    res = train_gpt(cfg, log=lambda *a: None)
    assert len(res.step_losses) == 4 and all(np.isfinite(res.step_losses))
    L = cfg.model_config().n_layer
    assert (fa.launches_lse_bf16 - n[0], fa.launches_bwd_dq_bf16 - n[1],
            fa.launches_bwd_dkv_bf16 - n[2]) == (4 * L, 4 * L, 4 * L)


# Head dims the kernels are not instantiated at run zero-padded to the next
# of 32, 64, 128 (16, 48 and 96 here); 256 runs its own instantiation,
# which splits the output columns over grid.z; above 256 the wide-head
# kernels (320 padded to 384, and 512).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 48, 96, 256, 320, 512])
@pytest.mark.parametrize("T", [1, 77, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_head_dims_padded_and_256_match_plain(cuda, dtype, D, T,
                                                    causal):
    """Forward (no lse and with lse) and both backward pairs at a padded or
    the 256-wide head dim, strided q/k/v views, against the plain versions
    at the true D within the existing tolerances; split bit-equal to fused;
    one launch counted per call, and in ``wide_launches`` by kernel and
    dtype where D > 256."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _flash_views(cuda, 2, T, T, 3, D, dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(dtype)
    n = (fa.launches, fa.launches_lse, fa.launches_bwd_dq,
         fa.launches_bwd_dkv)
    wide = dict(fa.wide_launches)
    out = fa.flash_attention(q, k, v, causal=causal)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=causal)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    split = fa.flash_bwd_split(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_lse, fa.launches_bwd_dq,
            fa.launches_bwd_dkv) == (n[0] + 1, n[1] + 1, n[2] + 1, n[3] + 1)
    ran = {kern + ("_bf16" if dtype == torch.bfloat16 else "")
           for kern in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                        "flash_bwd_dkv", "flash_bwd_dq_split",
                        "flash_bwd_dkv_split")} if D > 256 else set()
    assert fa.wide_launches == {kern: c + (kern in ran)
                                for kern, c in wide.items()}
    assert out.shape == o.shape == q.shape and torch.equal(out, o)
    ref, ref_lse = fa.blockwise_attention_lse(q, k, v, causal=causal)
    atol, rtol = _FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-6)
    rdq, rdelta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, rdelta,
                                      causal=causal)
    torch.testing.assert_close(delta, rdelta, atol=1e-4, rtol=1e-5)
    atol, rtol = BWD_TOL[dtype]
    for name, got, want, sp in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                   (rdq, rdk, rdv), split):
        assert got.shape == q.shape and got.dtype == dtype, name
        assert torch.equal(got, sp), name
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype", [0, 1])  # float32, bfloat16
@pytest.mark.parametrize("grid", ["small", "full"])
def test_flash_d256_smem_within_the_card(cuda, dtype, grid):
    """At D = 256 every launch the plans make fits one block's shared
    memory: the forward's 32-row q tile, the backward's rows (32 in f32,
    32 or 64 in bf16) for the fused and split kernels; the launches run,
    and a 64-row forward tile, which would not fit, is never planned."""
    from tpuflow_torch.ops import _build
    from tpuflow_torch.ops import flash_attention as fa

    torch_dtype = (torch.float32, torch.bfloat16)[dtype]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B = {"small": 1, "full": sms}[grid]
    assert fa._flash_bq(B, 1, 128, sms, 256) == 32
    assert 0 < _build.load("flash_fwd").tpuflow_flash_fwd_smem(
        dtype, 256, 32) <= _smem_limit()
    plan = fa._flash_bwd_plan(B, 1, 128, 128, 256, torch_dtype, sms)
    lib = _build.load("flash_bwd")
    for kernel, key in ((0, "dq_rows"), (1, "dkv_rows")):
        for split in (0, 1):
            assert 0 < lib.tpuflow_flash_bwd_smem(
                kernel, split, dtype, 256, plan[key]) <= _smem_limit()
    q, k, v = _flash_views(cuda, B, 128, 128, 1, 256, torch_dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(torch_dtype)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=True)
    fused = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, causal=True)
    atol, rtol = BWD_TOL[torch_dtype]
    for a, c in zip(fused, want):
        torch.testing.assert_close(a.float(), c.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [0, 1])  # float32, bfloat16
@pytest.mark.parametrize("grid", ["small", "full"])
def test_flash_wide_smem_within_the_card(cuda, dtype, grid):
    """Above D = 256 every launch the plans make (32 rows; bf16 forward
    and dq 64 or 32) takes dynamic shared memory within one
    block's limit, the C entries refuse the heights no plan makes, and
    the launches at the plan run and agree with the plain versions, split
    bit-equal to fused."""
    from tpuflow_torch.ops import _build
    from tpuflow_torch.ops import flash_attention as fa

    torch_dtype = (torch.float32, torch.bfloat16)[dtype]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B = {"small": 1, "full": sms}[grid]
    bq = fa._flash_bq(B, 1, 128, sms, 512, torch_dtype)
    plan = fa._flash_bwd_plan(B, 1, 128, 128, 512, torch_dtype, sms)
    want_rows = (32, 32, 32) if dtype == 0 else \
        {"small": (32, 32, 32), "full": (64, 64, 32)}[grid]
    assert (bq, plan["dq_rows"], plan["dkv_rows"]) == want_rows
    assert 0 < _build.load("flash_fwd").tpuflow_flash_fwd_smem(
        dtype, 512, bq) <= _smem_limit()
    lib = _build.load("flash_bwd")
    for kernel, key in ((0, "dq_rows"), (1, "dkv_rows")):
        for split in (0, 1):
            assert 0 < lib.tpuflow_flash_bwd_smem(
                kernel, split, dtype, 512, plan[key]) <= _smem_limit()
    q, k, v = _flash_views(cuda, B, 128, 128, 1, 512, torch_dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(torch_dtype)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=True)
    fused = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
    split = fa.flash_bwd_split(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    ref, ref_lse = fa.blockwise_attention_lse(q, k, v, causal=True)
    atol, rtol = _FLASH_TOL[torch_dtype]
    torch.testing.assert_close(o.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-6)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, causal=True)
    atol, rtol = BWD_TOL[torch_dtype]
    for a, b, c in zip(fused, split, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), atol=atol, rtol=rtol)
    # A tile height no plan makes is refused, not run.
    ptr = q.data_ptr()
    assert lib.tpuflow_flash_bwd_dq(
        ptr, ptr, ptr, ptr, ptr, lse.data_ptr(), ptr, lse.data_ptr(), 1, 1,
        128, 128, 512, dtype, 1, 48, 1.0, fa._strides(q, k, v, o, do),
        torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_bits_independent_of_plan(cuda, dtype):
    """At D = 512 the forward and both backward pairs give the same bits
    for the rows they share whatever the plan, batch and sequence length:
    a batch of eight against a batch of one (in bf16 other tile heights),
    and a 300-token causal sequence against the 1024-token one (dq of
    rows < 300; dk, dv of keys < 300 with dO zero from row 300 on, which
    adds exact zeros); the split pair bit-equal to the fused one."""
    from tpuflow_torch.ops import flash_attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {(fa._flash_bq(b, 12, t, sms, 512, dtype),
              *fa._flash_bwd_plan(b, 12, t, t, 512, dtype, sms).values())
             for b, t in ((8, 1024), (1, 1024), (1, 300))}
    assert len(plans) >= (2 if dtype == torch.bfloat16 else 1)
    q, k, v = _flash_views(cuda, 8, 1024, 1024, 12, 512, dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(dtype)
    do[:1, 300:] = 0
    full = fa.flash_attention(q, k, v, causal=True)
    one = fa.flash_attention(q[:1], k[:1], v[:1], causal=True)
    s = (q[:1, :300], k[:1, :300], v[:1, :300])
    short = fa.flash_attention(*s, causal=True)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=True)
    g_full = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
    o1, lse1 = fa.flash_fwd_lse(q[:1], k[:1], v[:1], causal=True)
    g_one = fa.flash_bwd(q[:1], k[:1], v[:1], o1, lse1, do[:1], causal=True)
    os_, lses = fa.flash_fwd_lse(*s, causal=True)
    g_short = fa.flash_bwd(*s, os_, lses, do[:1, :300].contiguous(),
                           causal=True)
    g_split = fa.flash_bwd_split(*s, os_, lses, do[:1, :300].contiguous(),
                                 causal=True)
    torch.cuda.synchronize()
    assert torch.equal(one, full[:1]) and torch.equal(short, full[:1, :300])
    assert torch.equal(o, full)
    for name, a, b, c, d in zip(("dq", "dk", "dv"), g_full, g_one, g_short,
                                g_split):
        assert torch.equal(b, a[:1]), name
        assert torch.equal(c, a[:1, :300]), name
        assert torch.equal(d, c), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,Tk,causal", [(100, 37, True), (37, 100, False),
                                          (65, 200, True), (200, 65, False),
                                          (37, 100, True)])
def test_flash_wide_tq_ne_tk(cuda, dtype, Tq, Tk, causal):
    """Tq != Tk at D = 512, ragged, masked in the wide kernels: the forward
    and the fused pair within the tolerances of their plain versions, the
    split pair bit-equal to the fused one."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _flash_views(cuda, 2, Tq, Tk, 3, 512, dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(dtype)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=causal)
    got = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
    split = fa.flash_bwd_split(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.blockwise_attention_lse(q, k, v, causal=causal)
    atol, rtol = _FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-6)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    atol, rtol = BWD_TOL[dtype]
    for a, b, c in zip(got, split, want):
        assert a.shape == c.shape and torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [640, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_above_the_column_cap(cuda, dtype, D, causal):
    """Above 512 columns a block owns one 512-wide panel of the output
    (grid.z = 2 here; 640's second panel is 128 wide) and sums the scores
    over every panel: the forward (with and without lse) and both pairs
    against their plain versions, split bit-equal to fused, the no-lse
    output equal to the lse one."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _flash_views(cuda, 2, 77, 77, 3, D, dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(dtype)
    out = fa.flash_attention(q, k, v, causal=causal)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=causal)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    split = fa.flash_bwd_split(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, o)
    ref, ref_lse = fa.blockwise_attention_lse(q, k, v, causal=causal)
    atol, rtol = _FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-6)
    rdq, rdelta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, rdelta,
                                      causal=causal)
    torch.testing.assert_close(delta, rdelta, atol=1e-4, rtol=1e-5)
    atol, rtol = BWD_TOL[dtype]
    for got, want, sp in zip((dq, dk, dv), (rdq, rdk, rdv), split):
        assert torch.equal(got, sp)
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


def test_flash_head_dim_not_multiple_of_8_takes_blockwise(cuda):
    """D % 8 != 0 takes blockwise_attention on the card too (the
    reference's dispatch): no kernel launches, gradients by autograd."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = (torch.randn(1, 40, 2, 20, device="cuda", generator=cuda)
               .requires_grad_() for _ in range(3))
    n = (fa.launches, fa.launches_lse, fa.launches_bwd_dq)
    out = fa.flash_attention(q, k, v, causal=True)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_lse, fa.launches_bwd_dq) == n
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_prefetch_to_device_on_the_card(cuda):
    """The prefetcher's batches on the card equal the loader's, in order,
    copied from pinned memory on its side stream."""
    from tpuflow_torch.data.loader import get_dataloaders, prefetch_to_device

    train, _ = get_dataloaders(32, n_train=256, n_test=10)
    got = list(prefetch_to_device(train, "cuda", keys=("x", "y")))
    want = list(train)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g["x"].is_cuda and sorted(g) == ["x", "y"]
        np.testing.assert_array_equal(g["x"].cpu().numpy(), w["x"])
        np.testing.assert_array_equal(g["y"].cpu().numpy(), w["y"])


def test_train_fashion_mnist_on_the_card_predicts_like_the_cpu(cuda,
                                                              tmp_path):
    """A small train_fashion_mnist on the card (2 epochs, 2,000 rows): the
    loss falls, and the predictor's argmax over the 1,000 test rows on the
    card equals the CPU predictor's on the same weights except for at
    most 3 rows (f32 products with TF32 off, rounded in another order),
    the logits within 1e-4 of the largest |logit|."""
    from tpuflow_torch.flows import my_torch_module as m

    sizes = dict(n_train=2000, n_test=1000)
    res = m.train_fashion_mnist(epochs=2, checkpoint_storage_path=str(
        tmp_path / "run"), **sizes)
    val = [h["val_loss"] for h in res.metrics_history]
    assert all(np.isfinite(val)) and val[1] < val[0]
    rows = m.get_dataloaders(512, as_rows=True, **sizes)
    on_card = m.map_batches(rows, m.TorchPredictor(res.best_checkpoint),
                            batch_size=512)
    on_cpu = m.map_batches(rows, m.TorchPredictor(res.best_checkpoint,
                                                  device="cpu"),
                           batch_size=512)
    flips = sum(int(a["predicted_values"]) != int(b["predicted_values"])
                for a, b in zip(on_card, on_cpu))
    assert flips <= 3
    a = np.stack([o["logits"] for o in on_card])
    b = np.stack([o["logits"] for o in on_cpu])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())


def test_torch_train_gang_over_nccl_on_two_cards(cuda, tmp_path):
    """``TorchTrain`` with ``--num-parallel 2`` on the card: a 2-process
    gang, one process a card, the process group over NCCL; the head's
    result records the 2-wide data mesh and the loss falls. Skips below
    two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: one gang member a card")
    from tpuflow_torch.flow import Run, store
    from tpuflow_torch.flows import train_flow

    try:
        pathspec = train_flow.main([
            "run", "--epochs", "2", "--num-parallel", "2", "--n-train",
            "2048", "--n-test", "512", "--home", str(tmp_path / "home")])
        run = Run(pathspec)
        assert run.successful
        result = run.data.result
        assert result.mesh_axes == {"data": 2}
        val = [h["val_loss"] for h in result.metrics_history]
        assert all(np.isfinite(val)) and val[1] < val[0]
        # Only the head persisted artifacts.
        assert store.load_artifacts("TorchTrain", run.run_id, "train",
                                    2) == {}
    finally:
        store.set_home(None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [65, 197])
def test_flash_noncausal_vit_lengths_match_plain(cuda, dtype, T):
    """The ViT's attention: non-causal at a ragged T (65 tokens of a
    patch-4 32 x 32 image, 197 of a patch-16 224 x 224 one), 6 heads of
    64, strided q/k/v views. The no-lse forward, the forward with lse and
    the fused pair within the stated tolerances of their plain versions,
    and one autograd call launching each kernel once."""
    from tpuflow_torch.ops import flash_attention as fa

    q, k, v = _flash_views(cuda, 4, T, T, 6, 64, dtype)
    do = torch.randn(q.shape, device="cuda", generator=cuda).to(dtype)
    out = fa.flash_attention(q, k, v, causal=False)
    o, lse = fa.flash_fwd_lse(q, k, v, causal=False)
    assert torch.equal(out, o)
    ref, ref_lse = fa.blockwise_attention_lse(q, k, v, causal=False)
    atol, rtol = _FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-6)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, causal=False)
    rdq, rdelta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=False)
    rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, rdelta, causal=False)
    atol, rtol = BWD_TOL[dtype]
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    counts = (fa.launches_lse, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    fa.flash_attention(*xs, causal=False).backward(do)
    torch.cuda.synchronize()
    assert (fa.launches_lse, fa.launches_bwd_dq, fa.launches_bwd_dkv) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)
    for x, want in zip(xs, (dq, dk, dv)):
        assert torch.equal(x.grad, want)


def test_resnet_step_on_the_card_matches_the_cpu(cuda):
    """One SGD-momentum step of a ResNet-18 (width 16, CIFAR stem) and of
    a ResNet-50 (width 8, ImageNet stem on 64 x 64) on the card against
    the same step on the CPU from the same weights (TF32 off): the loss
    within 1e-5 relative, every parameter and BatchNorm running statistic
    within atol 1e-5 (cuDNN and the CPU sum the convolutions in other
    orders), and the eval logits within 1e-4 of the largest |logit|."""
    from tpuflow_torch.ckpt.tree import running_stats
    from tpuflow_torch.models import get_model
    from tpuflow_torch.train.step import create_train_state, make_train_step

    r = np.random.default_rng(0)
    for name, kw, hw in (("resnet18", dict(width=16, small_inputs=True), 32),
                         ("resnet50", dict(width=8), 64)):
        x = r.standard_normal((16, hw, hw, 3)).astype(np.float32)
        batch = {"x": x, "y": r.integers(0, 10, 16)}
        states = {}
        for dev in ("cpu", "cuda"):
            model = get_model(name, seed=0, **kw).to(dev)
            state = create_train_state(model, 0.05)
            state, metrics = make_train_step()(state, batch, 0)
            states[dev] = (state, float(metrics["loss"]))
        (cpu, lc), (card, lg) = states["cpu"], states["cuda"]
        assert lg == pytest.approx(lc, rel=1e-5)
        for a, b in zip([*card.params, *running_stats(card.model).values()],
                        [*cpu.params, *running_stats(cpu.model).values()]):
            torch.testing.assert_close(a.detach().cpu(), b.detach(),
                                       atol=1e-5, rtol=0)
        with torch.no_grad():
            a = card.model(torch.from_numpy(x).cuda()).cpu()
            b = cpu.model(torch.from_numpy(x))
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def test_batchnorm_statistics_are_global_over_nccl_on_two_cards(cuda):
    """The BatchNorm statistics of a 2-process world over NCCL, one process
    a card: equal on both ranks, and within atol 1e-5 of one process on the
    whole batch (``tests/test_torch_dist.py``'s gloo test on the card;
    cuDNN picks its convolution algorithms by batch size, TF32 off).
    Skips below two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: one process a card")
    import test_torch_dist

    test_torch_dist._bn_global("cuda", atol=1e-5)


def _gpt2_width(n_layer=2):
    """GPT-2 124M's widths (768 wide, 12 heads of 64, vocab 50257) at a
    cut depth, weights from seed 0, on the card."""
    from tpuflow_torch.models.gpt2 import GPT2, GPT2Config

    cfg = GPT2Config(n_layer=n_layer, dropout=0.0, attn_impl="auto")
    return GPT2(cfg, seed=0)


def test_quantized_leaves_on_the_card_bit_equal_to_the_cpu(cuda):
    """Weight scales divide by a tensor: the card's quotients are the
    CPU's (IEEE) ones, so every q and scale of both modes is bit-equal."""
    from tpuflow_torch.infer.quant import (
        QuantLeaf,
        jax_layout_params,
        quantize_model,
        quantize_params,
    )

    model = _gpt2_width()
    cpu = _gpt2_width().cpu()

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            elif isinstance(v, QuantLeaf):
                yield prefix + k, v

    on_card = dict(leaves(quantize_params(jax_layout_params(model))))
    on_cpu = dict(leaves(quantize_params(jax_layout_params(cpu))))
    fused = quantize_model(model, mode="fused_native").leaves
    fused_cpu = quantize_model(cpu, mode="fused_native").leaves
    on_card.update({f"fused/{k}": v for k, v in fused.items()})
    on_cpu.update({f"fused/{k}": v for k, v in fused_cpu.items()})
    assert on_card.keys() == on_cpu.keys() and len(on_card) > 10
    for name, leaf in on_card.items():
        assert leaf.q.is_cuda, name
        assert torch.equal(leaf.q.cpu(), on_cpu[name].q), name
        assert torch.equal(leaf.scale.cpu(), on_cpu[name].scale), name


@pytest.mark.parametrize("int8", [False, True])
def test_speculative_and_engine_verify_equal_generate(cuda, int8):
    """At 124M's widths on the card, batch 4: speculative decoding and the
    engine's verify block give generate()'s tokens, fp and fused-native
    (the verify chunk's fp products run one (row, position) at a time)."""
    from tpuflow_torch.infer.generate import generate
    from tpuflow_torch.infer.quant import quantize_model
    from tpuflow_torch.infer.serve import ServeEngine
    from tpuflow_torch.infer.speculative import speculative_generate

    fp = _gpt2_width()
    model = quantize_model(fp, mode="fused_native") if int8 else fp
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 50257, size=16)
    prompt = np.tile(seg, (4, 8))
    prompt[1:, :16] = rng.integers(0, 50257, size=(3, 16))
    want = generate(model, prompt, max_new_tokens=32,
                    temperature=0.0).cpu().numpy()
    got, stats = speculative_generate(model, prompt, max_new_tokens=32,
                                      draft_len=4, return_stats=True)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert stats["n_forwards"] < 32  # the repeated segment drafts hit
    eng = ServeEngine(fp, max_slots=4, speculative=4, quant="fused_native")
    outs = eng.generate_many(list(prompt), max_new_tokens=32, quantize=int8)
    for row, out in zip(want, outs):
        np.testing.assert_array_equal(out, row)
    assert eng.spec_accept_rate > 1.0
