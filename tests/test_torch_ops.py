"""Port parity for the ops that hold kernels (tpuflow_torch.ops).

The same seeded numpy inputs go through the JAX function and its port
counterpart. Here, on the CPU, the port's wrappers take their kernels'
plain versions (the CUDA kernels run on the card, checked by
chip_smoke.py), and the JAX flash kernel runs as its own tests run it: in
Pallas interpret mode.

- flash: port plain version vs the JAX Pallas flash forward, atol 1e-5
  (f32; the two sum the same products in another order), and one bf16
  ulp in bf16.
- int8 matmul: bit-equal to JAX's XLA path and its Pallas kernel, for
  both weight layouts, with leading dims and an N that does not tile.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.ops import flash_attention as jfa
from tpuflow_torch.ops import attention as tattn
from tpuflow_torch.ops import flash_attention as tfa
from tpuflow_torch.ops import int8_matmul as tim
from torch_parity import one_torch_thread  # noqa: F401

# tpuflow.ops re-exports the functions `attention` and `int8_matmul` under
# their modules' names.
jattn = importlib.import_module("tpuflow.ops.attention")
jim = importlib.import_module("tpuflow.ops.int8_matmul")


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.fixture(autouse=True)
def _counters_zero():
    tfa.launches = tim.launches = 0
    yield
    # A CPU call takes the plain version and never counts a launch.
    assert tfa.launches == 0 and tim.launches == 0


def test_flash_plain_matches_jax_pallas_interpret():
    q, k, v = _qkv((2, 128, 4, 32), 0)
    want = np.asarray(jfa.flash_attention(*_j(q, k, v), causal=True))
    got = tfa.flash_attention(*_t(q, k, v), causal=True).numpy()
    assert got.shape == want.shape == (2, 128, 4, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_flash_plain_bf16_matches_jax_pallas_interpret():
    """bf16: both round P to bf16 before P.V over the same single KV
    tile, so they part only where f32 summation order flips a rounding:
    at most one bf16 ulp of the output (up to 2^-7 relative). Without the P
    rounding, thousands of outputs miss this limit."""
    q, k, v = _qkv((2, 128, 4, 32), 3)
    want = np.asarray(jfa.flash_attention(
        *(x.astype(jnp.bfloat16) for x in _j(q, k, v)), causal=True
    ).astype(jnp.float32))
    got = tfa.flash_attention(
        *(x.bfloat16() for x in _t(q, k, v)), causal=True
    ).float().numpy()
    np.testing.assert_allclose(got, want, atol=0, rtol=2 ** -7)


@pytest.mark.parametrize(
    "T,block_k,causal", [(128, 32, True), (128, 32, False), (100, 64, True)]
)
def test_blockwise_matches_jax(T, block_k, causal):
    """Several KV chunks, both mask modes, and a ragged T (both sides fall
    back to the einsum attention)."""
    q, k, v = _qkv((1, T, 2, 16), 1)
    want = np.asarray(jfa.blockwise_attention(
        *_j(q, k, v), causal=causal, block_k=block_k
    ))
    got = tfa.blockwise_attention(
        *_t(q, k, v), causal=causal, block_k=block_k
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_xla_attention_matches_jax(causal):
    q, k, v = _qkv((2, 24, 3, 16), 2)
    want = np.asarray(jattn.xla_attention(*_j(q, k, v), causal=causal))
    got = tattn.xla_attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_resolve_attention_impl_and_dispatch():
    r = tattn.resolve_attention_impl
    # The shipped thresholds: the H100's crossovers (chip_smoke.py phase
    # 11), flash from T = 128 forward and forward+backward.
    assert r("auto", 128, needs_bwd=False, backend="cuda") == "flash"
    assert r("auto", 127, needs_bwd=False, backend="cuda") == "xla"
    assert r("auto", 127, needs_bwd=True, backend="cuda") == "xla"
    assert r("auto", 128, needs_bwd=True, backend="cuda") == "flash"
    assert r("auto", 543, needs_bwd=True, backend="cuda") == "flash"
    assert r("auto", 4096, needs_bwd=False, backend="cpu") == "xla"
    assert r("flash", 8, backend="cpu") == "flash"
    # Under the JAX package's TPU thresholds as a tuning, the JAX table
    # picks the same way with cuda in the place of tpu.
    tpu = {"flash_min_seq": 2048, "flash_min_seq_fwd": 512}
    for T in (256, 511, 512, 2047, 2048):
        for bwd in (True, False):
            assert r("auto", T, needs_bwd=bwd, backend="cuda",
                     tuning=tpu) == \
                jattn.resolve_attention_impl("auto", T, needs_bwd=bwd,
                                             backend="tpu")
    q, k, v = _t(*_qkv((1, 8, 2, 16), 3))
    # Without a seq group, ring and ulysses are blockwise attention (the
    # JAX functions' fallback on a trivial axis).
    for impl in ("ring", "ulysses"):
        np.testing.assert_allclose(
            tattn.attention(q, k, v, impl=impl).numpy(),
            tattn.attention(q, k, v, impl="xla").numpy(), atol=1e-6)
    with pytest.raises(KeyError):
        tattn.attention(q, k, v, impl="bogus")
    np.testing.assert_allclose(
        tattn.attention(q, k, v, impl="flash").numpy(),
        tattn.attention(q, k, v, impl="xla").numpy(), atol=1e-6,
    )


def test_flash_wrapper_never_falls_back_off_cpu():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches the kernel or raises (here: an unsupported device)."""
    q = torch.zeros((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(q, q, q)
    x = torch.zeros((2, 8), device="meta")
    w = torch.zeros((8, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tim.int8_matmul(x, w, torch.ones(4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tim.int8_matmul(torch.zeros(2, 8), torch.zeros((8, 4), dtype=torch.int8),
                        torch.ones(4), impl="cuda")


def test_row_scales_and_quantize_rows_bit_equal():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, 96)) * 10).astype(np.float32)
    x[2] = 0.0  # an all-zero row pins its scale to 1/127
    x[3, ::7] = 2.5  # ties at .5 after division exercise half-to-even
    jq, js = jim.quantize_rows(jnp.asarray(x))
    tq, ts = tim.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tim.row_scales(torch.from_numpy(x)).numpy(),
        np.asarray(jim.row_scales(jnp.asarray(x))),
    )
    assert tq.dtype == torch.int8 and ts.shape == (5, 1)


def _quant_weight(w, axis):
    amax = np.abs(w).max(axis=axis, keepdims=True)
    s = np.where(amax > 0, amax, 1.0) / 127.0
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), \
        s.astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("contract_last", [False, True])
def test_int8_matmul_bit_equal_to_jax(impl, contract_last):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 256)).astype(np.float32)  # leading dims
    w = rng.standard_normal((384, 256) if contract_last else (256, 384))
    wq, ws = _quant_weight(w.astype(np.float32), -1 if contract_last else 0)
    want = np.asarray(jim.int8_matmul(
        *_j(x, wq, ws), w_contract_last=contract_last, impl=impl
    ))
    got = tim.int8_matmul(
        *_t(x, wq, ws), w_contract_last=contract_last
    ).numpy()
    assert got.shape == (2, 4, 384)
    np.testing.assert_array_equal(got, want)


def test_int8_matmul_untileable_n_and_per_tensor_scale():
    """N = 200 does not tile for the TPU kernel (JAX: XLA path only); the
    port's plain version and, on the card, its kernel take every shape."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 96)).astype(np.float32)
    wq, ws = _quant_weight(rng.standard_normal((96, 200)), 0)
    want = np.asarray(jim.int8_matmul(*_j(x, wq, ws), impl="xla"))
    np.testing.assert_array_equal(
        tim.int8_matmul(*_t(x, wq, ws)).numpy(), want
    )
    scalar = np.float32(0.01)
    want = np.asarray(jim.int8_matmul(*_j(x, wq), scalar, impl="xla"))
    got = tim.int8_matmul(*_t(x, wq), torch.tensor(scalar)).numpy()
    np.testing.assert_array_equal(got, want)
    bf = tim.int8_matmul(*_t(x, wq, ws), out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def test_int8_matmul_validation_errors():
    x = torch.zeros(2, 8)
    w = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        tim.int8_matmul(x, w.float(), torch.ones(4))
    with pytest.raises(ValueError, match="2-D"):
        tim.int8_matmul(x, w[None], torch.ones(4))
    with pytest.raises(ValueError, match="contraction mismatch"):
        tim.int8_matmul(x, w, torch.ones(4), w_contract_last=True)
    with pytest.raises(ValueError, match="w_scale"):
        tim.int8_matmul(x, w, torch.ones(3))
    with pytest.raises(ValueError, match="unknown int8 impl"):
        tim.int8_matmul(x, w, torch.ones(4), impl="pallas")
