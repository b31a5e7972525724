"""Port parity for fused-native int8 (tpuflow_torch.infer.quant): the int8
leaves are bit-equal to the JAX quantizer's (Dense kernels and the
per-vocab-row LM head ``wte_q``), and int8 greedy tokens equal the JAX
``QuantizedModel`` pinned to its XLA int8 path."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2
from tpuflow.infer import quant as jquant
from tpuflow_torch.infer import quant as tquant
from tpuflow_torch.infer.generate import generate
from tpuflow_torch.ops import int8_matmul as tim

jgen_mod = importlib.import_module("tpuflow.infer.generate")


@pytest.fixture(scope="module")
def quantized():
    jm, params, tm = jax_and_port_gpt2()
    jqm, jqp = jquant.quantize_model(
        jm, params, mode="fused_native", int8_impl="xla"
    )
    return jqm, jax.device_get(jqp), tquant.quantize_model(
        tm, mode="fused_native"
    )


def test_quantize_model_leaves_bit_equal(quantized):
    _, jqp, tqm = quantized
    assert tqm.mode == "mxu"
    names = ["wte_q"] + [
        f"h.{i}.{d}" for i in range(2)
        for d in ("c_attn", "c_proj", "mlp_fc", "mlp_proj")
    ]
    assert sorted(tqm.leaves) == sorted(names)
    for name in names:
        if name == "wte_q":
            want = jqp["wte_q"]
        else:
            _, i, d = name.split(".")
            want = jqp[f"h{i}"][d]["kernel"]
        got = tqm.leaves[name]
        assert got.q.dtype == torch.int8
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
    # Per-vocab-row head scales; per-output-channel Dense scales.
    assert tqm.leaves["wte_q"].scale.shape == (512, 1)
    assert tqm.leaves["h.0.c_attn"].scale.shape == (1, 384)


def test_int8_greedy_tokens_equal_jax(quantized):
    jqm, jqp, tqm = quantized
    prompt = np.random.default_rng(0).integers(0, 512, size=(2, 9))
    want = np.asarray(jgen_mod.generate(
        jqm, jqp, jnp.asarray(prompt, jnp.int32), max_new_tokens=8,
        temperature=0.0,
    ))
    tim.launches = 0
    got = generate(tqm, prompt, max_new_tokens=8, temperature=0.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert tim.launches == 0  # CPU: the plain version, no kernel launch


def test_quantize_params_fallbacks_match_jax():
    """Per-tensor fallback (the scales would outweigh a sixteenth of the
    int8 bytes), the 3-D per-layer layout, and pass-through of small or
    1-D leaves — each bit-equal to the JAX quantizer."""
    rng = np.random.default_rng(1)
    leaves = {
        "wide": rng.standard_normal((2, 4096)).astype(np.float32),
        "stacked": rng.standard_normal((3, 64, 96)).astype(np.float32),
        "small": rng.standard_normal((8, 8)).astype(np.float32),
        "bias": rng.standard_normal((4096,)).astype(np.float32),
    }
    want = jax.device_get(jquant.quantize_params(
        {k: jnp.asarray(v) for k, v in leaves.items()}
    ))
    got = tquant.quantize_params(
        {k: torch.from_numpy(v) for k, v in leaves.items()}
    )
    for k in ("wide", "stacked"):
        assert isinstance(got[k], tquant.QuantLeaf)
        np.testing.assert_array_equal(got[k].q.numpy(), np.asarray(want[k].q))
        np.testing.assert_array_equal(got[k].scale.numpy(),
                                      np.asarray(want[k].scale))
    assert got["wide"].scale.shape == (1, 1)
    assert got["stacked"].scale.shape == (3, 1, 96)
    for k in ("small", "bias"):
        assert torch.equal(got[k], torch.from_numpy(leaves[k]))


def test_canonical_mode():
    for alias in ("mxu", "native", "fused_native"):
        assert tquant.canonical_mode(alias) == jquant.canonical_mode(alias)
    for alias in ("weight", "weight_only"):
        with pytest.raises(NotImplementedError, match="weight-only"):
            tquant.canonical_mode(alias)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tquant.canonical_mode("fp4")
