"""Port parity for int8 (tpuflow_torch.infer.quant). Fused-native: the
int8 leaves are bit-equal to the JAX quantizer's (Dense kernels and the
per-vocab-row LM head ``wte_q``), and int8 greedy tokens equal the JAX
``QuantizedModel`` pinned to its XLA int8 path. Weight-only: the leaves of
the JAX-layout tree are bit-equal, greedy tokens equal the JAX weight-only
model's, and the gate (``quant_decision``) and ``teacher_forced_agreement``
give the JAX package's verdicts."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
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
        assert tquant.canonical_mode(alias) == jquant.canonical_mode(alias)
        assert tquant.canonical_mode(alias) == "weight"
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tquant.canonical_mode("fp4")


@pytest.mark.parametrize("scan_layers", [False, True])
def test_weight_only_leaves_bit_equal_on_the_jax_layout(scan_layers):
    """``quantize_params`` over the port model's JAX-layout tree gives the
    JAX package's q and scale on every leaf (the scan layout stacks the
    blocks' kernels: per-layer scales); ``dequantize_params`` and
    ``quantized_nbytes`` agree as well."""
    jm, params, tm = jax_and_port_gpt2(scan_layers=scan_layers)
    # The port's config names the layout its param tree takes.
    tm.config = dataclasses.replace(tm.config, scan_layers=scan_layers)
    want = jax.device_get(jquant.quantize_params(params))
    got = tquant.quantize_params(tquant.jax_layout_params(tm))
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jquant.QuantLeaf))[0]
    n_quant = 0
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[p.key]
        if isinstance(w, jquant.QuantLeaf):
            n_quant += 1
            assert isinstance(g, tquant.QuantLeaf)
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(g.scale.numpy(),
                                          np.asarray(w.scale))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert n_quant == (6 if scan_layers else 10)  # wte, wpe, the kernels
    assert tquant.quantized_nbytes(got) == jquant.quantized_nbytes(want)
    deq = jax.device_get(jquant.dequantize_params(want))
    np.testing.assert_array_equal(
        tquant.dequantize_params(got)["wte"].numpy(), deq["wte"])


def test_weight_only_greedy_tokens_equal_jax_and_dequantized_fp():
    jm, params, tm = jax_and_port_gpt2()
    jqm, jqp = jquant.quantize_model(jm, params, mode="weight")
    tqm = tquant.quantize_model(tm, mode="weight")
    assert tqm.mode == "weight" and tqm.device == tm.device
    # No float copy of a quantized leaf: the module holds no storage.
    assert all(p.is_meta for p in tqm.model.parameters())
    prompt = np.random.default_rng(4).integers(0, 512, size=(2, 9))
    want = np.asarray(jgen_mod.generate(
        jqm, jqp, jnp.asarray(prompt, jnp.int32), max_new_tokens=8,
        temperature=0.0))
    got = generate(tqm, prompt, max_new_tokens=8, temperature=0.0).numpy()
    np.testing.assert_array_equal(got, want)
    # The same tokens from an fp GPT2 loaded with the dequantized leaves.
    from tpuflow_torch.models.convert import params_from_jax
    from tpuflow_torch.models.gpt2 import GPT2

    fp = GPT2(tm.config, seed=None, device="cpu")
    fp.load_state_dict(params_from_jax(tquant.dequantize_params(tqm.leaves)))
    np.testing.assert_array_equal(
        generate(fp, prompt, max_new_tokens=8, temperature=0.0).numpy(), got)
    toks = np.concatenate([prompt, got], axis=1)
    assert tquant.teacher_forced_agreement(tm, tqm, toks, 9) == \
        jquant.teacher_forced_agreement(jm, params, jqm, jqp,
                                        jnp.asarray(toks), 9)
    with pytest.raises(ValueError, match="extend past") as e:
        tquant.teacher_forced_predictions(tm, prompt, 9)
    with pytest.raises(ValueError) as je:
        jquant.teacher_forced_predictions(jm, params, jnp.asarray(prompt), 9)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("mode", ["weight", "weight_only", "mxu",
                                  "fused_native"])
def test_quant_decision_equals_jax(mode):
    jm, params, tm = jax_and_port_gpt2()
    want = jquant.quant_decision(params, mode=mode)
    for src in (tm, tquant.jax_layout_params(tm)):
        got = tquant.quant_decision(src, mode=mode)
        assert (got.apply, got.mode, got.weight_bytes) == (
            want.apply, want.mode, want.weight_bytes)
        assert "v5e" not in got.reason and "TPU" not in got.reason
    same, dec = tquant.maybe_quantize(tm, mode=mode)
    assert dec.apply == want.apply
    assert (same is tm) == (not want.apply)
    # Above the threshold (a broadcast view: no memory behind it) the
    # gate turns weight-only on.
    big = {"w": np.broadcast_to(np.float32(0), (2 ** 28,))}
    assert tquant.quant_decision(big, mode=mode).apply
    assert tquant.WEIGHT_QUANT_MIN_BYTES == jquant.WEIGHT_QUANT_MIN_BYTES
