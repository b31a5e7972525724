"""Port parity for generation (tpuflow_torch.infer.generate): greedy tokens
are exact against JAX ``generate(temperature=0)`` on the same weights, and
the top-k / top-p filters produce the same filtered logits on the same
logits. Sampled tokens are not compared: the two frameworks' random
streams differ by design."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow_torch.infer.generate import (
    after_first_true,
    filter_logits,
    generate,
    pad_ragged,
)
from tpuflow_torch.ops import flash_attention as tfa

# tpuflow.infer re-exports the function `generate` under the module's name.
jgen_mod = importlib.import_module("tpuflow.infer.generate")


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


def _prompt(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, size=shape).astype(
        np.int32
    )


def _both(pair, prompt, **kw):
    jm, params, tm = pair
    want = np.asarray(jgen_mod.generate(
        jm, params, jnp.asarray(prompt), temperature=0.0, **kw
    ))
    got = generate(tm, prompt, temperature=0.0, **kw).numpy()
    assert got.dtype == np.int32
    return got, want


@pytest.mark.parametrize("case", ["dense", "ragged", "prefill_chunk", "eos"])
def test_greedy_tokens_equal_jax(pair, case):
    prompt = _prompt((2, 9), 0)
    kw = {"max_new_tokens": 8}
    if case == "ragged":
        prompt, lens = pad_ragged(
            [_prompt((5,), 1), _prompt((9,), 2), _prompt((3,), 3)]
        )
        kw["prompt_lens"] = lens
    elif case == "prefill_chunk":
        kw["prefill_chunk"] = 4  # three chunks; the last two hit the warm cache
    elif case == "eos":
        dense, _ = _both(pair, prompt, max_new_tokens=8)
        kw["eos_id"] = int(dense[0, 3])  # row 0 stops early, then pads
        kw["pad_id"] = 7
    got, want = _both(pair, prompt, **kw)
    np.testing.assert_array_equal(got, want)
    if case == "eos":
        assert (got[0, 4:] == 7).all()


def test_greedy_flash_impl_equals_jax():
    """attn_impl='flash': the dense fresh-cache prefill goes through the
    flash path on both sides (JAX: the Pallas kernel in interpret mode;
    port: the plain version, since the tensors lie on the CPU)."""
    pair = jax_and_port_gpt2(attn_impl="flash")
    tfa.launches = 0
    got, want = _both(pair, _prompt((2, 32), 4), max_new_tokens=6)
    np.testing.assert_array_equal(got, want)
    assert tfa.launches == 0


def _jax_filtered(monkeypatch, logits, **kw):
    """JAX ``_sample``'s filtered logits: capture what it hands to the
    categorical draw."""
    seen = {}

    def capture(rng, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.zeros(lg.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen_mod._sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                     jnp.float32(kw["temperature"]),
                     jnp.float32(kw.get("top_p") or 1.0), greedy=False,
                     top_k=kw.get("top_k"),
                     use_top_p=kw.get("top_p") is not None)
    return seen["logits"]


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.6), (8, 0.5)])
def test_top_k_top_p_filtered_logits_equal_jax(monkeypatch, top_k, top_p):
    logits = (np.random.default_rng(5).standard_normal((3, 64)) * 3).astype(
        np.float32
    )
    want = _jax_filtered(monkeypatch, logits, temperature=0.7, top_k=top_k,
                         top_p=top_p)
    got = filter_logits(torch.from_numpy(logits), 0.7, top_k=top_k,
                        top_p=top_p).numpy()
    np.testing.assert_array_equal(got, want)
    kept = got > -1e29
    if top_k is not None:
        assert (kept.sum(-1) <= top_k).all()
    assert kept.any(-1).all()


def test_sampling_is_seeded_and_validates(pair):
    _, _, tm = pair
    prompt = _prompt((2, 6), 6)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return generate(tm, prompt, max_new_tokens=5, temperature=0.9,
                        top_k=20, top_p=0.9, generator=g).numpy()

    a, b = draw(1), draw(1)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 5) and (a >= 0).all() and (a < 512).all()
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(tm, prompt, max_new_tokens=0)
    with pytest.raises(ValueError, match="top_p"):
        generate(tm, prompt, max_new_tokens=2, top_p=0.0)
    with pytest.raises(ValueError, match="n_ctx"):
        generate(tm, prompt, max_new_tokens=60)
    with pytest.raises(ValueError, match="prefill_chunk"):
        generate(tm, prompt, max_new_tokens=2, prefill_chunk=0)


def test_after_first_true_matches_jax():
    flags = np.array([[0, 1, 0, 1], [0, 0, 0, 0], [1, 0, 0, 0]], bool)
    np.testing.assert_array_equal(
        after_first_true(torch.from_numpy(flags)).numpy(),
        np.asarray(jgen_mod.after_first_true(jnp.asarray(flags))),
    )
