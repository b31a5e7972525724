"""Port parity for scoring and reranking (tpuflow_torch.infer.score):
``sequence_logprob`` within 1e-5 of the JAX package's (dense, right-padded
mask, left-padded ``prompt_lens`` / ``pad_lens``, ``per_token``), its
validation messages equal, ``best_of_n`` at temperature 0 equal to greedy
and to the JAX ``best_of_n``, and ``render_tokens`` equal."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.infer.generate import render_tokens as jrender
from tpuflow.infer.score import best_of_n as jbest_of_n
from tpuflow.infer.score import sequence_logprob as jscore
from tpuflow_torch.infer.generate import generate, render_tokens
from tpuflow_torch.infer.score import best_of_n, sequence_logprob

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


def _tokens(shape=(3, 12), seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=shape).astype(
        np.int32)


def _right_mask():
    mask = np.ones((3, 12), np.float32)
    mask[1, 8:] = 0.0
    mask[2, 5:] = 0.0
    return mask


@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("case", [
    dict(),
    dict(mask=_right_mask()),
    dict(prompt_lens=np.array([12, 7, 3])),
    dict(pad_lens=np.array([0, 5, 9])),
    dict(prompt_lens=np.array([12, 7, 3]), mask=_right_mask()),
], ids=["dense", "right_mask", "prompt_lens", "pad_lens", "lens_and_mask"])
def test_sequence_logprob_matches_jax(pair, case, per_token):
    jm, params, tm = pair
    toks = _tokens()
    jkw = {k: jnp.asarray(v) if k == "mask" else v for k, v in case.items()}
    want = np.asarray(jscore(jm, params, jnp.asarray(toks),
                             per_token=per_token, **jkw))
    got = sequence_logprob(tm, toks, per_token=per_token, **case)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_right_padding_is_exact_vs_unpadded(pair):
    """A right-padded row scores as its unpadded prefix alone (trailing
    pad never precedes a scored token)."""
    _, _, tm = pair
    toks = _tokens()
    got = sequence_logprob(tm, toks, mask=_right_mask())
    alone = sequence_logprob(tm, toks[1:2, :8])
    np.testing.assert_allclose(got[1].numpy(), alone[0].numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("kw", [
    dict(prompt_lens=[12, 7, 3], pad_lens=[0, 5, 9]),
    dict(pad_lens=[0, 5, 12]),
    dict(pad_lens=[-1, 5, 0]),
    dict(prompt_lens=[0, 5, 9]),
    dict(mask=np.ones((3, 11), np.float32)),
])
def test_validation_messages_equal_jax(pair, kw):
    jm, params, tm = pair
    toks = _tokens()
    jkw = {k: jnp.asarray(v) if k == "mask" else v for k, v in kw.items()}
    with pytest.raises(ValueError) as want:
        jscore(jm, params, jnp.asarray(toks), **jkw)
    with pytest.raises(ValueError) as got:
        sequence_logprob(tm, toks, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", [
    dict(),
    dict(eos=True),
    dict(prompt_lens=np.array([9, 4])),
], ids=["dense", "eos", "ragged"])
def test_best_of_n_greedy_equals_generate_and_jax(pair, case):
    """At temperature 0 every candidate is the greedy continuation: the
    pick equals ``generate``'s, and tokens and scores equal the JAX
    ``best_of_n``'s."""
    jm, params, tm = pair
    prompt = _tokens((2, 9), 1)
    kw = dict(case)
    if kw.pop("eos", False):
        kw["eos_id"] = int(generate(tm, prompt, max_new_tokens=3,
                                    temperature=0.0)[0, 1])
    greedy = generate(tm, prompt, max_new_tokens=6, temperature=0.0,
                      **kw).numpy()
    toks, score = best_of_n(tm, prompt, n=3, max_new_tokens=6,
                            temperature=0.0, **kw)
    np.testing.assert_array_equal(toks.numpy(), greedy)
    jtoks, jscore_ = jbest_of_n(jm, params, jnp.asarray(prompt), n=3,
                                max_new_tokens=6, temperature=0.0, **kw)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore_), rtol=0,
                               atol=ATOL)


def test_best_of_n_sampled_picks_the_best_scored(pair):
    """Sampled candidates: the pick is the candidate whose own
    continuation score is the highest (one seeded generator)."""
    _, _, tm = pair
    prompt = _tokens((1, 6), 2)
    g = torch.Generator().manual_seed(5)
    toks, score = best_of_n(tm, prompt, n=4, max_new_tokens=5,
                            temperature=1.0, generator=g)
    cands = generate(tm, np.repeat(prompt, 4, axis=0), max_new_tokens=5,
                     temperature=1.0,
                     generator=torch.Generator().manual_seed(5))
    full = np.concatenate([np.repeat(prompt, 4, axis=0), cands.numpy()], 1)
    mask = np.concatenate([np.zeros((4, 6)), np.ones((4, 5))], 1)
    scores = sequence_logprob(tm, full, mask=mask, per_token=True)
    best = int(scores.argmax())
    np.testing.assert_array_equal(toks[0].numpy(), cands[best].numpy())
    assert float(score[0]) == float(scores[best])
    with pytest.raises(ValueError, match="n must be >= 1"):
        best_of_n(tm, prompt, n=0, max_new_tokens=2)


def test_render_tokens_matches_jax():
    ids = [72, 105, 300, -1, 10]
    for byte_level in (False, True):
        assert render_tokens(ids, byte_level=byte_level) == jrender(
            ids, byte_level=byte_level)
    # The port's module exports the names the JAX package's does.
    jinfer = importlib.import_module("tpuflow.infer")
    tinfer = importlib.import_module("tpuflow_torch.infer")
    missing = set(jinfer.__all__) - set(tinfer.__all__)
    assert missing == set()
