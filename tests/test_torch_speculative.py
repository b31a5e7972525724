"""Port parity for prompt-lookup speculative decoding
(tpuflow_torch.infer.speculative): the host drafter ``ngram_draft`` and the
batched ladder equal the JAX package's on random histories; tokens and
``return_stats`` equal the JAX ``speculative_generate``'s and the tokens
the port's own ``generate(temperature=0)`` (fp and fused-native int8,
batch 1 and 3, eos, chunked prefill); a drafter that always guesses the
greedy continuation commits draft_len + 1 tokens a forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.infer import quant as jquant
from tpuflow.infer import speculative as jspec
from tpuflow_torch.infer import speculative as tspec
from tpuflow_torch.infer.generate import generate
from tpuflow_torch.infer.quant import quantize_model


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


def test_ngram_draft_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(1, 40))
        hist = rng.integers(0, int(rng.integers(2, 6)), size=n)
        K, ngram = int(rng.integers(1, 7)), int(rng.integers(2, 6))
        np.testing.assert_array_equal(
            tspec.ngram_draft(hist, K, ngram=ngram),
            jspec.ngram_draft(hist, K, ngram=ngram))
    with pytest.raises(ValueError, match="non-empty"):
        tspec.ngram_draft([], 3)


def test_draft_ladder_matches_jax():
    """Random histories and valid lengths for several (W, K, G): one JAX
    compile per shape, the lengths traced."""
    ladder = jax.jit(jspec._draft_ladder, static_argnames=("K", "G"))
    rng = np.random.default_rng(1)
    for W, K, G in ((8, 1, 1), (12, 3, 2), (20, 4, 3), (30, 2, 2),
                    (15, 5, 1), (25, 3, 3)):
        for _ in range(10):
            hist = rng.integers(0, int(rng.integers(2, 5)),
                                size=(3, W)).astype(np.int32)
            n_hist = int(rng.integers(G + 1, W + 1))
            want = ladder(jnp.asarray(hist), jnp.int32(n_hist), K=K, G=G)
            got = tspec.draft_ladder(torch.from_numpy(hist).long(), n_hist,
                                     K=K, G=G)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _prompt(B, seed=0):
    """Rows repeating a 5-token segment (drafts hit), one row with a
    random head."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 512, size=5)
    prompt = np.tile(seg, (B, 4))[:, :17].astype(np.int32)
    if B > 1:
        prompt[1, :6] = rng.integers(0, 512, size=6)
    return prompt


@pytest.mark.parametrize("case", [
    dict(B=1),
    dict(B=3),
    dict(B=3, eos=True),
    dict(B=3, prefill_chunk=6),
    dict(B=1, int8=True),
    dict(B=3, int8=True, eos=True),
], ids=["b1", "b3", "b3_eos", "b3_chunked", "b1_int8", "b3_int8_eos"])
def test_tokens_and_stats_equal_jax_and_generate(pair, case):
    jm, params, tm = pair
    kw = dict(case)
    prompt = _prompt(kw.pop("B"))
    if kw.pop("int8", False):
        jm, params = jquant.quantize_model(jm, params, mode="fused_native",
                                           int8_impl="xla")
        tm = quantize_model(tm, mode="fused_native")
    if kw.pop("eos", False):
        kw["eos_id"] = int(generate(tm, prompt, max_new_tokens=5,
                                    temperature=0.0)[0, 4])
    want, wstats = jspec.speculative_generate(
        jm, params, jnp.asarray(prompt), max_new_tokens=14, draft_len=3,
        return_stats=True, **kw)
    got, stats = tspec.speculative_generate(
        tm, prompt, max_new_tokens=14, draft_len=3, return_stats=True, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == {k: int(v) for k, v in wstats.items()}
    greedy = generate(tm, prompt, max_new_tokens=14, temperature=0.0, **kw)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())


def test_greedy_drafter_commits_k_plus_one_a_forward(pair, monkeypatch):
    """Drafts taken from the greedy continuation itself are all accepted:
    every forward commits draft_len + 1 tokens (the bonus included)."""
    _, _, tm = pair
    prompt = _prompt(2, seed=4)
    T, M, K = prompt.shape[1], 12, 3
    greedy = generate(tm, prompt, max_new_tokens=M + K + 1,
                      temperature=0.0).long()

    def oracle(hist, n_hist, *, K, G):
        start = n_hist - T  # cur is greedy[:, start - 1]
        return greedy[:, start:start + K]

    monkeypatch.setattr(tspec, "draft_ladder", oracle)
    got, stats = tspec.speculative_generate(
        tm, prompt, max_new_tokens=M, draft_len=K, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), greedy[:, :M].numpy())
    assert stats == {"n_forwards": M // (K + 1), "n_committed": M}


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=0),
    dict(max_new_tokens=4, draft_len=0),
    dict(max_new_tokens=4, ngram=1),
    dict(max_new_tokens=4, ngram=20),
    dict(max_new_tokens=40),
    dict(max_new_tokens=4, prefill_chunk=0),
])
def test_validation_messages_equal_jax(pair, kw):
    jm, params, tm = pair
    prompt = _prompt(1)
    with pytest.raises(ValueError) as want:
        jspec.speculative_generate(jm, params, jnp.asarray(prompt), **kw)
    with pytest.raises(ValueError) as got:
        tspec.speculative_generate(tm, prompt, **kw)
    assert str(got.value) == str(want.value)
