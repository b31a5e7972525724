"""Port parity for beam search (tpuflow_torch.infer.beam): the same weights
and prompts through the JAX ``beam_search`` and the port's give equal best
and all-beam tokens and scores within 1e-5 (f32 log-probabilities, summed
in other orders), across dense and ragged prompts, eos freezing, chunked
prefill, the length penalty and ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.infer.beam import beam_search as jbeam
from tpuflow_torch.infer.beam import beam_search
from tpuflow_torch.infer.generate import generate
from tpuflow_torch.models.convert import params_from_jax

SCORE_ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


def _prompt(shape=(2, 9), seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=shape).astype(
        np.int32)


def _both(jm, params, tm, prompt, **kw):
    want = jbeam(jm, params, jnp.asarray(prompt), return_all=True, **kw)
    got = beam_search(tm, prompt, return_all=True, **kw)
    for w, g in zip(want[::2], got[::2]):  # best, then every beam's tokens
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for w, g in zip(want[1::2], got[1::2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=SCORE_ATOL)
    return got


def _eos(tm, prompt):
    """A token the greedy continuation of row 0 emits at its third step,
    so eos freezing really happens."""
    return int(generate(tm, prompt, max_new_tokens=3,
                        temperature=0.0)[0, 2])


@pytest.mark.parametrize("case", [
    dict(beam_size=3, max_new_tokens=6),
    dict(beam_size=3, max_new_tokens=5, prompt_lens=[9, 4]),
    dict(beam_size=4, max_new_tokens=7, eos=True),
    dict(beam_size=2, max_new_tokens=6, prefill_chunk=4),
    dict(beam_size=3, max_new_tokens=6, eos=True, length_penalty=0.0),
    dict(beam_size=3, max_new_tokens=6, eos=True, length_penalty=2.0),
    dict(beam_size=2, max_new_tokens=1),
], ids=["dense", "ragged", "eos", "prefill_chunk", "penalty0", "penalty2",
        "one_token"])
def test_beams_equal_jax(pair, case):
    jm, params, tm = pair
    prompt = _prompt()
    kw = dict(case)
    if kw.pop("eos", False):
        kw["eos_id"] = _eos(tm, prompt)
    best, scores, seqs, ranked = _both(jm, params, tm, prompt, **kw)
    K, M = kw["beam_size"], kw["max_new_tokens"]
    assert best.dtype == torch.int32 and best.shape == (2, M)
    assert seqs.shape == (2, K, M) and ranked.shape == (2, K)
    if "eos_id" in kw:
        # Some beam finished and was frozen to pad after its eos.
        flat = seqs.reshape(-1, M).numpy()
        hit = [r for r in flat if kw["eos_id"] in r[:-1].tolist()]
        assert hit, "no beam emitted eos before its last step"
        for r in hit:
            after = r[r.tolist().index(kw["eos_id"]) + 1:]
            assert (after == 0).all()


def test_beam_one_equals_greedy(pair):
    _, _, tm = pair
    prompt = _prompt(seed=3)
    best, _ = beam_search(tm, prompt, beam_size=1, max_new_tokens=8)
    np.testing.assert_array_equal(
        best.numpy(),
        generate(tm, prompt, max_new_tokens=8, temperature=0.0).numpy())


def test_tied_candidates_pick_jax_parents(pair):
    """With a zero embedding every logit is exactly 0: all K x V
    candidates tie at every step. ``jax.lax.top_k`` takes the lowest
    indices (beam 0's tokens 0..K-1); the port's stable sort must too."""
    jm, params, _ = pair
    zeroed = dict(jax.device_get(params))
    zeroed["wte"] = np.zeros_like(zeroed["wte"])
    tm = jax_and_port_gpt2()[2]
    tm.load_state_dict(params_from_jax(zeroed))
    K, M = 3, 4
    _, _, seqs, _ = _both(jm, zeroed, tm, _prompt(), beam_size=K,
                          max_new_tokens=M)
    want = np.zeros((2, K, M), np.int32)
    want[:, :, -1] = np.arange(K)
    np.testing.assert_array_equal(seqs.numpy(), want)


@pytest.mark.parametrize("n", [10, 512, 4 * 512, 200_000])
def test_top_k_breaks_ties_as_jax(n):
    """Selection with many equal values: the lower index first, as
    ``jax.lax.top_k`` (``torch.topk`` returns such ties in any order)."""
    from tpuflow_torch.infer.beam import _top_k

    x = np.zeros((3, n), np.float32)
    x[0, ::7] = 1.0
    x[1, 3::5] = -1.0
    x[2] = np.random.default_rng(n).integers(0, 3, size=n)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    got_v, got_i = _top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("kw", [
    dict(beam_size=0, max_new_tokens=2),
    dict(beam_size=2, max_new_tokens=0),
    dict(beam_size=2, max_new_tokens=2, length_penalty=-1.0),
    dict(beam_size=2, max_new_tokens=60),
    dict(beam_size=2, max_new_tokens=2, prefill_chunk=0),
    dict(beam_size=2, max_new_tokens=2, prompt_lens=[3]),
])
def test_validation_messages_equal_jax(pair, kw):
    jm, params, tm = pair
    prompt = _prompt()
    with pytest.raises(ValueError) as want:
        jbeam(jm, params, jnp.asarray(prompt), **kw)
    with pytest.raises(ValueError) as got:
        beam_search(tm, prompt, **kw)
    assert str(got.value) == str(want.value)
