"""The port's paged serving engine (tpuflow_torch.infer.serve), mirroring
tests/test_serve.py: host-pure page accounting, and the token contract —
every request decoded through the engine (left-padded to a bucket,
scattered across pool pages, batched beside unrelated sequences, fp or
int8) equals a solo ``generate(temperature=0)`` of its prompt, and for
one prompt per numeric path the JAX package's ``generate()`` too."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.infer import quant as jquant
from tpuflow_torch.infer.generate import generate
from tpuflow_torch.infer.serve import (
    PagePool,
    ServeEngine,
    default_buckets,
    resolve_buckets,
    resolve_page_size,
)
from tpuflow_torch.ops import int8_matmul as tim

jserve = importlib.import_module("tpuflow.infer.serve")
jgen_mod = importlib.import_module("tpuflow.infer.generate")


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


@pytest.fixture(scope="module")
def engine(pair):
    """One 2-slot paged engine (page_size 8, int8 armed) shared by the
    fast tests, as the JAX suite shares its warmed engine."""
    _, _, tm = pair
    eng = ServeEngine(
        tm, max_slots=2, buckets=[8, 16], decode_block=4, page_size=8,
        quant="fused_native",
    )
    return eng


def _solo(model, prompt, n_new, **kw):
    return generate(
        model, np.asarray(prompt, np.int32)[None, :], max_new_tokens=n_new,
        temperature=0.0, **kw,
    )[0].numpy()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=L).astype(np.int32) for L in lens]


# ------------------------------------------------------------ pure units
def test_page_pool_accounting():
    """PagePool host-side edges: trash-page reserve, allocation,
    backpressure, prefix chain matching + self-registration, refcounts
    across sharers, idle retention, and LRU eviction."""
    pool = PagePool(n_pages=6, page_size=4)  # pages 1..5 usable
    assert pool.usable_pages == 5 and pool.free_pages == 5
    prompt = np.arange(10, dtype=np.int32)  # 2 full pages + 2 tokens
    digests = pool.prefix_digests(prompt)
    assert len(digests) == 2  # only FULLY prompt-covered pages hash
    assert pool.match_len(digests) == 0
    ids, matched = pool.acquire(prompt, 3)
    assert matched == 0 and len(ids) == 3 and 0 not in ids
    assert pool.free_pages == 2 and pool.allocated_pages == 3
    ids2, matched2 = pool.acquire(prompt, 3)
    assert matched2 == 2 and ids2[:2] == ids[:2] and ids2[2] != ids[2]
    assert pool.free_pages == 1
    assert pool.prefix_hits == 2
    other = np.arange(100, 112, dtype=np.int32)
    assert pool.acquire(other, 2) is None  # backpressure
    pool.release(ids)
    assert pool.free_pages == 2 and pool.allocated_pages == 3
    pool.release(ids2)
    assert pool.allocated_pages == 0 and pool.free_pages == 5
    assert pool.match_len(digests) == 2  # idle, still matchable
    ids3, matched3 = pool.acquire(prompt, 2)
    assert matched3 == 2 and ids3 == ids[:2] and pool.evictions == 0
    pool.release(ids3)
    ids4, m4 = pool.acquire(other, 5)
    assert m4 == 0 and len(ids4) == 5
    assert pool.evictions == 2  # both idle prefix pages reclaimed, LRU
    assert pool.match_len(digests) == 0
    flat = PagePool(n_pages=4, page_size=2, prefix_cache=False)
    assert flat.prefix_digests(prompt) == []
    a, m = flat.acquire(prompt, 2)
    b, m2 = flat.acquire(prompt, 1)
    assert m == m2 == 0 and not set(a) & set(b)
    with pytest.raises(ValueError, match="n_pages"):
        PagePool(n_pages=1, page_size=4)


def test_host_helpers_match_jax():
    """The copied host-side pieces agree with the JAX package's: bucket
    ladders, page-size resolution, and the sha1 prefix digest chain."""
    for n_ctx in (20, 64, 128, 1024):
        assert default_buckets(n_ctx) == jserve.default_buckets(n_ctx)
        assert resolve_page_size(n_ctx) == jserve.resolve_page_size(n_ctx)
    assert resolve_buckets(64, [16, 8, 8, 99]) == \
        jserve.resolve_buckets(64, [16, 8, 8, 99]) == [8, 16]
    with pytest.raises(ValueError, match="bucket"):
        resolve_buckets(64, [64])
    with pytest.raises(ValueError, match="page_size"):
        resolve_page_size(64, 7)
    prompt = np.arange(37, dtype=np.int32)
    assert PagePool(4, 8).prefix_digests(prompt) == \
        jserve.PagePool(4, 8).prefix_digests(prompt)


# ------------------------------------------------- engine decode contracts
def test_unequal_requests_token_exact(engine, pair):
    """Four unequal-length requests through TWO slots (admissions wait on
    evictions, slots are reused), an eos early exit, and a one-token
    request that completes at admission: every request equals its solo
    generate()."""
    _, _, tm = pair
    prompts = _prompts(1, (3, 8, 11, 6))
    reqs = [engine.submit(p, max_new_tokens=7) for p in prompts]
    engine.run_until_idle(max_iters=200)
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(r.result(), _solo(tm, p, 7))
        assert r.done and r.finish_reason == "budget"
        assert r.ttft_s is not None and r.ttft_s >= 0
        assert r.decode_tokens_per_s is None or r.decode_tokens_per_s > 0
    want = _solo(tm, prompts[0], 7)
    eos = int(want[3])
    r = engine.submit(prompts[0], max_new_tokens=7, eos_id=eos)
    engine.run_until_idle(max_iters=200)
    assert r.finish_reason == "eos"
    assert r.tokens == list(want[:4])
    r1 = engine.submit(prompts[1], max_new_tokens=1)
    engine.run_until_idle(max_iters=10)
    assert r1.done and r1.tokens == [int(_solo(tm, prompts[1], 1)[0])]
    assert engine.live_slots == 0 and engine.queue_depth == 0
    assert engine.pool.allocated_pages == 0


def test_interleaved_submission_mid_decode(engine, pair):
    _, _, tm = pair
    p1, p2, p3 = _prompts(2, (5, 12, 7))
    r1 = engine.submit(p1, max_new_tokens=9)
    engine.step()
    assert engine.live_slots == 1
    r2 = engine.submit(p2, max_new_tokens=5)
    engine.step()
    r3 = engine.submit(p3, max_new_tokens=6)
    engine.run_until_idle(max_iters=200)
    for p, r, n in ((p1, r1, 9), (p2, r2, 5), (p3, r3, 6)):
        np.testing.assert_array_equal(r.result(), _solo(tm, p, n))


def test_page_boundary_lengths_exact(engine, pair):
    """Prompt length one under / on / one over a page boundary, with
    budgets landing the final frontier on and around page multiples."""
    _, _, tm = pair
    rng = np.random.default_rng(21)
    for L, n in ((7, 7), (8, 7), (9, 7), (8, 8)):
        p = rng.integers(0, 512, size=L).astype(np.int32)
        r = engine.submit(p, max_new_tokens=n)
        engine.run_until_idle(max_iters=100)
        np.testing.assert_array_equal(r.result(), _solo(tm, p, n))
        assert r.finish_reason == "budget"
    assert engine.pool.allocated_pages == 0


def test_mixed_fp_int8_exact_and_matches_jax(engine, pair):
    """fp and int8 requests share the engine and the pool, each group's
    block running with the other masked out: every request equals the
    port's solo generate() on its own numeric path, and the first prompt
    of each path equals the JAX package's generate() too."""
    jm, params, tm = pair
    qm = engine._qmodel
    prompts = _prompts(3, (4, 13, 9, 6))
    flags = [False, True, True, False]
    tim.launches = 0
    reqs = [engine.submit(p, max_new_tokens=6, quantize=q)
            for p, q in zip(prompts, flags)]
    engine.run_until_idle(max_iters=200)
    assert tim.launches == 0  # CPU tensors: the plain version
    for p, q, r in zip(prompts, flags, reqs):
        np.testing.assert_array_equal(
            r.result(), _solo(qm if q else tm, p, 6)
        )
    want_fp = np.asarray(jgen_mod.generate(
        jm, params, jnp.asarray(prompts[0][None]), max_new_tokens=6,
        temperature=0.0,
    ))[0]
    np.testing.assert_array_equal(reqs[0].result(), want_fp)
    jqm, jqp = jquant.quantize_model(jm, params, mode="fused_native",
                                     int8_impl="xla")
    want_q = np.asarray(jgen_mod.generate(
        jqm, jqp, jnp.asarray(prompts[1][None]), max_new_tokens=6,
        temperature=0.0,
    ))[0]
    np.testing.assert_array_equal(reqs[1].result(), want_q)


def test_speculative_and_weight_only_match_solo_and_jax_engine(pair):
    """A weight-only, speculative-armed engine (drafts of 3): plain and
    speculative requests on both numeric paths, one ending on eos, share
    the pool. Each equals its solo generate() and the JAX engine's answer
    to the same submissions."""
    jm, params, tm = pair
    rng = np.random.default_rng(31)
    seg = rng.integers(0, 512, size=4).astype(np.int32)
    prompts = [np.tile(seg, 4)[:L] for L in (5, 13, 16)] + _prompts(32, (7,))
    flags = [(False, False), (True, True), (False, True), (True, False)]
    # eos: the first token of prompt 2's solo continuation that is new at
    # its index >= 2, so the request ends inside a block.
    solo2 = _solo(tm, prompts[2], 9).tolist()
    stop = next(i for i in range(2, 9) if solo2[i] not in solo2[:i])
    eos = [None, None, solo2[stop], None]
    kw = dict(max_slots=3, buckets=[8, 16], decode_block=4, page_size=8,
              quant="weight_only", speculative=3)
    eng = ServeEngine(tm, **kw)
    jeng = jserve.ServeEngine(jm, params, **kw)
    reqs, jreqs = [], []
    for p, (q, sp), e in zip(prompts, flags, eos):
        reqs.append(eng.submit(p, max_new_tokens=9, quantize=q,
                               speculative=sp, eos_id=e))
        jreqs.append(jeng.submit(p, max_new_tokens=9, quantize=q,
                                 speculative=sp, eos_id=e))
    eng.run_until_idle(max_iters=200)
    jeng.run_until_idle(max_iters=200)
    assert reqs[2].finish_reason == "eos"
    assert len(reqs[2].tokens) == stop + 1
    for p, (q, _), e, r, jr in zip(prompts, flags, eos, reqs, jreqs):
        model = eng._qmodel if q else tm
        want = _solo(model, p, 9, eos_id=e)[:len(r.tokens)]
        np.testing.assert_array_equal(r.result(), want)
        np.testing.assert_array_equal(r.result(), jr.result())
    assert eng.spec_accept_rate == pytest.approx(jeng.spec_accept_rate)
    assert eng.spec_accept_rate > 1.0  # the repeated segment drafts hit
    assert eng.pool.allocated_pages == 0


def test_speculative_fused_native_and_validation(pair):
    """Speculative requests on the fused-native path equal their solo
    generate(); submit(speculative=True) on an unarmed engine raises; a
    speculative request reserves the draft's overshoot in pages."""
    _, _, tm = pair
    eng = ServeEngine(tm, max_slots=2, buckets=[8, 16], decode_block=4,
                      page_size=8, quant="fused_native", speculative=True)
    assert eng.spec_draft == 4
    prompts = _prompts(33, (6, 11, 3))
    outs = eng.generate_many(prompts, max_new_tokens=7, quantize=True)
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _solo(eng._qmodel, p, 7))
    plain = ServeEngine(tm, max_slots=1, buckets=[8], page_size=8)
    with pytest.raises(ValueError, match="spec-armed"):
        plain.submit([1, 2], max_new_tokens=2, speculative=True)
    with pytest.raises(ValueError, match="spec_ngram"):
        ServeEngine(tm, speculative=2, spec_ngram=1)
    with pytest.raises(ValueError, match="draft length must be >= 0"):
        ServeEngine(tm, speculative=-1)
    with pytest.raises(ValueError, match="already-quantized"):
        ServeEngine(eng._qmodel, quant="weight_only")
    r = eng.submit(np.arange(8), max_new_tokens=8)  # 16 + 4 columns
    assert r.speculative and eng._pages_needed(r) == 3
    r = eng.submit(np.arange(8), max_new_tokens=8, speculative=False)
    assert eng._pages_needed(r) == 2
    eng.run_until_idle(max_iters=100)


def test_prefix_cache_reuse_eviction(pair):
    """Two requests sharing a 2-page prefix decode exactly while the second
    SHARES the first's prefix pages; after release the pages idle in the
    cache, a third sharer reactivates them, and pool pressure evicts them
    LRU-first — never the trash page."""
    _, _, tm = pair
    eng = ServeEngine(tm, max_slots=2, buckets=[8, 16, 32], decode_block=4,
                      page_size=8, n_pages=9)  # 8 usable pages
    rng = np.random.default_rng(22)
    pre = rng.integers(0, 512, size=16).astype(np.int32)  # 2 full pages
    pa = np.concatenate([pre, rng.integers(0, 512, size=3).astype(np.int32)])
    pb = np.concatenate([pre, rng.integers(0, 512, size=5).astype(np.int32)])
    ra = eng.submit(pa, max_new_tokens=5)
    eng.step()
    rb = eng.submit(pb, max_new_tokens=5)  # shares the LIVE prefix pages
    eng.run_until_idle(max_iters=200)
    np.testing.assert_array_equal(ra.result(), _solo(tm, pa, 5))
    np.testing.assert_array_equal(rb.result(), _solo(tm, pb, 5))
    assert eng.pool.prefix_hits == 2 and eng.pool.evictions == 0
    assert eng.pool.allocated_pages == 0 and eng.pool.free_pages == 8
    rc = eng.submit(pa, max_new_tokens=4)
    eng.run_until_idle(max_iters=200)
    np.testing.assert_array_equal(rc.result(), _solo(tm, pa, 4))
    assert eng.pool.prefix_hits == 4 and eng.pool.evictions == 0
    fat = rng.integers(0, 512, size=30).astype(np.int32)
    rf = eng.submit(fat, max_new_tokens=30)  # ceil(60/8) = 8 pages
    eng.run_until_idle(max_iters=300)
    np.testing.assert_array_equal(rf.result(), _solo(tm, fat, 30))
    assert eng.pool.evictions == 2


def test_pool_exhaustion_backpressure(pair):
    """A full pool leaves the head-of-queue request queued (never dropped)
    while a slot is free; it admits once pages are released and decodes
    exactly. A request that could never fit fails at submit."""
    _, _, tm = pair
    eng = ServeEngine(tm, max_slots=2, buckets=[8], decode_block=4,
                      page_size=8, n_pages=3, prefix_cache=False)
    p = np.random.default_rng(23).integers(0, 512, size=4).astype(np.int32)
    q1 = eng.submit(p, max_new_tokens=8)  # ceil(12/8) = 2 pages
    q2 = eng.submit(p, max_new_tokens=8)  # must wait for them
    eng.step()
    assert q1.state == "running"
    assert q2.state == "queued" and eng.queue_depth == 1
    assert eng._free_slot() is not None
    eng.run_until_idle(max_iters=300)
    assert q1.done and q2.done
    np.testing.assert_array_equal(q2.result(), _solo(tm, p, 8))
    with pytest.raises(ValueError, match="pool"):
        eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=20)


def test_submit_validation_and_deferred_modes(engine, pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="at least one token"):
        engine.submit([], max_new_tokens=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.submit([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError, match="no prefill bucket"):
        engine.submit(np.arange(17), max_new_tokens=2)
    plain = ServeEngine(tm, max_slots=1, buckets=[8], page_size=8)
    with pytest.raises(ValueError, match="quant-armed"):
        plain.submit([1, 2], max_new_tokens=2, quantize=True)
    with pytest.raises(NotImplementedError, match="contiguous"):
        ServeEngine(tm, paged=False)
    weight = ServeEngine(tm, max_slots=1, buckets=[8], page_size=8,
                         quant="weight_only")
    assert weight.quant_mode == "weight" and weight._qmodel.mode == "weight"
    np.testing.assert_array_equal(
        weight.generate_many([[5, 6, 7]], max_new_tokens=3,
                             quantize=True)[0],
        _solo(weight._qmodel, [5, 6, 7], 3))
    outs = plain.generate_many([[5, 6, 7], [8]], max_new_tokens=3)
    for p, o in zip(([5, 6, 7], [8]), outs):
        np.testing.assert_array_equal(o, _solo(tm, p, 3))
