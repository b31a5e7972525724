"""Disaggregated prefill/decode and the tiered prefix cache on the port's
engine (tpuflow_torch.infer.serve), mirroring tests/test_serve_disagg.py.

- **A shipped admission is exact.** A prefill-role engine ships a prompt's
  KV pages through the store; a decode-role engine imports them by key and
  decodes the solo ``generate()`` tokens with no prefill of its own. The
  shipped bytes are the pool pages a local admission writes.
- **Suffix resume**, **torn, unknown and quant-mismatched sets fall back**
  to local prefill (``kv_fallback``), never an error.
- **Tier promotion is exact**: pages evicted to the host or disk tier
  promote back on re-admission with no prefill, and the disk tier survives
  an engine restart.
- **Across the packages**: a set shipped by the JAX engine imports into
  the port's engine with the JAX ``generate()``'s tokens, and the two
  packages' pages of one prompt agree within float tolerance.

The ship matrix over quant, speculative decode and page boundaries is in
the slow tier. The router's chaos case waits for the router's port.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow_torch import obs
from tpuflow_torch.infer import kv_store
from tpuflow_torch.infer.generate import generate
from tpuflow_torch.infer.serve import ServeEngine, resolve_serve_role

jserve = importlib.import_module("tpuflow.infer.serve")
jgen = importlib.import_module("tpuflow.infer.generate")

# The JAX and the port's prefills of one prompt agree to float rounding
# (~2e-6 at this size); their pages are held within this.
CROSS_PAGE_ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


@pytest.fixture(scope="module")
def ship_pair(pair, tmp_path_factory):
    """One prefill-role and one decode-role engine sharing a store."""
    _, _, tm = pair
    store = str(tmp_path_factory.mktemp("kvstore"))
    kw = dict(max_slots=2, buckets=[8, 16], decode_block=4, page_size=8,
              kv_store_dir=store)
    return (ServeEngine(tm, role="prefill", **kw),
            ServeEngine(tm, role="decode", **kw))


def _solo(model, prompt, n_new):
    return generate(model, np.asarray(prompt, np.int32)[None, :],
                    max_new_tokens=n_new, temperature=0.0)[0].tolist()


def _drive(engine, handle):
    engine.run_until_idle(max_iters=400)
    assert handle.done
    return [int(t) for t in handle.tokens]


def _admitted(handle) -> dict:
    return next(t for t in handle.trace if t["phase"] == "admitted")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 512, size=n).astype(
        np.int32)


# ------------------------------------------------------------ role knob
def test_resolve_serve_role():
    assert resolve_serve_role() == "both"
    for role in ("Prefill", "decode", " both "):
        assert resolve_serve_role(role) == jserve.resolve_serve_role(role)
    with pytest.raises(ValueError, match="role"):
        resolve_serve_role("router")
    with pytest.raises(ValueError, match="role"):
        jserve.resolve_serve_role("router")


# ----------------------------------------------------------------- ship
def test_ship_roundtrip_exact_with_no_decode_prefill(pair, ship_pair):
    """Ship, import by key, decode: the solo generate() tokens, no prefill
    on the decode engine, a trace that says so; the shipped pages are the
    bytes a local admission of the prompt writes into its pool pages."""
    _, _, tm = pair
    pf, dc = ship_pair
    prompt = _prompt(3, 9)
    want = _solo(tm, prompt, 6)
    key = pf.ship(prompt)
    assert key == kv_store.prompt_key(prompt) and pf.kv_store.contains(key)
    before = dc._prefill_calls
    h = dc.submit(prompt, max_new_tokens=6, kv_key=key)
    assert h.kv_import is not None
    assert _drive(dc, h) == want
    assert h.finish_reason == "budget"
    assert dc._prefill_calls == before  # no local prefill
    adm = _admitted(h)
    assert adm["prefilled"] == "ship" and adm["shipped_pages"] == 2
    assert [t["phase"] for t in h.trace] == [
        "submitted", "admitted", "first_token", "complete"]
    # A local admission on the prefill engine: its pool pages hold the
    # shipped bytes in every column the prompt covers.
    pset = pf.kv_store.load(key)
    local = pf.submit(prompt, max_new_tokens=8)
    pf.step()
    slot = next(s for s, r in enumerate(pf._slots) if r is local)
    for j, pid in enumerate(pf._slot_pages[slot][:pset.n_pages]):
        cols = min(8, prompt.size - 8 * j)
        page = pf._read_page_host(pid)
        for name, arr in pset.pages.items():
            assert page[name][:cols].tobytes() == arr[j, :cols].tobytes()
    pf.run_until_idle()


def test_ship_suffix_resume_prefills_only_the_suffix(pair, ship_pair):
    _, _, tm = pair
    pf, dc = ship_pair
    base = _prompt(4, 8)  # one full page
    ext = np.concatenate([base, _prompt(40, 3)])
    want = _solo(tm, ext, 5)
    key = pf.ship(base)
    before = dc._prefill_calls
    h = dc.submit(ext, max_new_tokens=5, kv_key=key)
    assert h.kv_import is not None  # a chain-prefix match
    assert _drive(dc, h) == want
    assert dc._prefill_calls == before + 1  # the suffix's prefill
    assert _admitted(h)["shipped_pages"] == 1


def test_torn_shipped_set_falls_back_to_local_prefill(pair, ship_pair):
    _, _, tm = pair
    pf, dc = ship_pair
    prompt = _prompt(5, 12)
    want = _solo(tm, prompt, 5)
    key = pf.ship(prompt)
    blob = pf.kv_store._blob(key)
    data = bytearray(open(blob, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(blob, "wb").write(bytes(data))
    before = dc._prefill_calls
    h = dc.submit(prompt, max_new_tokens=5, kv_key=key)
    assert h.kv_import is None
    assert _drive(dc, h) == want
    assert dc._prefill_calls == before + 1  # the local fallback
    assert any(t["phase"] == "kv_fallback" for t in h.trace)
    assert "prefilled" not in _admitted(h)


def test_ship_requires_a_store(pair):
    _, _, tm = pair
    eng = ServeEngine(tm, max_slots=1, buckets=[8], decode_block=2,
                      page_size=8)
    assert eng.kv_store is None and eng.role == "both"
    with pytest.raises(ValueError, match="KV store"):
        eng.ship(np.arange(1, 9, dtype=np.int32))


def test_unknown_kv_key_is_a_clean_fallback(pair, ship_pair):
    _, _, tm = pair
    _, dc = ship_pair
    prompt = _prompt(6, 7)
    h = dc.submit(prompt, max_new_tokens=4, kv_key="no-such-key")
    assert h.kv_import is None
    assert _drive(dc, h) == _solo(tm, prompt, 4)
    assert [t["phase"] for t in h.trace][:2] == ["submitted", "kv_fallback"]


def test_quant_mismatched_import_is_rejected(pair, tmp_path):
    """fp pages never import into an int8 admission (nor the reverse): the
    request falls back to local prefill and equals its own path's solo
    generate()."""
    _, _, tm = pair
    store = str(tmp_path / "kv")
    kw = dict(max_slots=2, buckets=[8, 16], decode_block=4, page_size=8,
              kv_store_dir=store, quant="fused_native")
    pf = ServeEngine(tm, role="prefill", **kw)
    dc = ServeEngine(tm, role="decode", **kw)
    prompt = _prompt(9, 9)
    key_fp = pf.ship(prompt)
    h = dc.submit(prompt, max_new_tokens=5, kv_key=key_fp, quantize=True)
    assert h.kv_import is None
    assert _drive(dc, h) == _solo(dc._qmodel, prompt, 5)
    key_q = pf.ship(prompt, quantize=True)
    assert key_q == key_fp  # the prompt keys the set: the int8 one won
    before = dc._prefill_calls
    h = dc.submit(prompt, max_new_tokens=5, kv_key=key_q)
    assert h.kv_import is None  # an fp request refuses int8 pages
    h = dc.submit(prompt, max_new_tokens=5, kv_key=key_q, quantize=True)
    assert h.kv_import is not None
    dc.run_until_idle(max_iters=400)
    assert h.tokens == _solo(dc._qmodel, prompt, 5)
    assert dc._prefill_calls == before + 1  # the fp fallback's only


def test_foreign_leaves_are_a_clean_fallback(pair, ship_pair):
    """A set whose page leaves this engine's model does not have (another
    depth, a scanned JAX model) is refused at submit, never an error."""
    _, _, tm = pair
    pf, dc = ship_pair
    prompt = _prompt(11, 9)
    pset = pf.prefill_export(prompt)
    pset.pages = {k.replace("cached", "stacked"): v
                  for k, v in pset.pages.items()}
    key = dc.kv_store.commit(pset)
    h = dc.submit(prompt, max_new_tokens=3, kv_key=key)
    assert h.kv_import is None
    assert _drive(dc, h) == _solo(tm, prompt, 3)


# ----------------------------------------------------------- tier cache
def _churn_until(eng, rng, done, rounds=12):
    for _ in range(rounds):
        p = rng.integers(0, 512, size=int(rng.integers(9, 16)))
        _drive(eng, eng.submit(p.astype(np.int32), max_new_tokens=4))
        if done():
            return
    raise AssertionError("churn never evicted the hot pages")


def test_tier_promotion_readmits_without_prefill(pair, tmp_path):
    """Evict a hot prompt's pages to the host tier through pool pressure,
    re-admit it: its pages promote back, no prefill runs (a feed
    admission: 2 full pages + 1 token), the tokens equal solo generate();
    the obs recorder holds the tier's events."""
    _, _, tm = pair
    obs.configure(str(tmp_path / "obs"))
    try:
        eng = ServeEngine(tm, max_slots=1, buckets=[16, 32], decode_block=4,
                          page_size=8, n_pages=9, kv_host_mb=8.0)
        rng = np.random.default_rng(7)
        hot = rng.integers(0, 512, size=17).astype(np.int32)
        want = _solo(tm, hot, 5)
        assert _drive(eng, eng.submit(hot, max_new_tokens=5)) == want
        tier = eng.pool.tier
        hot_digests = kv_store.chain_digests(hot, 8)
        _churn_until(eng, rng, lambda: all(
            tier.locate(d) == "host" for d in hot_digests))
        prefills, hits = eng._prefill_calls, tier.hits_host
        h = eng.submit(hot, max_new_tokens=5)
        assert _drive(eng, h) == want  # promotion is exact
        assert eng._prefill_calls == prefills
        assert tier.hits_host == hits + 2 and eng.pool.tier_hits >= 2
        adm = _admitted(h)
        assert (adm["prefilled"], adm["promoted_pages"]) == ("feed", 2)
        assert h.ttft_s is not None and h.t_first > h.t_admit
        obs.flush()
        names = {e["name"] for e in obs.read_events(obs.recorder().path)}
    finally:
        obs.configure(None)
    assert {"serve.tier_spill", "serve.page_evict", "serve.tier_hit",
            "serve.tier_promote", "serve.admit", "serve.trace"} <= names


def test_promotion_ending_on_a_page_boundary_prefills(pair, tmp_path):
    """A promoted prompt of exactly 2 pages: column L - 1 lies in a
    restored page that the prefix cache shares, so the admission prefills
    (a feed's decode step would rewrite it) with the restored pages masked
    off the write. The promoted pages keep a local admission's bytes, and a
    later request sharing them equals solo generate()."""
    _, _, tm = pair
    kw = dict(max_slots=1, buckets=[16, 32], decode_block=4, page_size=8,
              n_pages=9)
    eng = ServeEngine(tm, kv_host_mb=8.0, **kw)
    rng = np.random.default_rng(15)
    hot = rng.integers(0, 512, size=16).astype(np.int32)
    want = _solo(tm, hot, 5)
    assert _drive(eng, eng.submit(hot, max_new_tokens=5)) == want
    tier = eng.pool.tier
    hot_digests = kv_store.chain_digests(hot, 8)
    _churn_until(eng, rng, lambda: all(
        tier.locate(d) == "host" for d in hot_digests))
    prefills = eng._prefill_calls
    h = eng.submit(hot, max_new_tokens=5)
    assert _drive(eng, h) == want
    adm = _admitted(h)
    assert (adm["prefilled"], adm["promoted_pages"]) == ("prefill", 2)
    assert eng._prefill_calls == prefills + 1
    local = ServeEngine(tm, **kw)
    assert _drive(local, local.submit(hot, max_new_tokens=5)) == want
    for d in hot_digests:
        mine = eng._read_page_host(eng.pool._hash_to_page[d])
        theirs = local._read_page_host(local.pool._hash_to_page[d])
        for name, arr in theirs.items():
            assert mine[name].tobytes() == arr.tobytes(), name
    ext = np.concatenate([hot, rng.integers(0, 512, size=3)]).astype(
        np.int32)
    h = eng.submit(ext, max_new_tokens=5)
    assert _drive(eng, h) == _solo(tm, ext, 5)
    assert _admitted(h)["shared_pages"] == 2


def test_disk_tier_survives_engine_restart(pair, tmp_path):
    _, _, tm = pair
    disk = str(tmp_path / "tier")
    rng = np.random.default_rng(10)
    hot = rng.integers(0, 512, size=17).astype(np.int32)
    want = _solo(tm, hot, 5)
    hot_digests = kv_store.chain_digests(hot, 8)

    def build():
        return ServeEngine(tm, max_slots=1, buckets=[16, 32],
                           decode_block=4, page_size=8, n_pages=9,
                           kv_disk_dir=disk)

    eng = build()
    assert _drive(eng, eng.submit(hot, max_new_tokens=5)) == want
    _churn_until(eng, rng, lambda: all(
        eng.pool.tier.locate(d) == "disk" for d in hot_digests))
    reborn = build()  # the restart: a fresh pool over the same directory
    assert reborn.pool.tier.pages_disk >= 2
    h = reborn.submit(hot, max_new_tokens=5)
    assert _drive(reborn, h) == want
    assert reborn._prefill_calls == 0
    assert reborn.pool.tier.hits_disk == 2
    assert _admitted(h)["prefilled"] == "feed"


def test_queued_trace_reasons(pair):
    _, _, tm = pair
    eng = ServeEngine(tm, max_slots=1, buckets=[8, 16], decode_block=4,
                      page_size=8)
    a = eng.submit(_prompt(12, 5), max_new_tokens=6)
    b = eng.submit(_prompt(13, 6), max_new_tokens=6)
    eng.run_until_idle(max_iters=50)
    assert [t["phase"] for t in a.trace] == [
        "submitted", "admitted", "first_token", "complete"]
    queued = [t for t in b.trace if t["phase"] == "queued"]
    assert [t["reason"] for t in queued] == ["slots"]  # once, not a tick
    assert b.trace[-1]["reason"] == "budget"


# ------------------------------------------------------ across packages
def test_jax_shipped_set_imports_into_the_port(pair, tmp_path):
    """The JAX engine ships; the port's decode engine imports the set with
    no prefill and decodes the JAX generate()'s tokens; the port's own
    export of the prompt holds the same pages within CROSS_PAGE_ATOL."""
    jm, params, tm = pair
    store = str(tmp_path / "kv")
    jpf = jserve.ServeEngine(jm, params, max_slots=2, buckets=[8, 16],
                             decode_block=4, page_size=8, role="prefill",
                             kv_store_dir=store)
    prompt = _prompt(3, 11)
    want = np.asarray(jgen.generate(
        jm, params, jnp.asarray(prompt[None]), max_new_tokens=6,
        temperature=0.0))[0].tolist()
    key = jpf.ship(prompt)
    dc = ServeEngine(tm, max_slots=2, buckets=[8, 16], decode_block=4,
                     page_size=8, role="decode", kv_store_dir=store)
    h = dc.submit(prompt, max_new_tokens=6, kv_key=key)
    assert h.kv_import is not None
    assert _drive(dc, h) == want
    assert dc._prefill_calls == 0 and _admitted(h)["prefilled"] == "ship"
    theirs, mine = jpf.kv_store.load(key), dc.prefill_export(prompt)
    assert sorted(theirs.pages) == sorted(mine.pages)
    assert theirs.digests == mine.digests and theirs.tok0 == mine.tok0
    for name, arr in theirs.pages.items():
        assert arr.shape == mine.pages[name].shape
        np.testing.assert_allclose(mine.pages[name], arr, rtol=0,
                                   atol=CROSS_PAGE_ATOL)


# ------------------------------------------------------------ slow tier
@pytest.mark.slow
def test_ship_matrix_quant_spec_page_boundaries(pair, tmp_path):
    """fp/int8 x speculative/plain x L in {ps - 1, ps, ps + 1}: every
    shipped admission equals its path's solo generate() with no prefill on
    the decode engine."""
    _, _, tm = pair
    store = str(tmp_path / "kv")
    kw = dict(max_slots=2, buckets=[8, 16], decode_block=4, page_size=8,
              kv_store_dir=store, quant="fused_native")
    pf = ServeEngine(tm, role="prefill", **kw)
    dc = ServeEngine(tm, role="decode", speculative=2, **kw)
    rng = np.random.default_rng(8)
    for L in (7, 8, 9):
        prompt = rng.integers(0, 512, size=L).astype(np.int32)
        refs = {False: _solo(tm, prompt, 6),
                True: _solo(dc._qmodel, prompt, 6)}
        for quant in (False, True):
            key = pf.ship(prompt, quantize=quant)
            for spec in (False, True):
                before = dc._prefill_calls
                h = dc.submit(prompt, max_new_tokens=6, kv_key=key,
                              quantize=quant, speculative=spec)
                assert h.kv_import is not None, (L, quant, spec)
                assert _drive(dc, h) == refs[quant], (L, quant, spec)
                assert dc._prefill_calls == before, (L, quant, spec)


def test_bf16_cache_ships_spills_and_promotes(pair, tmp_path):
    """A bfloat16 KV cache (numpy has no bfloat16: pages travel as their
    16-bit patterns) ships, imports, spills and promotes exactly."""
    import dataclasses

    import torch

    from tpuflow_torch.models.gpt2 import GPT2

    _, _, tm = pair
    cfg = dataclasses.replace(tm.config, cache_dtype=torch.bfloat16)
    bm = GPT2(cfg, device="cpu")
    bm.load_state_dict(tm.state_dict())
    store = str(tmp_path / "kv")
    kw = dict(max_slots=1, buckets=[16, 32], decode_block=4, page_size=8,
              n_pages=9, kv_store_dir=store, kv_host_mb=8.0)
    pf, dc = ServeEngine(bm, **kw), ServeEngine(bm, **kw)
    rng = np.random.default_rng(14)
    hot = rng.integers(0, 512, size=17).astype(np.int32)
    want = _solo(bm, hot, 5)
    h = dc.submit(hot, max_new_tokens=5, kv_key=pf.ship(hot))
    assert h.kv_import is not None and _drive(dc, h) == want
    assert _admitted(h)["prefilled"] == "ship"
    tier = dc.pool.tier
    _churn_until(dc, rng, lambda: all(
        tier.locate(d) == "host" for d in kv_store.chain_digests(hot, 8)))
    calls = dc._prefill_calls
    h = dc.submit(hot, max_new_tokens=5)
    assert _drive(dc, h) == want
    assert _admitted(h)["prefilled"] == "feed"
    assert dc._prefill_calls == calls
