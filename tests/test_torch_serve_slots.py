"""The port's contiguous engine (``ServeEngine(paged=False)``: one n_ctx
cache row a slot, the bucket pads kept at its head) against the JAX
package's ``paged=False`` engine, on the same weights and submissions.

- Greedy tokens: exactly equal, fp and fused-native int8 requests mixed,
  slots reused, one request ending on eos inside a decode block.
- ``residency_efficiency``: a ratio of integer counts, exactly equal after
  every scheduler step of the same schedule.
- The live ledger's snapshot: the same ``serve_*`` keys, without the page
  keys (``serve_pages_free``, ``serve_prefix_hit_rate``).

The fast tier runs the fp engines; the slow one arms the fused-native
int8 path too (its JAX twins' compiles, ~4 s).
"""

import importlib

import numpy as np
import pytest

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow_torch import obs
from tpuflow_torch.infer.serve import ServeEngine

jserve = importlib.import_module("tpuflow.infer.serve")
jgoodput = importlib.import_module("tpuflow.obs.goodput")

@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


@pytest.fixture(scope="module", params=[
    None, pytest.param("fused_native", marks=pytest.mark.slow)])
def engines(pair, request):
    """The port's contiguous engine and the JAX one, each built once for
    the module (the JAX programs compile on first use); ``quant`` the
    param."""
    jm, params, tm = pair
    kw = dict(max_slots=2, buckets=[8, 16], decode_block=4, paged=False,
              quant=request.param)
    return ServeEngine(tm, **kw), jserve.ServeEngine(jm, params, **kw)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=L).astype(np.int32) for L in lens]


def test_contiguous_engine_matches_jax_engine(engines):
    """Five requests through two slot rows (admissions wait for a free
    row; a padded-width admission rule), with the int8 path armed fp and
    int8 alternating, one ending on eos: tokens and residency equal the
    JAX engine's step by step, and a bucket the padded width cannot fit
    raises on both."""
    eng, jeng = engines
    armed = eng.quant_mode is not None
    prompts = _prompts(41, (3, 13, 9, 6, 11))
    flags = [False, armed, False, armed, False]
    # eos for the fourth request: a token its JAX run emits at index >= 2
    # that is new there, so it ends inside a block.
    probe = jeng.generate_many([prompts[3]], max_new_tokens=9)[0].tolist()
    stop = next(i for i in range(2, 9) if probe[i] not in probe[:i])
    eos = [None, None, None, probe[stop], None]
    reqs, jreqs = [], []
    for p, q, e in zip(prompts, flags, eos):
        reqs.append(eng.submit(p, max_new_tokens=9, quantize=q, eos_id=e))
        jreqs.append(jeng.submit(p, max_new_tokens=9, quantize=q, eos_id=e))
    seen = []
    for _ in range(100):
        if not (eng.queue_depth or eng.live_slots):
            break
        eng.step()
        jeng.step()
        got = eng.residency_efficiency()
        assert got == jeng.residency_efficiency()
        seen.append(got)
    assert not (jeng.queue_depth or jeng.live_slots)
    # Contiguous rows hold a whole n_ctx row a live slot.
    assert any(r is not None and r < 0.5 for r in seen)
    assert seen[-1] is None  # idle
    assert reqs[3].finish_reason == "eos" and len(reqs[3].tokens) == stop + 1
    for r, jr in zip(reqs, jreqs):
        assert r.done and r.finish_reason == jr.finish_reason
        np.testing.assert_array_equal(r.result(), jr.result())
    # The padded width counts: 9 tokens bucket to 16, 16 + 49 > 64.
    for e in (eng, jeng):
        assert e.bucket_for(9, 48) == 16
        with pytest.raises(ValueError, match="no prefill bucket"):
            e.bucket_for(9, 49)


def test_contiguous_engine_snapshot_has_no_page_keys(engines, tmp_path):
    """A contiguous engine feeds the live ledger no page keys, as the JAX
    one; a ``kv_key`` on it rides local prefill (``kv_fallback``)."""
    eng, jeng = engines
    snaps = []
    for e, led in ((eng, obs.goodput_live()), (jeng, jgoodput.live())):
        led.reset()
        e.generate_many([[5, 6, 7], [8]], max_new_tokens=3)
        snaps.append({k for k in led.snapshot() if k.startswith("serve_")})
        led.reset()
    assert snaps[0] == snaps[1]
    assert "serve_queue_depth" in snaps[0]
    assert not snaps[0] & {"serve_pages_free", "serve_prefix_hit_rate"}
    rows = ServeEngine(eng.model, max_slots=1, buckets=[8], paged=False,
                       kv_store_dir=str(tmp_path))
    assert rows.pool is None
    r = rows.submit([5, 6, 7], max_new_tokens=2, kv_key="absent")
    assert [t["phase"] for t in r.trace] == ["submitted", "kv_fallback"]
    rows.run_until_idle(max_iters=10)
    assert r.done and r.result().size == 2
