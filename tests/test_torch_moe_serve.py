"""Switch-MoE GPT-2 serving on the port against the JAX package, on the
same weights (``small_test``, n_ctx 64, 4 experts, capacity factor 1.25)
and the same submissions.

The fast tier holds the fp engine (plain and speculative requests, a
prefix hit, an eos inside a block, a dropped token) and the int8 leaves;
the slow tier (each case 4-10 s of JAX compiles) the fused-native and
weight-only engines, the ship pair, ``speculative_generate`` and the
predictor's engine route.

The oracle is the JAX package under the same call structure
(``models/moe.py``'s contract): an expert's capacity counts the T of one
call, so a bucket's pads, a verify chunk or a prefix hit can drop other
tokens than a solo ``generate()``. Each JAX engine is built once for the
module. Tolerances: greedy tokens and ``residency_efficiency`` (a ratio
of integer counts) exactly equal; int8 leaves (values and scales) and
their byte counts exactly equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.infer import quant as jquant
from tpuflow_torch.infer import quant as tquant
from tpuflow_torch.infer import speculative as tspec
from tpuflow_torch.infer.engine import GenerationPredictor, map_batches
from tpuflow_torch.infer.serve import ServeEngine
from tpuflow_torch.models.moe import MoEMLP

jserve = importlib.import_module("tpuflow.infer.serve")
jspec = importlib.import_module("tpuflow.infer.speculative")
jengine = importlib.import_module("tpuflow.infer.engine")

GATE_MIN = 256  # quantize_model(min_size=): the 128 x 4 router passes it


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2(n_experts=4)


@pytest.fixture(scope="module", params=[
    None, pytest.param("fused_native", marks=pytest.mark.slow)])
def spec_engines(pair, request):
    """A speculative-armed engine in each package (fp, or with the
    fused-native int8 path armed)."""
    jm, params, tm = pair
    kw = dict(max_slots=3, buckets=[16, 32], decode_block=4, page_size=8,
              quant=request.param, speculative=3)
    return ServeEngine(tm, **kw), jserve.ServeEngine(jm, params, **kw)


@pytest.fixture
def drops(monkeypatch):
    """Every port MoE routing of a one-row call as ``(T, kept)``, kept a
    (T,) bool array: was each token given a slot of its expert."""
    seen = []
    real = MoEMLP.route

    def spy(self, x, seq=None, **kw):
        out = real(self, x, seq, **kw)
        if x.shape[0] == 1:
            seen.append((x.shape[1], out[2].sum(dim=(2, 3))[0].numpy() > 0))
        return out

    monkeypatch.setattr(MoEMLP, "route", spy)
    return seen


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=L).astype(np.int32) for L in lens]


def _lockstep(eng, jeng, reqs, jreqs):
    """Step both engines together to idle, residency equal every step."""
    for _ in range(200):
        if not (eng.queue_depth or eng.live_slots):
            break
        eng.step()
        jeng.step()
        assert eng.residency_efficiency() == jeng.residency_efficiency()
    assert not (jeng.queue_depth or jeng.live_slots)
    for r, jr in zip(reqs, jreqs):
        assert r.done and r.finish_reason == jr.finish_reason
        np.testing.assert_array_equal(r.result(), jr.result())


def test_moe_engine_matches_jax_engine(spec_engines, drops):
    """Plain and speculative requests (with the int8 path armed: half of
    them int8), a request ending on eos inside a block and a prompt
    sharing a live request's two prefix pages, through three slots: every
    request equals the JAX engine's, as do the speculative acceptance and
    the prefix hits. The 13-token prompt's bucketed prefill (3 pads first)
    drops a real token at an expert: the engine answers the JAX engine's
    call, not solo ``generate()``'s."""
    eng, jeng = spec_engines
    armed = eng.quant_mode is not None
    rng = np.random.default_rng(51)
    seg = rng.integers(0, 512, size=4).astype(np.int32)
    rep = np.tile(seg, 4)
    base = _prompts(52, (13, 9, 7))
    prompts = [base[0], base[1], rep, rep[:13], base[2],
               np.concatenate([rep, base[1][:5]])]
    flags = [(False, False), (armed, False), (False, True), (armed, True),
             (False, False), (False, True)]
    # eos for the fifth request: a token its JAX run emits at index >= 2
    # that is new there, so it ends inside a block.
    probe = jeng.generate_many([base[2]], max_new_tokens=9,
                               speculative=False)[0].tolist()
    stop = next(i for i in range(2, 9) if probe[i] not in probe[:i])
    eos = [None] * 4 + [probe[stop], None]
    reqs, jreqs = [], []
    for p, (q, sp), e in zip(prompts, flags, eos):
        reqs.append(eng.submit(p, max_new_tokens=9, quantize=q,
                               speculative=sp, eos_id=e))
        jreqs.append(jeng.submit(p, max_new_tokens=9, quantize=q,
                                 speculative=sp, eos_id=e))
    _lockstep(eng, jeng, reqs, jreqs)
    assert reqs[4].finish_reason == "eos" and len(reqs[4].tokens) == stop + 1
    assert eng.spec_accept_rate == pytest.approx(jeng.spec_accept_rate)
    assert eng.spec_accept_rate > 1.0
    assert eng.pool.prefix_hits == jeng.pool.prefix_hits >= 2
    # The first admission is the 13-token prompt in its 16-wide bucket:
    # its first routings (one a layer) see 3 pads, then the prompt.
    width, kept = drops[0]
    assert width == 16 and not kept[3:].all()


@pytest.mark.slow
def test_moe_weight_only_engine_and_ship_match_jax(pair, tmp_path):
    """A weight-only prefill-role engine ships fp and int8 prompts; a
    decode-role engine imports them beside local requests of both paths:
    every request equals the JAX pair's."""
    jm, params, tm = pair
    kw = dict(max_slots=2, buckets=[8, 16], decode_block=4, page_size=8,
              quant="weight_only")
    prompts = _prompts(53, (11, 7, 13))
    flags = [False, True, True]
    outs = []
    for cls, args, d in ((ServeEngine, (tm,), "port"),
                         (jserve.ServeEngine, (jm, params), "jax")):
        store = str(tmp_path / d)
        pre = cls(*args, role="prefill", kv_store_dir=store, **kw)
        dec = cls(*args, role="decode", kv_store_dir=store, **kw)
        keys = [pre.ship(p, quantize=q) for p, q in zip(prompts[:2],
                                                         flags[:2])]
        reqs = [dec.submit(p, max_new_tokens=7, quantize=q, kv_key=k)
                for p, q, k in zip(prompts, flags, keys + [None])]
        reqs.append(dec.submit(prompts[0], max_new_tokens=7, quantize=True))
        dec.run_until_idle(max_iters=100)
        admitted = [next(t for t in r.trace if t["phase"] == "admitted")
                    for r in reqs[:2]]
        assert [t["prefilled"] for t in admitted] == ["ship"] * 2
        outs.append([r.result() for r in reqs])
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)


@pytest.mark.slow
@pytest.mark.parametrize("quantized", [False, True])
def test_moe_speculative_generate_matches_jax(pair, quantized):
    """``speculative_generate`` on the MoE model, fp and fused-native with
    the router quantized, a batch of two repeating prompts: tokens and
    stats equal the JAX call's."""
    jm, params, tm = pair
    jmodel, jprm, model = jm, params, tm
    if quantized:
        jmodel, jprm = jquant.quantize_model(
            jm, params, mode="fused_native", min_size=GATE_MIN,
            int8_impl="xla")
        model = tquant.quantize_model(tm, mode="fused_native",
                                      min_size=GATE_MIN)
        assert "h.0.moe.gate" in model.leaves
    rng = np.random.default_rng(54)
    seg = rng.integers(0, 512, size=(2, 5))
    prompt = np.concatenate([seg, seg, seg[:, :2]], axis=1).astype(np.int32)
    kw = dict(max_new_tokens=10, draft_len=3, return_stats=True)
    want, wstats = jspec.speculative_generate(jmodel, jprm,
                                              jnp.asarray(prompt), **kw)
    got, stats = tspec.speculative_generate(model, prompt, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["n_forwards"] == int(wstats["n_forwards"])
    assert stats["n_committed"] == int(wstats["n_committed"])


def test_moe_quantize_model_leaves_match_jax(pair):
    """``quantize_model`` on the MoE model: the fused-native leaf set is
    the JAX Dense-kernel set (the router's included at a low
    ``min_size``; the expert weights stay float) with the LM head, and the
    weight-only tree keeps per-(E, F) and per-(E, C) scales on the 3-D
    expert leaves; values, scales and bytes equal the JAX package's."""
    jm, params, tm = pair
    _, jq = jquant.quantize_model(jm, params, mode="fused_native",
                                  min_size=GATE_MIN)
    q = tquant.quantize_model(tm, mode="fused_native", min_size=GATE_MIN)
    want = {}
    for top, sub in jq.items():
        if isinstance(sub, jquant.QuantLeaf):
            want[top] = sub
            continue
        for path, leaf in _flat(sub):
            if isinstance(leaf, jquant.QuantLeaf):
                name = ".".join(path[:-1])
                want[f"h.{top[1:]}.{name}"] = leaf
    assert set(q.leaves) == set(want)
    assert {"h.1.moe.gate", "wte_q"} <= set(q.leaves)
    for name, leaf in q.leaves.items():
        np.testing.assert_array_equal(leaf.q.numpy(),
                                      np.asarray(want[name].q))
        np.testing.assert_array_equal(leaf.scale.numpy().reshape(-1),
                                      np.asarray(want[name].scale).reshape(-1))
    assert sum(t.nbytes for leaf in q.leaves.values() for t in leaf) == \
        sum(np.asarray(t).nbytes for leaf in want.values() for t in leaf)
    _, jw = jquant.quantize_model(jm, params, mode="weight_only")
    w = tquant.quantize_model(tm, mode="weight_only")
    jflat, tflat = dict(_flat(jw)), dict(_flat(w.leaves))
    assert set(jflat) == set(tflat)
    for path, want_leaf in jflat.items():
        got = tflat[path]
        assert isinstance(got, tquant.QuantLeaf) == isinstance(
            want_leaf, jquant.QuantLeaf), path
        if isinstance(got, tquant.QuantLeaf):
            np.testing.assert_array_equal(got.q.numpy(),
                                          np.asarray(want_leaf.q))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want_leaf.scale))
    w1 = tflat[("h0", "moe", "w1")]
    assert w1.scale.shape == (4, 1, 512)  # per (E, F)
    assert tflat[("h0", "moe", "w2")].scale.shape == (4, 1, 128)
    assert tquant.quantized_nbytes(w.leaves) == jquant.quantized_nbytes(jw)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.slow
def test_moe_predictor_engine_route_matches_jax(pair):
    """``GenerationPredictor`` over ragged rows in three batches: the
    first decodes through ``generate``, the next two through each
    package's shared engine, which routes each row's bucketed prefill as
    its own call; the tokens equal the JAX predictor's."""
    jm, params, tm = pair
    rng = np.random.default_rng(55)
    rows = [{"tokens": rng.integers(0, 512, size=int(L)).astype(np.int32)}
            for L in rng.integers(2, 20, size=10)]
    kw = dict(max_new_tokens=6, eos_id=7)
    jp = jengine.GenerationPredictor(jm, params, **kw)
    tp = GenerationPredictor(tm, **kw)
    want = np.stack([r["generated"] for r in jengine.map_batches(
        rows, jp, batch_size=4)])
    got = np.stack([r["generated"] for r in map_batches(
        rows, tp, batch_size=4)])
    np.testing.assert_array_equal(got, want)
    assert tp.stats["serve_batches"] == 2 and jp._serve_engine is not None
