"""Port parity for ``GenerationPredictor`` (tpuflow_torch.infer.engine):
restored from one checkpoint (its ``ema_params`` subtree) in both
packages, the port's predictor gives the JAX predictor's tokens through
``map_batches`` for ragged greedy batches (the port's second batch on
through its shared ``ServeEngine``), ``pad_to``, speculative decoding and
each ``quantize=`` mode, records the same ``quant_decision``, and raises
the JAX package's messages. The JAX side runs with its engine route off
(it gives the same tokens, and would only add its compiles)."""

import importlib

import jax
import numpy as np
import pytest

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.ckpt import CheckpointManager as JCheckpointManager
from tpuflow_torch.ckpt import Checkpoint
from tpuflow_torch.infer.engine import GenerationPredictor, map_batches
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config

jengine = importlib.import_module("tpuflow.infer.engine")


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


@pytest.fixture(autouse=True)
def jax_engine_route_off(monkeypatch):
    monkeypatch.setenv("TPUFLOW_SERVE", "0")


def _rows(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 512, size=int(L)).astype(np.int32)}
            for L in rng.integers(lo, hi + 1, size=n)]


def _tokens(out):
    return np.stack([np.asarray(r["generated"]) for r in out])


def _run(pair, rows, batch_size, kw, port_kw=None):
    jm, params, tm = pair
    jp = jengine.GenerationPredictor(jm, params, **kw)
    tp = GenerationPredictor(tm, **kw, **(port_kw or {}))
    want = _tokens(jengine.map_batches(rows, jp, batch_size=batch_size))
    got = _tokens(map_batches(rows, tp, batch_size=batch_size))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return jp, tp


def test_from_checkpoint_ema_ragged_greedy_equals_jax(pair, tmp_path):
    """Ragged rows over three batches of 4 (the last padded): the first
    decodes through ``generate``, the next two through the shared engine;
    the ``ema_params`` subtree is what both load."""
    jm, params, _ = pair
    ema = jax.tree_util.tree_map(lambda x: np.asarray(x) * 0.9,
                                 jax.device_get(params))
    mgr = JCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    mgr.save(1, {"step": np.int32(0), "params": jax.device_get(params),
                 "ema_params": ema})
    mgr.wait_until_finished()
    handle = mgr.checkpoint(1)
    kw = dict(max_new_tokens=6, eos_id=7)
    jp = jengine.GenerationPredictor.from_checkpoint(
        handle, jm, subtree=("ema_params",), **kw)
    tm = GPT2(GPT2Config.small_test(n_ctx=64, dropout=0.0), seed=None,
              device="cpu")
    tp = GenerationPredictor.from_checkpoint(
        Checkpoint(path=handle.path), tm, subtree=("ema_params",), **kw)
    rows = _rows(10, 1, 20)
    want = _tokens(jengine.map_batches(rows, jp, batch_size=4))
    got = _tokens(map_batches(rows, tp, batch_size=4))
    np.testing.assert_array_equal(got, want)
    assert tp.stats["generate_batches"] == 1
    assert tp.stats["serve_batches"] == 2
    np.testing.assert_array_equal(tm.wte.detach().numpy(), ema["wte"])


def test_serve_off_and_pad_to_equal_jax(pair):
    rows = _rows(6, 2, 12, seed=1)
    _, tp = _run(pair, rows, 3, dict(max_new_tokens=5, pad_to=12))
    assert tp.stats["generate_batches"] == 2
    _, tp = _run(pair, rows, 3, dict(max_new_tokens=5),
                 port_kw=dict(serve=False))
    assert tp.stats["serve_batches"] == 0


def test_speculative_dense_batches_equal_jax(pair):
    seg = np.random.default_rng(2).integers(0, 512, size=4)
    rows = [{"tokens": np.tile(np.roll(seg, i), 4).astype(np.int32)}
            for i in range(6)]
    _, tp = _run(pair, rows, 3, dict(max_new_tokens=10, speculative=True,
                                     draft_len=3))
    assert tp.stats["spec_batches"] == 2
    assert tp.stats["spec_forwards"] >= 2
    assert tp.stats["spec_committed"] == 2 * 10


@pytest.mark.parametrize("mode", ["int8", "int8-native", "int8-mxu",
                                  "auto"])
def test_quantize_modes_decide_and_decode_as_jax(pair, mode):
    rows = _rows(3, 3, 9, seed=3)
    jp, tp = _run(pair, rows, 3, dict(max_new_tokens=5, quantize=mode))
    want, got = jp.quant_decision, tp.quant_decision
    assert (got.apply, got.mode, got.weight_bytes) == (
        want.apply, want.mode, want.weight_bytes)
    if mode == "auto":
        assert not got.apply and tp.model is pair[2]
    else:
        assert tp.model.mode == want.mode


@pytest.mark.parametrize("kw", [
    dict(quantize="int4"),
    dict(speculative=True, temperature=0.5),
    dict(speculative=True, pad_to=8),
    dict(speculative=True, draft_len=0),
    dict(speculative=True, ngram=1),
    dict(prefill_chunk=0),
])
def test_construction_errors_equal_jax(pair, kw):
    jm, params, tm = pair
    with pytest.raises(ValueError) as want:
        jengine.GenerationPredictor(jm, params, max_new_tokens=2, **kw)
    with pytest.raises(ValueError) as got:
        GenerationPredictor(tm, max_new_tokens=2, **kw)
    assert str(got.value) == str(want.value)


def test_pad_to_overflow_error_equals_jax(pair):
    jm, params, tm = pair
    batch = {"tokens": np.ones((2, 9), np.int32)}
    with pytest.raises(ValueError) as want:
        jengine.GenerationPredictor(jm, params, max_new_tokens=2,
                                    pad_to=8)(batch)
    with pytest.raises(ValueError) as got:
        GenerationPredictor(tm, max_new_tokens=2, pad_to=8)(batch)
    assert str(got.value) == str(want.value)
