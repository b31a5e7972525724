"""Batch prediction in the port (tpuflow_torch.infer.engine and the
``TorchPredictor`` twin) against the JAX package's.

``map_batches``: row order, the padded and trimmed tail, prefetch on and
off. ``BatchPredictor`` on one JAX-written checkpoint against the JAX
``BatchPredictor``: the same argmax on every row, the logits within 1e-5
of the largest |logit| (f32, the same products summed in another order).
"""

import numpy as np
import pytest

from tpuflow.ckpt import CheckpointManager as JCheckpointManager
from tpuflow.infer.engine import BatchPredictor as JBatchPredictor
from tpuflow.infer.engine import map_batches as j_map_batches
from tpuflow.models.mlp import NeuralNetwork as JNeuralNetwork
from tpuflow_torch.ckpt import Checkpoint
from tpuflow_torch.data.loader import get_dataloaders
from tpuflow_torch.flows.my_torch_module import TorchPredictor
from tpuflow_torch.infer.engine import BatchPredictor, _collate, map_batches
from tpuflow_torch.models import NeuralNetwork


class _Recorder:
    """A predictor that returns each row's feature sum and records the
    batch shapes it was given."""

    def __init__(self):
        self.shapes = []

    def __call__(self, batch):
        x = np.asarray(batch["features"])
        self.shapes.append(x.shape)
        return {"sum": x.reshape(len(x), -1).sum(axis=1),
                "label": np.asarray(batch["labels"])}


def _rows(n, seed=0):
    r = np.random.default_rng(seed)
    return [{"features": r.standard_normal((28, 28)).astype(np.float32),
             "labels": int(i)} for i in range(n)]


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("n,batch", [(10, 4), (8, 4), (3, 8), (1, 1)])
def test_map_batches_order_and_tail(prefetch, n, batch):
    rows = _rows(n)
    rec = _Recorder()
    out = map_batches(rows, rec, batch_size=batch, prefetch=prefetch)
    assert len(out) == n
    assert [int(o["label"]) for o in out] == list(range(n))
    for o, r in zip(out, rows):
        np.testing.assert_allclose(o["sum"], r["features"].sum(), rtol=1e-5)
    assert all(s == (batch, 28, 28) for s in rec.shapes)
    assert len(rec.shapes) == -(-n // batch)
    assert map_batches([], rec) == []


def test_map_batches_prefetch_on_equals_off_and_jax():
    rows = _rows(37, seed=2)
    on = map_batches(rows, _Recorder(), batch_size=8, prefetch=True)
    off = map_batches(rows, _Recorder(), batch_size=8, prefetch=False)
    ref = j_map_batches(rows, _Recorder(), batch_size=8)
    for a, b, c in zip(on, off, ref):
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])


def test_collate_keeps_ragged_values_as_lists():
    assert _collate([np.zeros(3), np.ones(3)]).shape == (2, 3)
    ragged = _collate([np.zeros(2), np.ones(3)])
    assert isinstance(ragged, list) and len(ragged) == 2


@pytest.fixture
def jax_checkpoint(tmp_path):
    """A JAX MLP checkpoint (numpy-made weights) and the test rows."""
    r = np.random.default_rng(4)
    dims = [(784, 512), (512, 512), (512, 10)]
    params = {f"dense{i + 1}": {
        "kernel": (r.standard_normal(d) / np.sqrt(d[0])).astype(np.float32),
        "bias": (0.1 * r.standard_normal(d[1])).astype(np.float32),
    } for i, d in enumerate(dims)}
    mgr = JCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    mgr.save(1, {"step": np.int32(0), "params": params},
             metrics={"val_loss": 1.0})
    mgr.wait_until_finished()
    rows = get_dataloaders(64, as_rows=True, n_train=64, n_test=300)
    return mgr.checkpoint(1), rows


@pytest.mark.parametrize("final_relu", [True, False])
def test_batch_predictor_matches_jax(jax_checkpoint, final_relu):
    handle, rows = jax_checkpoint
    jp = JBatchPredictor.from_checkpoint(
        handle, JNeuralNetwork(final_relu=final_relu),
        sample_input=np.zeros((1, 28, 28), np.float32))
    tp = BatchPredictor.from_checkpoint(
        Checkpoint(path=handle.path), NeuralNetwork(final_relu=final_relu),
        device="cpu")
    want = j_map_batches(rows, jp, batch_size=128)
    got = map_batches(rows, tp, batch_size=128)
    assert len(got) == len(want) == 300
    wl = np.stack([w["logits"] for w in want])
    gl = np.stack([g["logits"] for g in got])
    assert gl.dtype == np.float32
    np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-5 * np.abs(wl).max())
    assert [int(g["predicted_values"]) for g in got] == \
        [int(w["predicted_values"]) for w in want]


def test_torch_predictor_squeezes_a_stray_leading_one(jax_checkpoint):
    handle, rows = jax_checkpoint
    p = TorchPredictor(Checkpoint(path=handle.path).to_json(), device="cpu")
    x = np.stack([r["features"] for r in rows[:5]])
    a = p({"features": x})
    b = p({"features": x[None]})
    assert a["logits"].shape == (5, 10)
    np.testing.assert_array_equal(a["logits"], b["logits"])
    np.testing.assert_array_equal(a["predicted_values"],
                                  a["logits"].argmax(axis=-1))
