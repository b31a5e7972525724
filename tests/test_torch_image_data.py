"""The port's image datasets (``cifar10``, ``imagenet_synth``) and their
loaders against the JAX package's, bit for bit.

- The synthetic splits (CIFAR-10 seed 30, 32 x 32 x 3; ImageNet seed 40,
  224 x 224 x 3, 1000 classes) at small sizes: the same numpy generator
  on both sides, so every array must be equal.
- The ``cifar-10-batches-py`` pickle reader on small fake batches: the
  same NHWC, normalised arrays.
- The per-dataset default sizes (CIFAR 50,000 / 10,000; imagenet_synth
  2,000 / ``max(2_000 // 10, 100)``) and the NHWC batches of
  ``get_dataloaders``.

The JAX side sizes its synthetic sets from its declared knobs
(``TPUFLOW_SYNTH_TRAIN_N``/``_TEST_N``, set with monkeypatch); the port
takes the sizes as arguments.
"""

import pickle

import numpy as np
import pytest

from tpuflow.data import datasets as jdatasets
from tpuflow.data.loader import get_dataloaders as j_get_dataloaders
from tpuflow_torch.data import datasets
from tpuflow_torch.data.loader import get_dataloaders

N_TRAIN, N_TEST = 96, 40


@pytest.fixture
def jax_sizes(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUFLOW_SYNTH_TRAIN_N", str(N_TRAIN))
    monkeypatch.setenv("TPUFLOW_SYNTH_TEST_N", str(N_TEST))
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path / "jax_default"))
    return str(tmp_path / "jax")


def _assert_split_equal(got, want):
    assert got.images.dtype == np.float32 and got.labels.dtype == np.int32
    assert got.images.shape == want.images.shape
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)


def test_synthetic_cifar10_bit_equal(jax_sizes):
    ds = datasets.load_dataset("cifar10", n_train=N_TRAIN, n_test=N_TEST)
    jds = jdatasets.load_dataset("cifar10", data_dir=jax_sizes)
    assert ds.synthetic and jds.synthetic and ds.num_classes == 10
    assert ds.train.images.shape == (N_TRAIN, 32, 32, 3)
    _assert_split_equal(ds.train, jds.train)
    _assert_split_equal(ds.test, jds.test)


def test_synthetic_imagenet_bit_equal_and_default_sizes():
    """16 train rows and max(16 // 10, 100) = 100 test rows on both sides
    (the port's ``n_train``/``n_test``, JAX's ``synthetic_size``),
    224 x 224 x 3, 1000 classes."""
    ds = datasets.load_dataset("imagenet_synth", n_train=16, n_test=100)
    jds = jdatasets.load_dataset("imagenet_synth", synthetic_size=16)
    assert ds.synthetic and ds.num_classes == jds.num_classes == 1000
    assert (len(ds.train), len(ds.test)) == (16, 100)
    assert ds.train.images.shape[1:] == (224, 224, 3)
    _assert_split_equal(ds.train, jds.train)
    _assert_split_equal(ds.test, jds.test)


def test_default_sizes_per_dataset(monkeypatch):
    seen = []
    monkeypatch.setattr(datasets, "_synth_classification",
                        lambda **kw: seen.append(kw) or (None, None))
    datasets.load_dataset("cifar10")
    datasets.load_dataset("fashion_mnist")
    datasets.load_dataset("imagenet_synth")
    datasets.load_dataset("imagenet_synth", n_train=5_000, n_test=500)
    datasets.load_dataset("cifar10", n_train=7)
    got = [(k["seed"], k["n_train"], k["n_test"]) for k in seen]
    assert got == [(30, 50_000, 10_000), (20, 60_000, 10_000),
                   (40, 2_000, 200), (40, 5_000, 500), (30, 7, 10_000)]


def _write_cifar(root, r):
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for name, n in [(f"data_batch_{i}", 6) for i in range(1, 6)] + [
            ("test_batch", 10)]:
        batch = {b"data": r.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": [int(v) for v in r.integers(0, 10, n)]}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f)


def test_cifar_pickles_read_like_jax(tmp_path, jax_sizes):
    """Five train batches of 6 rows and a test batch of 10, each row 3072
    uint8 (3 x 32 x 32): both packages give the same NHWC normalised
    arrays and batch them the same way."""
    _write_cifar(tmp_path / "cifar", np.random.default_rng(0))
    root = str(tmp_path / "cifar")
    ds = datasets.load_dataset("cifar10", data_dir=root)
    jds = jdatasets._load_cifar10(root)
    assert not ds.synthetic and (len(ds.train), len(ds.test)) == (30, 10)
    _assert_split_equal(ds.train, jds.train)
    _assert_split_equal(ds.test, jds.test)
    assert ds.train.images.min() >= -1.0 and ds.train.images.max() <= 1.0
    # Row 0, channel 1, pixel (0, 5) is byte 1024 + 5 of the row.
    with open(tmp_path / "cifar" / "cifar-10-batches-py" / "data_batch_1",
              "rb") as f:
        raw = pickle.load(f)[b"data"]
    assert ds.train.images[0, 0, 5, 1] == pytest.approx(
        (raw[0, 1029] / 255.0 - 0.5) / 0.5, abs=1e-6)
    (pt, pv) = get_dataloaders(8, dataset="cifar10", data_dir=root, seed=2)
    (jt, jv) = j_get_dataloaders(8, dataset="cifar10", data_dir=root, seed=2)
    for a, b in ((pt, jt), (pv, jv)):
        pa, ja = list(a), list(b)
        assert len(pa) == len(ja) > 0
        for x, y in zip(pa, ja):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


def test_image_loaders_are_nhwc(jax_sizes):
    train, val = get_dataloaders(32, dataset="cifar10", n_train=N_TRAIN,
                                 n_test=N_TEST, seed=1)
    jtrain, jval = j_get_dataloaders(32, dataset="cifar10",
                                     data_dir=jax_sizes, seed=1)
    assert train.num_classes == jtrain.num_classes == 10
    b, jb = next(iter(train)), next(iter(jtrain))
    assert b["x"].shape == (32, 32, 32, 3)
    for k in b:
        np.testing.assert_array_equal(b[k], jb[k])
    assert len(val) == len(jval) == 2  # 40 = 32 + a padded tail of 8
    rows = get_dataloaders(32, dataset="cifar10", as_rows=True, n_train=0,
                           n_test=N_TEST)
    assert len(rows) == N_TEST and rows[0]["features"].shape == (32, 32, 3)
