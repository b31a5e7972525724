"""The port's FashionMNIST data (tpuflow_torch.data) against the JAX
package's: the synthetic stand-in, the IDX decoder, ``get_dataloaders``
in every mode, and the prefetcher on the CPU. Every batch must be
bit-equal to the JAX loader's.

The JAX side sizes its synthetic set from its declared knobs
(``TPUFLOW_SYNTH_TRAIN_N``/``_TEST_N``, set with monkeypatch) and caches
it under its own ``tmp_path`` directory; the port takes the sizes as
arguments and writes nothing.
"""

import gzip
import struct

import numpy as np
import pytest
import torch

from tpuflow.data import datasets as jdatasets
from tpuflow.data.loader import get_dataloaders as j_get_dataloaders
from tpuflow_torch.data import datasets
from tpuflow_torch.data.loader import get_dataloaders, prefetch_to_device

N_TRAIN, N_TEST = 512, 100


@pytest.fixture
def jax_sizes(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUFLOW_SYNTH_TRAIN_N", str(N_TRAIN))
    monkeypatch.setenv("TPUFLOW_SYNTH_TEST_N", str(N_TEST))
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path / "jax_default"))
    return str(tmp_path / "jax")


def _assert_batches_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == np.asarray(y[k]).dtype, k
            np.testing.assert_array_equal(x[k], y[k])


def _both(jax_dir, port_dir=None, **kw):
    j = j_get_dataloaders(data_dir=jax_dir, **kw)
    p = get_dataloaders(data_dir=port_dir, n_train=N_TRAIN, n_test=N_TEST,
                        **kw)
    return j, p


@pytest.mark.parametrize("shards", [1, 2])
def test_synthetic_loaders_bit_equal(jax_sizes, shards):
    for index in range(shards):
        (jt, jv), (pt, pv) = _both(jax_sizes, batch_size=32, seed=3,
                                   shard_index=index, num_shards=shards)
        assert pt.num_classes == jt.num_classes == 10
        assert len(pt) == len(jt) and len(pv) == len(jv)
        _assert_batches_equal(pt, jt)
        _assert_batches_equal(pv, jv)  # padded, masked tail
        for epoch in (1, 2):
            pt.set_epoch(epoch)
            jt.set_epoch(epoch)
            _assert_batches_equal(pt, jt)


def test_val_only_and_rows_bit_equal(jax_sizes):
    jv, pv = _both(jax_sizes, batch_size=64, val_only=True)
    _assert_batches_equal(pv, jv)
    jr, pr = _both(jax_sizes, batch_size=64, as_rows=True)
    assert len(pr) == len(jr) == N_TEST
    for a, b in zip(pr, jr):
        assert a["labels"] == b["labels"] and isinstance(a["labels"], int)
        np.testing.assert_array_equal(a["features"], b["features"])


def test_synthetic_split_arrays_equal_at_the_real_sizes():
    """At the default sizes (60,000 / 10,000 rows) the port makes the same
    arrays as the JAX package's generator, seed 20."""
    ds = datasets.load_dataset("fashion_mnist")
    assert ds.synthetic and (len(ds.train), len(ds.test)) == (60_000, 10_000)
    jtrain, jtest = jdatasets._synth_classification(
        seed=20, n_train=60_000, n_test=10_000, shape=(28, 28),
        num_classes=10)
    for got, want in ((ds.train, jtrain), (ds.test, jtest)):
        assert got.images.dtype == np.float32 and got.labels.dtype == np.int32
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)


def _write_idx(path, arr, gz):
    codes = {np.dtype(np.uint8): 0x08, np.dtype(np.int32): 0x0C}
    head = struct.pack(">HBB", 0, codes[arr.dtype], arr.ndim)
    head += struct.pack(f">{arr.ndim}I", *arr.shape)
    data = head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(data)


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_decode_like_jax(tmp_path, jax_sizes, gz):
    """Four small IDX files (images uint8 (n, 28, 28), labels uint8 (n,)),
    plain or gzipped: both packages decode and normalise them to the same
    arrays, and batch them the same way."""
    r = np.random.default_rng(0)
    d = tmp_path / "idx"
    d.mkdir()
    for split, n in (("train", 96), ("t10k", 40)):
        _write_idx(d / f"{split}-images-idx3-ubyte",
                   r.integers(0, 256, (n, 28, 28), dtype=np.uint8), gz)
        _write_idx(d / f"{split}-labels-idx1-ubyte",
                   r.integers(0, 10, n, dtype=np.uint8), gz)
    ds = datasets.load_dataset("fashion_mnist", data_dir=str(d))
    jds = jdatasets._load_fashion_mnist(str(d), "fashion_mnist")
    assert not ds.synthetic and not jds.synthetic
    assert (len(ds.train), len(ds.test)) == (96, 40)
    for got, want in ((ds.train, jds.train), (ds.test, jds.test)):
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
    assert ds.train.images.min() >= -1.0 and ds.train.images.max() <= 1.0
    (jt, jv), (pt, pv) = _both(str(d), str(d), batch_size=32, seed=1)
    _assert_batches_equal(pt, jt)
    _assert_batches_equal(pv, jv)
    bad = tmp_path / "bad-idx"
    bad.write_bytes(b"\x01\x00\x08\x01\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="IDX magic"):
        datasets._read_idx(str(bad))


def test_registry_matches_jax():
    for name in ("fashion_mnist", "mnist", "cifar10", "imagenet_synth"):
        assert datasets.dataset_info(name) == jdatasets.dataset_info(name)
        assert datasets.get_labels_map(name) == jdatasets.get_labels_map(name)
    with pytest.raises(KeyError):
        datasets.dataset_info("nope")
    # lm_text loads (its parity: tests/test_torch_lm_text.py): without a
    # file, the synthetic byte-level stand-in.
    text = datasets.load_dataset("lm_text")
    assert (text.name, text.num_classes, text.synthetic) == ("lm_text", 256,
                                                             True)
    with pytest.raises(KeyError, match="unknown dataset"):
        datasets.load_dataset("nope")


def test_prefetch_to_device_on_the_cpu_is_the_loader():
    """On the CPU the prefetcher converts each batch inline: the loader's
    batches as tensors, in order, with only the keys asked for."""
    train, _ = get_dataloaders(32, n_train=128, n_test=10)
    got = list(prefetch_to_device(train, "cpu", keys=("x", "y")))
    want = list(train)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == ["x", "y"]
        assert g["x"].device.type == "cpu" and g["x"].dtype == torch.float32
        np.testing.assert_array_equal(g["x"].numpy(), w["x"])
        np.testing.assert_array_equal(g["y"].numpy(), w["y"])
