"""Dataset containers, the image datasets and the synthetic LM corpus.

The port's copy of the parts of ``tpuflow/data/datasets.py`` that the
training slices read, byte for byte the same arrays from the same seed:

- ``Split``, ``Dataset``, ``dataset_info``, ``get_labels_map``;
- FashionMNIST and MNIST (``load_dataset``): the four IDX files
  (``*-ubyte`` or ``*-ubyte.gz``) under ``data_dir`` when they are all
  there, normalised as the reference does; otherwise the deterministic
  synthetic stand-in (seed 20), marked ``synthetic=True``;
- CIFAR-10 (``:355``): the ``cifar-10-batches-py`` pickles under
  ``data_dir`` (NHWC, normalised), else the synthetic stand-in (seed 30,
  32 x 32 x 3);
- ``imagenet_synth`` (``:385``): synthetic only, seed 40, 224 x 224 x 3,
  1000 classes;
- ``_load_synthetic_lm`` (the ``lm_synth`` corpus).

The synthetic sizes are the arguments ``n_train`` / ``n_test`` where the
JAX package reads ``TPUFLOW_SYNTH_TRAIN_N`` / ``_TEST_N``; None takes the
dataset's default, as the JAX package does without the knobs
(``_SYNTH_SIZES``).

Not ported: the download branch, the npz cache and its FileLock (every
load decodes or generates afresh, and nothing is written, ``data_dir``
included) and ``lm_text``.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import pickle
import struct

import numpy as np

FASHION_MNIST_CLASSES = [
    "T-shirt/top",
    "Trouser",
    "Pullover",
    "Dress",
    "Coat",
    "Sandal",
    "Shirt",
    "Sneaker",
    "Bag",
    "Ankle boot",
]

# Per-dataset spec: sample shape and class count, read by loaders and by
# consumers sizing a model before touching rows.
_DATASET_SPECS = {
    "fashion_mnist": {"shape": (28, 28), "num_classes": 10},
    "mnist": {"shape": (28, 28), "num_classes": 10},
    "cifar10": {"shape": (32, 32, 3), "num_classes": 10},
    "imagenet_synth": {"shape": (224, 224, 3), "num_classes": 1000},
}


def dataset_info(name: str) -> dict:
    """Registry metadata without materializing the data: sample shape and
    class count."""
    if name not in _DATASET_SPECS:
        raise KeyError(
            f"no registry metadata for dataset {name!r}; known: "
            f"{sorted(_DATASET_SPECS)}"
        )
    return _DATASET_SPECS[name]


def get_labels_map(dataset: str = "fashion_mnist") -> dict[int, str]:
    """class-id → human name."""
    if dataset in ("fashion_mnist", "mnist"):
        return dict(enumerate(FASHION_MNIST_CLASSES))
    if dataset == "cifar10":
        return dict(enumerate([
            "airplane", "automobile", "bird", "cat", "deer", "dog", "frog",
            "horse", "ship", "truck",
        ]))
    if dataset == "imagenet_synth":
        return {i: f"class_{i}" for i in range(1000)}
    raise KeyError(dataset)


@dataclasses.dataclass
class Split:
    """One split: model inputs (``images``: normalized float32 images, or
    token ids) and targets (``labels``: int32)."""

    images: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.labels)


@dataclasses.dataclass
class Dataset:
    name: str
    train: Split
    test: Split
    num_classes: int
    synthetic: bool


def _load_synthetic_lm(
    n_docs: int, seq_len: int, vocab_size: int, seed: int = 0
) -> Dataset:
    """Deterministic learnable LM data: each document cycles an arithmetic
    token pattern (next token fully predictable from the previous one) with
    a doc-dependent stride. ``images = tokens[:, :-1]`` (model input) and
    ``labels = tokens[:, 1:]`` (next-token targets) are views of one int32
    token buffer."""

    def make(n: int, split_seed: int) -> Split:
        r = np.random.default_rng((seed, split_seed))
        starts = r.integers(0, vocab_size, size=n)
        strides = r.integers(1, 7, size=n)
        pos = np.arange(seq_len + 1)
        tokens = (
            (starts[:, None] + strides[:, None] * pos[None, :]) % vocab_size
        ).astype(np.int32)
        return Split(tokens[:, :-1], tokens[:, 1:])

    return Dataset(
        "lm_synth",
        make(n_docs, 1),
        make(max(n_docs // 8, 1), 2),
        num_classes=vocab_size,
        synthetic=True,
    )


def _read_idx(path: str) -> np.ndarray:
    """Decode an IDX file (the FashionMNIST/MNIST wire format)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    zero, dtype_code, ndim = struct.unpack(">HBB", data[:4])
    if zero != 0:
        raise ValueError(f"{path}: bad IDX magic")
    dims = struct.unpack(f">{ndim}I", data[4: 4 + 4 * ndim])
    dtype = {0x08: np.uint8, 0x0B: np.int16, 0x0C: np.int32,
             0x0D: np.float32}[dtype_code]
    return np.frombuffer(data[4 + 4 * ndim:], dtype=dtype).reshape(dims)


def _find(data_dir: str, names: list[str]) -> str | None:
    for n in names:
        for cand in (os.path.join(data_dir, n),
                     os.path.join(data_dir, n + ".gz")):
            if os.path.exists(cand):
                return cand
    return None


def _normalize(images_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32: /255, then Normalize((0.5,), (0.5,))."""
    return ((images_u8.astype(np.float32) / 255.0) - 0.5) / 0.5


def _synth_classification(
    seed: int, n_train: int, n_test: int, shape: tuple, num_classes: int
) -> tuple[Split, Split]:
    """Deterministic learnable stand-in: each class is a fixed smooth
    template + per-sample noise."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(scale=1.0, size=(num_classes, *shape)).astype(
        np.float32)
    for axis in range(len(shape))[:2]:
        templates = (
            templates + np.roll(templates, 1, axis=axis + 1)
            + np.roll(templates, -1, axis=axis + 1)
        ) / 3.0

    def make(n: int, split_seed: int) -> Split:
        r = np.random.default_rng(split_seed)
        labels = r.integers(0, num_classes, size=n).astype(np.int32)
        noise = r.normal(scale=1.0, size=(n, *shape)).astype(np.float32)
        images = 0.8 * templates[labels] + noise * 0.6
        return Split(images.astype(np.float32), labels)

    return make(n_train, seed + 1), make(n_test, seed + 2)


_IDX_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


# Synthetic (n_train, n_test) without arguments: the JAX loaders' knob
# defaults (``datasets.py:346-347, 375-376``) and, for imagenet_synth, its
# ``synthetic_size`` default of 2,000 with max(2_000 // 10, 100) test rows
# (``:405-422``).
_SYNTH_SIZES = {"fashion_mnist": (60_000, 10_000), "mnist": (60_000, 10_000),
                "cifar10": (50_000, 10_000),
                "imagenet_synth": (2_000, max(2_000 // 10, 100))}


def _load_fashion_mnist(data_dir: str | None, name: str, *, n_train: int,
                        n_test: int) -> Dataset:
    """The IDX files under ``data_dir`` when all four are there, else the
    synthetic stand-in of ``n_train`` and ``n_test`` rows."""
    files = {k: _find(data_dir, [v]) if data_dir else None
             for k, v in _IDX_FILES.items()}
    if all(files.values()):
        train = Split(
            _normalize(_read_idx(files["train_images"])),
            _read_idx(files["train_labels"]).astype(np.int32),
        )
        test = Split(
            _normalize(_read_idx(files["test_images"])),
            _read_idx(files["test_labels"]).astype(np.int32),
        )
        return Dataset(name, train, test, 10, synthetic=False)
    train, test = _synth_classification(
        seed=20, n_train=n_train, n_test=n_test, shape=(28, 28),
        num_classes=10,
    )
    return Dataset(name, train, test, 10, synthetic=True)


def _load_cifar10(data_dir: str | None, *, n_train: int, n_test: int
                  ) -> Dataset:
    """The ``cifar-10-batches-py`` pickles under ``data_dir`` (five train
    batches and ``test_batch``, rows of 3 x 32 x 32 uint8 turned NHWC)
    when the directory is there, else the synthetic stand-in."""
    batch_dir = os.path.join(data_dir, "cifar-10-batches-py") if data_dir \
        else None
    if batch_dir and os.path.isdir(batch_dir):
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(batch_dir, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        train_x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(
            0, 2, 3, 1)
        with open(os.path.join(batch_dir, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        test_x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return Dataset(
            "cifar10",
            Split(_normalize(train_x), np.asarray(ys, np.int32)),
            Split(_normalize(test_x), np.asarray(d[b"labels"], np.int32)),
            10,
            synthetic=False,
        )
    spec = _DATASET_SPECS["cifar10"]
    train, test = _synth_classification(
        seed=30, n_train=n_train, n_test=n_test, shape=spec["shape"],
        num_classes=spec["num_classes"],
    )
    return Dataset("cifar10", train, test, spec["num_classes"], synthetic=True)


def _load_synthetic_imagenet(n_train: int, n_test: int) -> Dataset:
    """ImageNet-shaped synthetic data (224 x 224 x 3, 1000 classes)."""
    spec = _DATASET_SPECS["imagenet_synth"]
    train, test = _synth_classification(
        seed=40, n_train=n_train, n_test=n_test, shape=spec["shape"],
        num_classes=spec["num_classes"],
    )
    return Dataset(
        "imagenet_synth", train, test, spec["num_classes"], synthetic=True
    )


def load_dataset(name: str = "fashion_mnist", *, data_dir: str | None = None,
                 n_train: int | None = None, n_test: int | None = None
                 ) -> Dataset:
    """Load (or synthesize) ``fashion_mnist``, ``mnist``, ``cifar10`` or
    ``imagenet_synth``: the real files under ``data_dir`` (None: look
    nowhere), else the synthetic stand-in of ``n_train`` / ``n_test`` rows
    (None: the dataset's default, ``_SYNTH_SIZES``). No cache is read or
    written."""
    if name in _SYNTH_SIZES:
        d_train, d_test = _SYNTH_SIZES[name]
        sizes = dict(n_train=d_train if n_train is None else n_train,
                     n_test=d_test if n_test is None else n_test)
        if name == "imagenet_synth":
            return _load_synthetic_imagenet(**sizes)
        if name == "cifar10":
            return _load_cifar10(data_dir, **sizes)
        return _load_fashion_mnist(data_dir, name, **sizes)
    if name == "lm_text":
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet: ROADMAP Queue 1 item 12")
    raise KeyError(f"unknown dataset {name!r}; available: fashion_mnist, "
                   "mnist, cifar10, imagenet_synth")
