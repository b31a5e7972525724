"""Dataset containers and the synthetic LM corpus.

The port's copy of the parts of ``tpuflow/data/datasets.py`` that the GPT
training slice reads: ``Split``, ``Dataset`` and ``_load_synthetic_lm``
(the ``lm_synth`` corpus), byte for byte the same arrays from the same
seed. The image datasets and ``lm_text`` are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Split:
    """One split: model inputs (``images``) and targets (``labels``)."""

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
