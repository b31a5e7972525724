"""Sharded batch loader with a seeded per-epoch reshuffle.

The port's copy of ``tpuflow/data/loader.py::ShardedLoader``: the same
permutation from ``(seed, epoch)``, the same shard striding, ``max_batches``
cap, mid-epoch ``skip_batches`` and padded+masked validation tail, so both
packages see the same batches. Rows are gathered with plain numpy indexing
(the LM splits hold int32 tokens, which the JAX package's native float32
gather never handles either).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from tpuflow_torch.data.datasets import Split


@dataclasses.dataclass
class ShardedLoader:
    """Iterate fixed-shape batches of one shard of a Split. Uneven shards
    are wrap-padded so every shard sees the same number of batches."""

    split: Split
    batch_size: int
    shuffle: bool = False
    seed: int = 0
    shard_index: int = 0
    num_shards: int = 1
    drop_last: bool = True
    pad_tail: bool = False  # emit a final padded+masked batch (eval mode)
    # Cap on batches per epoch (None = all); the permutation still ranges
    # over the whole split, so epochs cover different subsets.
    max_batches: int | None = None

    def __post_init__(self):
        if not 0 <= self.shard_index < self.num_shards:
            raise ValueError(
                f"shard_index {self.shard_index} out of range for "
                f"{self.num_shards} shards"
            )
        self._epoch = 0
        self._skip_next = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for a new epoch."""
        self._epoch = epoch

    def skip_batches(self, n: int) -> None:
        """Skip the first ``n`` batches of the NEXT iteration (one-shot):
        the mid-epoch resume of a restored run."""
        self._skip_next = max(int(n), 0)

    def state_dict(self, batches_consumed: int) -> dict:
        """The loader cursor: pair with ``set_epoch`` + ``skip_batches``."""
        return {
            "epoch": int(self._epoch),
            "batch_index": int(batches_consumed),
            "seed": int(self.seed),
        }

    def _indices(self) -> np.ndarray:
        n = len(self.split)
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, self._epoch)
            ).permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards > 1:
            per = -(-n // self.num_shards)  # ceil
            padded = np.concatenate([order, order[: per * self.num_shards - n]])
            order = padded[self.shard_index :: self.num_shards]
        return order

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last and not self.pad_tail:
            count = n // self.batch_size
        else:
            count = -(-n // self.batch_size)
        if self.max_batches is not None:
            count = min(count, self.max_batches)
        return count

    def __iter__(self) -> Iterator[dict]:
        order = self._indices()
        if self.max_batches is not None:
            order = order[: self.max_batches * self.batch_size]
        bs = self.batch_size
        skip, self._skip_next = self._skip_next, 0
        if skip:
            order = order[skip * bs :]
        n_full = len(order) // bs
        for b in range(n_full):
            idx = order[b * bs : (b + 1) * bs]
            yield {
                "x": self.split.images[idx],
                "y": self.split.labels[idx],
                "mask": np.ones(bs, np.float32),
            }
        tail = len(order) - n_full * bs
        if tail and self.pad_tail:
            idx = order[n_full * bs :]
            pad = bs - tail
            pad_idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            mask = np.concatenate(
                [np.ones(tail, np.float32), np.zeros(pad, np.float32)]
            )
            yield {
                "x": self.split.images[pad_idx],
                "y": self.split.labels[pad_idx],
                "mask": mask,
            }
        elif tail and not self.drop_last:
            idx = order[n_full * bs :]
            yield {
                "x": self.split.images[idx],
                "y": self.split.labels[idx],
                "mask": np.ones(tail, np.float32),
            }
