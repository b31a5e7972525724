"""Sharded batch loader with a seeded per-epoch reshuffle, the loaders'
entry point and the device prefetcher.

- ``ShardedLoader``: the port's copy of ``tpuflow/data/loader.py::
  ShardedLoader``: the same permutation from ``(seed, epoch)``, the same
  shard striding, ``max_batches`` cap, mid-epoch ``skip_batches``,
  padded+masked validation tail and ``reshard`` to a resized world, so
  both packages see the same batches.
  Rows are gathered with plain numpy indexing (the LM splits hold int32
  tokens, which the JAX package's native float32 gather never handles
  either).
- ``get_dataloaders`` (``loader.py:323``): the shuffled, sharded train
  loader and the unshuffled, padded val loader, both carrying
  ``num_classes``; ``val_only``; ``as_rows`` (the test split as
  ``{"features", "labels"}`` rows for ``infer.engine.map_batches``).
- ``prefetch_to_device`` (``loader.py:199``): batches assembled and copied
  to the card ahead of the consumer.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from tpuflow_torch.data.datasets import Split, load_dataset


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

    def reshard(self, shard_index: int, num_shards: int) -> None:
        """Re-key this loader to a resized data-parallel world (an elastic
        gang's shrink or grow). Only the stride over the per-epoch
        permutation changes: the permutation is a function of ``(seed,
        epoch)``, so a cursor recorded by the old world, fed to
        ``set_epoch`` + ``skip_batches``, resumes the epoch under the new
        shard map (epoch and step accounting exact; the rows of the old
        and new strides interleave differently)."""
        if not 0 <= shard_index < num_shards:
            raise ValueError(
                f"shard_index {shard_index} out of range for "
                f"{num_shards} shards"
            )
        self.shard_index = shard_index
        self.num_shards = num_shards

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


def get_dataloaders(
    batch_size: int,
    *,
    dataset: str = "fashion_mnist",
    val_only: bool = False,
    as_rows: bool = False,
    data_dir: str | None = None,
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    n_train: int | None = None,
    n_test: int | None = None,
):
    """(train, val) ShardedLoaders, the val loader alone (``val_only``), or
    with ``as_rows`` the test split as a list of ``{"features", "labels"}``
    rows. The train loader is shuffled from ``seed`` and takes shard
    ``shard_index`` of ``num_shards``; the val loader is unshuffled, whole,
    and pads its tail with a mask. Batches hold ``x`` as the split stores
    it: (B, 28, 28) for FashionMNIST, NHWC (B, H, W, 3) for ``cifar10`` and
    ``imagenet_synth``. ``n_train``/``n_test``: the synthetic stand-in's
    sizes (None: the dataset's default, ``datasets.load_dataset``)."""
    ds = load_dataset(dataset, data_dir=data_dir, n_train=n_train,
                      n_test=n_test)
    if as_rows:
        return [
            {"features": ds.test.images[i], "labels": int(ds.test.labels[i])}
            for i in range(len(ds.test))
        ]
    val = ShardedLoader(ds.test, batch_size, shuffle=False, pad_tail=True,
                        drop_last=False)
    val.num_classes = ds.num_classes
    if val_only:
        return val
    train = ShardedLoader(ds.train, batch_size, shuffle=True, seed=seed,
                          shard_index=shard_index, num_shards=num_shards)
    train.num_classes = ds.num_classes
    return train, val


def _to_device(batch: dict, device: torch.device, stream) -> dict:
    """Host arrays → tensors on ``device``: pinned host copies, then
    ``non_blocking`` copies enqueued on ``stream``."""
    with torch.cuda.stream(stream):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(device, non_blocking=True) for k, v in batch.items()}


def prefetch_to_device(loader, device, *, depth: int = 2, keys=None):
    """Iterate ``loader``'s batches as tensors on ``device``.

    On the card a background thread assembles up to ``depth`` batches
    ahead, stages each in pinned host memory and copies it with
    ``non_blocking`` copies on a side CUDA stream; before a batch is used
    the consumer's stream waits for the side stream (``wait_stream``) and
    the tensors are marked as used on it (``record_stream``), so the
    caching allocator does not hand their memory out early. On the CPU,
    and with ``depth`` <= 0, batches are converted inline on the calling
    thread. ``keys``: the batch entries to keep (e.g. ("x", "y"))."""
    device = torch.device(device)

    def pick(batch):
        return batch if keys is None else {k: batch[k] for k in keys}

    if device.type != "cuda" or depth <= 0:
        for batch in loader:
            yield {k: torch.as_tensor(v, device=device)
                   for k, v in pick(batch).items()}
        return
    side = torch.cuda.Stream(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            for batch in loader:
                if not put(_to_device(pick(batch), device, side)):
                    return  # the consumer went away
            put(done)
        except BaseException as e:  # raised on the consuming thread
            put(e)

    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    current = torch.cuda.current_stream(device)
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            current.wait_stream(side)
            for t in item.values():
                t.record_stream(current)
            yield item
    finally:
        stop.set()
        thread.join(timeout=1.0)
