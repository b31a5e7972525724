"""Batched inference over row datasets with a stateful predictor.

Counterpart of ``tpuflow/infer/engine.py:31-143`` and ``:459-524``:

- ``BatchPredictor`` loads the weights once (``from_checkpoint``: the
  ``params`` subtree of a checkpoint, and for a model with BatchNorm its
  ``batch_stats`` subtree, whose absence is an error) and maps a batch to
  ``{"logits": f32, "predicted_values": argmax}`` with a no-grad forward
  on its device (BatchNorm on its running statistics).
- ``map_batches`` feeds it fixed-size batches (the ragged tail padded by
  repeating its last row, the outputs trimmed) and returns one output row
  per input row, in order; a one-thread prefetch assembles batch N+1
  while batch N runs.

Not here yet: ``GenerationPredictor`` (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from tpuflow_torch.ckpt import Checkpoint, restore_from_handle
from tpuflow_torch.ckpt.tree import (
    load_batch_stats,
    load_params,
    running_stats,
)
from tpuflow_torch.device import resolve_device


class BatchPredictor:
    """Stateful predictor over ``model`` (its weights already in place) on
    ``device`` (None: ``cuda``, which raises where CUDA is absent)."""

    def __init__(self, model: torch.nn.Module, *, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, model: torch.nn.Module,
                        *, device=None) -> "BatchPredictor":
        """Load the checkpoint's ``params`` (the JAX layout, weights only)
        into ``model`` once, then serve from it. A model with BatchNorm
        also loads the ``batch_stats`` subtree; a checkpoint without one
        raises ``KeyError``, since the running statistics are what
        inference normalises by."""
        device = resolve_device(device)
        params = restore_from_handle(checkpoint, weights_only=True)
        load_params(model, params)
        if running_stats(model):
            try:
                stats = restore_from_handle(checkpoint,
                                            subtree=("batch_stats",))
            except KeyError:
                raise KeyError(
                    "model has BatchNorm running statistics but checkpoint "
                    f"{checkpoint.path} carries no batch_stats subtree: it "
                    "cannot serve inference") from None
            load_batch_stats(model, stats)
        return cls(model, device=device)

    @torch.no_grad()
    def __call__(self, batch: dict) -> dict:
        x = np.asarray(batch["features"])
        # Squeeze an accidental leading batch-of-batches dim (1, B, ...).
        while x.ndim > 3 and x.shape[0] == 1:
            x = x[0]
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        logits = self.model(x, train=False).float().cpu().numpy()
        return {"logits": logits, "predicted_values": logits.argmax(axis=-1)}


def _collate(vals: list) -> object:
    """Stack same-shape row values into one array; keep ragged values as a
    list."""
    arrays = [np.asarray(v) for v in vals]
    if len({a.shape for a in arrays}) == 1:
        return np.stack(arrays)
    return arrays


def map_batches(rows: Sequence[dict], predictor: Callable[[dict], dict], *,
                batch_size: int = 512, prefetch: bool = True) -> list[dict]:
    """Run ``predictor`` over ``rows`` in batches of ``batch_size``; return
    one output row per input row, in order. The last batch is padded up to
    ``batch_size`` by repeating its last row and its outputs trimmed, so
    the predictor sees one shape. ``prefetch``: assemble the next batch on
    a background thread while the predictor runs."""
    rows = list(rows)
    if not rows:
        return []
    keys = rows[0].keys()

    def make_batch(start: int):
        chunk = rows[start:start + batch_size]
        n = len(chunk)
        if n < batch_size:
            chunk = chunk + [chunk[-1]] * (batch_size - n)
        return n, {k: _collate([r[k] for r in chunk]) for k in keys}

    def emit(n: int, out: dict) -> None:
        for r in range(n):
            out_rows.append({k: np.asarray(v)[r] for k, v in out.items()})

    starts = range(0, len(rows), batch_size)
    out_rows: list[dict] = []
    if prefetch and len(starts) > 1:
        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = ex.submit(make_batch, starts[0])
            for i in range(len(starts)):
                n, batch = pending.result()
                if i + 1 < len(starts):
                    pending = ex.submit(make_batch, starts[i + 1])
                emit(n, predictor(batch))
        return out_rows
    for start in starts:
        n, batch = make_batch(start)
        emit(n, predictor(batch))
    return out_rows
