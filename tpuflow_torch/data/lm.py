"""LM data plumbing for the GPT training slice (counterpart of
``tpuflow/data/lm.py``): corpus sizing, the train/val loaders of
``lm_synth`` and the byte-level ``lm_text``, and the provenance record of
an ``lm_text`` corpus (``text_source_record``, ``check_text_source``).

Where the JAX package resolves the text file through
``TPUFLOW_TEXT_FILE`` and its data directory, the port takes the file as
``text_path`` and the directory as ``data_dir`` (None: look nowhere)."""

from __future__ import annotations

import hashlib
import os
from typing import Any

from tpuflow_torch.data.datasets import (
    _load_synthetic_lm,
    load_dataset,
    resolve_text_path,
)
from tpuflow_torch.data.loader import ShardedLoader

DATASETS = ("lm_synth", "lm_text")


def lm_corpus_size(batch_size: int, steps: int) -> int:
    """Docs in the lm_synth corpus for a run's parameters."""
    return max(batch_size * steps, batch_size)


def text_source_record(text_path: str | None = None,
                       data_dir: str | None = None) -> dict[str, Any]:
    """The ``lm_text`` source a run trains on, fingerprinted: ``{"path",
    "sha256", "bytes"}`` (path None: the synthetic stand-in). A train
    flow records it; an eval flow checks it (``check_text_source``)
    before scoring."""
    path = resolve_text_path(data_dir, text_path)
    if path is None:
        return {"path": None, "sha256": None, "bytes": 0}
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
            n += len(chunk)
    return {"path": os.path.abspath(path), "sha256": h.hexdigest(), "bytes": n}


def check_text_source(record: dict[str, Any],
                      data_dir: str | None = None) -> None:
    """Raise unless the recorded text source still holds the recorded
    bytes: a missing file or a changed hash raises. A run that trained on
    the stand-in raises when a file resolves now (under ``data_dir``)."""
    path = record.get("path")
    if path is None:
        found = resolve_text_path(data_dir)
        if found is not None:
            raise ValueError(
                f"training used the synthetic lm_text stand-in but {found} "
                "resolves now; clean the data dir or re-train on the file"
            )
        return
    current = text_source_record(text_path=path)
    if current["sha256"] != record.get("sha256"):
        raise ValueError(
            f"lm_text corpus changed since training: {path} now hashes "
            f"{current['sha256']} (recorded {record.get('sha256')}); "
            "re-train or pass the original file as text_path"
        )


def make_lm_loaders(
    batch_size: int,
    steps: int,
    seq_len: int,
    vocab: int,
    dataset: str = "lm_synth",
    text_path: str | None = None,
    data_dir: str | None = None,
) -> tuple[ShardedLoader, ShardedLoader]:
    """Train/val LM loaders yielding ``{'x': tokens[:, :-1], 'y':
    tokens[:, 1:], 'mask'}``: the train loader reshuffles per epoch and
    stops after ``steps`` batches; the val loader pads and masks its
    ragged tail so every held-out window counts. ``lm_text`` is
    byte-level (the model's vocab must hold 256) and needs a batch's
    worth of windows."""
    check_dataset(dataset)
    if dataset == "lm_text":
        ds = load_dataset("lm_text", data_dir=data_dir, seq_len=seq_len,
                          text_path=text_path)
        if vocab < 256:
            raise ValueError(
                f"lm_text is byte-level (vocab 256) but the model's "
                f"vocab_size is {vocab}"
            )
        if ds.train.images.shape[0] < batch_size:
            raise ValueError(
                f"lm_text corpus yields only {ds.train.images.shape[0]} "
                f"windows of seq_len+1 bytes — fewer than one batch of "
                f"{batch_size}; use a bigger file or smaller batch size"
            )
    else:
        ds = _load_synthetic_lm(lm_corpus_size(batch_size, steps), seq_len,
                                vocab)
    train = ShardedLoader(
        ds.train, batch_size=batch_size, shuffle=True, max_batches=steps
    )
    return train, _val_loader(ds, batch_size)


def check_dataset(dataset: str) -> None:
    """Raise unless ``dataset`` is one of the LM datasets."""
    if dataset not in DATASETS:
        raise ValueError(
            f"unknown dataset {dataset!r}; available: lm_synth, lm_text"
        )


def _val_loader(ds, batch_size: int) -> ShardedLoader:
    return ShardedLoader(
        ds.test,
        batch_size=batch_size,
        shuffle=False,
        pad_tail=True,
        drop_last=False,
    )


def lm_test_loader(
    batch_size: int,
    synthetic_size: int,
    seq_len: int,
    vocab: int,
    dataset: str = "lm_synth",
    text_path: str | None = None,
) -> ShardedLoader:
    """The held-out loader a training run validated on
    (``make_lm_loaders``'s val loader), for an eval flow that scores the
    run's checkpoint: ``lm_synth`` of ``synthetic_size`` documents, or
    ``lm_text`` of the recorded ``text_path`` (None: the stand-in)."""
    check_dataset(dataset)
    if dataset == "lm_text":
        ds = load_dataset("lm_text", seq_len=seq_len, text_path=text_path)
    else:
        ds = _load_synthetic_lm(synthetic_size, seq_len, vocab)
    return _val_loader(ds, batch_size)
