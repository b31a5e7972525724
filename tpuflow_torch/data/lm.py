"""LM data plumbing for the GPT training slice (counterpart of
``tpuflow/data/lm.py``): corpus sizing and the train/val loaders."""

from __future__ import annotations

from tpuflow_torch.data.datasets import _load_synthetic_lm
from tpuflow_torch.data.loader import ShardedLoader


def lm_corpus_size(batch_size: int, steps: int) -> int:
    """Docs in the lm_synth corpus for a run's parameters."""
    return max(batch_size * steps, batch_size)


def make_lm_loaders(
    batch_size: int,
    steps: int,
    seq_len: int,
    vocab: int,
    dataset: str = "lm_synth",
    text_path: str | None = None,
) -> tuple[ShardedLoader, ShardedLoader]:
    """Train/val LM loaders yielding ``{'x': tokens[:, :-1], 'y':
    tokens[:, 1:], 'mask'}``: the train loader reshuffles per epoch and
    stops after ``steps`` batches; the val loader pads and masks its
    ragged tail so every held-out window counts. Only ``lm_synth`` is
    ported: ``lm_text`` resolves its file through environment knobs the
    port does not take, and raises."""
    check_dataset(dataset, text_path)
    ds = _load_synthetic_lm(lm_corpus_size(batch_size, steps), seq_len, vocab)
    train = ShardedLoader(
        ds.train, batch_size=batch_size, shuffle=True, max_batches=steps
    )
    return train, _val_loader(ds, batch_size)


def check_dataset(dataset: str, text_path: str | None = None) -> None:
    """Raise unless ``dataset`` is one the port's loaders take:
    ``lm_text`` is not ported yet, any other name is unknown."""
    if dataset == "lm_text":
        raise NotImplementedError(
            "dataset 'lm_text' is not ported yet: ROADMAP Queue 1 item 12 "
            "(GPT-2 training remainder)"
        )
    if dataset != "lm_synth":
        raise ValueError(
            f"unknown dataset {dataset!r}; available: lm_synth, lm_text"
        )
    if text_path is not None:
        raise ValueError("text_path applies to dataset 'lm_text' only")


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
) -> ShardedLoader:
    """The held-out ``lm_synth`` loader a training run of
    ``synthetic_size`` documents validated on (``make_lm_loaders``'s val
    loader), for an eval flow that scores the run's checkpoint."""
    return _val_loader(_load_synthetic_lm(synthetic_size, seq_len, vocab),
                       batch_size)
