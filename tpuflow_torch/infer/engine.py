"""Batched inference over row datasets with stateful predictors.

Counterpart of ``tpuflow/infer/engine.py``:

- ``BatchPredictor`` loads the weights once (``from_checkpoint``: the
  ``params`` subtree of a checkpoint, and for a model with BatchNorm its
  ``batch_stats`` subtree, whose absence is an error) and maps a batch to
  ``{"logits": f32, "predicted_values": argmax}`` with a no-grad forward
  on its device (BatchNorm on its running statistics).
- ``map_batches`` feeds it fixed-size batches (the ragged tail padded by
  repeating its last row, the outputs trimmed) and returns one output row
  per input row, in order; a one-thread prefetch assembles batch N+1
  while batch N runs.
- ``GenerationPredictor`` decodes each batch of (possibly ragged) prompt
  rows: ``generate`` over the left-padded batch, the speculative path for
  dense greedy batches, and from the second batch on a shared
  ``ServeEngine`` for greedy non-speculative ones; int8 through
  ``quantize=``.
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
from tpuflow_torch.infer.generate import generate, pad_ragged
from tpuflow_torch.infer.quant import (
    maybe_quantize,
    quant_decision,
    quantize_model,
)
from tpuflow_torch.infer.serve import ServeEngine
from tpuflow_torch.infer.speculative import speculative_generate


class BatchPredictor:
    """Stateful predictor over ``model`` (its weights already in place) on
    ``device`` (None: ``cuda``, which raises where CUDA is absent)."""

    def __init__(self, model: torch.nn.Module, *, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, model: torch.nn.Module,
                        *, device=None,
                        zero_copy: bool = False) -> "BatchPredictor":
        """Load the checkpoint's ``params`` (the JAX layout, weights only)
        into ``model`` once, then serve from it. A model with BatchNorm
        also loads the ``batch_stats`` subtree; a checkpoint without one
        raises ``KeyError``, since the running statistics are what
        inference normalises by. ``zero_copy`` maps the shard files
        instead of reading them: sound for a finished run's checkpoint,
        which no writer recycles any more."""
        device = resolve_device(device)
        params = restore_from_handle(checkpoint, weights_only=True,
                                     zero_copy=zero_copy)
        load_params(model, params)
        if running_stats(model):
            try:
                stats = restore_from_handle(checkpoint,
                                            subtree=("batch_stats",),
                                            zero_copy=zero_copy)
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


class GenerationPredictor:
    """Stateful LM generation actor for ``map_batches``: weights loaded
    once, each batch of (possibly ragged) prompt rows decoded in one call
    (``generate`` with ``prompt_lens``; raggedness is absorbed by left-pad
    + mask, token-exactly). Returns ``{"generated": (B, max_new_tokens)
    int32}``.

    ``pad_to`` fixes the padded prompt width across batches. ``quantize``:
    ``'int8'`` (weight-only), ``'int8-native'`` / ``'int8-mxu'``
    (fused-native W8A8), both forced, with the advisory ``quant_decision``
    recorded; ``'auto'`` applies weight-only only where the gate says so.
    ``speculative`` decodes dense greedy batches by prompt lookup
    (``draft_len``, ``ngram``). From the second batch on, greedy
    non-speculative batches without ``pad_to`` go through one shared
    ``ServeEngine`` unless ``serve=False``; a batch with a row no engine
    bucket fits takes ``generate``. ``generator`` drives sampling across
    batches (None: one seeded 0). ``stats`` counts the batches by route
    and the speculative forwards and committed tokens.
    """

    def __init__(
        self,
        model,
        *,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        eos_id: int | None = None,
        pad_id: int = 0,
        pad_to: int | None = None,
        generator: torch.Generator | None = None,
        quantize: str | None = None,
        speculative: bool = False,
        draft_len: int = 8,
        ngram: int = 3,
        prefill_chunk: int | None = None,
        serve: bool = True,
    ):
        self.quant_decision = None
        if quantize is not None:
            # Explicit modes are forced (the caller asked); 'auto' asks
            # the gate. The verdict lands on quant_decision either way,
            # taken on the ORIGINAL float weights.
            modes = {
                "int8": "weight",
                "int8-mxu": "mxu",
                "int8-native": "mxu",
            }
            if quantize == "auto":
                model, self.quant_decision = maybe_quantize(model,
                                                            mode="weight")
            elif quantize in modes:
                self.quant_decision = quant_decision(model,
                                                     mode=modes[quantize])
                model = quantize_model(model, mode=modes[quantize])
            else:
                raise ValueError(
                    f"unknown quantize mode {quantize!r}; supported: "
                    f"{sorted(modes) + ['auto']}"
                )
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.pad_to = pad_to
        if speculative and temperature != 0.0:
            raise ValueError(
                "speculative=True requires temperature=0.0 (greedy): "
                "prompt-lookup speculation is token-exact greedy decoding"
            )
        if speculative and pad_to is not None:
            raise ValueError(
                "speculative=True is incompatible with pad_to: padded "
                "batches are LEFT-padded and speculation is dense-only"
            )
        if speculative and draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        if speculative and ngram < 2:
            raise ValueError(f"ngram must be >= 2, got {ngram}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}"
            )
        self.speculative = speculative
        self.draft_len = draft_len
        self.ngram = ngram
        self.prefill_chunk = prefill_chunk
        self.serve = serve
        self._serve_engine = None
        self._batches_seen = 0
        self.generator = generator if generator is not None else (
            torch.Generator(device=model.device).manual_seed(0))
        self.stats = dict(generate_batches=0, serve_batches=0,
                          spec_batches=0, spec_forwards=0, spec_committed=0)

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, model, *, subtree=None,
                        **kw) -> "GenerationPredictor":
        """Load the checkpoint's ``params`` (``subtree`` names another, e.g.
        ``("ema_params",)``) into ``model`` once, then serve from it."""
        load_params(model, restore_from_handle(
            checkpoint, weights_only=True, subtree=subtree))
        return cls(model, **kw)

    def _serve_batch(self, prompt, lens) -> np.ndarray | None:
        """Decode one (possibly LEFT-padded) batch through the shared
        engine: each row becomes a request, the outputs re-assembled into
        the ``generate()`` contract (eos emitted, the rest ``pad_id``).
        Returns None when a row fits no engine bucket."""
        if self._serve_engine is None:
            # quant=False: the predictor already applied its own quantize=
            # policy to the model.
            self._serve_engine = ServeEngine(
                self.model, prefill_chunk=self.prefill_chunk,
                pad_id=self.pad_id, quant=False,
            )
        engine = self._serve_engine
        B, W = prompt.shape
        rows = [
            prompt[i, W - (W if lens is None else int(lens[i])):]
            for i in range(B)
        ]
        try:
            for row in rows:
                engine.bucket_for(row.size, self.max_new_tokens)
        except ValueError:
            return None
        outs = engine.generate_many(rows, max_new_tokens=self.max_new_tokens,
                                    eos_id=self.eos_id)
        full = np.full((B, self.max_new_tokens), self.pad_id, np.int32)
        for i, toks in enumerate(outs):
            full[i, :toks.size] = toks
        self.stats["serve_batches"] += 1
        return full

    def __call__(self, batch: dict) -> dict:
        tokens = batch["tokens"]
        if isinstance(tokens, np.ndarray) and tokens.ndim == 2:
            prompt = tokens.astype(np.int32)
            lens = None
        else:
            prompt, lens = pad_ragged(tokens, pad_id=self.pad_id)
        if self.pad_to is not None:
            if prompt.shape[1] > self.pad_to:
                raise ValueError(
                    f"a prompt of length {prompt.shape[1]} exceeds "
                    f"pad_to={self.pad_to}"
                )
            extra = self.pad_to - prompt.shape[1]
            if extra:
                if lens is None:
                    lens = np.full(
                        (prompt.shape[0],), prompt.shape[1], np.int32
                    )
                prompt = np.concatenate(
                    [np.full((prompt.shape[0], extra), self.pad_id, np.int32),
                     prompt],
                    axis=1,
                )
        if lens is not None and bool((lens == prompt.shape[1]).all()):
            # Equal-length rows that arrived as lists: nothing was padded,
            # so take the dense path (it enables speculation).
            lens = None
        self._batches_seen += 1
        if (
            self._batches_seen > 1
            and self.temperature == 0.0
            and not self.speculative
            and self.pad_to is None
            and self.serve
        ):
            out = self._serve_batch(prompt, lens)
            if out is not None:
                return {"generated": out}
        if (
            self.speculative
            and lens is None
            and prompt.shape[1] >= self.ngram - 1
            # The uniform advance can overshoot by draft_len + 1.
            and prompt.shape[1] + self.max_new_tokens + self.draft_len + 1
            <= self.model.config.n_ctx
        ):
            out, stats = speculative_generate(
                self.model, prompt, max_new_tokens=self.max_new_tokens,
                draft_len=self.draft_len, ngram=self.ngram,
                eos_id=self.eos_id, pad_id=self.pad_id,
                prefill_chunk=self.prefill_chunk, return_stats=True,
            )
            self.stats["spec_batches"] += 1
            self.stats["spec_forwards"] += stats["n_forwards"]
            self.stats["spec_committed"] += stats["n_committed"]
            return {"generated": out.cpu().numpy()}
        out = generate(
            self.model, prompt, prompt_lens=lens,
            max_new_tokens=self.max_new_tokens, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p, eos_id=self.eos_id,
            pad_id=self.pad_id, generator=self.generator,
            prefill_chunk=self.prefill_chunk,
        )
        self.stats["generate_batches"] += 1
        return {"generated": out.cpu().numpy()}


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
