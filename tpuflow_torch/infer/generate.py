"""Autoregressive generation for the GPT-2 family: KV-cache decode.

Counterpart of ``tpuflow/infer/generate.py``. Prefill runs the prompt
through the model once in decode mode (or in fixed-size chunks), filling a
fresh ``KVCache``; decode then loops single-token steps in Python (PyTorch
runs eagerly, so the JAX scan / while-loop becomes a loop that, with an
``eos_id``, stops as soon as every row has finished). Sampling is
temperature / top-k / top-p from a ``torch.Generator``; temperature 0 is
greedy.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.device import pin_f32_matmul_precision

_MASKED = -1e30


def filter_logits(logits, temperature, *, top_k: int | None,
                  top_p: float | None):
    """Temperature, then top-k, then nucleus filtering of (B, V) logits;
    filtered entries become -1e30. The nucleus keeps the smallest prefix of
    the sorted distribution with cumulative probability >= top_p (the first
    token always survives)."""
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _MASKED, logits)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits, float("inf")).amin(
            dim=-1, keepdim=True
        )
        logits = torch.where(logits < cutoff, _MASKED, logits)
    return logits


def _sample(logits, generator, temperature, top_p, *, greedy: bool,
            top_k: int | None, use_top_p: bool):
    """(B, V) logits → (B,) sampled token ids (int64)."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(
        logits, temperature, top_k=top_k,
        top_p=top_p if use_top_p else None,
    )
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


def normalize_prefill_chunk(prefill_chunk, T: int):
    """Widths < 1 fail; no-op widths (>= T) normalize to None."""
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    if prefill_chunk is not None and prefill_chunk >= T:
        return None
    return prefill_chunk


def chunked_prefill(model, prompt, prefill_chunk, *, pad_lens=None):
    """Fill a fresh KV cache from ``prompt`` in one pass (``prefill_chunk``
    None or >= T) or in fixed-size slices; chunks after the first hit the
    warm cache at index > 0 (masked whole-cache attention). Returns
    ``(last_chunk_logits, cache)``."""
    T = prompt.shape[1]
    cache = model.init_cache(prompt.shape[0])
    if prefill_chunk is None or prefill_chunk >= T:
        return model(
            prompt, decode=True, cache=cache, pad_lens=pad_lens, prefill=True
        )
    for start in range(0, T, prefill_chunk):
        logits, cache = model(
            prompt[:, start:start + prefill_chunk], decode=True, cache=cache,
            pad_lens=pad_lens, prefill=True,
        )
    return logits, cache


def after_first_true(flags):
    """(…, T) bool → True at positions STRICTLY after the first True along
    the last axis."""
    f = flags.to(torch.int32)
    return (torch.cumsum(f, dim=-1) - f) > 0


def check_cache_capacity(model, width: int, max_new_tokens: int) -> None:
    """prompt + new tokens must fit the model's fixed KV-cache size."""
    n_ctx = model.config.n_ctx
    if width + max_new_tokens > n_ctx:
        raise ValueError(
            f"prompt length {width} + max_new_tokens {max_new_tokens} "
            f"exceeds the model's n_ctx={n_ctx} (the KV cache size)"
        )


def prompt_lens_to_pad_lens(prompt_lens, batch: int, width: int, *,
                            device=None):
    """Validate ``prompt_lens`` (B,) against a LEFT-padded batch of ``width``
    columns and return the pad counts (an int64 tensor on ``device``);
    None passes through."""
    if prompt_lens is None:
        return None
    lens = np.asarray(prompt_lens, np.int64)
    if lens.shape != (batch,):
        raise ValueError(
            f"prompt_lens shape {lens.shape} != (batch,) = ({batch},)"
        )
    if (lens < 1).any() or (lens > width).any():
        raise ValueError(
            f"prompt_lens must be in [1, {width}], got "
            f"[{lens.min()}, {lens.max()}]"
        )
    return torch.as_tensor(width - lens, device=device)


def pad_ragged(prompts, *, pad_id: int = 0):
    """LEFT-pad variable-length token sequences to one (B, Tmax) int32
    array. Returns ``(prompt, prompt_lens)``."""
    seqs = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if not seqs:
        raise ValueError("prompts is empty")
    lens = np.array([len(s) for s in seqs], np.int32)
    if (lens == 0).any():
        raise ValueError("every prompt must have at least one token")
    T = int(lens.max())
    out = np.full((len(seqs), T), pad_id, np.int32)
    for i, s in enumerate(seqs):
        out[i, T - len(s):] = s
    return out, lens


@torch.no_grad()
def generate(
    model,
    prompt,
    *,
    max_new_tokens: int,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_id: int | None = None,
    pad_id: int = 0,
    generator: torch.Generator | None = None,
    prompt_lens=None,
    prefill_chunk: int | None = None,
):
    """Sample ``max_new_tokens`` continuations of ``prompt`` (B, T).

    Returns (B, max_new_tokens) int32 on the model's device. Runs where the
    model lives (``GPT2(..., device=)``). ``temperature=0`` is greedy;
    ``top_k`` and ``top_p`` compose (top-k first). With ``eos_id`` the eos
    token itself is emitted and the row's later positions hold ``pad_id``.
    Ragged batches: a LEFT-padded ``prompt`` with ``prompt_lens`` (see
    ``pad_ragged``). ``prefill_chunk`` streams the prompt into the cache
    in fixed-size slices.
    """
    if model.config.decode_precision == "highest":
        pin_f32_matmul_precision()
    dev = model.device
    prompt = torch.as_tensor(np.asarray(prompt), device=dev).long()
    B, T = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(
            f"top_p must be in (0, 1], got {top_p} (<= 0 would mask every "
            "token)"
        )
    check_cache_capacity(model, T, max_new_tokens)
    prefill_chunk = normalize_prefill_chunk(prefill_chunk, T)
    pad_lens = prompt_lens_to_pad_lens(prompt_lens, B, T, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(
        greedy=temperature == 0.0, top_k=top_k, use_top_p=top_p is not None
    )
    logits, cache = chunked_prefill(
        model, prompt, prefill_chunk, pad_lens=pad_lens
    )
    tok = _sample(logits[:, -1, :], generator, temperature, top_p, **kw)
    done = (
        tok == eos_id if eos_id is not None
        else torch.zeros(B, dtype=torch.bool, device=dev)
    )
    out = torch.full((B, max_new_tokens), pad_id, dtype=torch.int32,
                     device=dev)
    out[:, 0] = tok
    for i in range(1, max_new_tokens):
        if eos_id is not None and bool(done.all()):
            break  # every row finished: the rest stays pad_id
        logits, cache = model(
            tok[:, None], decode=True, cache=cache, pad_lens=pad_lens
        )
        sampled = _sample(logits[:, -1, :], generator, temperature, top_p,
                          **kw)
        tok = torch.where(done, torch.full_like(sampled, pad_id), sampled)
        if eos_id is not None:
            done = done | (sampled == eos_id)
        out[:, i] = tok
    return out
