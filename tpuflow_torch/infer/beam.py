"""Beam-search decoding: deterministic width-K search over the KV cache.

Counterpart of ``tpuflow/infer/beam.py``. The prompt is prefilled ONCE at
width B (``chunked_prefill``), then each layer's cache is tiled K-fold
along the batch axis (B -> B*K rows, ``repeat_interleave``); every step
runs one cached decode over the B*K beams, keeps each row's K best
continuations, and reorders the cache rows to the chosen parents. Finished
beams extend only with ``pad_id`` at zero cost. After the last step the
parent chain is walked back and the beams are ranked under the GNMT
length penalty. The JAX scan becomes a Python loop.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values;
``torch.topk`` promises no order, so selection here is a stable descending
sort (``_top_k``), which picks the same parents.
"""

from __future__ import annotations

import torch

from tpuflow_torch.device import f32_matmul_precision
from tpuflow_torch.infer.generate import (
    check_cache_capacity,
    chunked_prefill,
    normalize_prefill_chunk,
    prompt_lens_to_pad_lens,
)

_NEG = -1e30


def _top_k(x, k: int):
    """The ``k`` largest entries along the last axis, largest first, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_beams(cache, flat_parent) -> None:
    """Reorder the cache rows to the chosen parents, in place. Only the
    written columns (before ``cache.index``) move: later columns are
    masked out of every query until a step overwrites them.
    ``index_select`` copies the gathered rows before they are written
    back, so no row reads one that was already overwritten."""
    n = cache.index
    for c in (*cache.k, *cache.v):
        c[:, :n].copy_(c[:, :n].index_select(0, flat_parent))


@torch.no_grad()
def beam_search(
    model,
    prompt,
    *,
    beam_size: int,
    max_new_tokens: int,
    eos_id: int | None = None,
    pad_id: int = 0,
    length_penalty: float = 1.0,
    prompt_lens=None,
    return_all: bool = False,
    prefill_chunk: int | None = None,
):
    """Deterministic beam-search continuation of ``prompt`` (B, T).

    Returns ``(tokens (B, max_new_tokens) int32, scores (B,))`` — the best
    beam per row under a GNMT-style length penalty (``scores`` are total
    token logprob / length**penalty; eos-frozen tails contribute nothing)
    — or, with ``return_all``, ``(tokens, scores, all_tokens (B, K, M),
    all_scores (B, K))``. ``beam_size=1`` equals greedy decoding. Ragged
    prompts ride ``prompt_lens`` as in ``generate``; ``prefill_chunk``
    streams the prompt into the cache in fixed slices.
    """
    with f32_matmul_precision(model.config.decode_precision == "highest"):
        dev = model.device
        prompt = torch.as_tensor(prompt, device=dev).long()
        B, T = prompt.shape
        if beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam_size}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if length_penalty < 0:
            raise ValueError(
                f"length_penalty must be >= 0, got {length_penalty} (negative "
                "penalties would be silently neutralized by the norm clamp)"
            )
        check_cache_capacity(model, T, max_new_tokens)
        prefill_chunk = normalize_prefill_chunk(prefill_chunk, T)
        pad_lens = prompt_lens_to_pad_lens(prompt_lens, B, T, device=dev)
        K = beam_size

        # Prefill once at width B, then tile the cache K-fold: K x cheaper
        # than prefilling B*K identical prompts.
        logits, cache = chunked_prefill(model, prompt, prefill_chunk,
                                        pad_lens=pad_lens)
        cache.k = [c.repeat_interleave(K, dim=0) for c in cache.k]
        cache.v = [c.repeat_interleave(K, dim=0) for c in cache.v]
        tiled_pad_lens = (
            pad_lens.repeat_interleave(K, dim=0) if pad_lens is not None
            else None
        )
        logprobs = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
        V = logprobs.shape[-1]
        # Step 0: the top-K first tokens seed the beams.
        scores, tok0 = _top_k(logprobs, K)  # (B, K)
        done = (tok0 == eos_id if eos_id is not None
                else torch.zeros((B, K), dtype=torch.bool, device=dev))
        lengths = torch.ones((B, K), dtype=torch.int64, device=dev)
        frozen = torch.full((V,), _NEG, device=dev)
        frozen[pad_id] = 0.0
        rows = torch.arange(B, device=dev)[:, None] * K
        tok, parents, tokens = tok0, [], []
        for _ in range(max_new_tokens - 1):
            logits, cache = model(tok.reshape(B * K)[:, None], decode=True,
                                  cache=cache, pad_lens=tiled_pad_lens)
            lp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
            lp = lp.reshape(B, K, V)
            if eos_id is not None:
                # Finished beams extend ONLY with pad at zero cost: they keep
                # their score and stay comparable against live beams.
                lp = torch.where(done[..., None], frozen, lp)
            total = scores[..., None] + lp  # (B, K, V)
            scores, idx = _top_k(total.reshape(B, K * V), K)
            parent, token = idx // V, idx % V
            _gather_beams(cache, (rows + parent).reshape(-1))
            done = torch.gather(done, 1, parent)
            lengths = torch.gather(lengths, 1, parent) + (~done).long()
            if eos_id is not None:
                done = done | (token == eos_id)
                token = torch.where(done & (token != eos_id), pad_id, token)
            parents.append(parent)
            tokens.append(token)
            tok = token

        # Backtrack: follow each surviving beam's parent chain from the last
        # step to the first, then prepend step 0.
        beam_idx = torch.arange(K, device=dev).expand(B, K)
        back = []
        for parent, token in zip(reversed(parents), reversed(tokens)):
            back.append(torch.gather(token, 1, beam_idx))
            beam_idx = torch.gather(parent, 1, beam_idx)
        first = torch.gather(tok0, 1, beam_idx)
        seqs = torch.stack([first, *reversed(back)], dim=2).to(torch.int32)

        # Rank by length-normalized score (GNMT-style penalty; 1.0 = the mean
        # token logprob over real tokens).
        norm = lengths.float() ** length_penalty
        ranked = scores / torch.clamp(norm, min=1.0)
        best = torch.argmax(ranked, dim=1)
        r = torch.arange(B, device=dev)
        if return_all:
            return seqs[r, best], ranked[r, best], seqs, ranked
        return seqs[r, best], ranked[r, best]
