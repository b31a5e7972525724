"""Prompt-lookup speculative decoding: draft from the context, verify in
one forward — token-exact greedy decoding at fewer model forwards.

Counterpart of ``tpuflow/infer/speculative.py``. No draft model: the
trailing (ngram-1)-gram is matched against the prompt + generated text and
the tokens that followed its most recent occurrence become the draft,
laddering down to shorter grams (ultimately a single token) when the
longer gram never recurs. Each iteration runs ONE cached forward over the
``[cur, draft...]`` chunk of draft_len + 1 tokens, accepts the longest
prefix on which the model's own argmax agrees, keeps the model's token at
the first disagreement (the "bonus" token, so every iteration commits at
least one token), and rewinds the shared cache index past the rejected
tail (stale entries beyond the index are masked out of attention until
overwritten). The JAX ``while_loop`` becomes a Python loop.

Exactness: the verify chunk's products round like single-token decode
because the model runs every fp product of a multi-token decode call one
(row, position) at a time (``models/gpt2.py::_tokenwise``), and the int8
products are exact integer sums at any width. On an MoE model the chunk
routes its K + 1 tokens together, so an expert's capacity can drop a
token that a single-token step keeps: there the oracle is the JAX
``speculative_generate`` (``models/moe.py``'s contract), not
``generate()``.

Batching: rows draft independently; the batch advances by the MINIMUM
acceptance across live rows (the cache index is shared). The serving
engine (``infer/serve.py``) commits per row instead, drafting each slot on
the host with ``ngram_draft``. Greedy only; dense prompts only.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.device import f32_matmul_precision
from tpuflow_torch.infer.generate import (
    after_first_true,
    check_cache_capacity,
    chunked_prefill,
    normalize_prefill_chunk,
)


def ngram_draft(history, K: int, *, ngram: int = 3):
    """Host-side (numpy) twin of ``draft_ladder`` for ONE sequence: the K
    tokens that followed the most recent earlier occurrence of the
    trailing (ngram-1)-gram, laddering down to shorter grams, falling back
    to repeat-last-token (a short continuation is padded with the last
    token). The serving engine drafts per slot with this. Returns a (K,)
    int32 draft; ``history`` must be non-empty."""
    h = np.asarray(history, np.int32).reshape(-1)
    n = h.size
    if n == 0:
        raise ValueError("ngram_draft needs a non-empty history")
    G = max(int(ngram) - 1, 1)
    for g in range(min(G, n - 1), 0, -1):
        key = h[n - g:]
        # Windows over h[:n-1]: starts 0..n-g-1, so the trailing gram
        # itself (start n-g) is never its own match.
        win = np.lib.stride_tricks.sliding_window_view(h[: n - 1], g)
        hits = np.nonzero((win == key).all(axis=1))[0]
        if hits.size:
            s = int(hits[-1])
            cand = h[s + g: s + g + K]
            if cand.size < K:
                cand = np.concatenate(
                    [cand, np.full(K - cand.size, h[-1], np.int32)]
                )
            return cand.astype(np.int32)
    return np.full(K, h[-1], np.int32)


def draft_ladder(hist, n_hist: int, *, K: int, G: int):
    """Per-row prompt lookup with an n-gram LADDER, for a (B, W) history
    buffer whose first ``n_hist`` columns are valid (prompt + committed +
    cur): the K tokens that followed the most recent earlier occurrence of
    the trailing G-gram; when that gram never recurs, shorter and shorter
    grams down to 1; when none recurs, the last token repeated. A match
    counts only when its K continuation columns lie inside the buffer.
    Wrong drafts only cost speed: the verify forward arbitrates."""
    B, W = hist.shape
    dev = hist.device
    # Window origins extend to -(G-1): a g-gram (g < G) needs only the LAST
    # g columns of its window in range, so matches ending in the first
    # G-g history positions live at negative origins.
    pos = torch.arange(-(G - 1), W, device=dev)
    gs = torch.arange(G, device=dev)
    tail = hist[:, (n_hist - G + gs).clamp(0, W - 1)]  # (B, G)
    # Negative indices clip to 0: garbage columns, but only in the first
    # G-g slots that a g-gram never reads (the origin bound below).
    windows = hist[:, (pos[:, None] + gs[None, :]).clamp(0, W - 1)]
    eq = windows == tail[:, None, :]  # (B, W+G-1, G)
    # suffix_ok[..., g-1]: the window matches the tail on its LAST g
    # entries, a g-gram match ending at column pos+G-1.
    suffix_ok = torch.cumprod(eq.flip(-1).int(), dim=-1).bool()
    in_range = (pos + G < n_hist) & (pos + G + K <= W)
    start = torch.zeros(B, dtype=torch.long, device=dev)
    found_any = torch.zeros(B, dtype=torch.bool, device=dev)
    # Longest gram first; the sentinel -G-1 sits below every legal origin.
    for g in range(G, 0, -1):
        ok_g = suffix_ok[..., g - 1] & in_range & (pos + G - g >= 0)
        m_g = torch.where(ok_g, pos, -G - 1).amax(dim=-1)
        found_g = m_g > -G
        start = torch.where(found_g & ~found_any, m_g + G, start)
        found_any = found_any | found_g
    cand = torch.gather(
        hist, 1, start[:, None] + torch.arange(K, device=dev)[None, :]
    )
    last = hist[:, n_hist - 1: n_hist]
    return torch.where(found_any[:, None], cand, last)


@torch.no_grad()
def speculative_generate(
    model,
    prompt,
    *,
    max_new_tokens: int,
    draft_len: int = 8,
    ngram: int = 3,
    eos_id: int | None = None,
    pad_id: int = 0,
    return_stats: bool = False,
    prefill_chunk: int | None = None,
):
    """Greedy decode via prompt-lookup speculation, committing up to
    ``draft_len + 1`` tokens per model forward when the context repeats.
    Token-exact vs ``generate(..., temperature=0)`` of the same model (fp
    or fused-native int8), given the same ``prefill_chunk``.

    ``prompt``: dense (B, T). ``ngram`` is the match-key length + 1 (3 =
    match on the trailing 2-gram). Returns (B, max_new_tokens) int32; with
    ``return_stats=True`` ``(tokens, stats)``, stats holding
    ``n_forwards`` (verify passes) and ``n_committed`` (tokens emitted,
    clamped to the budget): realized acceptance is ``n_committed /
    n_forwards`` tokens per forward.
    """
    with f32_matmul_precision(model.config.decode_precision == "highest"):
        dev = model.device
        prompt = torch.as_tensor(prompt, device=dev).long()
        B, T = prompt.shape
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        if ngram < 2:
            raise ValueError(f"ngram must be >= 2, got {ngram}")
        if T < ngram - 1:
            raise ValueError(
                f"prompt length {T} is shorter than the {ngram - 1}-token "
                "match key; use generate() for such prompts"
            )
        # The uniform advance can run the cache up to draft_len+1 past the
        # budget before the loop notices: reserve that slack in n_ctx.
        check_cache_capacity(model, T, max_new_tokens + draft_len + 1)
        prefill_chunk = normalize_prefill_chunk(prefill_chunk, T)
        K, G = draft_len, ngram - 1
        L = max_new_tokens + K + 1  # output slack for the last overshoot write

        logits, cache = chunked_prefill(model, prompt, prefill_chunk)
        cur = torch.argmax(logits[:, -1, :], dim=-1)
        # One buffer serves drafting (the full history) and output (the slice
        # past the prompt). cur lands at column T now, so the first draft's
        # match key ends in the real first token.
        hist = torch.cat(
            [prompt, torch.full((B, L), pad_id, dtype=torch.long, device=dev)],
            dim=1,
        )
        hist[:, T] = cur
        done = (cur == eos_id if eos_id is not None
                else torch.zeros(B, dtype=torch.bool, device=dev))
        j = torch.arange(K + 1, device=dev)
        rows = torch.arange(B, device=dev)[:, None]
        n_out = n_fwd = 0
        while n_out < max_new_tokens and not bool(done.all()):
            d = draft_ladder(hist, T + n_out + 1, K=K, G=G)  # (B, K)
            x = torch.cat([cur[:, None], d], dim=1)  # (B, K+1)
            logits, cache = model(x, decode=True, cache=cache)
            am = torch.argmax(logits, dim=-1)  # (B, K+1)
            # am[:, j] = the model's token after (cur, d_0..d_{j-1}).
            a_row = torch.cumprod((am[:, :K] == d).int(), dim=1).sum(dim=1)
            a_row = torch.where(done, K, a_row)  # frozen rows never constrain
            a = int(a_row.min())  # shared cache index: batch-uniform advance
            # Committed window (a+1 valid): the accepted draft prefix, then
            # the model's token at the disagreement.
            window = torch.where(
                j[None, :] < a, torch.nn.functional.pad(d, (0, 1)),
                am[rows, j.clamp(max=a)[None, :]],
            )
            if eos_id is not None:
                is_eos = (window == eos_id) & (j[None, :] <= a)
                window = torch.where(after_first_true(is_eos) | done[:, None],
                                     pad_id, window)
                done = done | (is_eos & ~done[:, None]).any(dim=1)
            else:
                window = torch.where(done[:, None], pad_id, window)
            hist[:, T + n_out] = cur
            hist[:, T + n_out + 1: T + n_out + K + 2] = window
            cur = window[:, a]
            # The cache index is always T + committed-count: the keys of cur
            # and the accepted drafts stay, the rejected tail is rewound.
            cache.index = T + n_out + a + 1
            n_out += a + 1
            n_fwd += 1
        # If the loop never ran (or exited at the budget), the pending cur was
        # never committed: flush it raw.
        hist[:, T + min(n_out, L - 1)] = cur
        out = hist[:, T:T + max_new_tokens]
        if eos_id is not None:
            out = torch.where(after_first_true(out == eos_id), pad_id, out)
        out = out.to(torch.int32)
        if return_stats:
            return out, {"n_forwards": n_fwd,
                         "n_committed": min(n_out, max_new_tokens)}
        return out
