"""Per-sequence log-likelihood scoring and best-of-n reranking for the LM
family.

Counterpart of ``tpuflow/infer/score.py``: ``sequence_logprob`` returns
each sequence's total (or mean) token log-likelihood under the model, one
no-grad forward per batch (the dense forward goes through
``attention(impl=cfg.attn_impl)``, the flash kernel at long T on the
card), on padded batches through a token mask or left-pad counts;
``best_of_n`` samples n continuations per prompt in one ``generate`` and
keeps the one the model scores highest.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.infer.generate import (
    after_first_true,
    generate,
    prompt_lens_to_pad_lens,
)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def best_of_n(
    model,
    prompt,
    *,
    n: int,
    max_new_tokens: int,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    generator: torch.Generator | None = None,
    per_token: bool = True,
    eos_id: int | None = None,
    pad_id: int = 0,
    prompt_lens=None,
):
    """Sample ``n`` continuations per prompt row and return the one the
    model itself scores highest: ONE ``generate`` over the (B*n)-row tiled
    prompt (each row draws from ``generator`` in turn), one
    ``sequence_logprob`` pass scoring only the continuation tokens (the
    prompt conditions but is masked out of the score), then an argmax per
    original row. Returns ``(tokens (B, max_new_tokens), logprob (B,))``;
    ``per_token=True`` compares length-normalized scores.

    With ``eos_id`` a candidate counts its tokens up to AND INCLUDING its
    first eos (``after_first_true``); the pad after it contributes nothing.
    Ragged prompts ride ``prompt_lens`` (LEFT-padded batch, see
    ``pad_ragged``) through both passes.
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    prompt = _host(prompt).astype(np.int64)
    B, T = prompt.shape
    tiled = np.repeat(prompt, n, axis=0)
    tiled_lens = pad_lens_full = None
    if prompt_lens is not None:
        tiled_lens = np.repeat(_host(prompt_lens).astype(np.int64), n, axis=0)
        pad_lens_full = T - tiled_lens
    conts = generate(
        model, tiled, max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=top_k, top_p=top_p, generator=generator, eos_id=eos_id,
        pad_id=pad_id, prompt_lens=tiled_lens,
    )
    dev = conts.device
    full = torch.cat([torch.as_tensor(tiled, device=dev), conts.long()], 1)
    cont_mask = torch.ones((B * n, max_new_tokens), device=dev)
    if eos_id is not None:
        # Score through the first eos (inclusive); the frozen tail out.
        cont_mask = torch.where(after_first_true(conts == eos_id), 0.0,
                                cont_mask)
    mask = torch.cat([torch.zeros((B * n, T), device=dev), cont_mask], 1)
    scores = sequence_logprob(
        model, full, mask=mask, per_token=per_token, pad_lens=pad_lens_full,
    ).reshape(B, n)
    best = torch.argmax(scores, dim=-1)
    rows = torch.arange(B, device=dev)
    picked = conts.reshape(B, n, max_new_tokens)[rows, best]
    return picked, scores[rows, best]


@torch.no_grad()
def sequence_logprob(model, tokens, *, mask=None, per_token: bool = False,
                     pad_lens=None, prompt_lens=None):
    """log p(tokens[:, 1:] | prefixes) per sequence, (B,) float32.

    ``mask`` (B, T) {0, 1}: position i contributes iff ``mask[i] == 1``. It
    gates contributions only, not attention, so on its own it is exact for
    RIGHT-padded batches. For LEFT-padded batches pass ``prompt_lens``
    (B,) real lengths (the ``pad_ragged`` convention) or ``pad_lens`` (B,)
    pad counts: the model then masks the pad columns out of attention and
    shifts positions per row; the default mask then scores each row's
    real positions after its first real token. The first token never
    contributes (it is only conditioned on). ``per_token=True`` returns
    the mean instead of the sum.
    """
    dev = model.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    B, T = tokens.shape
    if prompt_lens is not None:
        if pad_lens is not None:
            raise ValueError("pass prompt_lens or pad_lens, not both")
        pad_lens = prompt_lens_to_pad_lens(prompt_lens, B, T, device=dev)
    elif pad_lens is not None:
        pl = _host(pad_lens).astype(np.int64)
        if (pl < 0).any() or (pl >= T).any():
            raise ValueError(
                f"pad_lens must be in [0, {T - 1}], got "
                f"[{pl.min()}, {pl.max()}]"
            )
        pad_lens = torch.as_tensor(pl, device=dev)
    if mask is None:
        if pad_lens is not None:
            mask = (
                torch.arange(T, device=dev)[None, :] > pad_lens[:, None]
            ).float()
        else:
            mask = torch.ones((B, T), device=dev)
    else:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        if tuple(mask.shape) != (B, T):
            raise ValueError(
                f"mask shape {tuple(mask.shape)} != tokens shape {(B, T)}"
            )
    logits = model(tokens[:, :-1], pad_lens=pad_lens)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logprobs, -1, tokens[:, 1:, None])[..., 0]
    m = mask[:, 1:]
    total = (picked * m).sum(dim=-1)
    if per_token:
        return total / torch.clamp(m.sum(dim=-1), min=1.0)
    return total
