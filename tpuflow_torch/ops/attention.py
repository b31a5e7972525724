"""Attention implementations with one call signature, selectable per model.

Counterpart of ``tpuflow/ops/attention.py``. ``attention(q, k, v, *,
causal, impl)`` with q/k/v shaped (B, T, H, D):

- ``"xla"``   — the plain einsum softmax attention (the name is kept so a
  reader finds its counterpart; here it is plain PyTorch on any device).
- ``"flash"`` — flash attention (``tpuflow_torch.ops.flash_attention``):
  the hand-written CUDA kernels on the card (forward, and with a gradient
  the forward with lse and the backward pair ``flash_bwd`` names: fused,
  split or blockwise), their plain versions on the CPU.
- ``"ring"`` / ``"ulysses"`` — sequence parallelism over the ``seq``
  axis (``parallel/ring_attention.py``, ``parallel/ulysses.py``; the
  latter with ``xla`` inside, as the JAX dispatch calls it). Without a
  ``seq`` group (or one of size 1) both are blockwise attention, the JAX
  functions' fallback on a trivial axis.
- ``"auto"`` — flash on CUDA at T >= the threshold, else xla: one
  threshold for calls that will be differentiated, one for forwards
  only. ``resolve_attention_impl(..., tuning=)`` takes others (a dict,
  or the path of a JSON file, as ``chip_smoke.py`` writes one), as the
  JAX package's ``flash_tuning.json`` does.

Under a ``seq`` mesh (``seq``: this process's ``p2p.AxisGroup``, q, k, v
its block (B, T / s, H, D) of the sequence) ``xla``, ``flash`` and
``auto`` still see the whole sequence, as GSPMD makes the JAX step do:
``gathered_attention`` all-gathers q, k and v over the group, runs the
implementation on the whole T (``auto`` resolved at that T) and keeps
this process's rows; the gradient is reduce-scattered back.
"""

from __future__ import annotations

import json
import warnings

import torch

# Shipped auto-dispatch thresholds: the crossovers chip_smoke.py's phase
# 11 measured on one NVIDIA H100 80GB HBM3 (700 W), the flash kernels
# against xla_attention at (8, T, 12, 64), causal, f32 and bf16, T from
# 128 to 4096 (PERF.md §6). Flash won at every T, forward and
# forward+backward, in both dtypes: from the grid's first point, 128
# (below it nothing was measured, and xla stays).
_DEFAULT_FLASH_MIN_SEQ = 128
_DEFAULT_FLASH_MIN_SEQ_FWD = 128


def xla_attention(q, k, v, *, causal: bool = True):
    """Reference einsum attention. q,k,v: (B, T, H, D) → (B, T, H, D).

    Softmax statistics in float32 regardless of input dtype; the two
    products stay in the input dtype, as in the JAX version.
    """
    B, T, H, D = q.shape
    root = torch.sqrt(torch.tensor(D, dtype=torch.float32)).to(q.dtype)
    scale = (1.0 / root).float().to(q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = torch.ones((T, k.shape[1]), dtype=torch.bool, device=q.device)
        scores = scores.masked_fill(~mask.tril(), float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def load_tuning(tuning) -> dict:
    """A tuning as a dict: ``tuning`` itself, or the JSON object in the
    file it names (a missing or unreadable file: none, {})."""
    if tuning is None or isinstance(tuning, dict):
        return tuning or {}
    try:
        with open(tuning) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _tuning_entry(tuning: dict, key: str) -> int | None:
    """One entry, validated: a positive int, else None (a malformed entry
    is ignored with a warning, never dispatched on)."""
    v = tuning.get(key)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
        warnings.warn(f"flash tuning entry {key}={v!r} is not a positive "
                      "integer; ignoring it", stacklevel=3)
        return None
    return v


def flash_min_seq(*, needs_bwd: bool = True, tuning=None) -> int:
    """The T from which ``auto`` picks flash on the card. Forward and
    backward (``needs_bwd``): the largest valid ``flash_min_seq`` and
    ``flash_min_seq_bwd`` of ``tuning`` (below the backward's own
    crossover the backward loses, whatever the composition says); forward
    only: ``flash_min_seq_fwd``. With no valid entry, the shipped
    threshold."""
    tuning = load_tuning(tuning)
    keys = (("flash_min_seq", "flash_min_seq_bwd") if needs_bwd
            else ("flash_min_seq_fwd",))
    fitted = [v for v in (_tuning_entry(tuning, k) for k in keys)
              if v is not None]
    if fitted:
        return max(fitted)
    return _DEFAULT_FLASH_MIN_SEQ if needs_bwd else _DEFAULT_FLASH_MIN_SEQ_FWD


def resolve_attention_impl(
    impl: str, seq_len: int, *, needs_bwd: bool = True,
    backend: str = "cpu", tuning=None,
) -> str:
    """Resolve ``impl='auto'`` for one (backend, seq_len, path): flash only
    on ``cuda`` at ``seq_len`` >= ``flash_min_seq`` of the path
    (``needs_bwd``: forward and backward, else forward only) under
    ``tuning`` (a dict or a JSON file's path; None: the shipped
    thresholds); xla everywhere else. Other impls pass through
    unchanged."""
    if impl != "auto":
        return impl
    if backend == "cuda" and seq_len >= flash_min_seq(needs_bwd=needs_bwd,
                                                      tuning=tuning):
        return "flash"
    return "xla"


def gathered_attention(q, k, v, *, causal: bool = True, impl: str = "xla",
                       seq=None, needs_bwd: bool = True,
                       flash_bwd: str = "fused"):
    """``impl`` (``xla``, ``flash``, ``auto`` or ``blockwise``) over the
    whole sequence of a ``seq`` mesh: q, k and v gathered over ``seq``
    (a ``p2p.AxisGroup``) along T, this process's block of the output's
    rows kept."""
    from tpuflow_torch.parallel.p2p import all_gather

    Tl = q.shape[1]
    qf, kf, vf = (all_gather(x, seq, dim=1) for x in (q, k, v))
    if impl == "blockwise":
        from tpuflow_torch.ops.flash_attention import blockwise_attention

        out = blockwise_attention(qf, kf, vf, causal=causal)
    else:
        out = attention(qf, kf, vf, causal=causal, impl=impl,
                        needs_bwd=needs_bwd, flash_bwd=flash_bwd)
    return out.narrow(1, seq.rank * Tl, Tl)


def attention(q, k, v, *, causal: bool = True, impl: str = "xla",
              needs_bwd: bool = True, flash_bwd: str = "fused", seq=None):
    """Dispatch to the selected implementation (see module docstring).
    ``flash_bwd`` picks the flash backward (the JAX package's
    ``TPUFLOW_FLASH_BWD``); ``seq`` (a ``p2p.AxisGroup``, None off a
    ``seq`` mesh) the sequence's split."""
    if seq is not None and seq.size > 1:
        if impl == "ring":
            from tpuflow_torch.parallel.ring_attention import ring_attention

            return ring_attention(q, k, v, causal=causal, seq=seq)
        if impl == "ulysses":
            from tpuflow_torch.parallel.ulysses import ulysses_attention

            return ulysses_attention(q, k, v, causal=causal, seq=seq)
        if impl in ("xla", "flash", "auto"):
            return gathered_attention(q, k, v, causal=causal, impl=impl,
                                      seq=seq, needs_bwd=needs_bwd,
                                      flash_bwd=flash_bwd)
    impl = resolve_attention_impl(
        impl, q.shape[1], needs_bwd=needs_bwd, backend=q.device.type
    )
    if impl == "xla":
        return xla_attention(q, k, v, causal=causal)
    if impl == "flash":
        from tpuflow_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, bwd=flash_bwd)
    if impl in ("ring", "ulysses"):
        # A trivial seq axis: the JAX functions' blockwise fallback.
        from tpuflow_torch.ops.flash_attention import blockwise_attention

        return blockwise_attention(q, k, v, causal=causal)
    raise KeyError(
        f"unknown attention impl {impl!r}; use xla|flash|ring|ulysses"
    )
