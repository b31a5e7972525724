"""Attention implementations with one call signature, selectable per model.

Counterpart of ``tpuflow/ops/attention.py``. ``attention(q, k, v, *,
causal, impl)`` with q/k/v shaped (B, T, H, D):

- ``"xla"``   — the plain einsum softmax attention (the name is kept so a
  reader finds its counterpart; here it is plain PyTorch on any device).
- ``"flash"`` — flash attention (``tpuflow_torch.ops.flash_attention``):
  the hand-written CUDA kernels on the card (forward, and with a gradient
  the forward with lse and the backward pair ``flash_bwd`` names: fused,
  split or blockwise), their plain versions on the CPU.
- ``"ring"`` / ``"ulysses"`` — sequence parallelism, not ported yet
  (ROADMAP Queue 1 item 14); they raise.
- ``"auto"`` — flash on CUDA at T >= the threshold, else xla.
"""

from __future__ import annotations

import torch

# Auto-dispatch thresholds. Both values were fitted on a TPU v5e by the JAX
# package's bench (fwd+bwd wins from T >= 2048, forward only from
# T >= 512); they say nothing about this card yet and stay until the port
# measures its own crossover.
_DEFAULT_FLASH_MIN_SEQ = 2048
_DEFAULT_FLASH_MIN_SEQ_FWD = 512


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


def resolve_attention_impl(
    impl: str, seq_len: int, *, needs_bwd: bool = True,
    backend: str = "cpu",
) -> str:
    """Resolve ``impl='auto'`` for one (backend, seq_len, path): flash only
    on ``cuda`` at ``seq_len`` >= the fwd+bwd threshold (``needs_bwd``) or
    the forward-only threshold; xla everywhere else. Other impls pass
    through unchanged."""
    if impl != "auto":
        return impl
    threshold = (
        _DEFAULT_FLASH_MIN_SEQ if needs_bwd else _DEFAULT_FLASH_MIN_SEQ_FWD
    )
    if backend == "cuda" and seq_len >= threshold:
        return "flash"
    return "xla"


def attention(q, k, v, *, causal: bool = True, impl: str = "xla",
              needs_bwd: bool = True, flash_bwd: str = "fused"):
    """Dispatch to the selected implementation (see module docstring).
    ``flash_bwd`` picks the flash backward (the JAX package's
    ``TPUFLOW_FLASH_BWD``)."""
    impl = resolve_attention_impl(
        impl, q.shape[1], needs_bwd=needs_bwd, backend=q.device.type
    )
    if impl == "xla":
        return xla_attention(q, k, v, causal=causal)
    if impl == "flash":
        from tpuflow_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, bwd=flash_bwd)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention impl {impl!r} (sequence parallelism) is not ported "
            "yet: ROADMAP Queue 1 item 14"
        )
    raise KeyError(
        f"unknown attention impl {impl!r}; use xla|flash|ring|ulysses"
    )
