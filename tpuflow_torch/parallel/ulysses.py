"""Ulysses sequence parallelism: the head and sequence dimensions swapped
by all-to-all (counterpart of ``tpuflow/parallel/ulysses.py``).

Each process of the ``seq`` group holds its block (B, T / s, H, D) of q,
k and v. One all-to-all (``p2p.all_to_all``, split the heads, join the
sequence) gives it the whole sequence for H / s heads, (B, T, H / s, D);
attention runs there with ordinary causal masking through
``ops.attention`` (``inner_impl`` ``xla``, the einsum, or ``flash``, the
hand-written kernels on the card: each process sees an ordinary
full-sequence attention over its heads), and a second all-to-all swaps
the output back to (B, T / s, H, D). Differentiable end to end: the
backward of each all-to-all is the opposite one.
"""

from __future__ import annotations

from tpuflow_torch.ops.flash_attention import blockwise_attention
from tpuflow_torch.parallel.p2p import AxisGroup, all_to_all


def ulysses_attention(q, k, v, *, causal: bool = True,
                      seq: AxisGroup | None = None,
                      inner_impl: str = "xla", flash_bwd: str = "fused"):
    """Sequence-parallel attention through head <-> sequence all-to-all.
    q, k, v: this process's block (B, T / s, H, D) of a sequence split
    over ``seq`` (an ``AxisGroup``); the output is the same block of the
    attention over the whole sequence.

    ``inner_impl``: ``xla`` or ``flash`` (``flash_bwd`` picks the flash
    backward); the sequence-parallel impls cannot nest. Fallbacks, as the
    JAX function's: ``seq`` None or of size 1, blockwise attention on what
    this process holds; H not divisible by s, blockwise attention on the
    whole sequence (gathered over ``seq``, this process's block of the
    output kept: the computation GSPMD lays out for the JAX fallback).
    T not divisible by s cannot be split into blocks (see
    ``ring_attention``)."""
    if inner_impl not in ("xla", "flash"):
        raise ValueError(
            f"inner_impl must be 'xla' or 'flash', got {inner_impl!r} "
            "(sequence-parallel impls cannot nest inside ulysses)"
        )
    if seq is None or seq.size == 1:
        return blockwise_attention(q, k, v, causal=causal)
    if q.shape[2] % seq.size:
        from tpuflow_torch.ops.attention import gathered_attention

        return gathered_attention(q, k, v, causal=causal, impl="blockwise",
                                  seq=seq)
    from tpuflow_torch.ops.attention import attention

    def to_heads(x):  # (B, T/s, H, D) -> (B, T, H/s, D)
        return all_to_all(x, seq, split_dim=2, concat_dim=1)

    out = attention(to_heads(q), to_heads(k), to_heads(v), causal=causal,
                    impl=inner_impl, flash_bwd=flash_bwd)
    return all_to_all(out, seq, split_dim=1, concat_dim=2)
