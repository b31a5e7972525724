"""Ring attention: sequence parallelism over the ``seq`` mesh axis
(counterpart of ``tpuflow/parallel/ring_attention.py``).

Each process of the ``seq`` group holds its block of the sequence,
(B, T / s, H, D) of q, k and v (``dist.shard_batch`` hands process c the
columns [c T / s, (c + 1) T / s)). It keeps its q block and computes
online-softmax attention against the key and value block it holds, then
shifts that block to its right neighbour (``p2p.ppermute``): after s
steps every q block has seen every key block. At step i a process holds
the block of ``src = (c - i) % s``; causality comes from the global
positions ``c T_l + arange(T_l)`` of the queries and ``src T_l +
arange(T_l)`` of the keys, masked at -1e30. The update takes the JAX
body's steps (``_ring_shard_fn``, :29-77): q in f32, the scores scaled
by 1 / sqrt(D) in f32, the running max, sum and accumulator, the output
``acc / max(l, 1e-30)`` cast to q's dtype. The JAX scan shifts after its
last step too; that block is never read, so the port does not send it.

The JAX package computes this as einsums outside any Pallas kernel, so
the port's are plain PyTorch products: no kernel stands behind it.
Differentiable end to end: the shift's backward is the reverse shift.
"""

from __future__ import annotations

import torch

from tpuflow_torch.ops.flash_attention import blockwise_attention
from tpuflow_torch.parallel.p2p import AxisGroup, ppermute, ring_perm

_NEG_INF = -1e30


def _ring(q, k, v, causal: bool, seq: AxisGroup):
    B, Tl, H, D = q.shape
    s, me = seq.size, seq.rank
    scale = (1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))).to(
        q.device)
    q32 = q.float()
    q_pos = me * Tl + torch.arange(Tl, device=q.device)
    m = torch.full((B, H, Tl), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    perm = ring_perm(s)
    for step in range(s):
        src = (me - step) % s
        k_cur, v_cur = kv[0], kv[1]
        sc = torch.einsum("bqhd,bkhd->bhqk", q32, k_cur.float()) * scale
        if causal:
            k_pos = src * Tl + torch.arange(Tl, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            sc = torch.where(mask[None, None], sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   v_cur.float())
        m = m_new
        if step < s - 1:
            kv = ppermute(kv, seq, perm)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(q, k, v, *, causal: bool = True,
                   seq: AxisGroup | None = None):
    """Sequence-parallel attention. q, k, v: this process's block (B,
    T / s, H, D) of a sequence split over ``seq`` (an ``AxisGroup``) in
    group order; the output is the same block of the attention over the
    whole sequence.

    ``seq`` None or of size 1 (a trivial ring): blockwise attention on
    what this process holds, the JAX fallback. The JAX fallback for T not
    divisible by s has no block form: such a sequence cannot be split
    (``dist.shard_batch`` refuses it, as JAX's placement does), and a
    caller holding it whole passes ``seq=None``."""
    if seq is None or seq.size == 1:
        return blockwise_attention(q, k, v, causal=causal)
    return _ring(q, k, v, causal, seq)
