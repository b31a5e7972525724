"""Flash attention forward: a CUDA kernel and its plain PyTorch version.

Counterpart of ``tpuflow/ops/flash_attention.py``. Two tiers with the same
numerics contract (scale 1/sqrt(D), causal mask -1e30, f32 online softmax,
output / max(l, 1e-30)):

- ``blockwise_attention`` — plain PyTorch online softmax over KV chunks,
  any device; for bf16 inputs it rounds P to bf16 before P.V as the TPU
  kernel does. It is the kernel's plain version: the CPU path of
  ``flash_attention`` and the reference it is held against on the card.
- ``flash_attention`` — on a CUDA tensor, the hand-written kernel
  ``csrc/flash_fwd.cu`` (forward only, no lse). The backward kernels of
  the JAX package are not ported yet (ROADMAP Queue 2 items 1b-3), so a
  CUDA call that would need a gradient raises.
"""

from __future__ import annotations

import torch

from tpuflow_torch.ops import _build
from tpuflow_torch.ops.attention import xla_attention

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

# Kernel launches since the last reset: chip_smoke.py zeroes it before the
# main path and reads it after, to show the path went through the kernel.
launches = 0


def blockwise_attention(q, k, v, *, causal: bool = True, block_k: int = 512):
    """Online-softmax attention, scanning KV in chunks. q,k,v: (B,T,H,D)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    block_k = min(block_k, Tk)
    if Tk % block_k:
        return xla_attention(q, k, v, causal=causal)
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    q32 = q.float()
    q_pos = torch.arange(Tq, device=q.device)
    m = torch.full((B, H, Tq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Tk, block_k):
        k_blk = k[:, k0:k0 + block_k].float()
        v_blk = v[:, k0:k0 + block_k].float()
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk) * scale.to(q.device)
        if causal:
            kp = torch.arange(k0, k0 + block_k, device=q.device)
            s = torch.where(q_pos[:, None] >= kp[None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        # P is rounded to v's dtype before P.V, as the kernels cast it
        # (identity for f32); the product still sums in f32.
        pv = p.to(v.dtype).float()
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", pv,
                                                   v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True):
    """Flash attention forward. q,k,v: (B,T,H,D) → (B,T,H,D).

    CPU tensors take ``blockwise_attention``. CUDA tensors launch the
    kernel (f32 or bf16, D in {32, 64, 128}, any T; ragged tails are masked
    in the kernel) or raise.
    """
    if q.device.type == "cpu":
        return blockwise_attention(q, k, v, causal=causal)
    return _flash_fwd_cuda(q, k, v, causal)


def _flash_fwd_cuda(q, k, v, causal: bool):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise NotImplementedError(
            "flash_attention on CUDA is forward only: the backward kernels "
            "are ROADMAP Queue 2 items 2-3"
        )
    B, Tq, H, D = q.shape
    Bk, Tk, Hk, Dk = k.shape
    if (Bk, Hk, Dk) != (B, H, D) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not agree"
        )
    if D not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel supports head_dim in {_HEAD_DIMS}, got {D}"
        )
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel needs unit stride over D")
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_fwd")
    rc = lib.tpuflow_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Tq, Tk, D, _DTYPES[q.dtype], int(causal),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_fwd launch")
    launches += 1
    return out
