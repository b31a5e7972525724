"""Flash attention: CUDA kernels and their plain PyTorch versions.

Counterpart of ``tpuflow/ops/flash_attention.py``. Every tier keeps the
JAX numerics contract: scale 1/sqrt(D), causal mask -1e30, f32 online
softmax, output / max(l, 1e-30), lse = m + log(max(l, 1e-30)).

- ``flash_attention(q, k, v, *, causal)`` — the entry point. When a
  gradient is needed (grad mode on and an input requires grad) it runs
  ``_Flash``, a ``torch.autograd.Function``: the forward writes the output
  and a compact (B*H, Tq) f32 lse and saves ``(q, k, v, o, lse)`` (the
  residual of the JAX ``_flash_vjp_fwd``); the backward runs the fused pair
  (``flash_bwd``). Otherwise it takes the no-lse forward, as the JAX primal
  does, so serving never pays for the lse.
- Kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), each counted in
  its own module-level counter, launched for CUDA tensors (or the call
  raises): the forward without lse (``launches``), with lse
  (``launches_lse``), the dq kernel (``launches_bwd_dq``: dq and the row
  delta D = rowsum(dO o O)) and the dk/dv kernel (``launches_bwd_dkv``:
  reads q, dO, lse and D, never O).
- Plain versions, which CPU tensors take and the card holds the kernels
  against: ``blockwise_attention``, ``blockwise_attention_lse``,
  ``flash_bwd_dq_plain`` and ``flash_bwd_dkv_plain`` (``flash_bwd_plain``
  runs both). For bf16 they round P and dS to the input dtype before the
  products that take them, as the kernels do.

The forward with lse is registered as the custom op
``tpuflow_torch::flash_fwd_lse`` so that a selective-checkpoint policy sees
it as one op: the model's ``dots`` remat policy saves its outputs (the JAX
model's ``flash_out``) instead of re-running the kernel.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from tpuflow_torch.ops import _build
from tpuflow_torch.ops.attention import xla_attention

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

# Kernel launches since the last reset, one counter per kernel:
# chip_smoke.py zeroes them before a main path and reads them after, to
# show the path went through the kernels.
launches = 0           # forward, no lse
launches_lse = 0       # forward with lse
launches_bwd_dq = 0    # backward: dq and the row delta
launches_bwd_dkv = 0   # backward: dk and dv


def _scale(D: int, device) -> torch.Tensor:
    return (1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))).to(device)


def _online_softmax(q, k, v, causal: bool, block_k: int):
    """The f32 online-softmax state ``(acc, m, l)`` after scanning KV in
    chunks of ``block_k`` (the last chunk may be shorter);
    acc: (B, H, Tq, D), m and l: (B, H, Tq)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = _scale(D, q.device)
    q32 = q.float()
    q_pos = torch.arange(Tq, device=q.device)
    m = torch.full((B, H, Tq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Tk, block_k):
        k_blk = k[:, k0:k0 + block_k].float()
        v_blk = v[:, k0:k0 + block_k].float()
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk) * scale
        if causal:
            kp = torch.arange(k0, k0 + k_blk.shape[1], device=q.device)
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
    return acc, m, l


def blockwise_attention(q, k, v, *, causal: bool = True, block_k: int = 512):
    """Online-softmax attention, scanning KV in chunks. q,k,v: (B,T,H,D)."""
    Tk = k.shape[1]
    block_k = min(block_k, Tk)
    if Tk % block_k:
        return xla_attention(q, k, v, causal=causal)
    acc, _, l = _online_softmax(q, k, v, causal, block_k)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def blockwise_attention_lse(q, k, v, *, causal: bool = True,
                            block_k: int = 512):
    """``blockwise_attention`` plus the row logsumexp: ``(out, lse)`` with
    lse a compact (B*H, Tq) f32 array, row ``b*H + h``. Any Tk (a shorter
    last chunk). The plain version of the forward kernel with lse."""
    B, Tq, H, _ = q.shape
    acc, m, l = _online_softmax(q, k, v, causal, min(block_k, k.shape[1]))
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return out, (m + torch.log(l)).reshape(B * H, Tq)


def row_delta(o, do):
    """D = rowsum(dO o O) in f32, as a compact (B*H, Tq) array."""
    B, T, H, _ = o.shape
    d = (do.float() * o.float()).sum(dim=-1)  # (B, T, H)
    return d.transpose(1, 2).reshape(B * H, T)


def _heads(x):
    """(B, T, H, D) → (B, H, T, D) f32."""
    return x.float().transpose(1, 2)


def _probs(qh, kh, lse_h, scale, causal: bool, k0: int):
    """P = exp(S - lse) for all queries against one key chunk, S masked
    with -1e30 above the diagonal (B, H, Tq, chunk)."""
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if causal:
        q_pos = torch.arange(qh.shape[2], device=qh.device)
        k_pos = torch.arange(k0, k0 + kh.shape[2], device=qh.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, _NEG_INF)
    return torch.exp(s - lse_h[..., None])


def flash_bwd_dq_plain(q, k, v, o, lse, do, *, causal: bool,
                       block_k: int = 512):
    """The dq kernel's plain version: ``(dq, delta)``. D = rowsum(dO o O)
    once per row (``row_delta``), then dQ = sum over key chunks of
    dS K, dS = P o (dP - D) * scale, rounded to k's dtype before the
    product."""
    B, Tq, H, D = q.shape
    scale = _scale(D, q.device)
    delta = row_delta(o, do)
    qh, gh = _heads(q), _heads(do)
    lse_h = lse.view(B, H, Tq)
    delta_h = delta.view(B, H, Tq)
    dq = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[1], block_k):
        kh = _heads(k[:, k0:k0 + block_k])
        vh = _heads(v[:, k0:k0 + block_k])
        p = _probs(qh, kh, lse_h, scale, causal, k0)
        dp = torch.einsum("bhqd,bhkd->bhqk", gh, vh)
        ds = p * (dp - delta_h[..., None]) * scale
        dq += torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), kh)
    return dq.transpose(1, 2).to(q.dtype), delta


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                        block_k: int = 512):
    """The dk/dv kernel's plain version: ``(dk, dv)`` from q, k, v, dO, lse
    and D (never O). dV = P^T dO with P rounded to dO's dtype;
    dK = dS^T Q with dS rounded to q's dtype."""
    B, Tq, H, D = q.shape
    scale = _scale(D, q.device)
    qh, gh = _heads(q), _heads(do)
    lse_h = lse.view(B, H, Tq)
    delta_h = delta.view(B, H, Tq)
    dks, dvs = [], []
    for k0 in range(0, k.shape[1], block_k):
        kh = _heads(k[:, k0:k0 + block_k])
        vh = _heads(v[:, k0:k0 + block_k])
        p = _probs(qh, kh, lse_h, scale, causal, k0)
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(),
                                gh))
        dp = torch.einsum("bhqd,bhkd->bhqk", gh, vh)
        ds = p * (dp - delta_h[..., None]) * scale
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                                qh))
    dk = torch.cat(dks, dim=2).transpose(1, 2).to(k.dtype)
    dv = torch.cat(dvs, dim=2).transpose(1, 2).to(v.dtype)
    return dk, dv


def flash_bwd_plain(q, k, v, o, lse, do, *, causal: bool):
    """The fused pair's plain version: ``(dq, dk, dv)``."""
    dq, delta = flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


# ------------------------------------------------------------ dispatch
def flash_fwd_lse(q, k, v, *, causal: bool = True):
    """Forward with lse: ``(out, lse)``, lse (B*H, Tq) f32. CPU tensors take
    ``blockwise_attention_lse``; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return blockwise_attention_lse(q, k, v, causal=causal)
    return _flash_fwd_cuda(q, k, v, causal, with_lse=True)


@torch.library.custom_op("tpuflow_torch::flash_fwd_lse", mutates_args=())
def _flash_fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd_lse(q, k, v, causal=causal)


def flash_bwd_dq(q, k, v, o, lse, do, *, causal: bool):
    """``(dq, delta)``: the dq kernel on CUDA, its plain version on CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    return _flash_bwd_dq_cuda(q, k, v, o, lse, do, causal)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool):
    """``(dk, dv)``: the dk/dv kernel on CUDA, its plain version on CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    return _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)


def flash_bwd(q, k, v, o, lse, do, *, causal: bool):
    """The fused backward pair: ``(dq, dk, dv)``."""
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Flash attention with the fused backward; saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = torch.ops.tpuflow_torch.flash_fwd_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # The kernels need unit stride over D; a summed loss hands in an
        # expanded (stride 0) cotangent.
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """Flash attention. q,k,v: (B,T,H,D) → (B,T,H,D).

    Differentiable (``_Flash``) when a gradient is needed; else the no-lse
    forward. CPU tensors take the plain versions. CUDA tensors launch the
    kernels (f32 or bf16, D in {32, 64, 128}, any T; ragged tails are
    masked in the kernels) or raise.
    """
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _Flash.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return blockwise_attention(q, k, v, causal=causal)
    return _flash_fwd_cuda(q, k, v, causal, with_lse=False)


# --------------------------------------------------------- CUDA wrappers
def _check_qkv(q, k, v, what: str):
    """Device, dtype and shape checks shared by every kernel wrapper."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"{what} kernel takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    B, _, H, D = q.shape
    Bk, _, Hk, Dk = k.shape
    if (Bk, Hk, Dk) != (B, H, D) or v.shape != k.shape:
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not agree"
        )
    if D not in _HEAD_DIMS:
        raise ValueError(
            f"{what} kernel supports head_dim in {_HEAD_DIMS}, got {D}"
        )
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{what} kernel needs unit stride over D")


def _check_like(x, q, name: str, what: str):
    """``x`` has q's device, dtype and shape, with unit stride over D."""
    if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
        raise ValueError(
            f"{what}: {name} {tuple(x.shape)} {x.dtype} on {x.device} does "
            f"not match q {tuple(q.shape)} {q.dtype} on {q.device}"
        )
    if x.stride(3) != 1:
        raise ValueError(f"{what}: {name} needs unit stride over D")


def _check_rows(x, q, name: str, what: str):
    """``x`` is a contiguous (B*H, Tq) f32 array on q's device."""
    B, Tq, H, _ = q.shape
    if (x.device != q.device or x.dtype != torch.float32
            or x.shape != (B * H, Tq) or not x.is_contiguous()):
        raise ValueError(
            f"{what}: {name} must be a contiguous ({B * H}, {Tq}) float32 "
            f"array on {q.device}, got {tuple(x.shape)} {x.dtype} on "
            f"{x.device}"
        )


def _strides(*xs):
    return _build.int64_array(
        [s for x in xs for s in (x.stride(0), x.stride(1), x.stride(2))]
    )


def _flash_fwd_cuda(q, k, v, causal: bool, *, with_lse: bool):
    global launches, launches_lse
    _check_qkv(q, k, v, "flash_attention")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.load("flash_fwd")
    rc = lib.tpuflow_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, H, Tq, Tk, D, _DTYPES[q.dtype], int(causal),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_fwd launch")
    if with_lse:
        launches_lse += 1
        return out, lse
    launches += 1
    return out


def _flash_bwd_dq_cuda(q, k, v, o, lse, do, causal: bool):
    global launches_bwd_dq
    what = "flash_bwd_dq"
    _check_qkv(q, k, v, what)
    _check_like(o, q, "o", what)
    _check_like(do, q, "do", what)
    _check_rows(lse, q, "lse", what)
    B, Tq, H, D = q.shape
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, o, do)
    lib = _build.load("flash_bwd")
    rc = lib.tpuflow_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
        B, H, Tq, k.shape[1], D, _DTYPES[q.dtype], int(causal), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_bwd_dq launch")
    launches_bwd_dq += 1
    return dq, delta


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool):
    global launches_bwd_dkv
    what = "flash_bwd_dkv"
    _check_qkv(q, k, v, what)
    _check_like(do, q, "do", what)
    _check_rows(lse, q, "lse", what)
    _check_rows(delta, q, "delta", what)
    B, Tk, H, D = k.shape
    dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=v.device)
    strides = _strides(q, k, v, do)
    lib = _build.load("flash_bwd")
    rc = lib.tpuflow_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, q.shape[1], Tk, D, _DTYPES[q.dtype], int(causal), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_bwd_dkv launch")
    launches_bwd_dkv += 1
    return dk, dv
