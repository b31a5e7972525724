"""Flash attention: CUDA kernels and their plain PyTorch versions.

Counterpart of ``tpuflow/ops/flash_attention.py``. Every tier keeps the
JAX numerics contract: scale 1/sqrt(D), causal mask -1e30, f32 online
softmax, output / max(l, 1e-30), lse = m + log(max(l, 1e-30)).

- ``flash_attention(q, k, v, *, causal, bwd)`` — the entry point. When a
  gradient is needed (grad mode on and an input requires grad) it runs
  ``_Flash``, a ``torch.autograd.Function``: the forward writes the output
  and a compact (B*H, Tq) f32 lse and saves ``(q, k, v, o, lse)`` (the
  residual of the JAX ``_flash_vjp_fwd``); the backward runs the pair that
  ``bwd`` names — ``"fused"`` (``flash_bwd``, the default), ``"split"``
  (``flash_bwd_split``) or ``"blockwise"`` (autograd through the plain
  ``blockwise_attention``, no backward kernel; a CPU reference only, CUDA
  tensors raise) — the choice the JAX package takes from
  ``TPUFLOW_FLASH_BWD``. Otherwise it takes the no-lse forward,
  as the JAX primal does, so serving never pays for the lse.
- Kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), each counted in
  its own module-level counter, launched for CUDA tensors (or the call
  raises): the forward without lse (``launches``), with lse
  (``launches_lse``), the fused dq kernel (``launches_bwd_dq``: dq and the
  row delta D = rowsum(dO o O)), the fused dk/dv kernel
  (``launches_bwd_dkv``: reads q, dO, lse and D, never O), and the split
  pair (``launches_bwd_dq_split``, ``launches_bwd_dkv_split``: both read O
  and recompute D on every block visit; the same bits as the fused pair).
  ``launches_bwd_dq_bf16`` and ``launches_bwd_dkv_bf16`` count the bf16
  launches of either pair (the tensor-core variants). ``wide_launches``
  counts, by wrapper and dtype, the launches of the wide-head kernels
  (D > 256) among them. Each backward launch takes its tile heights from
  ``_flash_bwd_plan``.
- Plain versions, which CPU tensors take and the card holds the kernels
  against: ``blockwise_attention``, ``blockwise_attention_lse``,
  ``flash_bwd_dq_plain`` and ``flash_bwd_dkv_plain`` (``flash_bwd_plain``
  runs both), ``flash_bwd_dq_split_plain`` and
  ``flash_bwd_dkv_split_plain``. For bf16 they round P and dS to the input
  dtype before the products that take them, as the kernels do.

Head dims: the kernels are instantiated at D = 32, 64, 128 and 256, and
above 256 the wide-head kernels take any multiple of 128 (they contract
the scores over D in chunks, so no full-width tile has to fit shared
memory). Any other D is zero-padded up to the next width (q, k, v, and in
the backward O and dO; ``_padded``), run with the scale of the true D and
cut back: zero columns add exact zeros to every score, product and row
delta, so only the scale needs the true D. ``flash_attention`` routes a
D that is not a multiple of 8 to ``blockwise_attention``, as the
reference does. The one limit left is the wide kernels' grid: at most
65535 blocks of 128 output columns (``MAX_HEAD_DIM``); above it the
wrappers raise.

The forward with lse is registered as the custom op
``tpuflow_torch::flash_fwd_lse`` so that a selective-checkpoint policy sees
it as one op: the model's ``dots`` remat policy saves its outputs (the JAX
model's ``flash_out``) instead of re-running the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tpuflow_torch.ops import _build
from tpuflow_torch.ops.attention import xla_attention

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The head dims the kernels are instantiated at; others are padded up.
_HEAD_DIMS = (32, 64, 128, 256)
# Above 256 the wide-head kernels take multiples of this (a block's output
# columns), up to the 65535 column blocks grid.z holds.
_WIDE = 128
MAX_HEAD_DIM = 65535 * _WIDE

# Kernel launches since the last reset, one counter per kernel:
# chip_smoke.py zeroes them before a main path and reads them after, to
# show the path went through the kernels.
launches = 0           # forward, no lse
launches_lse = 0       # forward with lse
launches_lse_bf16 = 0  # of those, on bf16 inputs (the tensor-core variant)
launches_bwd_dq = 0    # backward: dq and the row delta
launches_bwd_dkv = 0   # backward: dk and dv
launches_bwd_dq_split = 0   # split backward: dq, D recomputed from O
launches_bwd_dkv_split = 0  # split backward: dk and dv, D per q-block visit
launches_bwd_dq_bf16 = 0    # dq launches of either pair on bf16 inputs
launches_bwd_dkv_bf16 = 0   # dk/dv launches of either pair on bf16 inputs
# Of those, the launches that ran a wide-head kernel (D > 256), by wrapper
# and dtype ("flash_bwd_dq", "flash_bwd_dq_bf16", ...).
wide_launches = {
    kernel + dtype: 0
    for kernel in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                   "flash_bwd_dkv", "flash_bwd_dq_split",
                   "flash_bwd_dkv_split")
    for dtype in ("", "_bf16")
}
BWD_MODES = ("fused", "split", "blockwise")


def _scale(D: int, device) -> torch.Tensor:
    return (1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))).to(device)


def _kernel_dim(D: int) -> int:
    """The kernel head dim ``D`` runs at: the narrowest of ``_HEAD_DIMS``
    that holds it, else (the wide-head kernels) D rounded up to a multiple
    of 128, up to ``MAX_HEAD_DIM``."""
    for width in _HEAD_DIMS:
        if D <= width:
            return width
    if D <= MAX_HEAD_DIM:
        return -(-D // _WIDE) * _WIDE
    raise ValueError(
        f"flash_attention kernels take head_dim up to {MAX_HEAD_DIM}, got "
        f"{D}: the wide-head kernels' grid holds at most 65535 blocks of "
        f"{_WIDE} output columns"
    )


def _padded(fn, *args, **kwargs):
    """``fn(*args, scale_dim=D, **kwargs)`` at the kernel width of the
    head dim D of ``args[0]``: every (B, T, H, D) tensor argument
    zero-padded over D, and every (B, T, H, width) output cut back to D.
    The zero columns add exact zeros; ``scale_dim`` keeps the scale at
    1/sqrt(D)."""
    D = args[0].shape[-1]
    width = _kernel_dim(D)
    if width == D:
        return fn(*args, scale_dim=D, **kwargs)

    def heads(x):
        return isinstance(x, torch.Tensor) and x.dim() == 4

    out = fn(*(F.pad(x, (0, width - D)) if heads(x) else x for x in args),
             scale_dim=D, **kwargs)
    if isinstance(out, tuple):
        return tuple(x[..., :D].contiguous() if heads(x) else x
                     for x in out)
    return out[..., :D].contiguous()


def _online_softmax(q, k, v, causal: bool, block_k: int, scale_dim=None):
    """The f32 online-softmax state ``(acc, m, l)`` after scanning KV in
    chunks of ``block_k`` (the last chunk may be shorter);
    acc: (B, H, Tq, D), m and l: (B, H, Tq). The scores are scaled by
    1/sqrt(``scale_dim``), by default the head dim."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = _scale(scale_dim or D, q.device)
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
                            block_k: int = 512, scale_dim=None):
    """``blockwise_attention`` plus the row logsumexp: ``(out, lse)`` with
    lse a compact (B*H, Tq) f32 array, row ``b*H + h``. Any Tk (a shorter
    last chunk). The plain version of the forward kernel with lse."""
    B, Tq, H, _ = q.shape
    acc, m, l = _online_softmax(q, k, v, causal, min(block_k, k.shape[1]),
                                scale_dim)
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


def _dq_chunks(q, k, v, lse, do, delta_of, causal: bool, block_k: int,
               scale_dim=None):
    """dQ = sum over key chunks of dS K, dS = P o (dP - D) * scale rounded
    to k's dtype before the product; ``delta_of()`` gives D, (B*H, Tq)
    f32, for each chunk."""
    B, Tq, H, D = q.shape
    scale = _scale(scale_dim or D, q.device)
    qh, gh = _heads(q), _heads(do)
    lse_h = lse.view(B, H, Tq)
    dq = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[1], block_k):
        delta_h = delta_of().view(B, H, Tq)
        kh = _heads(k[:, k0:k0 + block_k])
        vh = _heads(v[:, k0:k0 + block_k])
        p = _probs(qh, kh, lse_h, scale, causal, k0)
        dp = torch.einsum("bhqd,bhkd->bhqk", gh, vh)
        ds = p * (dp - delta_h[..., None]) * scale
        dq += torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), kh)
    return dq.transpose(1, 2).to(q.dtype)


def _dkv_chunks(q, k, v, lse, do, delta_of, causal: bool, block_k: int,
                scale_dim=None):
    """(dK, dV) chunk by chunk of keys: dV = P^T dO with P rounded to dO's
    dtype, dK = dS^T Q with dS rounded to q's dtype; ``delta_of()`` gives
    D for each chunk."""
    B, Tq, H, D = q.shape
    scale = _scale(scale_dim or D, q.device)
    qh, gh = _heads(q), _heads(do)
    lse_h = lse.view(B, H, Tq)
    dks, dvs = [], []
    for k0 in range(0, k.shape[1], block_k):
        delta_h = delta_of().view(B, H, Tq)
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


def flash_bwd_dq_plain(q, k, v, o, lse, do, *, causal: bool,
                       block_k: int = 512, scale_dim=None):
    """The fused dq kernel's plain version: ``(dq, delta)``, with
    D = rowsum(dO o O) computed once per row (``row_delta``)."""
    delta = row_delta(o, do)
    return _dq_chunks(q, k, v, lse, do, lambda: delta, causal, block_k,
                      scale_dim), delta


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                        block_k: int = 512, scale_dim=None):
    """The fused dk/dv kernel's plain version: ``(dk, dv)`` from q, k, v,
    dO, lse and D (never O)."""
    return _dkv_chunks(q, k, v, lse, do, lambda: delta, causal, block_k,
                       scale_dim)


def flash_bwd_plain(q, k, v, o, lse, do, *, causal: bool):
    """The fused pair's plain version: ``(dq, dk, dv)``."""
    dq, delta = flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


def flash_bwd_dq_split_plain(q, k, v, o, lse, do, *, causal: bool,
                             block_k: int = 512, scale_dim=None):
    """The split dq kernel's plain version: ``dq``, with D recomputed from
    O and dO for every key chunk (the same value each time, so the fused
    version's dq bit for bit)."""
    return _dq_chunks(q, k, v, lse, do, lambda: row_delta(o, do), causal,
                      block_k, scale_dim)


def flash_bwd_dkv_split_plain(q, k, v, o, lse, do, *, causal: bool,
                              block_k: int = 512, scale_dim=None):
    """The split dk/dv kernel's plain version: ``(dk, dv)`` from q, k, v,
    O, dO and lse, D recomputed for every key chunk."""
    return _dkv_chunks(q, k, v, lse, do, lambda: row_delta(o, do), causal,
                       block_k, scale_dim)


# ------------------------------------------------------------ dispatch
def flash_fwd_lse(q, k, v, *, causal: bool = True):
    """Forward with lse: ``(out, lse)``, lse (B*H, Tq) f32. CPU tensors take
    ``blockwise_attention_lse``; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return blockwise_attention_lse(q, k, v, causal=causal)
    return _padded(_flash_fwd_cuda, q, k, v, causal, with_lse=True)


@torch.library.custom_op("tpuflow_torch::flash_fwd_lse", mutates_args=())
def _flash_fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd_lse(q, k, v, causal=causal)


def flash_bwd_dq(q, k, v, o, lse, do, *, causal: bool):
    """``(dq, delta)``: the dq kernel on CUDA, its plain version on CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    return _padded(_flash_bwd_dq_cuda, q, k, v, o, lse, do, causal)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool):
    """``(dk, dv)``: the dk/dv kernel on CUDA, its plain version on CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    return _padded(_flash_bwd_dkv_cuda, q, k, v, do, lse, delta, causal)


def flash_bwd(q, k, v, o, lse, do, *, causal: bool):
    """The fused backward pair: ``(dq, dk, dv)``."""
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


def flash_bwd_dq_split(q, k, v, o, lse, do, *, causal: bool):
    """``dq``: the split dq kernel on CUDA, its plain version on CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dq_split_plain(q, k, v, o, lse, do, causal=causal)
    return _padded(_flash_bwd_dq_split_cuda, q, k, v, o, lse, do, causal)


def flash_bwd_dkv_split(q, k, v, o, lse, do, *, causal: bool):
    """``(dk, dv)``: the split dk/dv kernel on CUDA, its plain version on
    CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_split_plain(q, k, v, o, lse, do, causal=causal)
    return _padded(_flash_bwd_dkv_split_cuda, q, k, v, o, lse, do, causal)


def flash_bwd_split(q, k, v, o, lse, do, *, causal: bool):
    """The split backward pair: ``(dq, dk, dv)``, the fused pair's bits."""
    dq = flash_bwd_dq_split(q, k, v, o, lse, do, causal=causal)
    dk, dv = flash_bwd_dkv_split(q, k, v, o, lse, do, causal=causal)
    return dq, dk, dv


def _blockwise_bwd(q, k, v, do, causal: bool):
    """Gradients by autograd through the plain ``blockwise_attention``
    (the JAX ``blockwise`` backward): no backward kernel runs."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = blockwise_attention(*xs, causal=causal)
        return torch.autograd.grad(out, xs, do)


class _Flash(torch.autograd.Function):
    """Flash attention; saves (q, k, v, o, lse) and runs the backward that
    ``bwd`` names."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bwd):
        o, lse = torch.ops.tpuflow_torch.flash_fwd_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.bwd = bwd
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # The kernels need unit stride over D; a summed loss hands in an
        # expanded (stride 0) cotangent.
        do = do.contiguous()
        if ctx.bwd == "blockwise":
            dq, dk, dv = _blockwise_bwd(q, k, v, do, ctx.causal)
        else:
            pair = flash_bwd_split if ctx.bwd == "split" else flash_bwd
            dq, dk, dv = pair(q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, bwd: str = "fused"):
    """Flash attention. q,k,v: (B,T,H,D) → (B,T,H,D).

    Differentiable (``_Flash``) when a gradient is needed, with the
    backward ``bwd`` names (``fused``, ``split`` or ``blockwise``); else
    the no-lse forward. CPU tensors take the plain versions. CUDA tensors
    launch the kernels (f32 or bf16, any D % 8 == 0 up to
    ``MAX_HEAD_DIM``, padded to the kernel's width; any T, ragged tails
    masked in the kernels) or
    raise; ``blockwise``, which runs no backward kernel, takes CPU tensors
    only. A head dim that is not a multiple of 8 takes
    ``blockwise_attention`` on any device, as in the reference.
    """
    if bwd not in BWD_MODES:
        raise ValueError(f"unknown flash backward {bwd!r}; use "
                         f"{'|'.join(BWD_MODES)}")
    if bwd == "blockwise" and q.device.type != "cpu":
        raise ValueError(
            "flash backward 'blockwise' is the plain version, a CPU "
            f"reference; on {q.device} use 'fused' or 'split'")
    # The reference's own dispatch (tpuflow/ops/flash_attention.py:724):
    # a head dim that is not a multiple of 8 takes blockwise attention.
    if q.shape[-1] % 8:
        return blockwise_attention(q, k, v, causal=causal)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _Flash.apply(q, k, v, causal, bwd)
    if q.device.type == "cpu":
        return blockwise_attention(q, k, v, causal=causal)
    return _padded(_flash_fwd_cuda, q, k, v, causal, with_lse=False)


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
    if not (D <= MAX_HEAD_DIM and _kernel_dim(D) == D):
        raise ValueError(
            f"{what} kernel supports head_dim in {_HEAD_DIMS} or a multiple "
            f"of {_WIDE} above 256 up to {MAX_HEAD_DIM} (the wrappers pad "
            f"other head dims), got {D}"
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


def _kernel_scale(scale_dim: int) -> float:
    """1/sqrt(scale_dim) as the f32 value the plain versions use (IEEE
    sqrt and division in f32), for the kernels' float argument."""
    return float(_scale(scale_dim, "cpu"))


def _strides(*xs):
    return _build.int64_array(
        [s for x in xs for s in (x.stride(0), x.stride(1), x.stride(2))]
    )


def _flash_bq(B: int, H: int, Tq: int, sms: int, D: int = 64) -> int:
    """The forward kernel's q tile height on a card of ``sms`` streaming
    multiprocessors: 64 where the grid of B*H x ceil(Tq/64) blocks gives
    every SM one, else 32; always 32 at the kernel head dim ``D`` = 256,
    whose 64-row block would overrun shared memory. It changes no output
    bit: the key tiles are anchored at key 0 and each row's arithmetic
    does not depend on it. The kernel derives the grid and shared memory
    from it, and runs the causal q tiles longest first. The wide-head
    kernel (D > 256) takes 32 rows only."""
    if D > 128:
        return 32
    return 64 if B * H * -(-Tq // 64) >= sms else 32


def _flash_bwd_plan(B: int, H: int, Tq: int, Tk: int, D: int, dtype,
                    sms: int) -> dict:
    """The backward kernels' launch plan on a card of ``sms`` streaming
    multiprocessors: ``dq_rows``, the q rows a dq block owns, and
    ``dkv_rows``, the key rows a dk/dv block owns. bf16 blocks hold 16
    rows a warp (32 or 64 rows); f32 blocks 8 rows a lane pair (32, 64, or
    128 at D <= 64: 8 warps, where the f32 kernels' shared memory allows
    one block an SM; 32 only at D = 256, whose full-width tiles leave no
    room for more). Each takes the tallest tile whose grid of B*H x
    ceil(T/rows) blocks still gives every SM one, else 32 (1 x 512 x 12
    heads: 96 blocks of 64 would leave SMs idle). No output bit depends on
    it: the streamed tiles' height is fixed by ``dtype`` and ``D``, and
    every element sums its products in the same order. The C entries
    derive grid and shared memory from it, and run the causal tiles
    longest first (dq tiles in reverse, dk/dv ascending). The wide-head
    kernels (D > 256) take 32 rows only."""
    if D > 256:
        return {"dq_rows": 32, "dkv_rows": 32}
    if dtype != torch.float32:
        tall = (64,)
    else:
        tall = (128, 64) if D <= 64 else (64,) if D <= 128 else ()

    def rows(T: int) -> int:
        return next((r for r in tall if B * H * -(-T // r) >= sms), 32)

    return {"dq_rows": rows(Tq), "dkv_rows": rows(Tk)}


def _bwd_rows(q, Tk: int, key: str) -> int:
    B, Tq, H, D = q.shape
    return _flash_bwd_plan(B, H, Tq, Tk, D, q.dtype, torch.cuda.
                           get_device_properties(q.device)
                           .multi_processor_count)[key]


def _count_wide(kernel: str, q) -> None:
    """One more launch in ``wide_launches`` when ``q``'s head dim runs the
    wide-head variant of ``kernel``."""
    if q.shape[-1] > 256:
        wide_launches[kernel + ("_bf16" if q.dtype == torch.bfloat16
                                else "")] += 1


def _flash_fwd_cuda(q, k, v, causal: bool, *, with_lse: bool,
                    scale_dim: int):
    global launches, launches_lse, launches_lse_bf16
    _check_qkv(q, k, v, "flash_attention")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * H * Tq == 0:
        return (out, lse) if with_lse else out
    bq = _flash_bq(B, H, Tq, torch.cuda.get_device_properties(
        q.device).multi_processor_count, D)
    lib = _build.load("flash_fwd")
    rc = lib.tpuflow_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, H, Tq, Tk, D, _DTYPES[q.dtype], int(causal), bq,
        _kernel_scale(scale_dim), q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_fwd launch")
    _count_wide("flash_fwd_lse" if with_lse else "flash_fwd", q)
    if with_lse:
        launches_lse += 1
        if q.dtype == torch.bfloat16:
            launches_lse_bf16 += 1
        return out, lse
    launches += 1
    return out


def _flash_bwd_dq_cuda(q, k, v, o, lse, do, causal: bool, *,
                       scale_dim: int):
    global launches_bwd_dq, launches_bwd_dq_bf16
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
        B, H, Tq, k.shape[1], D, _DTYPES[q.dtype], int(causal),
        _bwd_rows(q, k.shape[1], "dq_rows"), _kernel_scale(scale_dim),
        strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_bwd_dq launch")
    launches_bwd_dq += 1
    _count_wide("flash_bwd_dq", q)
    launches_bwd_dq_bf16 += q.dtype == torch.bfloat16
    return dq, delta


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, *,
                        scale_dim: int):
    global launches_bwd_dkv, launches_bwd_dkv_bf16
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
        B, H, q.shape[1], Tk, D, _DTYPES[q.dtype], int(causal),
        _bwd_rows(q, Tk, "dkv_rows"), _kernel_scale(scale_dim), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_bwd_dkv launch")
    launches_bwd_dkv += 1
    _count_wide("flash_bwd_dkv", q)
    launches_bwd_dkv_bf16 += q.dtype == torch.bfloat16
    return dk, dv


def _flash_bwd_dq_split_cuda(q, k, v, o, lse, do, causal: bool, *,
                             scale_dim: int):
    global launches_bwd_dq_split, launches_bwd_dq_bf16
    what = "flash_bwd_dq_split"
    _check_qkv(q, k, v, what)
    _check_like(o, q, "o", what)
    _check_like(do, q, "do", what)
    _check_rows(lse, q, "lse", what)
    B, Tq, H, D = q.shape
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, o, do)
    lib = _build.load("flash_bwd")
    rc = lib.tpuflow_flash_bwd_dq_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        B, H, Tq, k.shape[1], D, _DTYPES[q.dtype], int(causal),
        _bwd_rows(q, k.shape[1], "dq_rows"), _kernel_scale(scale_dim),
        strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_bwd_dq_split launch")
    launches_bwd_dq_split += 1
    _count_wide("flash_bwd_dq_split", q)
    launches_bwd_dq_bf16 += q.dtype == torch.bfloat16
    return dq


def _flash_bwd_dkv_split_cuda(q, k, v, o, lse, do, causal: bool, *,
                              scale_dim: int):
    global launches_bwd_dkv_split, launches_bwd_dkv_bf16
    what = "flash_bwd_dkv_split"
    _check_qkv(q, k, v, what)
    _check_like(o, q, "o", what)
    _check_like(do, q, "do", what)
    _check_rows(lse, q, "lse", what)
    B, Tk, H, D = k.shape
    dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=v.device)
    strides = _strides(q, k, v, o, do)
    lib = _build.load("flash_bwd")
    rc = lib.tpuflow_flash_bwd_dkv_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, q.shape[1], Tk, D, _DTYPES[q.dtype], int(causal),
        _bwd_rows(q, Tk, "dkv_rows"), _kernel_scale(scale_dim), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_bwd_dkv_split launch")
    launches_bwd_dkv_split += 1
    _count_wide("flash_bwd_dkv_split", q)
    launches_bwd_dkv_bf16 += q.dtype == torch.bfloat16
    return dk, dv
