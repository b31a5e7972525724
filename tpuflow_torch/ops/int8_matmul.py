"""Fused native int8 matmul (W8A8): a CUDA kernel and its plain version.

Counterpart of ``tpuflow/ops/int8_matmul.py``. ``int8_matmul(x, wq,
w_scale)`` computes ``x (..., K) float @ wq int8 -> (..., N)`` with dynamic
per-row activation quantization (symmetric max-abs/127, round half to even,
clip to [-127, 127]), exact int32 accumulation, and the dequant epilogue
``acc.f32 * s * w_scale`` in that order.

Two implementations, bit-identical by contract (integer sums are exact and
every float op is elementwise, IEEE-rounded, in the same order):

- ``_plain_int8_matmul`` — plain PyTorch, any device. Its product runs in
  float64, which holds every int8 x int8 sum over K < 2^17 exactly.
- ``csrc/int8_matmul.cu`` — the hand-written kernel, for every shape on a
  CUDA tensor (including M < 8 and the untileable 50257-column LM head,
  which the TPU dispatch sent to XLA; the numerics are identical by
  contract, so this changes no token).
"""

from __future__ import annotations

import math

import torch

from tpuflow_torch.ops import _build

# Kernel launches since the last reset (see ops/flash_attention.py).
launches = 0


def row_scales(x):
    """Per-row symmetric quantization scale over the LAST axis: max-abs/127,
    all-zero rows pinned to 1/127. The one scale formula shared by the plain
    path and the kernel's wrapper."""
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    return torch.where(amax > 0.0, amax, torch.ones_like(amax)) / 127.0


def quantize_rows(x):
    """Dynamic per-row symmetric int8 quantization over the last axis.
    Returns ``(q int8, scale)`` with ``x ~= q * scale``."""
    scale = row_scales(x)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _plain_int8_matmul(x2d, wq, w_scale_row, *, w_contract_last: bool,
                       out_dtype):
    """The plain version: same quantization, exact integer accumulation
    (float64 products of int8 values, exact below 2^53), same epilogue op
    order as the kernel."""
    xq, s = quantize_rows(x2d)
    w = wq.double()
    acc = xq.double() @ (w.t() if w_contract_last else w)
    out = acc.float() * s * w_scale_row.reshape(1, -1).float()
    return out.to(out_dtype)


def _cuda_int8_matmul(x2d, wq, w_scale_row, *, w_contract_last: bool,
                      out_dtype):
    global launches
    if x2d.device.type != "cuda" or wq.device != x2d.device:
        raise ValueError(
            f"int8_matmul kernel needs x and wq on one CUDA device, got "
            f"{x2d.device} and {wq.device}"
        )
    m, k = x2d.shape
    n = wq.shape[0] if w_contract_last else wq.shape[1]
    x32 = x2d.float().contiguous()
    s = row_scales(x32).reshape(m).contiguous()
    w8 = wq.contiguous()
    ws = w_scale_row.float().reshape(n).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x2d.device)
    if m == 0 or n == 0:
        return out.to(out_dtype)
    lib = _build.load("int8_matmul")
    rc = lib.tpuflow_int8_matmul(
        x32.data_ptr(), s.data_ptr(), w8.data_ptr(), ws.data_ptr(),
        out.data_ptr(), m, k, n, int(w_contract_last),
        torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    _build.check(lib, rc, "int8_matmul launch")
    launches += 1
    return out.to(out_dtype)


def int8_matmul(
    x,
    wq,
    w_scale,
    *,
    w_contract_last: bool = False,
    out_dtype=torch.float32,
    impl: str | None = None,
):
    """``x (..., K) float @ wq int8 -> (..., N) out_dtype`` with dynamic
    per-row activation quantization and the dequant epilogue fused in.

    ``wq`` is ``(K, N)`` — a Dense kernel — or ``(N, K)`` with
    ``w_contract_last=True`` (the LM-head layout: the tied ``wte`` is
    ``(vocab, n_embd)``). ``w_scale`` holds the per-out-channel scales, any
    shape of size N, or one per-tensor scale. ``impl``: None / ``"auto"``
    picks by device (the plain version for CPU tensors, the kernel for CUDA
    tensors); ``"cuda"`` demands the kernel.
    """
    if wq.dtype != torch.int8:
        raise TypeError(f"wq must be int8, got {wq.dtype}")
    if wq.ndim != 2:
        raise ValueError(f"wq must be 2-D, got shape {tuple(wq.shape)}")
    k = x.shape[-1]
    n, kw = wq.shape if w_contract_last else tuple(wq.shape)[::-1]
    if kw != k:
        raise ValueError(
            f"contraction mismatch: x (..., {k}) vs wq {tuple(wq.shape)} "
            f"(w_contract_last={w_contract_last})"
        )
    w_scale = torch.as_tensor(w_scale, device=wq.device)
    if w_scale.numel() == 1:
        w_scale_row = w_scale.reshape(()).expand(n)
    elif w_scale.numel() == n:
        w_scale_row = w_scale.reshape(n)
    else:
        raise ValueError(
            f"w_scale has {w_scale.numel()} elements; want {n} "
            "(per-out-channel) or 1 (per-tensor)"
        )
    if impl not in (None, "auto", "cuda"):
        raise ValueError(f"unknown int8 impl {impl!r}; use auto|cuda")
    lead = tuple(x.shape[:-1])
    m = math.prod(lead) if lead else 1
    x2d = x.reshape(m, k)
    if x2d.device.type == "cpu" and impl != "cuda":
        out = _plain_int8_matmul(
            x2d, wq, w_scale_row,
            w_contract_last=w_contract_last, out_dtype=out_dtype,
        )
    else:
        out = _cuda_int8_matmul(
            x2d, wq, w_scale_row,
            w_contract_last=w_contract_last, out_dtype=out_dtype,
        )
    return out.reshape(*lead, n)
