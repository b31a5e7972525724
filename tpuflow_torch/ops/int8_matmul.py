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
  contract, so this changes no token). The int8 tensor-core product's
  tile and split of K are ``_int8_plan``'s; a decode call (M <= 16) is
  one launch, a prefill call two (the row scale pass first).
"""

from __future__ import annotations

import functools
import math

import torch

from tpuflow_torch.ops import _build

# Kernel launches since the last reset (see ops/flash_attention.py), and
# the same launches by the plan's tile.
launches = 0
tile_launches = {"decode": 0, "prefill": 0}


def row_scales(x):
    """Per-row symmetric quantization scale over the LAST axis: max-abs/127,
    all-zero rows pinned to 1/127. The plain path's formula; the kernel's
    scale pass computes the same bits on the card (a max is exact in any
    order, then one IEEE division)."""
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    amax = torch.where(amax > 0.0, amax, torch.ones_like(amax))
    # A tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one rounding away from the IEEE
    # division that JAX, the CPU and the kernel compute.
    return amax / torch.full_like(amax, 127.0)


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


# The kernel's tile, as csrc/int8_matmul.cu fixes it.
CHUNK_K = 64         # k per pipeline stage (two m16n8k32 steps)
TILE_N = 128         # output channels per block
DECODE_MAX_M = 16    # rows the decode tile takes (two n8 tiles)
DECODE_WARPS = 4
DECODE_MAX_STAGES = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once: the
    decode path asks for it on every call."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _int8_plan(M: int, K: int, N: int, sms: int) -> dict:
    """The decisions the kernel is launched with, for an (M, K) x (K, N)
    product on a card of ``sms`` streaming multiprocessors.

    ``tile``: ``"decode"`` for M <= 16 (one block per 128 channels and
    split of K, 4 warps taking its 64-wide k chunks in turn), ``"prefill"``
    otherwise (64 rows x 128 channels a block, walking all of K: on the
    H100 a split ran slower there). ``splits``: pieces of K, each ``cps``
    chunks, summed across blocks by atomics into an int32 scratch when
    above 1 — taken by the decode tile where its output tiles alone would
    leave the SMs short of two blocks each. ``stages``: the decode ring's
    depth per warp (every chunk of a warp in flight at once, up to 4). The
    C entry derives the grid and shared memory from these and refuses a
    plan that leaves a piece of K empty or uncovered. Cached: the engine
    calls it at a few shapes, 49 times a decode step; treat the returned
    dict as read-only."""
    n_chunks = _cdiv(K, CHUNK_K)
    if M > DECODE_MAX_M:
        return dict(tile="prefill", splits=1, cps=n_chunks, stages=2)
    splits = min(_cdiv(n_chunks, DECODE_WARPS),
                 max(1, _cdiv(2 * sms, _cdiv(N, TILE_N))))
    cps = _cdiv(n_chunks, splits)
    return dict(tile="decode", splits=_cdiv(n_chunks, cps), cps=cps,
                stages=min(DECODE_MAX_STAGES, _cdiv(cps, DECODE_WARPS)))


# The split-K scratch (M x N int32) and per-tile counters, per device:
# zeroed once when (re)allocated, left zero by every launch. Calls on one
# stream are ordered; the port launches on the current stream only.
_SCRATCH: dict = {}


def _split_scratch(device, n_sums: int, n_tiles: int):
    sc, cn = _SCRATCH.get(device, (None, None))
    if sc is None or sc.numel() < n_sums or cn.numel() < n_tiles:
        sc = torch.zeros(max(n_sums, 0 if sc is None else sc.numel()),
                         dtype=torch.int32, device=device)
        cn = torch.zeros(max(n_tiles, 0 if cn is None else cn.numel()),
                         dtype=torch.int32, device=device)
        _SCRATCH[device] = (sc, cn)
    return sc, cn


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
    w8 = wq.contiguous()
    ws = w_scale_row.float()
    if ws.stride(0) not in (0, 1):
        ws = ws.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x2d.device)
    if m == 0 or n == 0:
        return out.to(out_dtype)
    if k == 0:
        return out.zero_().to(out_dtype)
    plan = _int8_plan(m, k, n, _sm_count(x2d.device.index))
    # The prefill tile's scale pass writes the row scales here; the
    # decode tile keeps them in shared memory.
    s = (torch.empty(m, dtype=torch.float32, device=x2d.device)
         if plan["tile"] == "prefill" else None)
    scratch = counters = None
    if plan["splits"] > 1:
        scratch, counters = _split_scratch(x2d.device, m * n,
                                           _cdiv(n, TILE_N))
    lib = _build.load("int8_matmul")
    rc = lib.tpuflow_int8_matmul(
        x32.data_ptr(), w8.data_ptr(), ws.data_ptr(),
        None if s is None else s.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if counters is None else counters.data_ptr(),
        m, k, n, int(w_contract_last), ws.stride(0),
        0 if plan["tile"] == "decode" else 1, plan["splits"], plan["cps"],
        plan["stages"], torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    _build.check(lib, rc, "int8_matmul launch")
    launches += 1
    tile_launches[plan["tile"]] += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


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
