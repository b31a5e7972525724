"""Fused-native (W8A8) int8 quantization for the decode path.

Counterpart of ``tpuflow/infer/quant.py``, mode ``mxu`` (alias
``fused_native``): every Dense kernel and the tied LM head stay int8
through the matmul. Activations are quantized per row at the matmul
boundary, the contraction runs int8 x int8 -> int32, and the combined
``act_scale (x) weight_scale`` dequant folds into the epilogue — one call of
``tpuflow_torch.ops.int8_matmul`` (the hand-written kernel on the card).
No dequantized weight copy ever exists.

``quantize_model(model)`` returns a ``QuantizedModel``: a view over the
same fp module (its embeddings and norms stay exact float) plus the int8
leaves, keyed by Dense name (``h.<i>.c_attn``, ...) and ``wte_q`` for the
head. It is called like the model, so ``generate`` and ``ServeEngine``
take either. Weight-only mode (``weight`` / ``weight_only``) is not ported
yet.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, NamedTuple

import torch
import torch.nn as nn

from tpuflow_torch.ops.int8_matmul import quantize_rows


class QuantLeaf(NamedTuple):
    """int8 values + broadcastable per-channel scale."""

    q: Any      # int8, original shape
    scale: Any  # float32, broadcastable to q (reduced axes kept as size 1)


def _quantize_leaf(x: torch.Tensor, min_size: int):
    if x.ndim < 2 or x.numel() < min_size or not x.is_floating_point():
        return x
    # 2-D (in, out): reduce the in axis — per-output-channel scales. 3-D+
    # (a scan-stacked kernel): reduce only the middle axes.
    axes = (
        tuple(range(x.ndim - 1)) if x.ndim == 2
        else tuple(range(1, x.ndim - 1))
    )
    n_scales = x.numel() // math.prod(x.shape[a] for a in axes)
    if n_scales * 4 > x.numel() // 16:
        # The scales would eat the compression: 2-D collapses to one
        # per-tensor scale, 3-D+ to one scale per leading slice.
        axes = (
            tuple(range(x.ndim)) if x.ndim == 2
            else tuple(range(1, x.ndim))
        )
    amax = x.float().abs().amax(dim=axes, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return QuantLeaf(q.to(torch.int8).contiguous(), scale)


def quantize_params(params, *, min_size: int = 4096):
    """Replace large floating tensors (ndim >= 2, numel >= ``min_size``) with
    ``QuantLeaf``s, symmetric max-abs/127 per channel. Tensors are in the
    JAX layout (a Dense kernel is (in, out)). Takes one tensor or a mapping
    of them (nested mappings recurse); small leaves pass through exact."""
    if isinstance(params, Mapping):
        return {
            k: quantize_params(v, min_size=min_size)
            for k, v in params.items()
        }
    return _quantize_leaf(params, min_size)


_MODE_ALIASES = {
    "weight": "weight",
    "weight_only": "weight",
    "mxu": "mxu",
    "native": "mxu",
    "fused_native": "mxu",
}


def canonical_mode(mode: str) -> str:
    """'mxu' from any accepted spelling. Weight-only spellings raise
    NotImplementedError (not ported yet); unknown ones raise ValueError."""
    try:
        canon = _MODE_ALIASES[mode]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown quantization mode {mode!r}; supported: "
            f"{sorted(_MODE_ALIASES)}"
        ) from None
    if canon == "weight":
        raise NotImplementedError(
            f"quantization mode {mode!r} (weight-only int8) is not ported "
            "yet; use 'fused_native'"
        )
    return canon


def _quantize_dense_kernels(model, *, min_size: int, head: bool = True):
    """int8 leaves for every ``nn.Linear`` of ``model`` whose (in, out)
    kernel passes ``min_size``, plus — when ``head`` and ``wte`` is big
    enough — the LM head ``wte_q`` with PER-VOCAB-ROW scales (the head
    contracts wte's last axis). ``wte`` itself stays exact float for the
    embedding gather."""
    leaves: dict[str, QuantLeaf] = {}
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, nn.Linear):
                continue
            got = _quantize_leaf(mod.weight.detach().t(), min_size)
            if isinstance(got, QuantLeaf):
                leaves[name] = got
        wte = model.wte.detach()
        if head and wte.ndim == 2 and wte.numel() >= min_size:
            q, scale = quantize_rows(wte)
            leaves["wte_q"] = QuantLeaf(q.contiguous(), scale)
    return leaves


class QuantizedModel:
    """The fp model plus its int8 leaves, callable like the model: every
    quantized Dense and the LM head run ``int8_matmul``. ``int8_impl`` pins
    the op's implementation for every call (None = by device)."""

    def __init__(self, model, leaves: dict[str, QuantLeaf], *,
                 mode: str = "mxu", int8_impl: str | None = None):
        self.model = model
        self.leaves = leaves
        self.mode = mode
        self.int8_impl = int8_impl

    def __call__(self, tokens, **kw):
        return self.model(
            tokens, quant=self.leaves, int8_impl=self.int8_impl, **kw
        )

    @property
    def config(self):
        return self.model.config

    @property
    def device(self) -> torch.device:
        return self.model.device

    def init_cache(self, batch: int):
        return self.model.init_cache(batch)


def quantize_model(model, *, min_size: int = 4096, mode: str = "fused_native",
                   head: bool = True, int8_impl: str | None = None):
    """One call: the ``QuantizedModel`` for ``model`` (fused-native W8A8:
    Dense kernels + the LM head; ``head=False`` keeps the head fp)."""
    mode = canonical_mode(mode)
    leaves = _quantize_dense_kernels(model, min_size=min_size, head=head)
    return QuantizedModel(model, leaves, mode=mode, int8_impl=int8_impl)
