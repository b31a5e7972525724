"""int8 quantization for the decode path: weight-only and fused native.

Counterpart of ``tpuflow/infer/quant.py``. Two modes, one wrapper:

- ``mode='weight'`` (alias ``weight_only``): every large floating leaf of
  the JAX-layout param tree (Dense kernels (in, out), ``wte`` (V, C),
  ``wpe``; under ``scan_layers`` the stacked kernels, and the stacked
  biases and norm scales that reach ``min_size``) becomes a ``QuantLeaf``
  once (``quantize_params``). At rest
  only the int8 values, their scales and the small leaves exist: the
  wrapper holds a weightless (``meta``) copy of the module, and each call
  rebuilds the floats (``dequantize_params``: ``q.float() * scale``, one
  multiply) and runs the module on them through
  ``torch.func.functional_call``. A memory-capacity feature: the rebuild
  writes every weight in f32 at every call.
- ``mode='mxu'`` (alias ``fused_native``): every Dense kernel and the tied
  LM head stay int8 through the matmul. Activations are quantized per row
  at the matmul boundary, the contraction runs int8 x int8 -> int32, and
  the combined ``act_scale (x) weight_scale`` dequant folds into the
  epilogue — one call of ``tpuflow_torch.ops.int8_matmul`` (the
  hand-written kernel on the card). No dequantized weight copy ever
  exists; the wrapper is a view over the same fp module plus the int8
  leaves, keyed by Dense name (``h.<i>.c_attn``, ...) and ``wte_q``. On
  an MoE model the router (``h.<i>.moe.gate``) is such a Dense layer and
  its leaf feeds ``MoEMLP``'s routing; the expert weights stay float, as
  in the JAX package (its leaf set is the Dense ``kernel`` leaves).

``quantize_model(model, mode=...)`` returns a ``QuantizedModel``, called
like the model, so ``generate``, ``beam_search``, ``speculative_generate``,
``sequence_logprob`` and ``ServeEngine`` take either. ``quant_decision`` /
``maybe_quantize`` are the size gate for weight-only mode, with the JAX
package's rule and threshold, and ``teacher_forced_agreement`` scores a
quantized model's top-1 predictions against the fp model's.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn as nn

from tpuflow_torch.ckpt.tree import params_to_jax
from tpuflow_torch.models.convert import params_from_jax
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
    amax = torch.where(amax > 0, amax, torch.ones_like(amax))
    # A tensor divisor, as in ops/int8_matmul.py::row_scales: PyTorch's
    # CUDA division by a Python scalar multiplies by its reciprocal, one
    # rounding away from the IEEE division of JAX and the CPU.
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return QuantLeaf(q.to(torch.int8).contiguous(), scale)


def quantize_params(params, *, min_size: int = 4096):
    """Replace large floating tensors (ndim >= 2, numel >= ``min_size``) with
    ``QuantLeaf``s, symmetric max-abs/127 per channel. Tensors are in the
    JAX layout (a Dense kernel is (in, out); ``jax_layout_params`` gives a
    GPT-2's tree). Takes one tensor or a mapping of them (nested mappings
    recurse); small leaves pass through exact."""
    if isinstance(params, Mapping):
        return {
            k: quantize_params(v, min_size=min_size)
            for k, v in params.items()
        }
    return _quantize_leaf(params, min_size)


def dequantize_params(qparams, dtype=None):
    """Rebuild float leaves from ``QuantLeaf``s: ``q * scale`` in ``dtype``
    (None: the scale's), the JAX op order. Other leaves pass through."""
    if isinstance(qparams, Mapping):
        return {k: dequantize_params(v, dtype) for k, v in qparams.items()}
    if isinstance(qparams, QuantLeaf):
        dt = dtype or qparams.scale.dtype
        return qparams.q.to(dt) * qparams.scale.to(dt)
    return qparams


def _tensors(tree):
    """Every tensor (or array) of a nested mapping, ``QuantLeaf`` parts
    included."""
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, QuantLeaf):
        yield from tree
    else:
        yield tree


def quantized_nbytes(qparams) -> int:
    """Bytes of a (possibly partially) quantized tree."""
    return sum(int(t.nbytes) for t in _tensors(qparams))


def jax_layout_params(model) -> dict:
    """A GPT-2's parameters as the JAX package's param tree (views): Dense
    kernels (in, out), blocks stacked under ``h/block`` when the config
    sets ``scan_layers``, as ``quantize_params`` expects them."""
    sd = {k: v.detach() for k, v in model.named_parameters()}
    return params_to_jax(sd, scan_layers=model.config.scan_layers)


_MODE_ALIASES = {
    "weight": "weight",
    "weight_only": "weight",
    "mxu": "mxu",
    "native": "mxu",
    "fused_native": "mxu",
}


def canonical_mode(mode: str) -> str:
    """'weight' | 'mxu' from any accepted spelling; unknown ones raise
    ValueError."""
    try:
        return _MODE_ALIASES[mode]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown quantization mode {mode!r}; supported: "
            f"{sorted(_MODE_ALIASES)}"
        ) from None


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
    """A GPT-2 with int8 weights, callable like the model.

    ``mode='mxu'``: ``model`` is the fp module and ``leaves`` its int8
    Dense kernels and head; every quantized Dense and the LM head run
    ``int8_matmul`` (``int8_impl`` pins the op's implementation, None = by
    device). ``mode='weight'``: ``model`` is a weightless (``meta``) copy
    of the module and ``leaves`` the quantized JAX-layout tree; each call
    rebuilds the f32 weights on ``device`` and runs the module on them."""

    def __init__(self, model, leaves, *, mode: str = "mxu",
                 int8_impl: str | None = None, device=None):
        self.model = model
        self.leaves = leaves
        self.mode = mode
        self.int8_impl = int8_impl
        self._device = model.device if device is None else device

    def _float_params(self) -> dict[str, torch.Tensor]:
        """Weight-only mode: the module's float parameters rebuilt from the
        int8 leaves, by name (the layout ``load_state_dict`` takes)."""
        return params_from_jax(dequantize_params(self.leaves),
                               device=self._device)

    def __call__(self, tokens, **kw):
        if self.mode == "weight":
            return torch.func.functional_call(
                self.model, self._float_params(), (tokens,), kw
            )
        return self.model(
            tokens, quant=self.leaves, int8_impl=self.int8_impl, **kw
        )

    @property
    def config(self):
        return self.model.config

    @property
    def device(self) -> torch.device:
        return self._device

    def init_cache(self, batch: int):
        return self.model.init_cache(batch, device=self._device)

    def init_paged_cache(self, n_pages: int, page_size: int):
        return self.model.init_paged_cache(n_pages, page_size,
                                           device=self._device)


def quantize_model(model, *, min_size: int = 4096, mode: str = "fused_native",
                   head: bool = True, int8_impl: str | None = None):
    """One call: the ``QuantizedModel`` for ``model``. ``mode='weight'``
    quantizes every large leaf of the JAX-layout tree (``head`` and
    ``int8_impl`` do not apply); fused-native quantizes the Dense kernels
    and the LM head (``head=False`` keeps the head fp)."""
    mode = canonical_mode(mode)
    if mode == "weight":
        with torch.no_grad():
            qparams = quantize_params(jax_layout_params(model),
                                      min_size=min_size)
        skeleton = type(model)(model.config, seed=None, device="meta")
        return QuantizedModel(skeleton, qparams, mode=mode,
                              device=model.device)
    leaves = _quantize_dense_kernels(model, min_size=min_size, head=head)
    return QuantizedModel(model, leaves, mode=mode, int8_impl=int8_impl)


# Weight-only int8 rebuilds every quantized weight in f32 at each call, so
# below some resident size the smaller weight stream cannot pay for the
# rebuild's writes and reads; above it the capacity argument (fit a model
# that otherwise would not) wins. The threshold is the JAX package's, kept
# so that both packages decide alike; chip_smoke.py measures the decode ms
# per token of fp, weight-only and fused-native on the card (PERF.md).
WEIGHT_QUANT_MIN_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class QuantDecision:
    """Gate verdict: whether quantization should be applied, and why."""

    apply: bool
    mode: str
    reason: str
    weight_bytes: int


def _float_nbytes(params) -> int:
    if isinstance(params, nn.Module):
        leaves = params.parameters()
    else:
        leaves = _tensors(params)
    total = 0
    for t in leaves:
        floating = (t.is_floating_point() if isinstance(t, torch.Tensor)
                    else np.issubdtype(np.asarray(t).dtype, np.floating))
        if floating:
            total += int(t.nbytes)
    return total


def quant_decision(params, *, mode: str = "weight") -> QuantDecision:
    """The gate for ``quantize_model`` over a module or a tree of tensors:
    weight-only quantization is OFF below ``WEIGHT_QUANT_MIN_BYTES`` of
    float weights; fused-native (mxu) mode is ungated, its int8 operands
    never becoming floats."""
    mode = canonical_mode(mode)
    nbytes = _float_nbytes(params)
    if mode == "mxu":
        return QuantDecision(
            True, mode,
            "fused-native (mxu, W8A8) mode: int8 operands go through the "
            "fused quantize-matmul-dequant kernel, no dequantized weight "
            "copy — ungated at any size",
            nbytes,
        )
    if nbytes < WEIGHT_QUANT_MIN_BYTES:
        return QuantDecision(
            False, mode,
            f"weight-only int8 gated OFF: float weights {nbytes / 2**20:.0f}"
            f" MiB < {WEIGHT_QUANT_MIN_BYTES / 2**20:.0f} MiB threshold — "
            "rebuilding every weight in f32 at each call costs more than "
            "the smaller resident weights save below this size",
            nbytes,
        )
    return QuantDecision(
        True, mode,
        f"weight-only int8 ON: float weights {nbytes / 2**20:.0f} MiB >= "
        "threshold — the smaller resident set outweighs the rebuild",
        nbytes,
    )


def maybe_quantize(model, *, mode: str = "weight"):
    """Gated form of ``quantize_model``: returns ``(model, decision)``,
    the model unchanged when ``quant_decision`` says quantization loses at
    this size."""
    decision = quant_decision(model, mode=mode)
    if not decision.apply:
        return model, decision
    return quantize_model(model, mode=mode), decision


@torch.no_grad()
def teacher_forced_predictions(model, tokens, prompt_len: int):
    """Argmax next-token predictions under teacher forcing: one forward
    over ``tokens`` (B, T), the predictions at positions ``prompt_len - 1
    .. T - 2`` (those that predict continuation tokens)."""
    tokens = torch.as_tensor(np.asarray(tokens), device=model.device).long()
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    if tokens.shape[1] <= prompt_len:
        raise ValueError("tokens must extend past prompt_len")
    logits = model(tokens)
    return torch.argmax(logits[:, prompt_len - 1:-1], dim=-1)


def teacher_forced_agreement(model_ref, model_test, tokens,
                             prompt_len: int) -> float:
    """Per-step top-1 agreement under teacher forcing: one full forward of
    each model over the same ``tokens`` (prompt + reference continuation),
    the fraction of continuation positions whose argmax agrees. Unlike
    free-running greedy agreement, one early near-tie flip does not
    cascade."""
    pa = teacher_forced_predictions(model_ref, tokens, prompt_len)
    pb = teacher_forced_predictions(model_test, tokens, prompt_len)
    return float((pa == pb.to(pa.device)).float().mean())
