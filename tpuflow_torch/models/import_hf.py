"""HuggingFace GPT-2 checkpoints into the port's GPT-2 and back
(counterpart of ``tpuflow/models/import_hf.py``).

``hf_gpt2_to_params`` turns a ``transformers`` GPT-2 (the model or its
``state_dict``) into a ``state_dict`` that ``models.gpt2.GPT2`` loads;
``params_to_hf_state_dict`` is the inverse (a fine-tuned port model
published as an HF checkpoint); ``config_from_hf`` builds the matching
``GPT2Config`` and rejects the GPT-2 variants whose forward the port's
block does not compute. Nothing here imports ``transformers``.

Mapping notes (HF ``GPT2LMHeadModel`` → the port):

- HF's ``Conv1D`` stores a kernel as (in, out), the port's ``nn.Linear``
  as (out, in): the four Dense kernels of a block transpose, both ways.
- LayerNorms are ``weight``/``bias`` on both sides.
- The LM head is tied to ``wte`` on both sides; an untied HF head is
  refused.
- The port holds its blocks one module a layer whatever ``scan_layers``
  says, so the state_dict has one layout.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

# ONE table drives both directions: (HF module, port module, whether the
# kernel transposes). Each carries a ``weight`` and a ``bias``.
_BLOCK_MAP = (
    ("ln_1", "ln_1", False),
    ("attn.c_attn", "c_attn", True),
    ("attn.c_proj", "c_proj", True),
    ("ln_2", "ln_2", False),
    ("mlp.c_fc", "mlp_fc", True),
    ("mlp.c_proj", "mlp_proj", True),
)
_TOP = (("transformer.wte.weight", "wte"), ("transformer.wpe.weight", "wpe"),
        ("transformer.ln_f.weight", "ln_f.weight"),
        ("transformer.ln_f.bias", "ln_f.bias"))


def _f32(t) -> torch.Tensor:
    """A tensor (or array-like) as a detached float32 tensor."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    return t.detach().float()


def _state_dict(source) -> Mapping[str, Any]:
    return source.state_dict() if hasattr(source, "state_dict") \
        else dict(source)


def _block_pairs(i: int):
    """(HF name, port name, transpose) of every tensor of block ``i``."""
    for hf_mod, ours, transpose in _BLOCK_MAP:
        for leaf in ("weight", "bias"):
            yield (f"transformer.h.{i}.{hf_mod}.{leaf}",
                   f"h.{i}.{ours}.{leaf}", transpose and leaf == "weight")


def hf_gpt2_to_params(source, config) -> dict[str, torch.Tensor]:
    """HF GPT-2 (model instance or ``state_dict``) → the port's GPT-2
    ``state_dict`` (float32, contiguous, on the source's device).
    ``config`` is the matching ``GPT2Config`` (``config_from_hf`` derives
    it); an MoE config cannot be imported (HF GPT-2 has none)."""
    if config.n_experts:
        raise ValueError("HF GPT-2 has no MoE variant to import from")
    sd = _state_dict(source)
    wte = _f32(sd["transformer.wte.weight"])
    if "lm_head.weight" in sd and not torch.equal(
            _f32(sd["lm_head.weight"]), wte):
        # The port's LM head is tied to wte: an untied fine-tune would
        # import into silently wrong logits.
        raise ValueError(
            "checkpoint has an untied lm_head (lm_head.weight != "
            "wte.weight); the port's GPT-2 ties the LM head to the token "
            "embedding and cannot represent it"
        )
    params = {ours: _f32(sd[hf]).contiguous() for hf, ours in _TOP}
    for field, want, got in (
        ("vocab_size", config.vocab_size, params["wte"].shape[0]),
        ("n_ctx", config.n_ctx, params["wpe"].shape[0]),
        ("n_embd", config.n_embd, params["wte"].shape[1]),
    ):
        if want != got:
            raise ValueError(
                f"config.{field}={want} does not match the checkpoint ({got})"
            )
    n_ckpt_layers = 0
    while f"transformer.h.{n_ckpt_layers}.ln_1.weight" in sd:
        n_ckpt_layers += 1
    if config.n_layer != n_ckpt_layers:
        raise ValueError(
            f"config.n_layer={config.n_layer} does not match the checkpoint "
            f"({n_ckpt_layers} layers)"
        )
    for i in range(config.n_layer):
        for hf, ours, transpose in _block_pairs(i):
            t = _f32(sd[hf])
            params[ours] = (t.t() if transpose else t).contiguous()
    return params


def params_to_hf_state_dict(params, config) -> dict[str, torch.Tensor]:
    """The port's GPT-2 ``state_dict`` (or the model) → an HF GPT-2
    ``state_dict`` (float32, contiguous), the inverse of
    ``hf_gpt2_to_params``; the tied ``lm_head.weight`` is emitted
    explicitly (HF models accept and re-tie it)."""
    if config.n_experts:
        raise ValueError("HF GPT-2 has no MoE variant to export to")
    params = _state_dict(params)
    sd = {hf: _f32(params[ours]).contiguous() for hf, ours in _TOP}
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    for i in range(config.n_layer):
        for hf, ours, transpose in _block_pairs(i):
            t = _f32(params[ours])
            sd[hf] = (t.t() if transpose else t).contiguous()
    return sd


def config_from_hf(hf_config, **overrides):
    """``transformers.GPT2Config`` → the port's ``GPT2Config`` (dropout 0,
    for eval). Rejects GPT-2 variants whose forward the port's block does
    not reproduce (activations other than tanh GELU, per-layer attention
    scaling, unscaled attention, a non-standard MLP width)."""
    from tpuflow_torch.models.gpt2 import GPT2Config

    act = getattr(hf_config, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"unsupported activation_function={act!r}: the port's GPT-2 "
            "block uses tanh-approximate GELU (gelu_new)"
        )
    for flag in ("scale_attn_by_inverse_layer_idx", "reorder_and_upcast_attn"):
        if getattr(hf_config, flag, False):
            raise ValueError(
                f"unsupported GPT-2 variant: {flag}=True changes the "
                "attention math and cannot be imported"
            )
    if not getattr(hf_config, "scale_attn_weights", True):
        raise ValueError(
            "unsupported GPT-2 variant: scale_attn_weights=False"
        )
    n_inner = getattr(hf_config, "n_inner", None)
    if n_inner not in (None, 4 * hf_config.n_embd):
        raise ValueError(
            f"unsupported GPT-2 variant: n_inner={n_inner} (the port's "
            f"block uses the standard 4*n_embd={4 * hf_config.n_embd} MLP)"
        )
    kw = dict(
        vocab_size=hf_config.vocab_size,
        n_ctx=hf_config.n_positions,
        n_embd=hf_config.n_embd,
        n_layer=hf_config.n_layer,
        n_head=hf_config.n_head,
        dropout=0.0,
        ln_eps=float(hf_config.layer_norm_epsilon),
    )
    kw.update(overrides)
    return GPT2Config(**kw)
