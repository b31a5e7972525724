"""Weights between the JAX package's Flax param trees and the port's
modules: GPT-2 (``params_from_jax``), and every other model, whose module
tree carries the Flax names (``named_params_{to,from}_jax``; the MLP's and
ViT's names are aliases of these, ``resnet_params_{from,to}_jax`` adds
BatchNorm's ``batch_stats``).

``params_from_jax(tree)`` takes the Flax param tree as nested mappings of
numpy arrays (``jax.device_get(params)`` gives one) or of torch tensors (a
restored checkpoint) and returns a ``state_dict`` for
``tpuflow_torch.models.gpt2.GPT2``. It reads both JAX
layouts: unrolled blocks (``h0`` .. ``h{L-1}``) and ``scan_layers``
(``h/block/...`` with a leading layer axis). A Flax Dense kernel is
(in, out); an ``nn.Linear`` weight is (out, in), so kernels transpose.
The port's module names are the Flax ones, so within a block the
walker maps every leaf, the MoE block's included.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _t(x, device="cpu") -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _row(arr, i: int):
    return arr[i] if isinstance(arr, torch.Tensor) else np.asarray(arr)[i]


def params_from_jax(tree, *, device="cpu") -> dict[str, torch.Tensor]:
    """Flax GPT-2 param tree → port ``state_dict`` (float32, on
    ``device``). A block's subtree maps by the Flax names
    (``named_params_from_jax``): LayerNorms, Dense layers and, in an MoE
    block, ``moe/{gate/{kernel, bias}, w1, b1, w2, b2}`` (the expert
    weights as they are)."""
    sd = named_params_from_jax(
        {k: v for k, v in tree.items()
         if k in ("wte", "wpe", "ln_f")}, device=device)
    if "h" in tree:  # scan_layers: one stacked block, leading layer axis
        stacked = tree["h"]["block"]
        n_layer = len(stacked["ln_1"]["scale"])
        for i in range(n_layer):
            sd.update(named_params_from_jax(
                _map_leaves(stacked, lambda arr: _row(arr, i)), f"h.{i}.",
                device=device))
    else:
        i = 0
        while f"h{i}" in tree:
            sd.update(named_params_from_jax(tree[f"h{i}"], f"h.{i}.",
                                            device=device))
            i += 1
    return sd


def _map_leaves(tree, fn):
    return {k: _map_leaves(v, fn) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def named_params_to_jax(sd: dict) -> dict:
    """A name → tensor mapping of a module whose submodules carry the Flax
    names → the Flax tree: a 4-D ``weight`` (a convolution, OIHW) becomes
    ``kernel`` (HWIO), a 2-D one (``nn.Linear``, (out, in)) ``kernel``
    (in, out), a 1-D one (a norm) ``scale``; every other leaf (``bias``,
    ``cls``, ``pos_embed``, the norms' ``mean`` and ``var``) keeps its
    name. The leaves are views."""
    tree: dict = {}
    for key, t in sd.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        if leaf == "weight":
            leaf, t = (("kernel", t.permute(2, 3, 1, 0)) if t.ndim == 4
                       else ("kernel", t.t()) if t.ndim == 2
                       else ("scale", t))
        node[leaf] = t
    return tree


def named_params_from_jax(tree, prefix: str = "", *, device="cpu"
                          ) -> dict[str, torch.Tensor]:
    """The inverse of ``named_params_to_jax`` (numpy arrays or tensors in;
    contiguous float32 tensors on ``device`` out)."""
    sd = {}
    for key, v in tree.items():
        if isinstance(v, Mapping):
            sd.update(named_params_from_jax(v, f"{prefix}{key}.",
                                            device=device))
            continue
        t = _t(v, device)
        if key == "kernel":
            key, t = "weight", (t.permute(3, 2, 0, 1) if t.ndim == 4
                                else t.t())
        elif key == "scale":
            key = "weight"
        sd[f"{prefix}{key}"] = t.contiguous()
    return sd


def _is_stat(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in ("mean", "var")


def resnet_params_to_jax(sd: dict) -> tuple[dict, dict]:
    """The port ResNet's ``state_dict`` (or any name → tensor mapping of its
    parameters and BatchNorm buffers) → ``(params, batch_stats)``, the Flax
    trees (``Conv_0/kernel`` HWIO, ``BatchNorm_0/{scale, bias}``,
    ``BasicBlock_3/...``, ``Dense_0/{kernel, bias}``; ``batch_stats``:
    ``BatchNorm_i/{mean, var}``), as views. ``batch_stats`` is empty when
    ``sd`` holds no buffers."""
    return (named_params_to_jax({k: v for k, v in sd.items()
                                 if not _is_stat(k)}),
            named_params_to_jax({k: v for k, v in sd.items() if _is_stat(k)}))


def resnet_params_from_jax(params, batch_stats=None) -> dict[str, torch.Tensor]:
    """The Flax ResNet ``params`` (and ``batch_stats``) trees, numpy arrays
    or tensors → a ``state_dict`` for the port's ResNet (float32, CPU;
    without ``batch_stats`` only the parameters)."""
    sd = named_params_from_jax(params)
    if batch_stats:
        sd.update(named_params_from_jax(batch_stats))
    return sd


# The MLP's (``dense{1,2,3}/{kernel (in, out), bias}``) and ViT's
# (``patch_embed/kernel`` HWIO, ``cls``, ``pos_embed``, ``block{i}/...``,
# ``ln_f``, ``head``; no ``batch_stats``) Flax trees are the walker's.
mlp_params_to_jax = vit_params_to_jax = named_params_to_jax
mlp_params_from_jax = vit_params_from_jax = named_params_from_jax
