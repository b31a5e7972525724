"""Weights between the JAX package's Flax param trees and the port's
modules: GPT-2 (``params_from_jax``) and the MLP (``mlp_params_from_jax``,
``mlp_params_to_jax``).

``params_from_jax(tree)`` takes the Flax param tree as nested mappings of
numpy arrays (``jax.device_get(params)`` gives one) or of torch tensors (a
restored checkpoint) and returns a ``state_dict`` for
``tpuflow_torch.models.gpt2.GPT2``. It reads both JAX
layouts: unrolled blocks (``h0`` .. ``h{L-1}``) and ``scan_layers``
(``h/block/...`` with a leading layer axis). A Flax Dense kernel is
(in, out); an ``nn.Linear`` weight is (out, in), so kernels transpose.
"""

from __future__ import annotations

import numpy as np
import torch

_DENSE = ("c_attn", "c_proj", "mlp_fc", "mlp_proj")
_NORMS = ("ln_1", "ln_2")


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _row(arr, i: int):
    return arr[i] if isinstance(arr, torch.Tensor) else np.asarray(arr)[i]


def _block(prefix: str, blk) -> dict[str, torch.Tensor]:
    out = {}
    for name in _NORMS:
        out[f"{prefix}{name}.weight"] = _t(blk[name]["scale"])
        out[f"{prefix}{name}.bias"] = _t(blk[name]["bias"])
    for name in _DENSE:
        out[f"{prefix}{name}.weight"] = _t(blk[name]["kernel"]).t().contiguous()
        out[f"{prefix}{name}.bias"] = _t(blk[name]["bias"])
    return out


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Flax GPT-2 param tree → port ``state_dict`` (float32, CPU)."""
    sd = {
        "wte": _t(tree["wte"]),
        "wpe": _t(tree["wpe"]),
        "ln_f.weight": _t(tree["ln_f"]["scale"]),
        "ln_f.bias": _t(tree["ln_f"]["bias"]),
    }
    if "h" in tree:  # scan_layers: one stacked block, leading layer axis
        stacked = tree["h"]["block"]
        n_layer = len(stacked["ln_1"]["scale"])
        for i in range(n_layer):
            layer = {
                name: {leaf: _row(arr, i) for leaf, arr in sub.items()}
                for name, sub in stacked.items()
            }
            sd.update(_block(f"h.{i}.", layer))
    else:
        i = 0
        while f"h{i}" in tree:
            sd.update(_block(f"h.{i}.", tree[f"h{i}"]))
            i += 1
    return sd


_MLP_DENSE = ("dense1", "dense2", "dense3")


def mlp_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Flax ``NeuralNetwork`` params (``dense{1,2,3}/{kernel (in, out),
    bias}``, numpy arrays or tensors) → the port MLP's ``state_dict``
    (float32, CPU)."""
    sd = {}
    for name in _MLP_DENSE:
        sd[f"{name}.weight"] = _t(tree[name]["kernel"]).t().contiguous()
        sd[f"{name}.bias"] = _t(tree[name]["bias"])
    return sd


def mlp_params_to_jax(sd: dict) -> dict:
    """The inverse: the port MLP's ``state_dict`` (or any name → tensor
    mapping of its parameters) → the Flax param tree, kernels as (in, out)
    views."""
    return {name: {"kernel": sd[f"{name}.weight"].t(),
                   "bias": sd[f"{name}.bias"]} for name in _MLP_DENSE}
