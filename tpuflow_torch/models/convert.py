"""Weights from the JAX package's GPT-2 params into the port's modules.

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
