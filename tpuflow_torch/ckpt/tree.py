"""The port's training state as the JAX package's checkpoint tree.

``tpuflow/train/gpt.py`` and ``flows/my_tpu_module.py::_state_tree`` save
``{"step", "params", "opt_state", ["batch_stats"], ["ema_params"]}`` with
Flax params and optax state. This module lays a ``train.step.TrainState`` out the same
way, so a checkpoint written by either package restores into the other:

- ``params``: for GPT-2, ``params_to_jax``, the inverse of
  ``models/convert.py::params_from_jax``. Dense kernels transpose back to
  (in, out); with ``scan_layers`` (the ``gpt2`` and ``medium`` presets)
  the blocks stack into ``h/block/...`` with a leading layer axis, else
  they are ``h0`` .. ``h{L-1}``. For every other model (the MLP, ResNet,
  ViT), the Flax module tree its names carry
  (``convert.named_params_to_jax``).
- ``batch_stats`` (ResNet): the running ``mean``/``var`` of each
  ``models.resnet.BatchNorm``, present only when the model has one.
- ``opt_state``: optax's tuple layout, tuple indices as keys. ``adamw`` is
  ``chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate)``:
  ``0/{count, mu, nu}``, plus ``2/count`` when the learning rate is
  scheduled. ``sgd`` is ``chain(trace, scale_by_learning_rate)``:
  ``0/trace``, plus ``1/count`` when scheduled. With ``grad_clip`` the
  whole chain sits under ``1`` (``clip_by_global_norm`` keeps no state).
  Every count is the int32 number of updates.
- ``step``: int32; ``ema_params`` like ``params``.
"""

from __future__ import annotations

import torch

from tpuflow_torch.models.convert import (
    named_params_from_jax,
    named_params_to_jax,
    params_from_jax,
)
from tpuflow_torch.models.gpt2 import GPT2
from tpuflow_torch.models.resnet import BatchNorm

_DENSE = ("c_attn", "c_proj", "mlp_fc", "mlp_proj")
_NORMS = ("ln_1", "ln_2")


def _block(sd: dict, i: int) -> dict:
    pre = f"h.{i}."
    out = {n: {"scale": sd[f"{pre}{n}.weight"], "bias": sd[f"{pre}{n}.bias"]}
           for n in _NORMS}
    for n in _DENSE:
        out[n] = {"kernel": sd[f"{pre}{n}.weight"].t(),
                  "bias": sd[f"{pre}{n}.bias"]}
    return out


def params_to_jax(sd: dict, *, scan_layers: bool) -> dict:
    """Port ``state_dict`` (name → tensor) → the Flax GPT-2 param tree."""
    tree = {"wte": sd["wte"], "wpe": sd["wpe"],
            "ln_f": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]}}
    n_layer = 0
    while f"h.{n_layer}.ln_1.weight" in sd:
        n_layer += 1
    blocks = [_block(sd, i) for i in range(n_layer)]
    if scan_layers:
        tree["h"] = {"block": {
            name: {leaf: torch.stack([b[name][leaf] for b in blocks])
                   for leaf in sub}
            for name, sub in blocks[0].items()
        }}
    else:
        for i, b in enumerate(blocks):
            tree[f"h{i}"] = b
    return tree


def _count(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


def _to_jax(model, sd: dict, scan_layers: bool) -> dict:
    if isinstance(model, GPT2):
        return params_to_jax(sd, scan_layers=scan_layers)
    return named_params_to_jax(sd)


def _from_jax(model, tree: dict, device) -> dict:
    if isinstance(model, GPT2):
        return params_from_jax(tree, device=device)
    return named_params_from_jax(tree, device=device)


def running_stats(model) -> dict:
    """The running statistics of the model's ``BatchNorm`` modules, name →
    buffer (empty without BatchNorm)."""
    return {f"{m}.{n}" if m else n: b
            for m, mod in model.named_modules() if isinstance(mod, BatchNorm)
            for n, b in mod.named_buffers(recurse=False)}


def checkpoint_tree(state, *, scan_layers: bool = False,
                    abstract: bool = False) -> dict:
    """``state`` as the JAX checkpoint tree: views of the live tensors, or
    with ``abstract`` shape-and-dtype stand-ins on the ``meta`` device (a
    restore template that allocates nothing). ``scan_layers`` picks
    GPT-2's stacked block layout; every other model has one layout."""
    names = [n for n, _ in state.model.named_parameters()]

    def layout(tensors) -> dict:
        if len(tensors) != len(names):
            raise ValueError(f"{len(tensors)} tensors for {len(names)} "
                             "parameters")
        if abstract:
            tensors = [torch.empty_like(t, device="meta") for t in tensors]
        return _to_jax(state.model, dict(zip(names, tensors)), scan_layers)

    tx = state.tx
    inner = {"0": {name: layout(ts) for name, ts in tx.slots().items()}}
    if tx.kind == "adamw":
        inner["0"]["count"] = _count(tx.count)
    if tx.scheduled:
        inner["2" if tx.kind == "adamw" else "1"] = {"count": _count(tx.count)}
    tree = {
        "step": _count(state.step),
        "params": layout(state.params),
        "opt_state": {"1": inner} if tx.grad_clip_norm is not None
        else inner,
    }
    stats = running_stats(state.model)
    if stats:
        if abstract:
            stats = {n: torch.empty_like(t, device="meta")
                     for n, t in stats.items()}
        tree["batch_stats"] = named_params_to_jax(stats)
    if state.ema_params is not None:
        tree["ema_params"] = layout(state.ema_params)
    return tree


def _ordered(model, tree: dict) -> list[torch.Tensor]:
    """A param-layout tree → its tensors in ``model``'s parameter order, on
    its device: each leaf is copied there first (a DMA from page-locked
    restore buffers), so the layout work (the Dense kernels' transposes,
    the stacked blocks' rows) runs there and not on one host core."""
    sd = _from_jax(model, tree, next(model.parameters()).device)
    return [sd[n] for n, _ in model.named_parameters()]


@torch.no_grad()
def load_params(model, params: dict) -> None:
    """Copy a restored ``params`` subtree (the JAX layout) into ``model``'s
    parameters in place: a weights-only warm start (an optimizer over them
    keeps its state)."""
    for p, src in zip(model.parameters(), _ordered(model, params)):
        p.copy_(src)


@torch.no_grad()
def load_batch_stats(model, batch_stats: dict) -> None:
    """Copy a restored ``batch_stats`` subtree (the JAX layout) into
    ``model``'s BatchNorm running statistics in place."""
    stats = running_stats(model)
    src = named_params_from_jax(batch_stats,
                                device=next(iter(stats.values())).device)
    for name, buf in stats.items():
        buf.copy_(src[name])


@torch.no_grad()
def load_checkpoint_tree(state, tree: dict) -> None:
    """Copy a restored checkpoint tree (either layout) into ``state`` in
    place: params, BatchNorm statistics, optimizer slots and count, EMA
    weights and step."""
    load_params(state.model, tree["params"])
    if running_stats(state.model):
        load_batch_stats(state.model, tree["batch_stats"])
    opt = tree["opt_state"]
    inner = opt["1"] if state.tx.grad_clip_norm is not None else opt
    slots = {name: _ordered(state.model, sub)
             for name, sub in inner["0"].items() if name != "count"}
    counts = [int(c["count"]) for c in (inner["0"], inner.get("1"),
                                        inner.get("2"))
              if isinstance(c, dict) and "count" in c]
    count = counts[0] if counts else int(tree["step"])
    if len(set(counts)) > 1:
        raise ValueError(f"optimizer counts disagree: {counts}")
    state.tx.load_slots(count, slots)
    if "ema_params" in tree:
        if state.ema_params is None:
            raise ValueError("the checkpoint holds ema_params; seed them "
                             "with with_ema(state) first")
        for e, src in zip(state.ema_params,
                          _ordered(state.model, tree["ema_params"])):
            e.copy_(src)
    state.step = int(tree["step"])
