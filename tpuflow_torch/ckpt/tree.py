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
- ``opt_state``: optax's tuple layout, tuple indices as keys (a
  transformation that keeps no state, ``EmptyState``, leaves no entry).
  ``adamw`` is ``chain(scale_by_adam, add_decayed_weights,
  scale_by_learning_rate)``: ``0/{count, mu, nu}``, plus ``2/count``
  when the learning rate is scheduled. ``sgd`` is ``chain(trace,
  scale_by_learning_rate)``: ``0/trace``, plus ``1/count`` when
  scheduled. ``lion`` is ``chain(scale_by_lion, add_decayed_weights,
  scale_by_learning_rate)``: ``0/{count, mu}``, plus ``2/count``.
  ``adafactor`` is ``chain(scale_by_factored_rms, clip_by_block_rms,
  scale_by_learning_rate, scale_by_param_block_rms,
  [add_decayed_weights], scale)``: ``0/{count, v_row, v_col, v}`` (each
  a param-shaped tree of per-leaf statistics, ``JaxLeaves``), plus
  ``2/count``. With ``grad_clip`` the whole chain sits under ``1``
  (``clip_by_global_norm`` keeps no state). Every count is the int32
  number of updates.
- ``step``: int32; ``ema_params`` like ``params``.

A sharded state (``state.plan``, ``parallel/sharding.py::ShardPlan``)
lays out its local parts the same way and wraps each params-layout leaf
as a ``raw.Piece``: the shard the JAX rule gives this process, which the
manager's multi-process save writes, or, as a restore template, the
region of the leaf it holds. Loading copies each restored region back
into the local shards. Adafactor's statistics are placed by the rule on
their own shapes (a ``v_col`` may split where its ``v_row`` stays whole)
while each process computes with the block its gradient gives it: a
save assembles each statistic whole (one all-reduce of every process's
blocks, each counted once) and writes the rule's block of it; a restore
reads the statistics whole and keeps the computed blocks.
"""

from __future__ import annotations

import collections
import math

import torch

from tpuflow_torch.ckpt.raw import Piece, flatten, unflatten
from tpuflow_torch.models.convert import (
    named_params_from_jax,
    named_params_to_jax,
    params_from_jax,
)
from tpuflow_torch.models.gpt2 import GPT2
from tpuflow_torch.models.resnet import BatchNorm
from tpuflow_torch.train.optim import Leaves, _factored_dims


def params_to_jax(sd: dict, *, scan_layers: bool) -> dict:
    """Port ``state_dict`` (name → tensor) → the Flax GPT-2 param tree:
    each block's leaves by the Flax names (``named_params_to_jax``), under
    ``h{i}`` or, with ``scan_layers``, stacked under ``h/block``."""
    tree = named_params_to_jax(
        {k: v for k, v in sd.items() if not k.startswith("h.")})
    n_layer = 0
    while f"h.{n_layer}.ln_1.weight" in sd:
        n_layer += 1
    blocks = [named_params_to_jax({k[len(f"h.{i}."):]: v
                                   for k, v in sd.items()
                                   if k.startswith(f"h.{i}.")})
              for i in range(n_layer)]
    if scan_layers:
        tree["h"] = {"block": _stack(blocks)}
    else:
        for i, b in enumerate(blocks):
            tree[f"h{i}"] = b
    return tree


def _stack(trees: list) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


class JaxLeaves(Leaves):
    """A model's parameters grouped into the leaves of its JAX param tree
    (``optim.Leaves``): Dense kernels (in, out), and under ``scan_layers``
    a name's tensors of every block stacked into one leaf. ``leaves``
    returns them in the checkpoint's leaf order (``raw.flatten``);
    ``tensors`` maps leaf-shaped tensors back to the parameter layout
    (contiguous copies).

    With ``plan`` and ``mesh`` (a sharded state) the tensors are this
    process's local parts, each leaf a block of the whole: ``shapes`` and
    ``specs`` hold the whole leaves' shapes and the specs of the blocks
    held (``ShardPlan.held_spec``), and ``reduce_sum`` all-reduces a
    local sum over the groups that shard the summed dims."""

    def __init__(self, model, scan_layers: bool, plan=None, mesh=None):
        self.model, self.scan_layers = model, scan_layers
        self.names = [n for n, _ in model.named_parameters()]
        self.paths = [path for path, _ in flatten(self._tree([
            torch.empty_like(p, device="meta") for p in model.parameters()]))]
        self.plan, self.mesh = plan, mesh
        if plan is not None:
            self.shapes = [plan.leaves[tuple(p)][0] for p in self.paths]
            self.specs = [plan.held_spec(tuple(p)) for p in self.paths]

    def global_shapes(self, tensors) -> list[tuple]:
        if self.plan is None:
            return super().global_shapes(tensors)
        return list(self.shapes)

    def reduce_sum(self, i: int, x: torch.Tensor, dims) -> torch.Tensor:
        out = x.sum(dims)
        if self.plan is None:
            return out
        import torch.distributed as tdist

        groups = []
        for d in dims:
            group = self.plan.group_of(self.specs[i][d], self.mesh)
            if group is not None and group not in groups:
                groups.append(group)
        for group in groups:
            tdist.all_reduce(out, group=group)
        return out

    def _tree(self, tensors) -> dict:
        return _to_jax(self.model, dict(zip(self.names, tensors)),
                       self.scan_layers)

    def leaves(self, tensors) -> list[torch.Tensor]:
        return [t for _, t in flatten(self._tree(tensors))]

    def tree(self, leaves) -> dict:
        """Leaves in ``leaves``' order → the nested param tree."""
        return unflatten(zip(self.paths, leaves))

    def flat(self, tree: dict) -> list:
        """A param-shaped tree → its leaves in ``leaves``' order."""
        pairs = flatten(tree)
        if [p for p, _ in pairs] != self.paths:
            raise ValueError("the tree's leaves are not this model's")
        return [t for _, t in pairs]

    def tensors(self, leaves) -> list[torch.Tensor]:
        leaves = list(leaves)
        sd = _from_jax(self.model, self.tree(leaves), leaves[0].device)
        return [sd[n] for n in self.names]


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
    plan = getattr(state, "plan", None)

    def layout(tensors) -> dict:
        if len(tensors) != len(names):
            raise ValueError(f"{len(tensors)} tensors for {len(names)} "
                             "parameters")
        if abstract:
            tensors = [torch.empty_like(t, device="meta") for t in tensors]
        tree = _to_jax(state.model, dict(zip(names, tensors)), scan_layers)
        if plan is None:
            return tree
        return plan.template(tree) if abstract else plan.pieces(tree)

    tx = state.tx
    # The first transformation's state: a named tuple, its fields in
    # optax's order (the count first, where it keeps one).
    first = collections.OrderedDict(
        [] if tx.kind == "sgd" else [("count", _count(tx.count))])
    first.update((name, layout(ts)) for name, ts in tx.slots().items())
    per_leaf = tx.leaf_slots()
    if plan is not None and per_leaf:
        first.update(_stat_pieces(state, per_leaf, abstract))
    else:
        for name, ts in per_leaf.items():
            if abstract:
                ts = [torch.empty_like(t, device="meta") for t in ts]
            first[name] = tx.leaves.tree(ts)
    inner = {"0": first}
    if tx.scheduled:
        inner["1" if tx.kind == "sgd" else "2"] = {"count": _count(tx.count)}
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


def _stat_layouts(leaves) -> dict:
    """Per Adafactor statistic name, per leaf: (the statistic's whole
    shape, the spec of the block this process computes). A factored leaf's
    ``v_row`` lacks its largest dim d0 and ``v_col`` its second largest
    d1 (the gradient's means over them); placeholders are (1,), whole."""
    out = {"v_row": [], "v_col": [], "v": []}
    for shape, spec in zip(leaves.shapes, leaves.specs):
        dims = _factored_dims(tuple(shape))
        one = ((1,), (None,))
        drop = lambda xs, d: tuple(x for i, x in enumerate(xs) if i != d)  # noqa: E731
        if dims is None:
            row = col = one
            full = (tuple(shape), tuple(spec))
        else:
            d1, d0 = dims
            row = (drop(shape, d0), drop(spec, d0))
            col = (drop(shape, d1), drop(spec, d1))
            full = one
        for name, layout in (("v_row", row), ("v_col", col), ("v", full)):
            out[name].append(layout)
    return out


def _stat_pieces(state, stats: dict, abstract: bool) -> dict:
    """The sharded Adafactor statistics as checkpoint trees of ``Piece``s:
    each statistic whole as a restore template, or the block the rule
    gives this process on the statistic's own shape (``leaf_spec`` with
    the plan's tensor rules), assembled from every process's computed
    blocks."""
    import torch.distributed as tdist

    from tpuflow_torch.parallel.sharding import leaf_spec, owner, region

    tx, plan = state.tx, state.plan
    leaves = tx.leaves
    layouts = _stat_layouts(leaves)
    coords, axes, fi = plan.coords, plan.axes, plan.fsdp_index
    out = {}
    if abstract:
        for name, ts in stats.items():
            out[name] = unflatten(
                (path, Piece(shape, [0] * len(shape),
                             torch.empty(shape, dtype=t.dtype,
                                         device="meta"),
                             spec=(None,) * len(shape),
                             mesh=plan.device_mesh))
                for path, t, (shape, _) in zip(leaves.paths, ts,
                                               layouts[name]))
        return out
    # Every statistic whole: each process adds the blocks it owns into a
    # zero buffer, one all-reduce sums them.
    names = list(stats)
    sizes = [math.prod(shape) for name in names
             for shape, _ in layouts[name]]
    ref = stats[names[0]][0]
    flat = torch.zeros(sum(sizes), dtype=ref.dtype, device=ref.device)
    offset = 0
    views = {}
    for name in names:
        for path, t, (shape, spec) in zip(leaves.paths, stats[name],
                                          layouts[name]):
            whole = flat[offset:offset + math.prod(shape)].view(shape)
            offset += whole.numel()
            views[(name, tuple(path))] = whole
            if owner(spec, coords):
                start, extent = region(spec, shape, coords, fi, axes)
                dst = whole
                for d in range(len(shape)):
                    dst = dst.narrow(d, start[d], extent[d])
                dst.copy_(t)
    if tdist.is_initialized() and tdist.get_world_size() > 1:
        tdist.all_reduce(flat)
    for name in names:
        pairs = []
        for path, (shape, _) in zip(leaves.paths, layouts[name]):
            spec = leaf_spec(path, shape, axes, plan.tensor_rules)
            start, extent = region(spec, shape, coords, fi, axes)
            own = views[(name, tuple(path))]
            for d in range(len(shape)):
                own = own.narrow(d, start[d], extent[d])
            pairs.append((path, Piece(shape, start, own, spec=spec,
                                      mesh=plan.device_mesh,
                                      owner=owner(spec, coords))))
        out[name] = unflatten(pairs)
    return out


def _stat_blocks(state, name: str, whole: list) -> list:
    """Restored whole statistics of ``name`` → the blocks this process
    computes with."""
    from tpuflow_torch.parallel.sharding import region

    plan = state.plan
    out = []
    for t, (shape, spec) in zip(whole, _stat_layouts(state.tx.leaves)[name]):
        start, extent = region(spec, shape, plan.coords, plan.fsdp_index,
                               plan.axes)
        for d in range(len(shape)):
            t = t.narrow(d, start[d], extent[d])
        out.append(t)
    return out


def _ordered(model, tree: dict) -> list[torch.Tensor]:
    """A param-layout tree → its tensors in ``model``'s parameter order, on
    its device: each leaf is copied there first (a DMA from page-locked
    restore buffers), so the layout work (the Dense kernels' transposes,
    the stacked blocks' rows) runs there and not on one host core."""
    sd = _from_jax(model, tree, next(model.parameters()).device)
    return [sd[n] for n, _ in model.named_parameters()]


@torch.no_grad()
def load_params(model, params: dict, dst=None) -> None:
    """Copy a restored ``params`` subtree (the JAX layout) into ``model``'s
    parameters in place: a weights-only warm start (an optimizer over them
    keeps its state). ``dst``: the tensors to fill instead, in parameter
    order (a sharded model's local parts, whose regions ``params``
    holds)."""
    dst = list(model.parameters()) if dst is None else dst
    for p, src in zip(dst, _ordered(model, params)):
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
    weights and step. For a sharded state each leaf holds this process's
    region (a restore through ``checkpoint_tree(state, abstract=True)``)
    and fills its local parts."""
    load_params(state.model, tree["params"],
                state.params if getattr(state, "plan", None) else None)
    if running_stats(state.model):
        load_batch_stats(state.model, tree["batch_stats"])
    opt = tree["opt_state"]
    inner = opt["1"] if state.tx.grad_clip_norm is not None else opt
    per_leaf = state.tx.leaf_slots()
    slots = {name: _ordered(state.model, sub)
             for name, sub in inner["0"].items()
             if name != "count" and name not in per_leaf}
    leaf_slots = {name: state.tx.leaves.flat(inner["0"][name])
                  for name in per_leaf if name in inner["0"]}
    if getattr(state, "plan", None) is not None:
        leaf_slots = {name: _stat_blocks(state, name, ts)
                      for name, ts in leaf_slots.items()}
    counts = [int(c["count"]) for c in (inner["0"], inner.get("1"),
                                        inner.get("2"))
              if isinstance(c, dict) and "count" in c]
    count = counts[0] if counts else int(tree["step"])
    if len(set(counts)) > 1:
        raise ValueError(f"optimizer counts disagree: {counts}")
    state.tx.load_slots(count, slots, leaf_slots)
    if "ema_params" in tree:
        if state.ema_params is None:
            raise ValueError("the checkpoint holds ema_params; seed them "
                             "with with_ema(state) first")
        for e, src in zip(state.ema_params,
                          _ordered(state.model, tree["ema_params"])):
            e.copy_(src)
    state.step = int(tree["step"])
