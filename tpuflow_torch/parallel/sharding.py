"""The JAX package's sharding rule for the port, applied with FSDP2 and
explicit tensor and expert slices.

Counterpart of ``tpuflow/parallel/sharding.py`` (``gpt2_tensor_rules``
:47, ``make_shardings`` :82, ``has_sharded_leaf`` :133,
``create_sharded_state`` :152). The JAX package places every leaf of the
abstract train state by its path and shape: ``gpt2_tensor_rules`` first
(Megatron column splits of ``c_attn``/``mlp_fc`` over ``tensor``, row
splits of ``c_proj``/``mlp_proj``, ``wte``/``wpe`` on dim 0, the MoE
expert stacks on ``expert`` and their FFN dim on ``tensor``), each
placement kept only where its axis divides the dim; then FSDP on the
largest dimension still free that the fsdp world (``fsdp`` x ``data``)
divides, the higher index on a tie. Leaves under 2**12 elements (and
scalars) stay replicated. GSPMD then inserts the collectives.

The rule is computed here on the same leaves (``leaf_spec``): the JAX
param tree that ``ckpt/tree.py::params_to_jax`` lays the port's
parameters out as (Dense kernels (in, out), and under ``scan_layers``
each name's blocks stacked on a leading layer axis). A spec has one
entry a dimension: None, ``"tensor"``, ``"expert"``, or the FSDP entry
(``"fsdp"``, ``"data"`` or ``("fsdp", "data")``, as JAX spells it).
``ShardPlan`` maps each leaf's dimensions back to the torch parameters
they came from, through the transposition and the layer stacking, and
``localize`` gives each process its ``tensor``/``expert`` block of every
parameter the rule splits (a fresh ``Parameter``); ``shard_model`` then
applies FSDP2's ``fully_shard`` over the ``data`` x ``fsdp`` group to
every block and to the root with the FSDP dimension as each parameter's
``Shard``. A parameter the rule leaves without an FSDP dimension, or
whose leaf it shards on the layer axis (which no torch parameter has), is
left out of FSDP (``ignored_params``): every process of the FSDP group
holds it whole and the train step averages its gradient with one
all-reduce. No mixed-precision policy: parameters, the f32 tied head and
the gradient reductions stay in f32, as the JAX step computes them.

FSDP2 places a shard by the process's rank in the FSDP group, data major;
JAX's ``("fsdp", "data")`` entry is fsdp major. The two differ on which
process holds which block only when both axes exceed 1; the checkpoint
pieces name their regions, so either side restores the other's.

The JAX rule never names ``seq``: on a ``seq`` axis every leaf is
replicated over it, its region written by the process at seq coordinate
0. The pipeline mesh ``{"data": D, "stage": S}`` takes the JAX pipeline
rule instead (``tpuflow/parallel/pipeline.py::gpt2_pipeline_shardings``,
``pipeline_spec``): ``P("stage")`` on dim 0 (the layer axis) of every
leaf under an ``h`` path, the parameters' and the optimizer state's
alike, everything else replicated; each stage's model holds only its
``n_layer / S`` blocks (``parallel/pipeline.py``), and no FSDP runs.

The optimizer moments and the EMA weights are made from the local parts
(``ShardPlan.local``), so they mirror their parameter's layout; the
checkpoint tree of a sharded state is built from them too
(``ShardPlan.pieces``): each process writes the regions the JAX rule gives
it, a region held by several processes (replicated over an axis) written
by the one at coordinate 0 of those axes (JAX's ``replica_id == 0``), and
restores the region it holds (``ShardPlan.template``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tpuflow_torch.ckpt.raw import Piece, flatten, map_leaves

MIN_SHARD_ELEMS = 2**12
_DATA, _FSDP, _TENSOR, _EXPERT = "data", "fsdp", "tensor", "expert"
_STAGE = "stage"
_AXES = (_DATA, _FSDP, _TENSOR, "seq", _EXPERT, _STAGE)


def gpt2_tensor_rules(names: tuple[str, ...], shape: tuple[int, ...]):
    """Megatron-style placements for a GPT-2 leaf (params and the
    optimizer leaves that carry their path), ``dim -> axis``: column
    splits (the output dim) of ``c_attn``/``mlp_fc`` kernels, row splits
    (the input dim) of ``c_proj``/``mlp_proj``, dim 0 of ``wte``/``wpe``;
    the MoE ``w1`` (E, C, F) and ``w2`` (E, F, C) on ``expert`` (dim 0)
    and their FFN dim on ``tensor``, ``b1``/``b2`` (E, .) on ``expert``.
    Under ``scan_layers`` every dim shifts right by the layer axis. A
    copy of the JAX package's rule."""
    if not names or len(shape) == 0:
        return None
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if leaf == "kernel" and len(shape) in (2, 3):
        col, row = len(shape) - 1, len(shape) - 2
        if parent in ("c_attn", "mlp_fc"):
            return {col: _TENSOR}
        if parent in ("c_proj", "mlp_proj"):
            return {row: _TENSOR}
    if leaf in ("wte", "wpe") and len(shape) == 2:
        return {0: _TENSOR}
    if parent == "moe" and leaf in ("w1", "w2") and len(shape) in (3, 4):
        placed = {len(shape) - 3: _EXPERT}
        placed[len(shape) - 1 if leaf == "w1" else len(shape) - 2] = _TENSOR
        return placed
    if parent == "moe" and leaf in ("b1", "b2") and len(shape) in (2, 3):
        return {len(shape) - 2: _EXPERT}
    return None


def fsdp_entry(axes: dict):
    """The spec entry of an FSDP-sharded dim on a mesh of ``axes``
    (``("fsdp", "data")``, ``"fsdp"``, ``"data"``), or None when the fsdp
    world is 1."""
    used = tuple(a for a in (_FSDP, _DATA) if axes.get(a, 1) > 1)
    if not used:
        return None
    return used if len(used) > 1 else used[0]


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes a spec entry names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def pipeline_spec(names, shape) -> tuple:
    """The JAX pipeline rule for one leaf: ``("stage", None, ...)`` under
    an ``h`` path (the stacked blocks' layer axis), replicated
    elsewhere."""
    spec: list = [None] * len(shape)
    if spec and "h" in tuple(names):
        spec[0] = _STAGE
    return tuple(spec)


def leaf_spec(names, shape, axes: dict,
              tensor_rules: Callable | None = None,
              min_shard_elems: int = MIN_SHARD_ELEMS) -> tuple:
    """The JAX ``make_shardings`` rule for one leaf (path ``names``,
    ``shape``) on a mesh of ``axes`` (axis -> size): the spec, one entry a
    dimension (see the module docstring); on a pipeline mesh (``stage``
    above 1) the pipeline rule."""
    shape = tuple(int(n) for n in shape)
    if axes.get(_STAGE, 1) > 1:
        return pipeline_spec(names, shape)
    spec: list = [None] * len(shape)
    if not shape or math.prod(shape) < min_shard_elems:
        return tuple(spec)
    placed = tensor_rules(tuple(names), shape) if tensor_rules else None
    for dim, axis in (placed or {}).items():
        size = axes.get(axis, 1)
        if size > 1 and shape[dim] % size == 0:
            spec[dim] = axis
    entry = fsdp_entry(axes)
    world = math.prod(axes.get(a, 1) for a in entry_axes(entry))
    if entry is not None:
        candidates = [(shape[d], d) for d in range(len(shape))
                      if spec[d] is None and shape[d] % world == 0]
        if candidates:
            spec[max(candidates)[1]] = entry
    return tuple(spec)


def make_shardings(tree, mesh, min_shard_elems: int = MIN_SHARD_ELEMS, *,
                   tensor_rules: Callable | None = None):
    """``tree`` (nested dicts of anything with a ``shape``) with each leaf
    replaced by its spec (``leaf_spec``) on ``mesh``, a mapping of axis
    sizes or a ``dist.Mesh``: the JAX rule with ``tensor_rules`` first."""
    axes = dict(getattr(mesh, "shape", mesh))
    out: dict = {}
    for names, leaf in flatten(tree):
        node = out
        for k in names[:-1]:
            node = node.setdefault(k, {})
        node[names[-1]] = leaf_spec(
            names, getattr(leaf, "shape", ()), axes, tensor_rules,
            min_shard_elems=min_shard_elems)
    return out


def has_sharded_leaf(shardings, axis: str | None = None) -> bool:
    """True when any leaf of a ``make_shardings`` tree (or of a
    ``ShardPlan``) is sharded, with ``axis`` on that mesh axis: guards
    equivalence checks that would pass vacuously if the rule kept
    everything replicated."""
    if isinstance(shardings, ShardPlan):
        specs = list(shardings.specs.values())
    else:
        specs = [d for _, d in flatten(shardings)]
    for spec in specs:
        for entry in spec:
            if entry is not None and (axis is None
                                      or axis in entry_axes(entry)):
                return True
    return False


def region(spec, shape, coords: dict, fsdp_index: int, axes: dict
           ) -> tuple[list, list]:
    """(start, extent) of the block of a leaf of ``shape`` with ``spec``
    that the process at ``coords`` (its FSDP-group rank ``fsdp_index``)
    holds."""
    start, extent = [0] * len(shape), list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry_axes(entry)
        if _FSDP in names or _DATA in names:
            n = math.prod(axes.get(a, 1) for a in names)
            i = fsdp_index
        else:
            n, i = axes.get(entry, 1), coords.get(entry, 0)
        extent[d] = shape[d] // n
        start[d] = i * extent[d]
    return start, extent


def owner(spec, coords: dict) -> bool:
    """True when the process at ``coords`` writes (and counts once) its
    block of a leaf with ``spec``: it sits at coordinate 0 of every axis
    the spec does not shard on (JAX's ``replica_id == 0``)."""
    used = {a for entry in spec for a in entry_axes(entry)}
    return all(c == 0 for a, c in coords.items() if a not in used)


def _jax_key(name: str, ndim: int, scan_layers: bool
             ) -> tuple[tuple[str, ...], bool, bool]:
    """(path of the JAX leaf, stacked on a layer axis, transposed) of the
    GPT-2 parameter ``name`` (``models/convert.py::named_params_to_jax``:
    a 2-D ``weight`` is a Dense kernel, a 1-D one a LayerNorm scale)."""
    *mods, leaf = name.split(".")
    transposed = leaf == "weight" and ndim == 2
    if leaf == "weight":
        leaf = "kernel" if ndim == 2 else "scale"
    if mods and mods[0] == "h":
        if scan_layers:
            return ("h", "block", *mods[2:], leaf), True, transposed
        return (f"h{mods[1]}", *mods[2:], leaf), False, transposed
    return (*mods, leaf), False, transposed


class ShardPlan:
    """Where each parameter of a GPT-2 model lives on a mesh: ``mesh`` a
    ``dist.Mesh`` (its axes, this process's coordinates and FSDP-group
    rank; ``dist.Mesh(shape, device)`` alone stands for the process at
    coordinate 0 of a world it is not part of). ``tensor_rules`` (``gpt2_tensor_rules`` on a mesh with
    a ``tensor`` or ``expert`` axis, as the JAX recipe passes it) places
    the model axes.

    - ``specs``: JAX leaf path → the rule's spec of the param tree at
      ``scan_layers``'s layout; ``leaves``: path → (global shape, the FSDP
      dimension or None);
    - ``dims``: torch parameter name → the dimension FSDP shards it on,
      or None (held whole over the FSDP group);
    - ``split``: name → {``"tensor"``/``"expert"``: the torch dimension
      the rule splits over that axis} (this process holds its block);
    - ``names``: the parameters in ``named_parameters`` order; ``shapes``
      their global (torch) shapes.
    """

    def __init__(self, model, scan_layers: bool, mesh, *,
                 tensor_rules: Callable | None = None):
        self.axes = {a: mesh.shape.get(a, 1) for a in _AXES}
        self.coords = {a: mesh.coord(a) if a in mesh.shape else 0
                       for a in _AXES}
        stages = self.axes[_STAGE]
        if stages > 1 and not scan_layers:
            raise ValueError("pipeline params require "
                             "GPT2Config(scan_layers=True)")
        self.fsdp_index = mesh.fsdp_index
        self.device_mesh = mesh.full_mesh
        self.world = self.axes[_DATA] * self.axes[_FSDP]
        self.tensor_rules = tensor_rules
        self.scan_layers = scan_layers
        self.names, self.dims, self.split, self.leaves = [], {}, {}, {}
        self.specs, self.shapes, self.staged = {}, {}, set()
        per_leaf: dict[tuple, list] = {}
        for name, p in model.named_parameters():
            path, stacked, transposed = _jax_key(name, p.dim(), scan_layers)
            shape = tuple(p.shape)[::-1] if transposed else tuple(p.shape)
            per_leaf.setdefault(path, []).append((name, stacked, transposed,
                                                  shape))
            self.names.append(name)
            self.shapes[name] = tuple(p.shape)
        entry = fsdp_entry(self.axes)
        for path, members in per_leaf.items():
            _, stacked, _, shape = members[0]
            if stacked:
                # A stage holds its n_layer / S blocks of the stack.
                shape = (len(members) * stages, *shape)
            spec = leaf_spec(path, shape, self.axes, tensor_rules)
            if spec and spec[0] == _STAGE:
                self.staged.update(name for name, *_ in members)
            self.specs[path] = spec
            fdim = spec.index(entry) if entry in spec else None
            self.leaves[path] = (shape, fdim)
            for name, _, transposed, _ in members:
                self.dims[name] = None
                self.split[name] = {}
                for d, e in enumerate(spec):
                    local = d - 1 if stacked else d
                    if e is None or local < 0:
                        continue  # the layer axis: no torch parameter has it
                    if transposed:
                        local = 1 - local
                    if e == entry:
                        self.dims[name] = local
                    else:
                        self.split[name][e] = local

    # --------------------------------------------------------- placement
    @property
    def sharded(self) -> list[bool]:
        """Per parameter, in ``names`` order: FSDP shards it."""
        return [self.dims[n] is not None for n in self.names]

    @property
    def owned(self) -> list[bool]:
        """Per parameter, in ``names`` order: this process counts its local
        part in a global norm (its coordinate is 0 on every axis the part
        is replicated over), so a sum of the owned parts over the world
        counts every element once."""
        out = []
        for n in self.names:
            used = set(self.split[n])
            if self.dims[n] is not None:
                used |= {_DATA, _FSDP}
            if n in self.staged:
                used.add(_STAGE)
            out.append(all(c == 0 for a, c in self.coords.items()
                           if a not in used))
        return out

    def local(self, model) -> list[torch.Tensor]:
        """This process's part of each parameter (``names`` order): the
        local shard of an FSDP-sharded one (a view: updating it in place
        updates the parameter), the parameter itself otherwise."""
        out = []
        with torch.no_grad():
            for name, p in model.named_parameters():
                out.append(p.to_local() if self.dims[name] is not None else p)
        return out

    def full(self, name: str, local: torch.Tensor, mesh) -> torch.Tensor:
        """Parameter ``name`` whole from every process's ``local`` part (a
        collective over the FSDP group, then the tensor and expert groups
        that split it; a part held whole comes back as it is): all-gathers
        of the parts laid out along the sharded dims, in group order."""
        out = local.detach()
        dim = self.dims[name]
        if dim is not None:
            out = _gather(out, dim, mesh.fsdp_group)
        for axis, d in self.split[name].items():
            out = _gather(out, d, mesh.tensor_group if axis == _TENSOR
                          else mesh.expert_group)
        return out

    def local_grads(self, model) -> list[torch.Tensor]:
        """The gradients as ``local`` lays the parameters out."""
        out = []
        for name, p in model.named_parameters():
            g = p.grad
            if g is None:
                raise ValueError(f"{name} has no gradient")
            out.append(g.to_local() if self.dims[name] is not None else g)
        return out

    def held_spec(self, path: tuple) -> tuple:
        """The spec of the block of leaf ``path`` this process holds: the
        rule's, but whole along a stacked leaf's layer axis (every process
        holds the torch tensors of a layer whole), except on a pipeline
        mesh, where a stage holds its layers alone."""
        spec = list(self.specs[path])
        if (self.scan_layers and path[0] == "h" and spec and spec[0]
                and spec[0] != _STAGE):
            spec[0] = None
        return tuple(spec)

    def group_of(self, entry, mesh):
        """The process group a spec entry shards over (None: none)."""
        names = entry_axes(entry)
        if not names:
            return None
        if _FSDP in names or _DATA in names:
            return mesh.fsdp_group if self.world > 1 else None
        return mesh.group(entry)

    # -------------------------------------------------------- checkpoint
    def _blocks(self, path: tuple) -> tuple:
        """(global shape, spec, the region this process holds, the region
        the rule gives it) of a params-layout leaf; the held region is the
        rule's but whole along the layer axis (every process holds a
        stacked leaf's torch tensors whole there)."""
        shape, spec = self.leaves[path][0], self.specs[path]
        rule = region(spec, shape, self.coords, self.fsdp_index, self.axes)
        held = region(self.held_spec(path), shape, self.coords,
                      self.fsdp_index, self.axes)
        return shape, spec, held, rule

    def _each(self, tree: dict, fn) -> dict:
        """``fn(path, leaf)`` over a params-layout tree."""
        out: dict = {}
        for names, leaf in flatten(tree):
            node = out
            for k in names[:-1]:
                node = node.setdefault(k, {})
            node[names[-1]] = fn(tuple(names), leaf)
        return out

    def pieces(self, tree: dict) -> dict:
        """A params-layout tree of this process's local parts (``local``'s
        tensors through ``params_to_jax``) → the tree of ``Piece``s it
        saves: the block the rule gives it, which it writes unless another
        process at coordinate 0 of the axes the leaf is replicated over
        does (``owner`` False)."""
        def piece(path, t):
            shape, spec, held, rule = self._blocks(path)
            own = t
            for d in range(len(shape)):
                if rule[1][d] != held[1][d]:
                    own = own.narrow(d, rule[0][d] - held[0][d], rule[1][d])
            return Piece(shape, rule[0], own, spec=spec,
                         mesh=self.device_mesh,
                         owner=owner(spec, self.coords))

        return self._each(tree, piece)

    def template(self, tree: dict) -> dict:
        """A params-layout tree of local parts (``meta`` tensors will do) →
        the restore template of ``Piece``s naming this process's region of
        each leaf (the whole leaf for a parameter held whole)."""
        def hold(path, t):
            shape, _, held, _ = self._blocks(path)
            return Piece(shape, held[0], torch.empty_like(t, device="meta"),
                         spec=self.held_spec(path), mesh=self.device_mesh)

        return self._each(tree, hold)


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The parts of ``t`` over ``group`` laid out along ``dim``, in group
    rank order."""
    import torch.distributed as tdist

    n = tdist.get_world_size(group)
    part = t.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(part) for _ in range(n)]
    tdist.all_gather(parts, part, group=group)
    return torch.cat(parts).movedim(0, dim)


def localize(model, plan: ShardPlan) -> None:
    """Replace each parameter the rule splits over ``tensor`` or
    ``expert`` by this process's block of it (a new ``Parameter`` of the
    block's values; a ``meta`` model gets a ``meta`` block). In place,
    before ``shard_model``."""
    coords, axes = plan.coords, plan.axes
    for name in plan.names:
        split = plan.split[name]
        if not split:
            continue
        *mods, leaf = name.split(".")
        mod = model.get_submodule(".".join(mods))
        t = getattr(mod, leaf).detach()
        for axis, d in split.items():
            n = t.shape[d] // axes[axis]
            t = t.narrow(d, coords[axis] * n, n)
        setattr(mod, leaf, torch.nn.Parameter(t.clone()))


def shard_model(model, mesh, plan: ShardPlan) -> None:
    """FSDP2 ``fully_shard`` on every block of ``model`` and on the root,
    over ``mesh.fsdp_mesh``, each parameter on ``plan``'s dimension; the
    ones ``plan`` keeps whole are ``ignored_params``. In place; a no-op on
    an fsdp world of 1."""
    if plan.world == 1:
        return
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    by_id = {id(p): plan.dims[n] for n, p in model.named_parameters()}
    ignored = {p for n, p in model.named_parameters()
               if plan.dims[n] is None}

    def placement(p):
        return Shard(by_id[id(p)])

    kw = dict(mesh=mesh.fsdp_mesh, shard_placement_fn=placement,
              ignored_params=ignored)
    for block in model.h:
        fully_shard(block, **kw)
    fully_shard(model, **kw)
