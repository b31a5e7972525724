"""FSDP for the port: the JAX package's sharding rule, applied with FSDP2.

Counterpart of ``tpuflow/parallel/sharding.py`` (``make_shardings`` :82,
``has_sharded_leaf`` :133, ``create_sharded_state`` :152) for the FSDP
layout. The JAX package shards every leaf of the abstract train state
along its largest dimension that the fsdp world (``fsdp`` x ``data``)
divides, the higher index on a tie, and keeps leaves under 2**12 elements
(and scalars) replicated; GSPMD then inserts the all-gathers and the
gradient reduce-scatters.

The rule is computed here on the same leaves: the JAX param tree that
``ckpt/tree.py::params_to_jax`` lays the port's parameters out as (Dense
kernels (in, out), and under ``scan_layers`` each name's blocks stacked
on a leading layer axis). ``ShardPlan`` maps each leaf's dimension back
to the torch parameters it came from, through the transposition and the
layer stacking: a block's ``mlp_fc`` kernel (L, 1024, 4096) shards its
dim 2, dim 0 of each (4096, 1024) torch weight; a stacked LayerNorm scale
(L, 1024) is judged at its stacked size and shards each (1024,) tensor.
``shard_model`` then applies FSDP2's ``fully_shard`` to every block and to
the root (which holds the tied ``wte``, read by the embedding and the
head) with that dimension as each parameter's ``Shard``. A parameter the
rule keeps replicated, or whose leaf it shards on the layer axis (which
no torch parameter has), is left out of FSDP (``ignored_params``): every
process holds it whole and the train step averages its gradient with one
all-reduce. No mixed-precision policy: parameters, the f32 tied head and
the gradient reductions stay in f32, as the JAX step computes them.

The optimizer moments and the EMA weights are made from the local shards
(``ShardPlan.local``), so they mirror their parameter's sharding; the
checkpoint tree of a sharded state is built from them too
(``ShardPlan.pieces``): each process writes the shards the JAX rule gives
it, and restores the region it holds (``ShardPlan.template``).
"""

from __future__ import annotations

import math

import torch

from tpuflow_torch.ckpt.raw import Piece, flatten, map_leaves

MIN_SHARD_ELEMS = 2**12


def fsdp_dim(shape, world: int,
             min_shard_elems: int = MIN_SHARD_ELEMS) -> int | None:
    """The JAX rule for one leaf of ``shape`` at an fsdp world of
    ``world``: the largest dimension ``world`` divides (the higher index
    on a tie), or None (replicated) for scalars, leaves under
    ``min_shard_elems`` elements, a world of 1, or no such dimension."""
    shape = tuple(shape)
    if world <= 1 or not shape or math.prod(shape) < min_shard_elems:
        return None
    candidates = [(shape[d], d) for d in range(len(shape))
                  if shape[d] % world == 0]
    return max(candidates)[1] if candidates else None


def make_shardings(tree, world: int,
                   min_shard_elems: int = MIN_SHARD_ELEMS):
    """``tree`` (nested dicts of anything with a ``shape``) with each leaf
    replaced by its sharded dimension at ``world`` (None: replicated)."""
    return map_leaves(
        lambda leaf: fsdp_dim(getattr(leaf, "shape", ()), world,
                              min_shard_elems), tree)


def has_sharded_leaf(shardings) -> bool:
    """True when any leaf of a ``make_shardings`` tree (or any dimension of
    a ``ShardPlan``) is sharded: guards equivalence checks that would pass
    vacuously if the rule kept everything replicated."""
    if isinstance(shardings, ShardPlan):
        return any(d is not None for d in shardings.dims.values())
    return any(d is not None for _, d in flatten(shardings))


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
    """Where each parameter of a GPT-2 model lives over an fsdp world of
    ``world`` processes, this one at ``index`` (``dist.Mesh.index``).

    - ``leaves``: JAX leaf path → (global shape, the rule's dimension or
      None), for the param tree at ``scan_layers``'s layout;
    - ``dims``: torch parameter name → the dimension FSDP shards it on, or
      None (held whole by every process);
    - ``names``: the parameters in ``named_parameters`` order.
    """

    def __init__(self, model, scan_layers: bool, world: int, index: int = 0):
        self.scan_layers, self.world, self.index = scan_layers, world, index
        self.names, self.dims, self.leaves = [], {}, {}
        per_leaf: dict[tuple, list] = {}
        for name, p in model.named_parameters():
            path, stacked, transposed = _jax_key(name, p.dim(), scan_layers)
            shape = tuple(p.shape)[::-1] if transposed else tuple(p.shape)
            per_leaf.setdefault(path, []).append((name, stacked, transposed,
                                                  shape))
            self.names.append(name)
        for path, members in per_leaf.items():
            _, stacked, _, shape = members[0]
            if stacked:
                shape = (len(members), *shape)
            dim = fsdp_dim(shape, world)
            self.leaves[path] = (shape, dim)
            for name, _, transposed, _ in members:
                local = dim - 1 if stacked and dim is not None else dim
                if local is not None and local < 0:
                    local = None  # the layer axis: no torch parameter has it
                if local is not None and transposed:
                    local = 1 - local
                self.dims[name] = local

    # --------------------------------------------------------- placement
    @property
    def sharded(self) -> list[bool]:
        """Per parameter, in ``names`` order: FSDP shards it."""
        return [self.dims[n] is not None for n in self.names]

    def local(self, model) -> list[torch.Tensor]:
        """This process's part of each parameter (``names`` order): the
        local shard of a sharded one (a view: updating it in place updates
        the parameter), the parameter itself otherwise."""
        out = []
        with torch.no_grad():
            for name, p in model.named_parameters():
                out.append(p.to_local() if self.dims[name] is not None else p)
        return out

    def full(self, name: str, local: torch.Tensor, mesh) -> torch.Tensor:
        """Parameter ``name`` whole from every process's ``local`` part (a
        collective over ``mesh.fsdp_mesh``; a part held whole comes back
        as it is). An all-gather of the shards laid out along the sharded
        dim, in mesh order."""
        import torch.distributed as tdist

        dim = self.dims[name]
        if dim is None:
            return local
        part = local.detach().movedim(dim, 0).contiguous()
        parts = [torch.empty_like(part) for _ in range(self.world)]
        tdist.all_gather(parts, part, group=mesh.fsdp_mesh.get_group())
        return torch.cat(parts).movedim(0, dim)

    def local_grads(self, model) -> list[torch.Tensor]:
        """The gradients as ``local`` lays the parameters out."""
        out = []
        for name, p in model.named_parameters():
            g = p.grad
            if g is None:
                raise ValueError(f"{name} has no gradient")
            out.append(g.to_local() if self.dims[name] is not None else g)
        return out

    # -------------------------------------------------------- checkpoint
    def _region(self, path: tuple, local_shape: tuple) -> tuple:
        """(global shape, start of this process's region, rule dim) of a
        params-layout leaf whose local part has ``local_shape``."""
        shape, dim = self.leaves[path]
        start = [0] * len(shape)
        if tuple(local_shape) != tuple(shape):
            # Sharded on ``dim`` by FSDP: this process's block of it.
            start[dim] = self.index * (shape[dim] // self.world)
        return shape, start, dim

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
        saves: the shard the rule gives it (block ``index`` of the rule's
        dimension), or, for a leaf the rule keeps replicated, the whole
        leaf from index 0 and nothing from the others."""
        def piece(path, t):
            shape, start, dim = self._region(path, t.shape)
            if dim is None:
                return Piece(shape, [0] * len(shape),
                             t if self.index == 0 else None, t.dtype)
            n = shape[dim] // self.world
            lo = self.index * n
            own = t.narrow(dim, lo - start[dim], n)
            box = [0] * len(shape)
            box[dim] = lo
            return Piece(shape, box, own)

        return self._each(tree, piece)

    def template(self, tree: dict) -> dict:
        """A params-layout tree of local parts (``meta`` tensors will do) →
        the restore template of ``Piece``s naming this process's region of
        each leaf (the whole leaf for a parameter held whole)."""
        def region(path, t):
            shape, start, _ = self._region(path, t.shape)
            return Piece(shape, start, torch.empty_like(t, device="meta"))

        return self._each(tree, region)


def shard_model(model, mesh, plan: ShardPlan) -> None:
    """FSDP2 ``fully_shard`` on every block of ``model`` and on the root,
    over ``mesh.fsdp_mesh``, each parameter on ``plan``'s dimension; the
    ones ``plan`` keeps whole are ``ignored_params``. In place."""
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
