"""The Megatron computation on the ``tensor`` and ``expert`` groups: the
counterpart of what GSPMD inserts for ``gpt2_tensor_rules``
(``tpuflow/parallel/sharding.py:47-79``) in the JAX package.

Design. Each process holds its ``tensor``/``expert`` block of the
parameters the rule splits (``sharding.localize``) and FSDP2 shards what
is left over the ``data`` x ``fsdp`` group alone; the blocks compute with
explicit collectives on the tensor and expert process groups. DTensor's
``parallelize_module`` under FSDP2 is the other route; it is not taken:
``DTensor.full_tensor()`` over gloo on CUDA tensors segfaulted (PERF.md),
and FSDP2 would have to shard a ``c_attn`` weight's dim 1 while the
tensor placement holds dim 0. Every collective here is a plain
``all_reduce`` or ``all_gather`` on a process group.

- ``copy_to`` (Megatron's f): identity forward, all-reduce of the
  gradient backward; ``reduce_from`` (g): all-reduce forward, identity
  backward. A column-parallel Dense (``c_attn``, ``mlp_fc``) takes its
  input through f; a row-parallel one (``c_proj``, ``mlp_proj``) gives
  its partial product to g and adds its bias after.
- Attention runs on the process's H / t heads. The rule's column split of
  the fused ``c_attn`` kernel is contiguous, not head-aligned (at t = 2
  the first half of the 3C outputs is all of q and half of k), so the
  block gathers the kernel's rows over the tensor group and takes its
  heads' q, k and v rows; the backward sums the gathered gradient over
  the group and keeps the process's contiguous block. The checkpoint and
  the optimizer see only the rule's layout.
- A parameter the rule keeps whole but a process uses in part (the
  ``c_attn`` and ``mlp_fc`` biases, the MoE ``b1`` on ``tensor``, any
  split leaf under 2**12 elements) gets the gradient of its part only:
  the train step sums its gradient over that group (``grad_sum``). A
  parameter the rule splits but every process uses whole (``wte``,
  ``wpe`` at a vocab or context the tensor size divides) is gathered
  before use; its gradient, the same on every peer, keeps the process's
  block.
- MoE (``models/moe.py``): each process of the expert group runs its
  E / e experts' slice of the dispatch (the batch is replicated over
  ``expert``, so no all-to-all is needed), and the combined partial
  outputs are all-reduced over the group; on ``tensor`` the experts'
  FFN dim splits as ``mlp_fc``/``mlp_proj`` do. The Switch load-balance
  loss takes its two means over the FSDP group's whole batch
  (``all_reduce_sum``, with a gradient) before their product, as JAX
  takes them over the global batch.

Every process of a tensor (expert) group takes the same rows, so the
reduced activations are the same bits on each: gloo's all-reduce hands
every member the same sums.

On a ``seq`` axis the same object carries the sequence's split to the
blocks (``seq``, a ``p2p.AxisGroup``; None where the axis is 1): the
attention dispatch (``ops/attention.py``) runs ring, Ulysses or the
gathered attention over it, the model offsets its positions, and the MoE
routing counts the preceding blocks' tokens (``models/moe.py``). Under
``tensor`` x ``seq`` each process runs the sequence-parallel attention on
its H / t heads (heads are independent).
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from tpuflow_torch.parallel.p2p import AxisGroup

_TENSOR, _EXPERT = "tensor", "expert"
# How a GPT-2 block (and the root) uses each parameter over a model axis:
# the torch dim of which a process takes its block; unlisted = used whole.
_USE = {
    "c_attn.weight": {_TENSOR: 0},
    "c_attn.bias": {_TENSOR: 0},
    "c_proj.weight": {_TENSOR: 1},
    "mlp_fc.weight": {_TENSOR: 0},
    "mlp_fc.bias": {_TENSOR: 0},
    "mlp_proj.weight": {_TENSOR: 1},
    "moe.w1": {_EXPERT: 0, _TENSOR: 2},
    "moe.w2": {_EXPERT: 0, _TENSOR: 1},
    "moe.b1": {_EXPERT: 0, _TENSOR: 1},
    "moe.b2": {_EXPERT: 0},
}
# Parameters whose tensor block is the process's heads' q, k and v rows.
_HEADS = ("c_attn.weight", "c_attn.bias")
# The row-parallel Dense layers of a block (the others are column-parallel).
_ROW = ("c_proj", "mlp_proj")


def _suffix(name: str) -> str:
    """A parameter's name within its block (``h.3.c_attn.weight`` →
    ``c_attn.weight``); root parameters keep theirs."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "h" else name


class _CopyTo(torch.autograd.Function):
    """f: identity forward, all-reduce (sum) of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """g: all-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        tdist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather(x, dim: int, group) -> torch.Tensor:
    n = tdist.get_world_size(group)
    part = x.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(part) for _ in range(n)]
    tdist.all_gather(parts, part, group=group)
    return torch.cat(parts).movedim(0, dim)


class _Gather(torch.autograd.Function):
    """The blocks of a parameter over the group, whole along ``dim``.
    Backward: ``partial`` (each member used its own part of the whole)
    sums the gradient over the group before keeping the member's block;
    else (every member used the whole the same way) the block alone."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, partial):
        ctx.dim, ctx.group, ctx.rank, ctx.partial = dim, group, rank, partial
        ctx.n = x.shape[dim]
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = g.contiguous().clone()
            tdist.all_reduce(g, group=ctx.group)
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(),
                None, None, None, None)


def all_reduce_sum(x, group):
    """``x`` summed over ``group`` (None or one member: ``x``), with the
    gradient summed over it too (g, then f): every member's loss holds
    the same global sum, and the FSDP step averages the members'
    gradients."""
    if group is None or tdist.get_world_size(group) == 1:
        return x
    return _CopyTo.apply(_ReduceFrom.apply(x, group), group)


class TensorParallel:
    """One process's place in the model-parallel computation of a sharded
    GPT-2 (``mesh``, ``plan``: ``dist.Mesh`` and ``sharding.ShardPlan``):
    the tensor and expert sizes, ranks and groups, the FSDP group (for
    the MoE loss), the ``seq`` peers (``seq``), and for each parameter how
    the model reads it (``view``) and over which groups the train step
    sums its gradient (``grad_sum``), and its data shard of the batch
    (``rows``). The model's blocks, its MoE layers and its root hold it
    as ``tp`` (``attach``)."""

    def __init__(self, mesh, plan, config):
        self.t = mesh.shape.get(_TENSOR, 1)
        self.e = mesh.shape.get(_EXPERT, 1)
        self.tensor_rank = mesh.coord(_TENSOR)
        self.expert_rank = mesh.coord(_EXPERT)
        self.groups = {_TENSOR: mesh.tensor_group, _EXPERT: mesh.expert_group}
        self.ranks = {_TENSOR: self.tensor_rank, _EXPERT: self.expert_rank}
        self.fsdp_group = mesh.fsdp_group if plan.world > 1 else None
        self.seq = AxisGroup.of(mesh, "seq")
        self.tensor = AxisGroup.of(mesh, _TENSOR)
        # The process's rows of the global batch: data shard i of n
        # (``dist.shard_batch``), for the dropout masks.
        self.rows = (mesh.index, plan.world)
        C, H = config.n_embd, config.n_head
        if H % self.t or (4 * C) % self.t:
            raise ValueError(f"tensor={self.t} must divide the heads ({H}) "
                             f"and the MLP width ({4 * C})")
        if config.n_experts and config.n_experts % self.e:
            raise ValueError(f"expert={self.e} must divide the experts "
                             f"({config.n_experts})")
        self.n_embd = C
        # Per parameter name within a block: the view's steps over the
        # model axes, (axis, "slice" | "heads" | "gather_heads" |
        # "gather_whole", dim); a block held as it is used takes none.
        self.steps: dict[str, list] = {}
        self.grad_sum: dict[str, list] = {}
        for name in plan.names:
            steps, sums = [], []
            use = _USE.get(_suffix(name), {})
            for axis in (_EXPERT, _TENSOR):
                size = self.t if axis == _TENSOR else self.e
                if size == 1:
                    continue
                want, held = use.get(axis), plan.split[name].get(axis)
                heads = _suffix(name) in _HEADS and axis == _TENSOR
                if want is None and held is not None:
                    steps.append((axis, "gather_whole", held))
                elif want is not None and held is None:
                    steps.append((axis, "heads" if heads else "slice", want))
                    sums.append(axis)
                elif want is not None:
                    if want != held:
                        raise ValueError(f"{name}: the rule splits dim {held}"
                                         f" over {axis}, the model uses "
                                         f"dim {want}")
                    if heads:
                        steps.append((axis, "gather_heads", want))
                # else: used whole and held whole.
            self.steps[_suffix(name)] = steps
            if sums:
                self.grad_sum[name] = sums

    # -------------------------------------------------------- the views
    def _head_rows(self, device) -> torch.Tensor:
        """The rows of a (3C, .) fused qkv weight (or a 3C bias) that
        hold this process's heads' q, k and v."""
        C, t, r = self.n_embd, self.t, self.tensor_rank
        block = torch.arange(r * C // t, (r + 1) * C // t, device=device)
        return torch.cat([block, block + C, block + 2 * C])

    def view(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """Parameter ``name`` (within a block, or a root one) as this
        process computes with it, from its held value ``p``."""
        for axis, kind, dim in self.steps.get(name, ()):
            group, rank = self.groups[axis], self.ranks[axis]
            size = self.t if axis == _TENSOR else self.e
            if kind == "gather_whole":
                p = _Gather.apply(p, dim, group, rank, False)
            elif kind == "gather_heads":
                p = _Gather.apply(p, dim, group, rank, True)
                p = p.index_select(dim, self._head_rows(p.device))
            elif kind == "heads":
                p = p.index_select(dim, self._head_rows(p.device))
            else:  # slice
                n = p.shape[dim] // size
                p = p.narrow(dim, rank * n, n)
        return p

    def dense(self, name: str, linear, x, dt) -> torch.Tensor:
        """The block's Dense layer ``name`` in compute dtype ``dt`` on
        this process's part: column-parallel (``c_attn``, ``mlp_fc``) on
        the input through f, row-parallel (``c_proj``, ``mlp_proj``) its
        partial product through g and its bias added after the sum."""
        w = self.view(f"{name}.weight", linear.weight).to(dt)
        x = x.to(dt)
        if name in _ROW:
            return (self.reduce_from(F.linear(x, w), _TENSOR)
                    + linear.bias.to(dt))
        b = self.view(f"{name}.bias", linear.bias).to(dt)
        return F.linear(self.copy_to(x, _TENSOR), w, b)

    # ------------------------------------------------------ collectives
    def copy_to(self, x, axis: str):
        """f over ``axis`` (identity when its size is 1)."""
        group = self.groups[axis]
        return x if group is None else _CopyTo.apply(x, group)

    def reduce_from(self, x, axis: str):
        """g over ``axis`` (identity when its size is 1)."""
        group = self.groups[axis]
        return x if group is None else _ReduceFrom.apply(x, group)

    @torch.no_grad()
    def sum_gradients(self, names: list[str], grads: list[torch.Tensor]
                      ) -> None:
        """Sum, in place, the gradients of the parameters a process uses
        in part but holds whole (``grad_sum``) over their groups, one
        all-reduce a group over one flat bucket."""
        for axis in (_TENSOR, _EXPERT):
            idx = [i for i, n in enumerate(names)
                   if axis in self.grad_sum.get(n, ())]
            if not idx:
                continue
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            tdist.all_reduce(flat, group=self.groups[axis])
            offset = 0
            for i in idx:
                n = grads[i].numel()
                grads[i].copy_(flat[offset:offset + n].view_as(grads[i]))
                offset += n


def attach(model, tp: TensorParallel | None) -> None:
    """Give ``model`` (a GPT-2), its blocks and its MoE layers ``tp``."""
    model.tp = tp
    for block in model.h:
        block.tp = tp
        if hasattr(block, "moe"):
            block.moe.tp = tp
