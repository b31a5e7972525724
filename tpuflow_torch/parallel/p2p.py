"""Differentiable collectives on one axis's process group: the port's
counterparts of the ``jax.lax`` collectives the JAX package's sequence
and pipeline parallelism use inside ``shard_map``.

- ``ppermute(x, peers, perm)``: each process sends ``x`` to the peer
  ``perm`` maps it to and takes what its own source sent (zeros where
  none sends to it), ``jax.lax.ppermute``; the backward is the same
  shift with ``perm`` inverted (JAX's transpose of ``ppermute``). The
  ring (``ring_attention.py``) shifts its key and value blocks to the
  right neighbour with it, the pipeline (``pipeline.py``) its
  activations to the next stage.
- ``all_to_all(x, peers, split_dim, concat_dim)``: ``x`` cut into as many
  equal blocks along ``split_dim`` as the group has processes, block j
  sent to process j, the received blocks laid side by side along
  ``concat_dim`` in group order (``jax.lax.all_to_all(..., tiled=True)``);
  the backward is the opposite all-to-all. Ulysses (``ulysses.py``) swaps
  its sequence and head dimensions with it.
- ``all_gather(x, peers, dim)``: the processes' blocks side by side along
  ``dim``; the backward sums the gradient over the group and keeps this
  process's block (a reduce-scatter). The gathered attention under a
  ``seq`` mesh (``ops/attention.py``) takes the whole sequence with it.

``AxisGroup`` names one axis's peers: the process group, this process's
place in it and its size.

Transport. NCCL (one process a card) carries CUDA tensors itself: the
plain ``batch_isend_irecv`` and ``all_to_all_single``. Two processes
sharing one card must use gloo (NCCL refuses two ranks of a communicator
on a device), and gloo's ``send``/``recv`` read the tensor's memory from
the host: on an H100 a CUDA tensor's send aborted its process (``writev
... Bad address``, ``chip_smoke.py --p2p-probe``). So on gloo a CUDA
tensor's shift is staged through page-locked host buffers (a copy off
the card, the send and receive of host tensors, a copy back), always,
not as a fallback. gloo's ``all_to_all_single`` takes CUDA tensors itself
(the probe held 64 MB of it bit-equal to the host's exchange), as its
``all_gather`` and ``all_reduce`` do. A backend other than NCCL and gloo
raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis's peers of this process: ``group`` the process group
    (None: no other process), ``rank`` this process's place in it (its
    coordinate on the axis), ``size`` the axis size."""

    group: object | None
    rank: int
    size: int

    @classmethod
    def of(cls, mesh, axis: str) -> "AxisGroup | None":
        """The peers on ``axis`` of a ``dist.Mesh`` (None: size 1)."""
        size = mesh.shape.get(axis, 1)
        if size == 1:
            return None
        return cls(mesh.group(axis), mesh.coord(axis), size)


def _host_staged(group, x: torch.Tensor) -> bool:
    """True where a point-to-point op must stage ``x`` through the host:
    a CUDA tensor on a gloo group. A backend other than NCCL and gloo
    raises."""
    backend = tdist.get_backend(group)
    if backend not in ("nccl", "gloo"):
        raise NotImplementedError(f"point-to-point on the {backend!r} "
                                  "backend: the port runs nccl and gloo")
    return backend == "gloo" and x.is_cuda


def _host_buffer(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device="cpu",
                       pin_memory=x.is_cuda)


def _shift(x: torch.Tensor, peers: AxisGroup, perm) -> torch.Tensor:
    """One ``ppermute`` exchange (no autograd): send ``x`` to the peer
    ``perm`` maps this process to, return what its source sent (zeros
    where none)."""
    me = peers.rank
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    x = x.contiguous()
    out = torch.zeros_like(x)
    if not dst and not src:
        return out
    staged = _host_staged(peers.group, x)
    send_buf, recv_buf = x, out
    if staged:
        if dst:
            send_buf = _host_buffer(x)
            send_buf.copy_(x)
        if src:
            recv_buf = _host_buffer(x)
    ops = []
    if dst:
        ops.append(tdist.P2POp(tdist.isend, send_buf,
                               tdist.get_global_rank(peers.group, dst[0]),
                               group=peers.group))
    if src:
        ops.append(tdist.P2POp(tdist.irecv, recv_buf,
                               tdist.get_global_rank(peers.group, src[0]),
                               group=peers.group))
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    if staged and src:
        out.copy_(recv_buf)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, peers, perm):
        ctx.peers, ctx.perm = peers, perm
        return _shift(x, peers, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return _shift(g, ctx.peers, back), None, None


def ppermute(x: torch.Tensor, peers: AxisGroup | None, perm) -> torch.Tensor:
    """``jax.lax.ppermute`` over ``peers``: ``perm`` lists (source,
    destination) pairs of group ranks. None (a trivial axis): ``x``."""
    if peers is None or peers.size == 1:
        return x
    return _PPermute.apply(x, peers, tuple(tuple(p) for p in perm))


def ring_perm(size: int) -> list[tuple[int, int]]:
    """Every process to its right neighbour, the last to the first."""
    return [(i, (i + 1) % size) for i in range(size)]


def _exchange(x: torch.Tensor, group, split_dim: int, concat_dim: int
              ) -> torch.Tensor:
    n = tdist.get_world_size(group)
    blocks = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(blocks)
    tdist.all_to_all_single(out, blocks, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_exchange(g.contiguous(), ctx.group, concat_dim, split_dim),
                None, None, None)


def all_to_all(x: torch.Tensor, peers: AxisGroup | None, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    over ``peers`` (None: ``x``). ``x.shape[split_dim]`` must be a
    multiple of the group size."""
    if peers is None or peers.size == 1:
        return x
    if x.shape[split_dim] % peers.size:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {peers.size} processes")
    return _AllToAll.apply(x, peers.group, split_dim, concat_dim)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``x`` over ``group`` side by side along ``dim``, in
    group order (no gradient)."""
    n = tdist.get_world_size(group)
    part = x.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(part) for _ in range(n)]
    tdist.all_gather(parts, part, group=group)
    return torch.cat(parts).movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, peers, dim):
        ctx.peers, ctx.dim, ctx.n = peers, dim, x.shape[dim]
        return gather(x, peers.group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=ctx.peers.group)
        n, r = ctx.n, ctx.peers.rank
        return g.narrow(ctx.dim, r * n, n).contiguous(), None, None


def all_gather(x: torch.Tensor, peers: AxisGroup | None, dim: int
               ) -> torch.Tensor:
    """The blocks of ``x`` over ``peers`` side by side along ``dim``, in
    group order; the gradient reduce-scattered back (None: ``x``)."""
    if peers is None or peers.size == 1:
        return x
    return _AllGather.apply(x, peers, dim)
