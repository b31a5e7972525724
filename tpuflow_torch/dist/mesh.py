"""Data-parallel runtime: process group, mesh, batch placement, barriers.

Counterpart of the part of ``tpuflow/dist/mesh.py`` that the main path
calls. The JAX package runs one process per host over a device mesh and
lets XLA emit the gradient all-reduce; the port runs one process per card
(``torch.distributed``), each holding a full replica, and averages the
gradients itself (``average_gradients``) before every update.

- ``initialize`` (``mesh.py:401``): joins the process group named by
  torch's standard rendezvous variables (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``) or by its arguments, with NCCL on
  CUDA and gloo on the CPU; a world of one process starts nothing.
- ``make_mesh`` (``:517``): a 1-D ``data`` mesh over the processes (a
  ``DeviceMesh`` when a process group is up, none for one process).
- ``process_index``/``process_count`` (``:507``/``:512``),
  ``data_axis_size`` (``:676``), ``shard_batch`` (``:704``), ``replicate``
  (``:770``), ``step_fence`` (``:810``) and ``barrier`` (``:820``).

Not here yet (ROADMAP Queue 1 item 5): ``make_hybrid_mesh``, FSDP and the
compile-cache functions.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as tdist

AXIS_DATA = "data"


@dataclasses.dataclass
class Mesh:
    """The data-parallel world as this process sees it: ``shape`` maps the
    one axis, ``data``, to the process count; ``device`` is this process's
    device; ``device_mesh`` the torch ``DeviceMesh`` over the process group
    (None for one process)."""

    shape: dict[str, int]
    device: torch.device
    device_mesh: object | None = None


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(device: str | torch.device = "cuda", *,
               rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None,
               timeout_s: float = 300.0) -> None:
    """Join the process group (no-op for a world of one, or when one is up).

    ``rank``/``world_size`` default to ``RANK``/``WORLD_SIZE``;
    ``init_method`` to ``tcp://MASTER_ADDR:MASTER_PORT``. Every process
    must join within ``timeout_s`` or the formation fails (the reference's
    cluster-formation barrier). On CUDA each process takes card
    ``LOCAL_RANK`` (default: its rank)."""
    if is_initialized():
        return
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if world is None or world <= 1:
        return
    rank = rank if rank is not None else _env_int("RANK")
    if rank is None:
        raise ValueError(f"a world of {world} processes needs a rank "
                         "(argument or RANK)")
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
        if not port:
            raise ValueError("a multi-process world needs init_method or "
                             "MASTER_PORT")
        init_method = f"tcp://{addr}:{port}"
    device = torch.device(device)
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else rank)
    tdist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown() -> None:
    """Leave the process group if one is up."""
    if is_initialized():
        tdist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return tdist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """Processes in the world (1 without a process group)."""
    return tdist.get_world_size() if is_initialized() else 1


def local_device(device: str | torch.device) -> torch.device:
    """This process's device of ``device``'s type: on CUDA the card the
    process took in ``initialize``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(device: str | torch.device = "cuda") -> Mesh:
    """The 1-D ``data`` mesh over every process, this process on its
    ``device``."""
    device = local_device(device)
    world = process_count()
    device_mesh = None
    if is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device.type, (world,),
                                       mesh_dim_names=(AXIS_DATA,))
    return Mesh({AXIS_DATA: world}, device, device_mesh)


def data_axis_size(mesh: Mesh) -> int:
    """Number of data-parallel shards (the reference's world size)."""
    return mesh.shape[AXIS_DATA]


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This process's rows of a batch (host arrays or tensors: the loader
    already handed this process its shard) as tensors on its device."""
    return {k: torch.as_tensor(v, device=mesh.device)
            for k, v in batch.items()}


@torch.no_grad()
def replicate(tensors, mesh: Mesh):
    """Make every process hold rank 0's values of ``tensors`` (in place,
    by broadcast; the reference's DDP broadcast at wrap time). A no-op for
    one process. Returns ``tensors``."""
    if data_axis_size(mesh) > 1:
        for t in tensors:
            tdist.broadcast(t, src=0)
    return tensors


@torch.no_grad()
def average_gradients(grads: list[torch.Tensor], mesh: Mesh | None
                      ) -> list[torch.Tensor]:
    """The gradients averaged over the ``data`` axis: one all-reduce over
    one flat bucket, then a division by the world size. Every process's
    loss is the mean over its equal share of the global batch, so the
    average is the gradient of the global mean, as the JAX step's. With
    one process (or no mesh) the gradients are returned untouched."""
    if mesh is None or data_axis_size(mesh) == 1:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    tdist.all_reduce(flat)
    flat /= data_axis_size(mesh)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return out


def step_fence(x):
    """The JAX package blocks here on a multi-device CPU simulation whose
    collectives would otherwise time out; PyTorch runs the CPU eagerly and
    each process owns one device, so no platform needs it: a
    pass-through."""
    return x


def barrier(mesh: Mesh | None = None) -> None:
    """Block until every process reaches this point (a no-op for one)."""
    if is_initialized() and process_count() > 1:
        if mesh is not None and mesh.device.type == "cuda":
            tdist.barrier(device_ids=[mesh.device.index])
        else:
            tdist.barrier()
