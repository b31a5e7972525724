"""Multi-process runtime: process group, mesh, batch placement, barriers.

Counterpart of the part of ``tpuflow/dist/mesh.py`` that the port's paths
call. The JAX package runs one process per host over a device mesh and
lets XLA emit the collectives; the port runs one process per card
(``torch.distributed``). Data parallelism holds a full replica in each
process and averages the gradients itself (``average_gradients``); FSDP
(``tpuflow_torch/parallel``) shards the state over the ``data`` x
``fsdp`` processes, the ``tensor`` and ``expert`` axes split the GPT-2
layers and expert stacks over their own groups (``parallel/tensor.py``),
the ``seq`` axis splits the sequence (``parallel/ring_attention.py``,
``parallel/ulysses.py``) and the pipeline mesh's ``stage`` axis the
layers (``parallel/pipeline.py``).

- ``initialize`` (``mesh.py:401``): joins the process group named by
  torch's standard rendezvous variables (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``) or by its arguments, with NCCL on
  CUDA and gloo on the CPU unless ``backend`` says otherwise; a world of
  one process starts nothing. An elastic gang's generation passes its
  plan's rank, world and coordinator (``dist/membership.py``), and
  ``teardown`` abandons a world whose peers may be dead;
  ``process_index``/``process_count`` then read the new world's.
- ``make_mesh`` (``:517``): without ``axes`` the 1-D ``data`` mesh over
  the processes (the data-parallel paths); with ``axes`` the named mesh
  of the JAX package (``data``, ``fsdp``, ``tensor``, ``seq``,
  ``expert``; unlisted ones are 1), whose product must be the world.
  Ranks lie in the JAX device order, ``np.asarray(devices).reshape``
  over the axes in that order, the last fastest: rank r sits at the
  coordinate ``np.unravel_index(r, shape)``, so a port process and a JAX
  device at the same coordinate own the same regions.
  ``make_hybrid_mesh`` (``:568``) lays its DCN axes major.
- ``process_index``/``process_count`` (``:507``/``:512``),
  ``data_axis_size`` (``:676``), ``shard_batch`` (``:704``: this
  process's rows of the global batch), ``place_batch`` (a batch whose
  rows the loader already picked), ``replicate`` (``:770``),
  ``step_fence`` (``:810``) and ``barrier`` (``:820``); ``world_sum`` and
  ``group_sum`` (sums that give every process the same bits).

The compile-cache functions have no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from collections.abc import Mapping

import torch
import torch.distributed as tdist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
# The JAX package's canonical axes (``tpuflow/dist/mesh.py``), in its order.
AXES = (AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, AXIS_SEQ, AXIS_EXPERT)
# The pipeline mesh's axis (``tpuflow/parallel/pipeline.py``), not
# canonical: it sits after ``data``, where JAX's pipeline leg names it.
AXIS_STAGE = "stage"
PIPELINE_AXES = (AXIS_DATA, AXIS_STAGE, AXIS_FSDP, AXIS_TENSOR, AXIS_SEQ,
                 AXIS_EXPERT)


@dataclasses.dataclass
class Mesh:
    """The world as this process sees it: ``shape`` maps each axis to its
    size; ``device`` is this process's device; ``device_mesh`` the torch
    ``DeviceMesh`` over the process group (the ``data`` dim alone, or the
    ``data`` x ``fsdp`` dims of a named mesh; None for one process).
    ``fsdp_mesh`` is the 1-D mesh of those dims flattened, ``data`` major,
    over which FSDP shards and the batch splits, and ``index`` this
    process's place on it (None and 0 for one process); ``full_mesh`` the
    ``DeviceMesh`` over every axis. ``coords`` is this
    process's coordinate on every axis; ``groups`` maps an axis to the
    process group of this process's peers on it (the processes that
    differ from it on that axis alone; absent where the axis has size
    1), ``tensor_group``, ``expert_group``, ``seq_group`` and
    ``stage_group`` naming four. Tensor, expert, seq and stage peers
    share their ``index``: they take the same rows of a batch (seq peers
    each its block of the columns)."""

    shape: dict[str, int]
    device: torch.device
    device_mesh: object | None = None
    fsdp_mesh: object | None = None
    index: int = 0
    coords: dict[str, int] = dataclasses.field(default_factory=dict)
    groups: dict = dataclasses.field(default_factory=dict)
    full_mesh: object | None = None  # the DeviceMesh over every axis

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of this process's peers on ``axis`` (None:
        size 1, or no process group)."""
        return self.groups.get(axis)

    @property
    def tensor_group(self):
        return self.group(AXIS_TENSOR)

    @property
    def expert_group(self):
        return self.group(AXIS_EXPERT)

    @property
    def seq_group(self):
        return self.group(AXIS_SEQ)

    @property
    def stage_group(self):
        return self.group(AXIS_STAGE)

    @property
    def fsdp_group(self):
        """The process group over which FSDP shards (None: one process)."""
        return None if self.fsdp_mesh is None else self.fsdp_mesh.get_group()

    @property
    def fsdp_index(self) -> int:
        """This process's place in the FSDP group, the block of a sharded
        dimension it holds (FSDP2 places shards by group rank)."""
        if self.fsdp_mesh is None:
            return 0
        return self.fsdp_mesh.get_local_rank()

    @property
    def model_parallel(self) -> bool:
        """True when a ``tensor`` or ``expert`` axis exceeds 1."""
        return (self.shape.get(AXIS_TENSOR, 1) > 1
                or self.shape.get(AXIS_EXPERT, 1) > 1)


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(device: str | torch.device = "cuda", *,
               rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None,
               timeout_s: float = 300.0, backend: str | None = None,
               device_index: int | None = None) -> None:
    """Join the process group (no-op for a world of one, or when one is up).

    ``rank``/``world_size`` default to ``RANK``/``WORLD_SIZE``;
    ``init_method`` to ``tcp://MASTER_ADDR:MASTER_PORT``. Every process
    must join within ``timeout_s`` or the formation fails (the reference's
    cluster-formation barrier). ``backend``: None is NCCL on CUDA and gloo
    on the CPU; ``"gloo"`` on CUDA carries the collectives through the
    host, which lets several processes share one card (NCCL refuses two
    ranks of a communicator on one device). On CUDA each process takes
    card ``device_index``, by default ``device``'s index, else
    ``LOCAL_RANK``, else its rank."""
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
        if device_index is None:
            device_index = device.index
        if device_index is None:
            local = _env_int("LOCAL_RANK")
            device_index = local if local is not None else rank
        torch.cuda.set_device(device_index)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    tdist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown() -> None:
    """Leave the process group if one is up."""
    if is_initialized():
        tdist.destroy_process_group()


def teardown() -> None:
    """Abandon the process group without a collective (an elastic re-form:
    peers may be dead). An elastic world is gloo's (``dist/membership.py``
    refuses NCCL), whose destruction waits for no peer: a dead peer's
    sockets are closed already. Then the ``DeviceMesh`` caches are
    emptied, so no mesh or sub-group of the old world reaches the next
    one (the ``Mesh`` objects built over it are the caller's to drop)."""
    if is_initialized():
        tdist.destroy_process_group()
    from torch.distributed.device_mesh import _mesh_resources

    for value in vars(_mesh_resources).values():
        if isinstance(value, (dict, list)):
            value.clear()


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


def make_mesh(device: str | torch.device = "cuda",
              axes: Mapping[str, int] | None = None) -> Mesh:
    """A mesh over every process, this process on its ``device``.

    Without ``axes``: the 1-D ``data`` mesh of the data-parallel paths.
    With ``axes``: the JAX package's named mesh (``tpuflow/dist/mesh.py``
    ``make_mesh``): a size of -1 (at most one) is inferred, unlisted
    canonical axes are 1, and the product must equal the world, else
    ValueError naming both; the process of rank r sits at
    ``np.unravel_index(r, shape)``, the JAX device order (a ``stage``
    axis right after ``data``)."""
    device = local_device(device)
    world = process_count()
    if axes is None:
        device_mesh = None
        if is_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            device_mesh = init_device_mesh(device.type, (world,),
                                           mesh_dim_names=(AXIS_DATA,))
        return Mesh({AXIS_DATA: world}, device, device_mesh,
                    device_mesh, process_index())
    shape = _named_axes(axes, world)
    return _named_mesh(device, shape, list(range(world)))


def axis_order(shape: Mapping[str, int]) -> tuple[str, ...]:
    """The axes of a named mesh's ``shape`` in rank order, the last
    fastest: the canonical ``AXES``, with ``stage`` after ``data`` on a
    pipeline mesh."""
    return PIPELINE_AXES if AXIS_STAGE in shape else AXES


def make_hybrid_mesh(dcn_axes: Mapping[str, int],
                     ici_axes: Mapping[str, int],
                     device: str | torch.device = "cuda") -> Mesh:
    """The named mesh with the ``dcn_axes`` major (``tpuflow/dist/mesh.py``
    ``make_hybrid_mesh``): ranks fill the ``ici_axes`` first, so a DCN
    axis steps over whole groups of consecutive ranks (one group a host,
    where a host holds consecutive ranks). An axis in both maps raises;
    the sizes multiply to the world as in ``make_mesh``."""
    device = local_device(device)
    dcn_axes, ici_axes = dict(dcn_axes), dict(ici_axes)
    overlap = set(dcn_axes) & set(ici_axes)
    if overlap:
        raise ValueError(
            f"axes {sorted(overlap)} appear in both dcn and ici maps")
    if any(v == -1 for v in (*dcn_axes.values(), *ici_axes.values())):
        raise ValueError("-1 axis inference is not supported in hybrid "
                         "meshes; specify every axis size explicitly")
    world = process_count()
    shape = _named_axes({**dcn_axes, **ici_axes}, world)
    # Rank order: the DCN axes major, each map's axes in the mesh's order.
    axes = axis_order(shape)
    order = ([a for a in axes if a in dcn_axes]
             + [a for a in axes if a not in dcn_axes])
    grid = torch.arange(world).reshape([shape[a] for a in order])
    grid = grid.permute([order.index(a) for a in axes])
    return _named_mesh(device, shape, grid.reshape(-1).tolist())


def _named_axes(axes: Mapping[str, int], world: int) -> dict[str, int]:
    axes = dict(axes)
    order = axis_order(axes)
    unknown = [k for k in order if k not in axes]
    extra = sorted(set(axes) - set(order))
    if extra:
        raise ValueError(f"unknown mesh axes {extra}; the axes are {AXES} "
                         f"(and {AXIS_STAGE!r} on a pipeline mesh)")
    inferred = [k for k, v in axes.items() if v == -1]
    if len(inferred) > 1:
        raise ValueError(f"at most one axis may be -1, got {inferred}")
    known = math.prod(v for v in axes.values() if v != -1)
    if inferred:
        if world % known:
            raise ValueError(f"{world} processes not divisible by {known}")
        axes[inferred[0]] = world // known
    total = math.prod(axes.values())
    if total != world:
        raise ValueError(f"mesh {axes} wants {total} processes but the "
                         f"world has {world}")
    for name in unknown:
        axes[name] = 1
    return {k: axes[k] for k in order}


def _named_mesh(device: torch.device, shape: dict[str, int],
                ranks: list[int]) -> Mesh:
    """The ``Mesh`` whose coordinate i (over ``axis_order(shape)``, the
    last axis fastest) is process ``ranks[i]``. Every process builds the
    same groups in the same order (group creation is collective)."""
    axes = tuple(shape)
    if not is_initialized():
        return Mesh(shape, device, coords={a: 0 for a in axes})
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.tensor(ranks).reshape([shape[a] for a in axes])
    full = DeviceMesh(device.type, grid, mesh_dim_names=axes)
    device_mesh = full[AXIS_DATA, AXIS_FSDP]
    flat = device_mesh._flatten(f"{AXIS_DATA}_{AXIS_FSDP}")
    coords = dict(zip(axes, (int(c) for c in full.get_coordinate())))
    groups = {a: full[a].get_group() for a in axes if shape[a] > 1}
    return Mesh(shape, device, device_mesh, flat,
                coords[AXIS_DATA] * shape[AXIS_FSDP] + coords[AXIS_FSDP],
                coords, groups, full)


def data_axis_size(mesh: Mesh) -> int:
    """Number of data shards: the ``data`` x ``fsdp`` processes (the
    reference's world size), over which the batch splits."""
    return mesh.shape[AXIS_DATA] * mesh.shape.get(AXIS_FSDP, 1)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This process's rows of a global batch as tensors on its device: of
    B rows over N data shards, shard i (``mesh.index``) takes rows
    [i B / N, (i + 1) B / N), the JAX batch sharding over (``data``,
    ``fsdp``), data major. Tensor, expert and stage peers take the same
    rows; on a ``seq`` axis of s, the process at seq coordinate c keeps
    columns [c T / s, (c + 1) T / s) of each 2-D entry (the JAX batch
    sharding ``P(("data", "fsdp"), "seq")``). A batch that N does not
    divide, or a sequence that s does not, raises, as the JAX placement
    does."""
    n = data_axis_size(mesh)
    s, c = mesh.shape.get(AXIS_SEQ, 1), mesh.coord(AXIS_SEQ)
    out = {}
    for k, v in batch.items():
        rows = len(v)
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} data shards")
        per = rows // n
        part = v[mesh.index * per:(mesh.index + 1) * per]
        if s > 1 and getattr(part, "ndim", 1) >= 2:
            cols = part.shape[1]
            if cols % s:
                raise ValueError(f"a sequence of {cols} tokens does not "
                                 f"split over seq={s}")
            part = part[:, c * cols // s:(c + 1) * cols // s]
        out[k] = torch.as_tensor(part, device=mesh.device)
    return out


def place_batch(batch: dict, mesh: Mesh) -> dict:
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
    average is the gradient of the global mean, as the JAX step's. The
    reduction runs over the ``data`` x ``fsdp`` group: tensor and expert
    peers hold the same rows. With one process (or no mesh) the gradients
    are returned untouched."""
    if mesh is None or data_axis_size(mesh) == 1 or not grads:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    tdist.all_reduce(flat, group=mesh.fsdp_group)
    flat /= data_axis_size(mesh)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return out


def world_sum(values: torch.Tensor) -> torch.Tensor:
    """The sum over every process of each process's ``values`` (1-D), the
    same bits everywhere: the vectors are all-gathered and summed in rank
    order (an all-reduce may order its sums differently on each
    process). One process: ``values`` itself."""
    return group_sum(values)


def group_sum(values: torch.Tensor, group=None) -> torch.Tensor:
    """``world_sum`` over the processes of ``group`` (None: the world)."""
    if not is_initialized():
        return values
    n = tdist.get_world_size(group)
    if n == 1:
        return values
    out = [torch.empty_like(values) for _ in range(n)]
    tdist.all_gather(out, values.contiguous(), group=group)
    total = out[0].clone()
    for part in out[1:]:
        total += part
    return total


def step_fence(x):
    """The JAX package blocks here on a multi-device CPU simulation whose
    collectives would otherwise time out; PyTorch runs the CPU eagerly and
    each process owns one device, so no platform needs it: a
    pass-through."""
    return x


def barrier(mesh: Mesh | None = None) -> None:
    """Block until every process reaches this point (a no-op for one)."""
    if is_initialized() and process_count() > 1:
        if (mesh is not None and mesh.device.type == "cuda"
                and tdist.get_backend() == "nccl"):
            tdist.barrier(device_ids=[mesh.device.index])
        else:
            tdist.barrier()
