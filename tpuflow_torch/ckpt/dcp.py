"""The ``dcp`` checkpoint format: a step's tensors written and read by
``torch.distributed.checkpoint``.

Counterpart of the JAX package's ``orbax`` format
(``tpuflow/ckpt/manager.py:168-191``, restore ``:1310-1330``): the
``CheckpointManager`` keeps the same step directories, commit marker,
metrics history and retention and only the ``state`` directory changes
hands. A sharded state's pieces (``raw.Piece`` with their ``spec`` and
``mesh``) become ``DTensor``s placed on the mesh's ``DeviceMesh`` (one
``Shard`` a mesh axis that splits a dim, ``Replicate`` otherwise), so DCP
writes each distinct region once and a restore at another world reads
the regions it asks for from whatever files hold them. Leaves every
process holds whole (scalars, a one-process state) are plain tensors.

A DCP step cannot cross into the JAX package: Orbax's OCDBT layout is not
DCP's, and neither reads the other's. Use the ``raw`` format (the default)
for checkpoints that cross. DCP keeps no checksums of its own:
``CheckpointManager.verify_step`` of a DCP step checks that its metadata
reads and that every file it names holds the bytes it names (``verify``),
and a restore has no corrupt-step fallback.
"""

from __future__ import annotations

import os

import torch

from tpuflow_torch.ckpt.raw import Piece, flatten, map_leaves

METADATA = ".metadata"  # DCP's own metadata file


def is_dcp(directory: str) -> bool:
    """True when ``directory`` (a step's ``state``) holds a DCP save."""
    return os.path.exists(os.path.join(directory, METADATA))


def verify(directory: str) -> bool:
    """True when the DCP save in ``directory`` is whole: its metadata
    reads, and every storage file it names exists and reaches the end of
    each record in it (a truncated or missing file fails)."""
    from torch.distributed.checkpoint import FileSystemReader

    try:
        meta = FileSystemReader(directory).read_metadata()
        ends: dict[str, int] = {}
        for info in meta.storage_data.values():
            ends[info.relative_path] = max(ends.get(info.relative_path, 0),
                                           info.offset + info.length)
    except Exception:  # noqa: BLE001 - an unreadable file is a failed verify
        return False
    return all(os.path.isfile(os.path.join(directory, name))
               and os.path.getsize(os.path.join(directory, name)) >= end
               for name, end in ends.items())


def _placements(spec, mesh) -> list:
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec) if e is not None
                    and axis in (e if isinstance(e, tuple) else (e,))),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def _strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _dtensor(piece: Piece, local: torch.Tensor):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), piece.mesh,
                              _placements(piece.spec, piece.mesh),
                              run_check=False, shape=torch.Size(piece.shape),
                              stride=_strides(piece.shape))


def _device(mesh) -> torch.device:
    if mesh is not None and mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def save(directory: str, tree) -> int:
    """Write ``tree`` (tensors and ``Piece``s) into ``directory`` with
    ``torch.distributed.checkpoint`` (a collective over the world when one
    is up). Returns the bytes this process owns."""
    import torch.distributed.checkpoint as dcp

    nbytes = 0

    def leaf(x):
        nonlocal nbytes
        if isinstance(x, Piece):
            if x.owner:
                nbytes += x.data.numel() * x.data.element_size()
            if x.mesh is None:
                return x.data.detach()
            return _dtensor(x, x.data.detach())
        return x.detach()

    sd = map_leaves(leaf, tree)
    up = torch.distributed.is_available() and torch.distributed.is_initialized()
    if not up or torch.distributed.get_rank() == 0:
        nbytes += sum(t.numel() * t.element_size() for _, t in flatten(tree)
                      if not isinstance(t, Piece))
    os.makedirs(directory, exist_ok=True)
    dcp.save(sd, checkpoint_id=directory, no_dist=not up)
    return nbytes


def load(directory: str, template, subtree: tuple | None = None) -> tuple:
    """The leaves of ``template`` (tensors, ``meta`` ones included, or
    ``Piece``s naming this process's regions) read from the DCP save in
    ``directory`` (``subtree``: the template is that subtree's); returns
    (the tree of tensors, this process's regions as local tensors; the
    bytes read)."""
    import torch.distributed.checkpoint as dcp

    if template is None:
        raise ValueError("a DCP checkpoint restores into a template "
                         "(abstract_state)")
    nbytes = 0

    def leaf(x):
        nonlocal nbytes
        if isinstance(x, Piece):
            local = torch.empty(tuple(x.data.shape), dtype=x.data.dtype,
                                device=_device(x.mesh))
            nbytes += local.numel() * local.element_size()
            return local if x.mesh is None else _dtensor(x, local)
        out = torch.empty(tuple(x.shape), dtype=x.dtype)
        nbytes += out.numel() * out.element_size()
        return out

    sd = map_leaves(leaf, template)
    for key in reversed(subtree or ()):
        sd = {key: sd}
    up = torch.distributed.is_available() and torch.distributed.is_initialized()
    dcp.load(sd, checkpoint_id=directory, no_dist=not up)
    for key in subtree or ():
        sd = sd[key]
    return map_leaves(lambda t: t.to_local() if hasattr(t, "to_local")
                      else t, sd), nbytes
