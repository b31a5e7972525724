"""The ``tpuflow-raw-v2`` checkpoint format, for trees of torch tensors.

Counterpart of ``tpuflow/ckpt/raw.py``, byte-compatible with it: a
directory holds ``manifest.json`` and one binary file per leaf shard,
written with fsync and read back by plain file calls. The manifest is

    {"format": "tpuflow-raw-v2", "process_count": 1, "leaves": [
      {"path": [...], "shape": [...], "dtype": "<f4",
       "shards": [{"file": "leaf_00000_0x0.bin", "start": [0, 0],
                   "shape": [...], "crc32": ...}]}, ...]}

with the leaves in the order ``jax.tree_util`` flattens the same tree (a
tree here is nested dicts with string keys, walked in sorted key order),
dtypes spelled as numpy's ``.str`` (bfloat16 as ``"bfloat16"``) and each
shard's crc32 verified when it is read back. A JAX checkpoint of the same
state therefore has the same manifest, leaf for leaf, and either package
restores the other's.

The port runs in one process and keeps each leaf whole: one shard per
leaf, ``process_count`` 1. Not here yet (ROADMAP Queue 1 item 6): the
recycle pool, the restore arena and prewarm, zero-copy (mmap) restore and
multi-process manifest fragments. The JAX package writes and reads
through a striped threaded C++ library; a copy of it was no faster than
these plain calls on the H100 machine's host disk (PERF.md), so the port
has none.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import math
import os
import random
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

MANIFEST = "manifest.json"
FORMAT_NAME = "tpuflow-raw-v2"

# Manifest dtype spellings (numpy's little-endian ``.str``; bfloat16, which
# numpy lacks, by name as ml_dtypes registers it).
_DTYPE_STR = {
    torch.float64: "<f8", torch.float32: "<f4", torch.float16: "<f2",
    torch.bfloat16: "bfloat16", torch.int64: "<i8", torch.int32: "<i4",
    torch.int16: "<i2", torch.int8: "|i1", torch.uint8: "|u1",
    torch.bool: "|b1",
}
_STR_DTYPE = {v: k for k, v in _DTYPE_STR.items()}


class CorruptShardError(RuntimeError):
    """A shard file's bytes do not match the manifest (crc32 mismatch or
    truncation). Restores raise it rather than return corrupted weights;
    the CheckpointManager catches it to fall back to the previous step."""


class CheckpointIOError(OSError):
    """A storage operation failed for good: a permanent error (EACCES,
    EROFS, ...) or a transient one that outlived the retry budget
    (``retry_io``). A save that dies this way fails that step's save
    cleanly; restores let it propagate."""


# Errnos worth retrying: the storage hiccuped but a fresh attempt may
# succeed. ENOSPC/EDQUOT count as transient: retention frees space between
# attempts.
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name)
    for name in (
        "EIO", "EAGAIN", "EBUSY", "EINTR", "ETIMEDOUT", "ESTALE",
        "ENOSPC", "EDQUOT", "ENETDOWN", "ENETUNREACH", "ENETRESET",
        "ECONNRESET", "ECONNABORTED", "EREMOTEIO", "ENOLINK",
    )
    if hasattr(errno, name)
)
# Structural absence is an answer callers branch on (is this step
# committed?), not a storage failure: re-raised unchanged.
_STRUCTURAL_ERRNOS = frozenset({errno.ENOENT, errno.ENOTDIR, errno.EISDIR})


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """The retry budget of one storage operation and the backoff before
    its first retry (doubled per attempt, with 50-100% jitter)."""

    retries: int = 4
    backoff_s: float = 0.05


def io_transient(e: OSError) -> bool:
    """An error without an errno counts as transient: retrying a permanent
    one costs a few bounded attempts, not retrying a transient one fails a
    save that would have succeeded."""
    return e.errno is None or e.errno in _TRANSIENT_ERRNOS


def retry_io(fn: Callable[[], Any], *, op: str, path: str = "",
             retries: int = 4, backoff_s: float = 0.05,
             sleep: Callable[[float], None] = time.sleep):
    """Run one storage operation, retrying transient ``OSError``s up to
    ``retries`` times with jittered exponential backoff from
    ``backoff_s``. A permanent error or an exhausted budget raises
    :class:`CheckpointIOError`; ENOENT and its kind re-raise unchanged;
    ``CorruptShardError`` is never retried. ``fn`` must be safe to re-run
    from scratch."""
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except CorruptShardError:
            raise
        except OSError as e:
            if isinstance(e, CheckpointIOError):
                raise  # a nested retry_io already classified it
            if e.errno in _STRUCTURAL_ERRNOS:
                raise
            where = path or "<unknown>"
            if not io_transient(e):
                raise CheckpointIOError(
                    f"{op} {where}: permanent storage error: {e}") from e
            if attempt > retries:
                raise CheckpointIOError(
                    f"{op} {where}: transient storage error persisted "
                    f"through {attempt} attempts: {e}") from e
            sleep(backoff_s * 2 ** (attempt - 1) * (0.5 + 0.5 * random.random()))


def _retry(policy: RetryPolicy, fn, op: str, path: str):
    return retry_io(fn, op=op, path=path, retries=policy.retries,
                    backoff_s=policy.backoff_s)


def _crc32(buf: np.ndarray) -> int:
    return zlib.crc32(memoryview(buf))


def _check_shard_bytes(path: str, shard: dict, buf, nbytes: int) -> None:
    """Compare just-read shard bytes against the manifest record; shards
    saved without a ``crc32`` pass."""
    want = shard.get("crc32")
    if want is None:
        return
    got = _crc32(buf)
    if got != int(want):
        raise CorruptShardError(
            f"{path}: crc32 mismatch (manifest {int(want)}, file {got}, "
            f"{nbytes} bytes): shard corrupted on storage")


# ------------------------------------------------------------------ trees
def flatten(tree, prefix: tuple[str, ...] = ()) -> list[tuple[list[str], Any]]:
    """``(path, leaf)`` pairs of a nested-dict tree in ``jax.tree_util``'s
    order (sorted keys at every level)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += flatten(tree[key], (*prefix, str(key)))
        return out
    return [(list(prefix), tree)]


def unflatten(pairs) -> dict:
    """The nested dict of ``(path, leaf)`` pairs."""
    root: dict = {}
    for names, leaf in pairs:
        node = root
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = leaf
    return root


def dtype_str(dtype: torch.dtype) -> str:
    try:
        return _DTYPE_STR[dtype]
    except KeyError:
        raise TypeError(f"no manifest spelling for {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _STR_DTYPE[name]
    except KeyError:
        raise TypeError(f"unsupported checkpoint dtype {name!r}") from None


def _to_host(leaf: torch.Tensor) -> torch.Tensor:
    """A private contiguous CPU copy of one leaf (the device→host stage:
    training may update the original in place right after)."""
    return leaf.detach().contiguous().to("cpu", copy=True)


def _bytes(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as a contiguous uint8 array (a view)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _gather_host(tree) -> list[tuple[list[str], torch.Tensor]]:
    return [(names, _to_host(leaf)) for names, leaf in flatten(tree)]


def write_file(path: str, buf: np.ndarray) -> None:
    """Write ``buf``'s bytes to ``path`` and fsync them."""
    with open(path, "wb") as fh:
        fh.write(memoryview(buf))
        fh.flush()
        os.fsync(fh.fileno())


def read_file(path: str, nbytes: int) -> np.ndarray:
    """The first ``nbytes`` of ``path`` as a uint8 array; a shorter file
    raises OSError(EIO)."""
    buf = np.fromfile(path, np.uint8, count=nbytes)
    if buf.nbytes != nbytes:
        raise OSError(errno.EIO, f"short read: {buf.nbytes} of {nbytes} "
                      "bytes", path)
    return buf


# ------------------------------------------------------------------- save
def _write_entries(directory: str, host_leaves, policy: RetryPolicy,
                   workers: int = 4) -> int:
    """Write every leaf as one shard file plus the manifest; returns the
    payload bytes. Files go through a small thread pool, so one file's
    fsync overlaps the next file's copy."""
    manifest = {"format": FORMAT_NAME, "process_count": 1, "leaves": []}
    jobs = []
    for i, (names, t) in enumerate(host_leaves):
        buf = _bytes(t)
        coord = "x".join("0" * t.dim()) or "0"
        fname = f"leaf_{i:05d}_{coord}.bin"
        jobs.append((fname, buf))
        manifest["leaves"].append({
            "path": names, "shape": list(t.shape),
            "dtype": dtype_str(t.dtype),
            "shards": [{"file": fname, "start": [0] * t.dim(),
                        "shape": list(t.shape), "crc32": _crc32(buf)}],
        })

    def write_one(fname, buf):
        dst = os.path.join(directory, fname)
        _retry(policy, lambda: write_file(dst, buf), "write_shard", dst)

    with ThreadPoolExecutor(max_workers=max(1, min(workers, len(jobs)))) as ex:
        for fut in [ex.submit(write_one, f, b) for f, b in jobs]:
            fut.result()  # the first write error propagates
    unified = os.path.join(directory, MANIFEST)

    def write_manifest():
        with open(unified, "w") as f:
            json.dump(manifest, f)

    _retry(policy, write_manifest, "write_manifest", unified)
    return sum(b.nbytes for _, b in jobs)


def save_raw(directory: str, tree, *, policy: RetryPolicy = RetryPolicy()
             ) -> int:
    """Write ``tree`` synchronously; returns the payload bytes."""
    os.makedirs(directory, exist_ok=True)
    return _write_entries(directory, _gather_host(tree), policy)


class AsyncRawSaver:
    """Asynchronous save: the device→host copy happens in ``save`` (the
    caller may update its tensors right after), the file IO on a
    background thread. ``on_commit(nbytes)`` runs on that thread strictly
    after every shard and the manifest are on disk. A failure surfaces at
    the next ``wait``. ``gather_s`` is the last save's host-copy seconds
    (the part the caller waits for)."""

    def __init__(self, policy: RetryPolicy = RetryPolicy()):
        self.policy = policy
        self.gather_s = 0.0
        self._thread: threading.Thread | None = None
        self._error: list[BaseException] = []

    def save(self, directory: str, tree, *, on_commit=None) -> None:
        self.wait()
        os.makedirs(directory, exist_ok=True)
        t0 = time.monotonic()
        host_leaves = _gather_host(tree)
        self.gather_s = time.monotonic() - t0

        def write():
            try:
                nbytes = _write_entries(directory, host_leaves, self.policy)
                if on_commit is not None:
                    on_commit(nbytes)
            except BaseException as e:  # surfaced by the next wait()
                self._error.append(e)

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()


# ---------------------------------------------------------------- restore
def is_raw(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, MANIFEST))


def read_manifest(directory: str, policy: RetryPolicy = RetryPolicy()
                  ) -> dict:
    path = os.path.join(directory, MANIFEST)

    def read():
        with open(path) as f:
            return json.load(f)

    m = _retry(policy, read, "read_manifest", path)
    if m.get("format") != FORMAT_NAME:
        raise ValueError(f"{directory}: not a {FORMAT_NAME} checkpoint")
    return m


def payload_bytes(directory: str, subtree: tuple[str, ...] | None = None
                  ) -> int:
    """The bytes of the shard files a restore of ``directory`` (or of its
    ``subtree``) reads."""
    n = len(subtree) if subtree else 0
    return sum(
        _nbytes(shard["shape"], torch_dtype(e["dtype"]))
        for e in read_manifest(directory)["leaves"]
        if not subtree or tuple(e["path"][:n]) == tuple(subtree)
        for shard in e["shards"]
    )


def _nbytes(shape, dtype: torch.dtype) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    return math.prod(shape) * itemsize


def _read_shard(directory: str, shard: dict, dtype: torch.dtype,
                policy: RetryPolicy) -> torch.Tensor:
    """Read one shard file, crc-verified against the manifest."""
    nbytes = _nbytes(shard["shape"], dtype)
    path = os.path.join(directory, shard["file"])
    # Truncation pre-check: a short file fails here as corruption, not as
    # a (retried) short read.
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise CorruptShardError(f"{path}: unreadable shard ({e})") from e
    if size < nbytes:
        raise CorruptShardError(
            f"{path}: truncated shard ({size} bytes, manifest expects "
            f"{nbytes})")
    buf = _retry(policy, lambda: read_file(path, nbytes), "read_shard", path)
    _check_shard_bytes(path, shard, buf, nbytes)
    return torch.from_numpy(buf).view(dtype).reshape(shard["shape"])


def _read_leaf(directory: str, entry: dict, policy: RetryPolicy
               ) -> torch.Tensor:
    dtype = torch_dtype(entry["dtype"])
    shards = entry["shards"]
    if len(shards) == 1 and shards[0]["shape"] == entry["shape"]:
        return _read_shard(directory, shards[0], dtype, policy)
    # A leaf saved as several shards (by a sharded JAX run): assemble it.
    full = torch.empty(entry["shape"], dtype=dtype)
    for shard in shards:
        idx = tuple(slice(s, s + n)
                    for s, n in zip(shard["start"], shard["shape"]))
        full[idx] = _read_shard(directory, shard, dtype, policy)
    return full


def verify_dir(directory: str, policy: RetryPolicy = RetryPolicy()
               ) -> tuple[int, list[str]]:
    """Recompute every shard file's crc32 against the manifest: returns
    ``(shards_checked, bad_files)``. A non-raw directory checks nothing."""
    if not is_raw(directory):
        return 0, []
    checked, bad, seen = 0, [], set()
    for entry in read_manifest(directory, policy)["leaves"]:
        dtype = torch_dtype(entry["dtype"])
        for shard in entry["shards"]:
            fname = shard["file"]
            if fname in seen or shard.get("crc32") is None:
                continue
            seen.add(fname)
            checked += 1
            nbytes = _nbytes(shard["shape"], dtype)
            try:
                with open(os.path.join(directory, fname), "rb") as f:
                    data = f.read()
            except OSError:
                bad.append(fname)
                continue
            if len(data) < nbytes or \
                    zlib.crc32(data[:nbytes]) != int(shard["crc32"]):
                bad.append(fname)
    return checked, bad


def restore_raw(directory: str, template=None, *,
                subtree: tuple[str, ...] | None = None,
                policy: RetryPolicy = RetryPolicy()) -> dict:
    """Restore a raw checkpoint as a nested dict of CPU tensors.

    - ``subtree``: only the leaves under this path prefix, returned as
      that subtree (e.g. ``("params",)`` for a weights-only restore);
      KeyError when there is none.
    - ``template``: a nested dict with the same leaves (tensors, any
      device, ``meta`` included); paths and shapes must match the
      manifest's (ValueError otherwise) and each leaf is cast to the
      template's dtype (a bfloat16 checkpoint restores into float32).

    The caller copies the tensors into place."""
    entries = read_manifest(directory, policy)["leaves"]
    n = len(subtree) if subtree else 0
    if subtree:
        entries = [e for e in entries
                   if tuple(e["path"][:n]) == tuple(subtree)]
        if not entries:
            raise KeyError(f"no leaves under {subtree} in {directory}")
    pairs = [(e["path"][n:], _read_leaf(directory, e, policy))
             for e in entries]
    if template is not None:
        want = flatten(template)
        got_paths = [p for p, _ in pairs]
        want_paths = [p for p, _ in want]
        if got_paths != want_paths:
            missing = [p for p in want_paths if p not in got_paths][:3]
            extra = [p for p in got_paths if p not in want_paths][:3]
            raise ValueError(
                f"{directory}: checkpoint leaves differ from the template "
                f"({len(got_paths)} vs {len(want_paths)}; missing "
                f"{missing}, unexpected {extra})")
        out = []
        for (names, arr), (_, tmpl) in zip(pairs, want):
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"{'/'.join(names)}: checkpoint shape "
                    f"{tuple(arr.shape)}, template {tuple(tmpl.shape)}")
            out.append((names, arr.to(tmpl.dtype)))
        pairs = out
    if len(pairs) == 1 and not pairs[0][0]:
        return pairs[0][1]  # the subtree was a single leaf
    return unflatten(pairs)
