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

A process of a one-process run writes each leaf whole, as one shard,
with ``process_count`` 1. With several processes (the port's FSDP, one
process per card) each writes the shards it owns (``Piece``: a leaf's
global shape, the start of the shard and its data; a leaf held whole by
every process is written by process 0, the JAX package's replica 0) and
its own ``manifest.p<rank>.json`` fragment listing them, with the world
as ``process_count``; ``merge_manifests`` unions the fragments into
``manifest.json`` once every process has written, polling briefly for
fragments that storage has not shown yet and failing loudly when some
never appear. A restore reads any layout onto any process count: a
template ``Piece`` names the region this process holds, and only the
shard files that overlap it are read (each whole, its crc32 checked)
and their overlaps copied into place.

The speed machinery is the JAX package's:
- a save writes its files on a thread pool, each task computing its
  file's crc32; a ``RecyclePool`` hands retired shard files back to later
  saves, which overwrite them in place, and ``prewarm`` creates such
  files ahead of the first saves;
- a restore reads one task a shard file on a thread pool, crc-checked in
  the task, into buffers a ``RestoreArena`` backed ahead of time (page
  locked on request, so the copy onto the card is a DMA), or maps the
  files (``zero_copy``), guarded against recycling by an inode registry.
The JAX package writes and reads through a striped threaded C++ library;
a copy of it was no faster than plain file calls on the H100 machine's
host disk (PERF.md), so the port has none.
"""

from __future__ import annotations

import collections
import dataclasses
import errno
import json
import math
import os
import random
import shutil
import threading
import time
import weakref
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from tpuflow_torch import obs
from tpuflow_torch.testing import faults

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


@dataclasses.dataclass
class Piece:
    """One process's part of a leaf that several processes share: the
    leaf's global ``shape``, the ``start`` of the part and its ``data``.
    In a save tree the part is the shard this process writes when it is
    the ``owner`` (a replica of a region several processes hold writes
    nothing; ``data`` None: it holds none of the leaf, ``dtype`` then
    names the leaf's); in a restore template it is the region this
    process reads (``data`` a tensor of the region's extent, ``meta`` will
    do), and the restore returns that region as a tensor. ``spec`` (one
    entry a dimension: None or the mesh axes that split it) and ``mesh``
    (the torch ``DeviceMesh`` over every axis) let a ``torch.distributed
    .checkpoint`` save or restore place the part (``ckpt/dcp.py``)."""

    shape: tuple
    start: list
    data: Any
    dtype: Any = None
    spec: tuple | None = None
    mesh: Any = None
    owner: bool = True

    def __post_init__(self):
        self.shape = tuple(int(n) for n in self.shape)
        self.start = [int(n) for n in self.start]
        if self.data is not None:
            self.dtype = self.data.dtype


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
    ``backoff_s``, one ``ckpt.io_retry`` event a retry. A permanent error
    or an exhausted budget records ``ckpt.io_error`` and raises
    :class:`CheckpointIOError`; ENOENT and its kind re-raise unchanged;
    ``CorruptShardError`` is never retried. ``fn`` must be safe to re-run
    from scratch. An installed ``ckpt_io_flaky`` fault plan fails each
    attempt first (``testing/faults.py::ckpt_io_fault``)."""
    attempt = 0
    while True:
        attempt += 1
        try:
            faults.ckpt_io_fault(op, path)
            return fn()
        except CorruptShardError:
            raise
        except OSError as e:
            if isinstance(e, CheckpointIOError):
                raise  # a nested retry_io already classified it
            if e.errno in _STRUCTURAL_ERRNOS:
                raise
            where = path or "<unknown>"
            name = os.path.basename(path.rstrip(os.sep)) if path else ""
            if not io_transient(e) or attempt > retries:
                obs.event("ckpt.io_error", op=op, path=name, errno=e.errno,
                          attempts=attempt, transient=io_transient(e),
                          error=str(e)[:200])
            if not io_transient(e):
                raise CheckpointIOError(
                    f"{op} {where}: permanent storage error: {e}") from e
            if attempt > retries:
                raise CheckpointIOError(
                    f"{op} {where}: transient storage error persisted "
                    f"through {attempt} attempts: {e}") from e
            delay = backoff_s * 2 ** (attempt - 1) * (
                0.5 + 0.5 * random.random())
            obs.event("ckpt.io_retry", op=op, path=name, attempt=attempt,
                      delay_s=round(delay, 4), error=str(e)[:200])
            sleep(delay)


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
    order: a dict's keys sorted, an ``OrderedDict``'s in insertion order
    (the port's form of a named tuple's fields, an optax state's, which
    the JAX package's manifests list in field order)."""
    if isinstance(tree, dict):
        out = []
        ordered = isinstance(tree, collections.OrderedDict)
        for key in tree if ordered else sorted(tree):
            out += flatten(tree[key], (*prefix, str(key)))
        return out
    return [(list(prefix), tree)]


def map_leaves(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, its nodes' types
    (and so its flatten order) kept."""
    if isinstance(tree, dict):
        return type(tree)((k, map_leaves(fn, v)) for k, v in tree.items())
    return fn(tree)


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


def _gather_host(tree, owner: bool = True
                 ) -> list[tuple[list[str], tuple, torch.dtype, list]]:
    """(path, global shape, dtype, [(start, host copy)]) per leaf: a
    ``Piece``'s one shard (none when it has no data or another process
    owns it), a plain tensor whole
    when this process is the ``owner`` of the leaves every process
    holds."""
    out = []
    for names, leaf in flatten(tree):
        if isinstance(leaf, Piece):
            shards = ([] if leaf.data is None or not leaf.owner
                      else [(list(leaf.start), _to_host(leaf.data))])
            out.append((names, leaf.shape, leaf.dtype, shards))
        else:
            shards = [([0] * leaf.dim(), _to_host(leaf))] if owner else []
            out.append((names, tuple(leaf.shape), leaf.dtype, shards))
    return out


# ------------------------------------------------------------ file calls
_PAGE = 4096
# Shards below this size never draw from or warm the recycle pool: their
# fresh-write cost is noise, and the in-place write's truncation would
# waste a large warm file's pages on them.
_POOL_MIN_BYTES = 64 * 1024


def aligned_empty(nbytes: int, align: int = _PAGE) -> np.ndarray:
    """An uninitialised uint8 buffer of ``nbytes`` whose data starts on an
    ``align`` boundary (the JAX package's ``_native.aligned_empty``)."""
    base = np.empty(nbytes + align, np.uint8)
    off = (-base.ctypes.data) % align
    return base[off:off + nbytes]


def write_file(path: str, buf: np.ndarray, *, inplace: bool = False) -> None:
    """Write ``buf``'s bytes to ``path`` and fsync them. ``inplace``
    overwrites an existing file without truncating it first, so the pages
    it already has are reused (the recycle pool's write), and then cuts it
    to ``buf``'s size."""
    mode = "r+b" if inplace and os.path.exists(path) else "wb"
    with open(path, mode) as fh:
        fh.write(memoryview(buf))
        fh.truncate(buf.nbytes)
        fh.flush()
        os.fsync(fh.fileno())


def read_file(path: str, nbytes: int, *, out: np.ndarray | None = None
              ) -> np.ndarray:
    """The first ``nbytes`` of ``path`` as a uint8 array, read straight
    into ``out`` when given (an arena buffer of that size), else into a
    fresh page-aligned one; a shorter file raises OSError(EIO)."""
    buf = aligned_empty(nbytes) if out is None else out
    view = memoryview(buf)
    got = 0
    with open(path, "rb", buffering=0) as fh:
        while got < nbytes:
            n = fh.readinto(view[got:])
            if not n:
                break
            got += n
    if got != nbytes:
        raise OSError(errno.EIO, f"short read: {got} of {nbytes} bytes",
                      path)
    return buf


# ------------------------------------------------------- aliased inodes
# (st_dev, st_ino) -> live-mapping count of the shard files whose mapped
# pages a zero_copy restore in this process handed to its caller. Those
# tensors alias the files' pages, so the recycle pool must never
# overwrite these inodes in place: adopt_dir and take unlink them instead
# (mapped pages outlive the unlink). A finalizer on each mapping releases
# its count, so a reused inode number is not excluded forever. Another
# process recycling the same directory is not covered (see restore_raw).
_ALIASED_INODES: dict[tuple[int, int], int] = {}
_ALIASED_LOCK = threading.Lock()


def _register_alias_fd(fd: int) -> tuple[int, int]:
    st = os.fstat(fd)
    key = (st.st_dev, st.st_ino)
    with _ALIASED_LOCK:
        _ALIASED_INODES[key] = _ALIASED_INODES.get(key, 0) + 1
    return key


def _unregister_alias(key: tuple[int, int]) -> None:
    with _ALIASED_LOCK:
        n = _ALIASED_INODES.get(key, 0)
        if n <= 1:
            _ALIASED_INODES.pop(key, None)
        else:
            _ALIASED_INODES[key] = n - 1


def _is_aliased(path: str) -> bool:
    try:
        st = os.stat(path)
    except OSError:
        return False
    with _ALIASED_LOCK:
        return (st.st_dev, st.st_ino) in _ALIASED_INODES


def _spare_cores() -> int:
    """Cores free for background page backing beside the one the training
    loop holds (the CPU count less one), read where a prewarm decides.
    With none, a background prewarm parks its work: it runs only in
    ``prewarm_wait`` (whose caller has nothing better to do with the
    core), else never, and the first save or restore pays what it would
    have paid without a prewarm."""
    return max((os.cpu_count() or 1) - 1, 0)


# ---------------------------------------------------------- recycle pool
class RecyclePool:
    """Retired shard files whose pages later saves reuse (counterpart of
    ``tpuflow/ckpt/raw.py::RecyclePool``, with its file names, so either
    package adopts the other's ``.recycle``).

    Retention hands doomed step directories to :meth:`adopt_dir`, which
    renames their ``.bin`` files into the pool; :meth:`take` hands one
    back to a save, which overwrites it in place: on memory-backed storage
    that skips the fresh-page zeroing of a new file. :meth:`prewarm`
    creates zero-filled pool files ahead of the first saves. Thread-safe:
    retention and the saver's writers share one pool. ``taken`` counts
    the files :meth:`take` handed out. Without a spare core a prewarm
    parks (see ``_spare_cores``)."""

    def __init__(self, directory: str, *, policy: RetryPolicy = RetryPolicy()):
        self.directory = directory
        self.policy = policy
        self.taken = 0
        self._lock = threading.Lock()
        self._files: dict[int, list[str]] = {}  # size -> paths
        self._counter = 0
        self._warm_promised: dict[int, int] = {}  # in-flight files by size
        self._warm_threads: list[threading.Thread] = []
        self._warm_cancel = threading.Event()
        self._deferred: list[int] = []  # sizes parked without a spare core
        if os.path.isdir(directory):
            for name in os.listdir(directory):
                path = os.path.join(directory, name)
                try:
                    self._files.setdefault(os.path.getsize(path),
                                           []).append(path)
                except OSError:
                    continue
                # The name counter starts past every surviving pool file,
                # so a restarted process never renames over a pooled inode.
                try:
                    self._counter = max(self._counter,
                                        int(name[1:].split(".")[0]))
                except (ValueError, IndexError):
                    self._counter += 1

    def _next_path(self) -> str:
        """The next pool file name (call with the lock held)."""
        self._counter += 1
        return os.path.join(self.directory, f"r{self._counter:08d}.bin")

    def adopt_dir(self, step_dir: str) -> None:
        """Absorb every ``.bin`` of 64 KiB or more under ``step_dir`` (no
        save draws a smaller one) and delete the rest."""
        # The step becomes invisible before its payload is harvested: a
        # crash mid-adopt must not leave a committed-looking step with
        # shard files missing.
        try:
            os.unlink(os.path.join(step_dir, "metadata.json"))
        except OSError:
            pass
        self.adopt_files(os.path.join(root, name)
                         for root, _, names in os.walk(step_dir)
                         for name in names if name.endswith(".bin"))
        shutil.rmtree(step_dir, ignore_errors=True)

    def adopt_files(self, paths) -> None:
        """Rename each of ``paths`` of 64 KiB or more into the pool (a
        multi-process save's retention: each process adopts the shard
        files it wrote)."""
        for src in paths:
            # An aliased inode backs a live zero-copy restore: its step's
            # deletion unlinks it instead of pooling it.
            if _is_aliased(src):
                continue
            try:
                size = os.path.getsize(src)
            except OSError:
                continue
            if size < _POOL_MIN_BYTES:
                continue
            os.makedirs(self.directory, exist_ok=True)
            with self._lock:
                dst = self._next_path()
                try:
                    os.rename(src, dst)
                except OSError:
                    continue
                self._files.setdefault(size, []).append(dst)

    def take(self, nbytes: int) -> str | None:
        """Pop a pooled file of ``nbytes`` (else the smallest larger one;
        its surplus tail is cut by the write), or None. Requests under 64
        KiB never draw from the pool."""
        if nbytes < _POOL_MIN_BYTES:
            return None
        with self._lock:
            candidates = [nbytes] if nbytes in self._files else []
            candidates += sorted(s for s in self._files if s > nbytes)
            for size in candidates:
                bucket = self._files.get(size, [])
                while bucket:
                    path = bucket.pop()
                    if not bucket:
                        self._files.pop(size, None)
                    if _is_aliased(path):
                        # A zero-copy mapping won the race with adopt_dir:
                        # unlink, never overwrite in place.
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
                        continue
                    self.taken += 1
                    return path
        return None

    def prewarm(self, sizes: list[int]) -> None:
        """Create pool files of exactly ``sizes`` (zero-filled, every page
        written) on a background thread, so the first saves land on
        recycled pages. Files enter the pool one by one. Idempotent
        top-up: a size already pooled or in flight is not booked again.
        Sizes under 64 KiB are skipped."""
        sizes = sorted((s for s in sizes if s >= _POOL_MIN_BYTES),
                       reverse=True)
        with self._lock:
            have = {s: len(v) for s, v in self._files.items()}
            for s, n in self._warm_promised.items():
                have[s] = have.get(s, 0) + n
            todo = []
            for s in sizes:
                if have.get(s, 0) > 0:
                    have[s] -= 1
                else:
                    todo.append(s)
                    self._warm_promised[s] = self._warm_promised.get(s, 0) + 1
            if not todo:
                return
            if _spare_cores() < 1:
                # Parked; the promises stay so a repeat does not re-book.
                self._deferred.extend(todo)
                return
            t = threading.Thread(target=self._prewarm_run, args=(todo,),
                                 daemon=True)
            self._warm_threads.append(t)
        t.start()

    def _release_promise(self, size: int) -> None:
        n = self._warm_promised.get(size, 0)
        if n <= 1:
            self._warm_promised.pop(size, None)
        else:
            self._warm_promised[size] = n - 1

    def _prewarm_run(self, sizes: list[int]) -> None:
        os.makedirs(self.directory, exist_ok=True)
        chunk = 32 * 2**20
        zeros = memoryview(bytes(chunk))

        class _Cancelled(Exception):
            pass

        for i, size in enumerate(sizes):
            with self._lock:
                path = self._next_path()

            def write_warm_file() -> None:
                # "wb" restarts a retried file from scratch: a partial
                # warm file never enters the pool.
                with open(path, "wb", buffering=0) as f:
                    written = 0
                    while written < size:
                        if self._warm_cancel.is_set():
                            raise _Cancelled
                        written += f.write(zeros[:min(chunk, size - written)])

            try:
                if self._warm_cancel.is_set():
                    raise _Cancelled
                _retry(self.policy, write_warm_file, "prewarm", path)
            except (_Cancelled, OSError):
                # Cancelled at close, or storage failed for good: drop the
                # partial file and release every unfulfilled promise so a
                # later prewarm may retry; the saves write fresh files.
                try:
                    os.unlink(path)
                except OSError:
                    pass
                with self._lock:
                    for s in sizes[i:]:
                        self._release_promise(s)
                return
            with self._lock:
                self._files.setdefault(size, []).append(path)
                self._release_promise(size)

    def prewarm_wait(self, timeout: float | None = None) -> None:
        """Block until the prewarmed files exist. Parked work runs here, on
        the caller's thread, in full; ``timeout`` bounds only the joins of
        background threads."""
        with self._lock:
            threads = list(self._warm_threads)
            deferred, self._deferred = self._deferred, []
        if deferred:
            self._prewarm_run(sorted(deferred, reverse=True))
        for t in threads:
            t.join(timeout)
        with self._lock:
            self._warm_threads = [t for t in self._warm_threads
                                  if t.is_alive()]

    def cancel_prewarm(self) -> None:
        """Stop in-flight prewarms promptly and join them; parked work is
        dropped, not run."""
        self._warm_cancel.set()
        with self._lock:
            deferred, self._deferred = self._deferred, []
            for s in deferred:
                self._release_promise(s)
        self.prewarm_wait()
        self._warm_cancel.clear()

    def clear(self) -> None:
        """Cancel prewarms and delete every pooled file."""
        self.cancel_prewarm()
        with self._lock:
            self._files.clear()
            self._warm_promised.clear()
            shutil.rmtree(self.directory, ignore_errors=True)


# ----------------------------------------------------------- restore arena
class RestoreArena:
    """Destination buffers for restore reads, backed ahead of the restore
    (counterpart of ``tpuflow/ckpt/raw.py::RestoreArena``).

    ``prewarm`` allocates one buffer a size and touches every page, on a
    background thread that overlaps the work before the restore (the
    model build); ``take`` hands each buffer out exactly once, and the
    restored tensor then owns it. ``pinned`` buffers are page-locked
    (``pin_memory``): the copy of the restored state onto the card is then
    a DMA, not a copy through a pageable staging buffer. Sizes match
    exactly (``manifest_shard_sizes``). One restore per prewarm:
    ``restore_raw`` drops the buffers it did not take. ``taken`` counts
    the buffers handed out. Without a spare core a background prewarm
    parks (see ``_spare_cores``)."""

    def __init__(self):
        self.taken = 0
        self._buffers: dict[int, list[torch.Tensor]] = {}
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        # Serialises background spawns: two racing prewarm calls must not
        # both see an empty slot.
        self._spawn_lock = threading.Lock()
        self._deferred: list[tuple[int, bool]] = []  # parked (size, pinned)
        # Bumped by abandon(): an in-flight _back of an older generation
        # discards its buffers instead of landing them.
        self._gen = 0

    def prewarm(self, sizes: list[int], *, background: bool = True,
                pinned: bool = False) -> None:
        """Allocate and back one buffer for each entry of ``sizes``
        (page-locked with ``pinned``, which needs CUDA)."""
        sizes = [int(s) for s in sizes if s > 0]
        if not sizes:
            return
        if pinned and not torch.cuda.is_available():
            raise RuntimeError("pinned restore buffers need CUDA")
        gen = self._gen
        if not background:
            self._back(sizes, gen, pinned)
            return
        if _spare_cores() < 1:
            with self._lock:
                self._deferred.extend((s, pinned) for s in sizes)
            return
        # One background prewarm at a time; the previous one is joined
        # outside the lock, and the slot re-checked after.
        while True:
            with self._spawn_lock:
                prev = self._thread
                if prev is None or not prev.is_alive():
                    t = threading.Thread(
                        target=self._back, args=(sizes, gen, pinned),
                        name="tpuflow-torch-restore-arena", daemon=True)
                    t.start()  # started before it is published
                    self._thread = t
                    return
            prev.join()

    def _back(self, sizes: list[int], gen: int, pinned: bool) -> None:
        for s in sizes:
            with self._lock:
                if gen != self._gen:
                    return  # abandoned mid-flight: discard
            if pinned:
                # cudaHostAlloc backs and locks every page itself.
                buf = torch.empty(s, dtype=torch.uint8, pin_memory=True)
            else:
                host = aligned_empty(s)
                host[::_PAGE] = 0  # back every page now, not at the read
                host[-1] = 0
                buf = torch.from_numpy(host)
            with self._lock:
                if gen != self._gen:
                    return
                self._buffers.setdefault(s, []).append(buf)

    def prewarm_wait(self, timeout: float | None = None) -> None:
        """Block until the prewarmed buffers have landed. Parked work runs
        here in full; ``timeout`` bounds only the background join."""
        with self._lock:
            deferred, self._deferred = self._deferred, []
            gen = self._gen
        for pinned in (False, True):
            sizes = [s for s, p in deferred if p == pinned]
            if sizes:
                self._back(sizes, gen, pinned)
        with self._spawn_lock:
            t = self._thread
        if t is not None:
            t.join(timeout)
            if not t.is_alive():
                with self._spawn_lock:
                    if self._thread is t:  # never drop a newer spawn
                        self._thread = None

    def take(self, nbytes: int) -> torch.Tensor | None:
        """Pop a backed uint8 buffer of exactly ``nbytes``, else None."""
        with self._lock:
            stack = self._buffers.get(int(nbytes))
            if not stack:
                return None
            self.taken += 1
            return stack.pop()

    def drop_present(self) -> None:
        """Drop the landed buffers and the parked work without joining an
        in-flight prewarm, whose buffers belong to the next restore (the
        end-of-restore cleanup)."""
        with self._lock:
            self._buffers.clear()
            self._deferred.clear()

    def abandon(self) -> None:
        """Drop landed and parked buffers and make an in-flight prewarm
        discard the rest, without joining it (a manager's close)."""
        with self._lock:
            self._gen += 1
            self._buffers.clear()
            self._deferred.clear()

    def clear(self) -> None:
        """Drop parked work unrun, wait for an in-flight prewarm, drop
        every buffer."""
        with self._lock:
            self._deferred.clear()
        self.prewarm_wait()
        with self._lock:
            self._buffers.clear()


_ARENA = RestoreArena()
# Restores serialise on one process-wide lock: the arena is process-wide,
# and a restore's cleanup would otherwise drop a concurrent restore's
# buffers. A prewarm issued during another restore may lose its backing
# work to that restore's cleanup: a lost optimisation, never wrong bytes.
_RESTORE_LOCK = threading.RLock()


def release_pinned() -> None:
    """Hand the page-locked memory of dropped pinned restore buffers back
    to the system. PyTorch's host allocator keeps a freed pinned block
    cached, and locked, for the life of the process: call this once a
    pinned restore's tree is on the card and dropped. The card's queued
    copies finish first, so no block is held back by one in flight."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch._C._host_emptyCache()


# ------------------------------------------------------------------- save
def _write_one(directory: str, fname: str, buf: np.ndarray,
               pool: RecyclePool | None, policy: RetryPolicy) -> int:
    """Write one shard file, over a pooled file when the pool has one that
    fits, else fresh; return its crc32, computed here on the write's
    thread (``zlib`` releases the GIL on large buffers)."""
    dst = os.path.join(directory, fname)

    def attempt() -> None:
        recycled = pool.take(buf.nbytes) if pool is not None else None
        if recycled is not None:
            try:
                os.rename(recycled, dst)
                write_file(dst, buf, inplace=True)
                return
            except OSError:
                pass  # a fresh write below
        write_file(dst, buf)

    _retry(policy, attempt, "write_shard", dst)
    faults.corrupt_after_write(dst)
    return _crc32(buf)


def _fs_is_memory_backed(path: str) -> bool:
    """True when ``path`` lives on tmpfs or ramfs (fsync is free there)."""
    try:
        best, fstype = "", ""
        path = os.path.abspath(path)
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                mnt = parts[1]
                # Path-boundary match: /run must not claim /runtime/ckpt.
                if (mnt == "/" or path == mnt or path.startswith(mnt + "/")
                        ) and len(mnt) > len(best):
                    best, fstype = mnt, parts[2]
        return fstype in ("tmpfs", "ramfs")
    except OSError:
        return False


def _write_entries(directory: str, host_leaves, policy: RetryPolicy, *,
                   pool: RecyclePool | None = None,
                   workers: int | None = None, process_count: int = 1,
                   process_index: int = 0) -> int:
    """Write this process's shards (``_gather_host``'s entries) and its
    manifest; returns the payload bytes it wrote. The files go through a
    thread pool of ``workers`` (default: 1 on tmpfs, where each write is a
    memcpy, else 4, so one file's fsync overlaps the next file's copy; the
    JAX package's ``TPUFLOW_WRITE_CONCURRENCY``), each task writing its
    file (over a ``pool`` file where one fits) and computing its crc32.
    The manifest is assembled after the tasks, in leaf order: with one
    process the unified ``manifest.json``, with several this process's
    fragment ``manifest.p<index>.json``, which ``merge_manifests`` joins
    (the shards' start coordinates name their files, so no two processes
    write one file)."""
    manifest = {"format": FORMAT_NAME, "process_count": process_count,
                "leaves": []}
    jobs, records = [], []
    for i, (names, shape, dtype, shards) in enumerate(host_leaves):
        entry = {"path": names, "shape": list(shape),
                 "dtype": dtype_str(dtype), "shards": []}
        for start, t in shards:
            fname = f"leaf_{i:05d}_{'x'.join(map(str, start)) or '0'}.bin"
            jobs.append((fname, _bytes(t)))
            record = {"file": fname, "start": list(start),
                      "shape": list(t.shape), "crc32": None}
            entry["shards"].append(record)
            records.append(record)
        manifest["leaves"].append(entry)
    if workers is None:
        workers = 1 if _fs_is_memory_backed(directory) else 4
    if jobs:
        with ThreadPoolExecutor(
                max_workers=max(1, min(workers, len(jobs)))) as ex:
            futures = [ex.submit(_write_one, directory, f, b, pool, policy)
                       for f, b in jobs]
            for record, fut in zip(records, futures):
                record["crc32"] = fut.result()  # the first error raises
    if process_count > 1:
        path = os.path.join(directory, f"manifest.p{process_index:05d}.json")

        def write_manifest():
            with open(path + ".tmp", "w") as f:
                json.dump(manifest, f)
            os.replace(path + ".tmp", path)
    else:
        path = os.path.join(directory, MANIFEST)

        def write_manifest():
            with open(path, "w") as f:
                json.dump(manifest, f)

    _retry(policy, write_manifest, "write_manifest", path)
    return sum(b.nbytes for _, b in jobs)


def merge_manifests(directory: str, *, visibility_timeout_s: float = 10.0,
                    policy: RetryPolicy = RetryPolicy()) -> None:
    """Union the manifest fragments of a multi-process save into
    ``manifest.json`` (process 0, after every process has written its
    shards). The fragments agree on the leaves; their shard lists are
    disjoint. Fewer fragments than the save's ``process_count`` would
    leave regions of the restored leaves unwritten, but every writer has
    reported success by then, so a shortfall is storage that has not
    shown a file yet: poll for the full set for ``visibility_timeout_s``
    before failing loudly (the JAX package's ``merge_manifests``)."""
    deadline = time.monotonic() + visibility_timeout_s
    while True:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("manifest.p") and n.endswith(".json"))
        expected = None
        if names:
            with open(os.path.join(directory, names[0])) as f:
                expected = int(json.load(f).get("process_count",
                                                len(names)))
            if len(names) >= expected:
                break
        if time.monotonic() >= deadline:
            if not names:
                raise FileNotFoundError(
                    f"no manifest fragments in {directory}")
            raise FileNotFoundError(
                f"{directory} has {len(names)} manifest fragments but the "
                f"save ran on {expected} processes; the step is incomplete "
                "on this storage (lagging sync or failed writer)")
        time.sleep(0.05)
    merged = None
    for name in names:
        with open(os.path.join(directory, name)) as f:
            frag = json.load(f)
        if merged is None:
            merged = frag
            continue
        for entry, add in zip(merged["leaves"], frag["leaves"]):
            entry["shards"].extend(add["shards"])
    path = os.path.join(directory, MANIFEST)

    def write_merged():
        with open(path + ".tmp", "w") as f:
            json.dump(merged, f)
        os.replace(path + ".tmp", path)

    _retry(policy, write_merged, "write_manifest", path)


def save_raw(directory: str, tree, *, policy: RetryPolicy = RetryPolicy(),
             pool: RecyclePool | None = None, process_count: int = 1,
             process_index: int = 0) -> int:
    """Write ``tree`` synchronously; returns the payload bytes this
    process wrote. With ``process_count`` > 1 every process calls it on
    its own tree (``Piece``s for the shared leaves) and process 0 then
    calls ``merge_manifests``."""
    os.makedirs(directory, exist_ok=True)
    return _write_entries(directory,
                          _gather_host(tree, owner=process_index == 0),
                          policy, pool=pool, process_count=process_count,
                          process_index=process_index)


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
        self.nbytes = 0  # the last save's payload bytes, once written
        self._thread: threading.Thread | None = None
        self._error: list[BaseException] = []

    def save(self, directory: str, tree, *, pool: RecyclePool | None = None,
             on_commit=None, process_count: int = 1,
             process_index: int = 0) -> None:
        self.wait()
        os.makedirs(directory, exist_ok=True)
        t0 = time.monotonic()
        host_leaves = _gather_host(tree, owner=process_index == 0)
        self.gather_s = time.monotonic() - t0
        self.nbytes = 0

        def write():
            try:
                nbytes = _write_entries(
                    directory, host_leaves, self.policy, pool=pool,
                    process_count=process_count, process_index=process_index)
                self.nbytes = nbytes
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


def _select(entries: list[dict], subtree) -> list[dict]:
    if not subtree:
        return entries
    n = len(subtree)
    return [e for e in entries if tuple(e["path"][:n]) == tuple(subtree)]


def payload_bytes(directory: str, subtree: tuple[str, ...] | None = None
                  ) -> int:
    """The bytes of the shard files a restore of ``directory`` (or of its
    ``subtree``) reads."""
    return sum(
        _nbytes(shard["shape"], torch_dtype(e["dtype"]))
        for e in _select(read_manifest(directory)["leaves"], subtree)
        for shard in e["shards"]
    )


def manifest_shard_sizes(directory: str,
                         subtree: tuple[str, ...] | None = None
                         ) -> list[int]:
    """The size of every buffer a restore of ``directory`` (or of its
    ``subtree``) takes from the arena: what ``RestoreArena.prewarm``
    backs. One a leaf: a leaf saved in several shards is read into one
    buffer, so its size is the leaf's."""
    return [_nbytes(e["shape"], torch_dtype(e["dtype"]))
            for e in _select(read_manifest(directory)["leaves"], subtree)]


def _nbytes(shape, dtype: torch.dtype) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    return math.prod(shape) * itemsize


def _map_shard(path: str, nbytes: int, escapes: bool) -> np.ndarray | None:
    """The first ``nbytes`` of ``path`` mapped copy-on-write (writable, the
    file untouched), or None where it cannot be mapped (an empty shard) or
    the file moved while it was being registered. With ``escapes`` (the
    mapping reaches the caller) the inode is registered from this open fd
    before the mapping escapes, the path re-checked after, and a finalizer
    on the mapping releases the registration."""
    try:
        f = open(path, "rb")
    except OSError:
        return None
    key = None
    try:
        if escapes:
            key = _register_alias_fd(f.fileno())
        try:
            flat = np.memmap(f, dtype=np.uint8, mode="c", shape=(nbytes,))
        except (OSError, ValueError):
            flat = None
    finally:
        f.close()
    if key is None:
        return flat
    if flat is not None:
        try:
            st = os.stat(path)
            if (st.st_dev, st.st_ino) != key:
                flat = None  # adopted meanwhile: its bytes may be changing
        except OSError:
            flat = None
    if flat is None:
        _unregister_alias(key)
    else:
        weakref.finalize(flat, _unregister_alias, key)
    return flat


def _read_shard(directory: str, shard: dict, dtype: torch.dtype,
                policy: RetryPolicy, *, mmap: bool = False,
                escapes: bool = True, verify: bool = True) -> torch.Tensor:
    """Read (with ``mmap``: map) one shard file, its crc32 checked against
    the manifest unless ``verify`` is off. ``escapes`` False promises the
    caller copies the result before it reaches user code: the read then
    takes no arena buffer and a mapping needs no registration. A read that
    escapes fills an arena buffer of its size where one is backed."""
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
    check = verify and shard.get("crc32") is not None
    flat = _map_shard(path, nbytes, escapes) if mmap else None
    if flat is not None:
        if check:  # pages every mapped byte in: the price of verifying
            _check_shard_bytes(path, shard, flat, nbytes)
        t = torch.from_numpy(flat)
    else:
        t = _ARENA.take(nbytes) if escapes else None
        out = None if t is None else t.numpy()
        buf = _retry(policy, lambda: read_file(path, nbytes, out=out),
                     "read_shard", path)
        if check:
            _check_shard_bytes(path, shard, buf, nbytes)
        if t is None:
            t = torch.from_numpy(buf)
    return t.view(dtype).reshape(shard["shape"])


def _read_into(buf: torch.Tensor, origin, directory: str, shard: dict,
               policy: RetryPolicy, verify: bool) -> int:
    """Copy the part of one shard file that falls in ``buf`` (the region of
    the leaf starting at ``origin``) into place; returns the file's bytes.
    The whole file is read (mapped) so its crc32 can be checked; the copy
    makes the data private, so the mapping needs no registration."""
    src = _read_shard(directory, shard, buf.dtype, policy, mmap=True,
                      escapes=False, verify=verify)
    dst_idx, src_idx = [], []
    for o, n, s0, sn in zip(origin, buf.shape, shard["start"],
                            shard["shape"]):
        lo, hi = max(o, s0), min(o + n, s0 + sn)
        dst_idx.append(slice(lo - o, hi - o))
        src_idx.append(slice(lo - s0, hi - s0))
    buf[tuple(dst_idx)] = src[tuple(src_idx)]
    return src.numel() * src.element_size()


def _overlaps(origin, extent, shard: dict) -> bool:
    return all(max(o, s0) < min(o + n, s0 + sn) for o, n, s0, sn in
               zip(origin, extent, shard["start"], shard["shape"]))


def _leaf_buffer(shape, dtype: torch.dtype) -> torch.Tensor:
    nbytes = _nbytes(shape, dtype)
    buf = _ARENA.take(nbytes)
    if buf is None:
        buf = torch.from_numpy(aligned_empty(nbytes))
    return buf.view(dtype).reshape(shape)


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
                policy: RetryPolicy = RetryPolicy(),
                zero_copy: bool = False, io_threads: int | None = None,
                verify: bool = True, stats: dict | None = None) -> dict:
    """Restore a raw checkpoint as a nested dict of CPU tensors.

    - ``subtree``: only the leaves under this path prefix, returned as
      that subtree (e.g. ``("params",)`` for a weights-only restore);
      KeyError when there is none.
    - ``template``: a nested dict with the same leaves (tensors, any
      device, ``meta`` included, or ``Piece``s); paths and (global) shapes
      must match the manifest's (ValueError otherwise) and each leaf is
      cast to the template's dtype (a bfloat16 checkpoint restores into
      float32). A ``Piece`` leaf restores only its region: the shard files
      that overlap it are read, whatever the layout or process count that
      wrote them, and its tensor comes back.
    - ``zero_copy``: map the shard files instead of reading them: the
      tensors alias the files' page-cache pages, paged in on first use.
      Sound in this process (each mapped inode is registered, and the
      recycle pool unlinks registered inodes instead of reusing them), not
      if another process may recycle the same directory while the tensors
      live: use it for read-only consumers of finished runs.
    - ``io_threads``: the most shard files read at once (default
      ``max(min(cpu_count, 16), 4)``: the reads wait on the device, so
      even a small host keeps four in flight).
    - ``verify``: check each shard's crc32 against the manifest (the JAX
      package's ``TPUFLOW_CKPT_VERIFY``); off, a zero-copy restore pages
      in nothing up front.
    - ``stats``: when given, ``stats["bytes"]`` is set to the shard bytes
      this restore read.

    One task a shard file, on a thread pool. A read that reaches the
    caller fills a prewarmed arena buffer where one of its size is backed
    (``CheckpointManager.prewarm_restore``); the rest of the arena is
    dropped when the restore ends. Restores run one at a time. The caller
    copies the tensors into place."""
    with _RESTORE_LOCK:
        try:
            return _restore(directory, template, subtree, policy, zero_copy,
                            io_threads, verify,
                            stats if stats is not None else {})
        finally:
            _ARENA.drop_present()


def _restore(directory, template, subtree, policy, zero_copy, io_threads,
             verify, stats) -> dict:
    entries = _select(read_manifest(directory, policy)["leaves"], subtree)
    if subtree and not entries:
        raise KeyError(f"no leaves under {subtree} in {directory}")
    n = len(subtree) if subtree else 0
    paths = [e["path"][n:] for e in entries]
    want = None
    if template is not None:
        want = flatten(template)
        want_paths = [p for p, _ in want]
        if paths != want_paths:
            missing = [p for p in want_paths if p not in paths][:3]
            extra = [p for p in paths if p not in want_paths][:3]
            raise ValueError(
                f"{directory}: checkpoint leaves differ from the template "
                f"({len(paths)} vs {len(want_paths)}; missing "
                f"{missing}, unexpected {extra})")
        for names, e, (_, tmpl) in zip(paths, entries, want):
            if tuple(e["shape"]) != tuple(tmpl.shape):
                raise ValueError(
                    f"{'/'.join(names)}: checkpoint shape "
                    f"{tuple(e['shape'])}, template {tuple(tmpl.shape)}")
    regions = []  # per entry: (origin, extent)
    for i, e in enumerate(entries):
        tmpl = want[i][1] if want is not None else None
        if isinstance(tmpl, Piece):
            regions.append((list(tmpl.start), list(tmpl.data.shape)))
        else:
            regions.append(([0] * len(e["shape"]), list(e["shape"])))
    n_tasks = sum(len(e["shards"]) for e in entries)
    budget = (max(min(os.cpu_count() or 1, 16), 4) if io_threads is None
              else max(1, io_threads))
    leaves, nbytes = [], 0
    with ThreadPoolExecutor(max_workers=max(1, min(budget, n_tasks))) as ex:
        pending = []
        for e, (origin, extent) in zip(entries, regions):
            dtype = torch_dtype(e["dtype"])
            shards = [s for s in e["shards"] if _overlaps(origin, extent, s)]
            exact = [s for s in shards if s["start"] == origin
                     and s["shape"] == extent]
            if exact:
                # The region is one saved shard (the layout it was saved
                # with, or a leaf saved whole): read it directly.
                pending.append((None, [ex.submit(
                    _read_shard, directory, exact[0], dtype, policy,
                    mmap=zero_copy, verify=verify)]))
            else:  # assembled from the shards that overlap it
                buf = _leaf_buffer(extent, dtype)
                pending.append((buf, [
                    ex.submit(_read_into, buf, origin, directory, s, policy,
                              verify)
                    for s in shards]))
        for buf, futures in pending:
            got = [f.result() for f in futures]  # the first error raises
            if buf is None:
                leaves.append(got[0])
                nbytes += got[0].numel() * got[0].element_size()
            else:
                leaves.append(buf)
                nbytes += sum(got)
    stats["bytes"] = nbytes
    if want is not None:
        leaves = [t.to(tmpl.dtype) for t, (_, tmpl) in zip(leaves, want)]
    pairs = list(zip(paths, leaves))
    if len(pairs) == 1 and not pairs[0][0]:
        return pairs[0][1]  # the subtree was a single leaf
    return unflatten(pairs)
