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
leaf, ``process_count`` 1. The speed machinery is the JAX package's:
- a save writes its files on a thread pool, each task computing its
  file's crc32; a ``RecyclePool`` hands retired shard files back to later
  saves, which overwrite them in place, and ``prewarm`` creates such
  files ahead of the first saves;
- a restore reads one task a shard file on a thread pool, crc-checked in
  the task, into buffers a ``RestoreArena`` backed ahead of time (page
  locked on request, so the copy onto the card is a DMA), or maps the
  files (``zero_copy``), guarded against recycling by an inode registry.
Not here yet (ROADMAP Queue 1 item 6b): multi-process manifest fragments
and ``merge_manifests``. The JAX package writes and reads through a
striped threaded C++ library; a copy of it was no faster than plain file
calls on the H100 machine's host disk (PERF.md), so the port has none.
"""

from __future__ import annotations

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
        for root, _, names in os.walk(step_dir):
            for name in names:
                src = os.path.join(root, name)
                # An aliased inode backs a live zero-copy restore: rmtree
                # below unlinks it instead of pooling it.
                if not name.endswith(".bin") or _is_aliased(src):
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
        shutil.rmtree(step_dir, ignore_errors=True)

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
                   workers: int | None = None) -> int:
    """Write every leaf as one shard file plus the manifest; returns the
    payload bytes. The files go through a thread pool of ``workers``
    (default: 1 on tmpfs, where each write is a memcpy, else 4, so one
    file's fsync overlaps the next file's copy; the JAX package's
    ``TPUFLOW_WRITE_CONCURRENCY``), each task writing its file (over a
    ``pool`` file where one fits) and computing its crc32. The manifest is
    assembled after the tasks, in leaf order."""
    manifest = {"format": FORMAT_NAME, "process_count": 1, "leaves": []}
    jobs = []
    for i, (names, t) in enumerate(host_leaves):
        coord = "x".join("0" * t.dim()) or "0"
        fname = f"leaf_{i:05d}_{coord}.bin"
        jobs.append((fname, _bytes(t)))
        manifest["leaves"].append({
            "path": names, "shape": list(t.shape),
            "dtype": dtype_str(t.dtype),
            "shards": [{"file": fname, "start": [0] * t.dim(),
                        "shape": list(t.shape), "crc32": None}],
        })
    if workers is None:
        workers = 1 if _fs_is_memory_backed(directory) else 4
    with ThreadPoolExecutor(max_workers=max(1, min(workers, len(jobs)))) as ex:
        futures = [ex.submit(_write_one, directory, f, b, pool, policy)
                   for f, b in jobs]
        for entry, fut in zip(manifest["leaves"], futures):
            entry["shards"][0]["crc32"] = fut.result()  # first error raises
    unified = os.path.join(directory, MANIFEST)

    def write_manifest():
        with open(unified, "w") as f:
            json.dump(manifest, f)

    _retry(policy, write_manifest, "write_manifest", unified)
    return sum(b.nbytes for _, b in jobs)


def save_raw(directory: str, tree, *, policy: RetryPolicy = RetryPolicy(),
             pool: RecyclePool | None = None) -> int:
    """Write ``tree`` synchronously; returns the payload bytes."""
    os.makedirs(directory, exist_ok=True)
    return _write_entries(directory, _gather_host(tree), policy, pool=pool)


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

    def save(self, directory: str, tree, *, pool: RecyclePool | None = None,
             on_commit=None) -> None:
        self.wait()
        os.makedirs(directory, exist_ok=True)
        t0 = time.monotonic()
        host_leaves = _gather_host(tree)
        self.gather_s = time.monotonic() - t0

        def write():
            try:
                nbytes = _write_entries(directory, host_leaves, self.policy,
                                        pool=pool)
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


def _read_into(full: torch.Tensor, directory: str, shard: dict,
               policy: RetryPolicy, verify: bool) -> None:
    """Copy one shard of a leaf saved in several shards into its place in
    ``full``. The copy makes the data private, so the shard is mapped
    without registration."""
    idx = tuple(slice(s, s + n)
                for s, n in zip(shard["start"], shard["shape"]))
    full[idx] = _read_shard(directory, shard, full.dtype, policy, mmap=True,
                            escapes=False, verify=verify)


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
                verify: bool = True) -> dict:
    """Restore a raw checkpoint as a nested dict of CPU tensors.

    - ``subtree``: only the leaves under this path prefix, returned as
      that subtree (e.g. ``("params",)`` for a weights-only restore);
      KeyError when there is none.
    - ``template``: a nested dict with the same leaves (tensors, any
      device, ``meta`` included); paths and shapes must match the
      manifest's (ValueError otherwise) and each leaf is cast to the
      template's dtype (a bfloat16 checkpoint restores into float32).
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

    One task a shard file, on a thread pool. A read that reaches the
    caller fills a prewarmed arena buffer where one of its size is backed
    (``CheckpointManager.prewarm_restore``); the rest of the arena is
    dropped when the restore ends. Restores run one at a time. The caller
    copies the tensors into place."""
    with _RESTORE_LOCK:
        try:
            return _restore(directory, template, subtree, policy, zero_copy,
                            io_threads, verify)
        finally:
            _ARENA.drop_present()


def _restore(directory, template, subtree, policy, zero_copy, io_threads,
             verify) -> dict:
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
    n_tasks = sum(len(e["shards"]) for e in entries)
    budget = (max(min(os.cpu_count() or 1, 16), 4) if io_threads is None
              else max(1, io_threads))
    leaves = []
    with ThreadPoolExecutor(max_workers=max(1, min(budget, n_tasks))) as ex:
        pending = []
        for e in entries:
            dtype = torch_dtype(e["dtype"])
            shards = e["shards"]
            if len(shards) == 1 and shards[0]["shape"] == e["shape"]:
                pending.append((None, [ex.submit(
                    _read_shard, directory, shards[0], dtype, policy,
                    mmap=zero_copy, verify=verify)]))
            else:  # saved in several shards (by a sharded JAX run)
                full = _leaf_buffer(e["shape"], dtype)
                pending.append((full, [
                    ex.submit(_read_into, full, directory, s, policy, verify)
                    for s in shards]))
        for full, futures in pending:
            got = [f.result() for f in futures]  # the first error raises
            leaves.append(got[0] if full is None else full)
    if want is not None:
        leaves = [t.to(tmpl.dtype) for t, (_, tmpl) in zip(leaves, want)]
    pairs = list(zip(paths, leaves))
    if len(pairs) == 1 and not pairs[0][0]:
        return pairs[0][1]  # the subtree was a single leaf
    return unflatten(pairs)
