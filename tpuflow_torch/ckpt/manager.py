"""Per-step checkpoints with best/latest policies and retention.

Counterpart of ``tpuflow/ckpt/manager.py`` for the raw format, with its
on-disk layout::

    directory/
      step_8/
        state/          # tpuflow-raw-v2: manifest.json + one file per leaf
        metadata.json   # step, metrics, metrics_history, data_state, ...
      step_16/ ...
      .recycle/         # retired shard files, r00000001.bin, ...

- A save stages into ``step_K.tmp`` and becomes visible by one atomic
  rename after its payload and ``metadata.json`` are on disk; anything
  still wearing the suffix (or lacking ``metadata.json``) when a manager
  starts is a killed writer's leftover and is deleted.
- Saves are asynchronous and double-buffered: ``save`` copies the state
  to the host, then writes on a thread; it blocks only to drain the
  previous save.
- Retention keeps the newest ``max_to_keep`` steps plus the best one (by
  ``best_metric``); ``latest_step``/``best_step``/``all_steps`` read the
  committed steps.
- ``restore`` reads a step crc-verified; a corrupt step falls back to the
  previous committed one. ``save_dtype`` ('bfloat16' | 'float16') casts
  wider floating leaves down on save; a restore with a template casts them
  back up.
- The metrics history is rebuilt from the newest step's metadata when a
  manager opens a directory (in-run resume).
- Retired steps (retention, a step saved again, a killed writer's
  leftovers) are adopted into ``.recycle`` (``raw.RecyclePool``), whose
  files later saves overwrite in place; on memory-backed storage
  ``prewarm`` creates them ahead of the first saves. ``prewarm_restore``
  (and the module's ``prewarm_restore_handle``) backs a restore's destination buffers
  ahead of it (``raw.RestoreArena``); ``restore(zero_copy=True)`` maps
  the shard files instead of reading them.

Not here yet (ROADMAP Queue 1 items 6b and 5): multi-process manifest
fragments, the node-local tier and its upload, ``emergency_save``, the
Orbax format, and the JAX package's ``obs`` events and fault-injection
hooks.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import torch

from tpuflow_torch.ckpt import raw
from tpuflow_torch.ckpt.handle import Checkpoint

_STATE_DIR = "state"
_META_FILE = "metadata.json"
_STEP_PREFIX = "step_"
_STAGE_SUFFIX = ".tmp"
_POOL_DIR = ".recycle"
_SAVE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _atomic_write_json(path: str, obj) -> None:
    """Stage at ``path.tmp``, fsync, publish with one ``os.replace``."""
    tmp = path + _STAGE_SUFFIX
    with open(tmp, "wb") as f:
        f.write(json.dumps(obj).encode("utf-8"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _downcast(tree, dtype_name: str):
    """Floating leaves wider than ``dtype_name`` cast down to it; integer
    and already-narrow leaves pass through."""
    target = _SAVE_DTYPES[dtype_name]
    width = torch.empty((), dtype=target).element_size()

    def cast(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and leaf.element_size() > width):
            return leaf.to(target)
        return leaf

    return raw.unflatten([(p, cast(x)) for p, x in raw.flatten(tree)])


def _saved_nbytes(leaf: torch.Tensor, dtype_name: str | None) -> int:
    """A leaf's shard bytes as ``save`` writes it (``_downcast``'s widths;
    ``meta`` tensors count too)."""
    size = leaf.element_size()
    if dtype_name is not None and leaf.is_floating_point():
        size = min(size, torch.empty(
            (), dtype=_SAVE_DTYPES[dtype_name]).element_size())
    return leaf.numel() * size


class CheckpointManager:
    """Manage per-step checkpoints under one directory (see the module
    docstring). ``saves`` and ``restores`` hold one record per committed
    save / finished restore: step, payload bytes and wall seconds (a save
    from ``save()`` entry to its commit, and ``host_copy_s``, the part
    ``save()`` blocks for)."""

    def __init__(self, directory: str, *, max_to_keep: int | None = 2,
                 best_metric: str = "val_loss", best_mode: str = "min",
                 async_save: bool = True, save_dtype: str | None = None,
                 io_retries: int = 4, io_backoff_s: float = 0.05):
        if save_dtype is not None and save_dtype not in _SAVE_DTYPES:
            raise ValueError(
                f"save_dtype must be None, 'bfloat16' or 'float16', got "
                f"{save_dtype!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        self.save_dtype = save_dtype
        self._async = async_save
        self.policy = raw.RetryPolicy(io_retries, io_backoff_s)
        self._saver = raw.AsyncRawSaver(self.policy)
        self._pool = raw.RecyclePool(
            os.path.join(self.directory, _POOL_DIR), policy=self.policy)
        self._metrics_history: list[dict[str, Any]] = []
        # (step, cleanup) of the save in flight, consumed by
        # wait_until_finished when that save dies on a CheckpointIOError.
        self._pending_fail = None
        self.saves: list[dict] = []
        self.restores: list[dict] = []
        self._sweep_orphans()
        # The newest step's metadata embeds the whole history, including
        # steps retention has since deleted.
        steps = self._all_steps()
        seen: set[int] = set()
        if steps:
            newest = self._read_meta(steps[-1]) or {}
            for m in newest.get("metrics_history", []):
                if "step" in m:
                    self._metrics_history.append(dict(m))
                    seen.add(m["step"])
        for step in steps:
            meta = self._read_meta(step)
            if step not in seen and meta and "metrics" in meta:
                self._metrics_history.append({"step": step, **meta["metrics"]})
        self._metrics_history.sort(key=lambda m: m.get("step", 0))

    # ------------------------------------------------------------ queries
    def _sweep_orphans(self) -> None:
        """Recycle staged ``step_K.tmp`` dirs and step dirs without
        ``metadata.json``: no save is in flight at construction."""
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if not name.startswith(_STEP_PREFIX) or not os.path.isdir(path):
                continue
            if name.endswith(_STAGE_SUFFIX) or not os.path.exists(
                    os.path.join(path, _META_FILE)):
                self._pool.adopt_dir(path)

    def _drop_step_dir(self, step_dir: str) -> None:
        """Make a step dir invisible (its metadata first), then recycle its
        shard files and delete the rest."""
        if os.path.isdir(step_dir):
            self._pool.adopt_dir(step_dir)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step}")

    def _committed(self, step: int) -> bool:
        return os.path.exists(os.path.join(self._step_dir(step), _META_FILE))

    def _all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_STEP_PREFIX) and not name.endswith(
                    _STAGE_SUFFIX):
                try:
                    step = int(name[len(_STEP_PREFIX):])
                except ValueError:
                    continue
                if self._committed(step):
                    steps.append(step)
        return sorted(steps)

    def _read_meta(self, step: int) -> dict | None:
        try:
            with open(os.path.join(self._step_dir(step), _META_FILE)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _best_step(self) -> int | None:
        best = None
        sign = 1.0 if self.best_mode == "min" else -1.0
        for step in self._all_steps():
            value = (self._read_meta(step) or {}).get("metrics", {}).get(
                self.best_metric)
            if value is None:
                continue
            key = (sign * float(value), step)
            if best is None or key < best:
                best = key
        return best[1] if best else None

    def all_steps(self) -> list[int]:
        self.wait_until_finished()  # a step is visible once its save commits
        return self._all_steps()

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> int | None:
        self.wait_until_finished()
        return self._best_step()

    # --------------------------------------------------------------- save
    def save(self, step: int, state, metrics: dict | None = None, *,
             data_state: dict | None = None) -> Checkpoint:
        """Save ``state`` (a nested dict of tensors) for ``step`` with
        ``metrics`` and the loader cursor ``data_state``. The host copy is
        made before this returns; the files are written on a thread (at
        once when the manager is not asynchronous)."""
        self.wait_until_finished()
        t0 = time.monotonic()
        final_dir = self._step_dir(step)
        stage_dir = final_dir + _STAGE_SUFFIX
        # A step saved again first becomes invisible, then is replaced.
        for d in (final_dir, stage_dir):
            self._drop_step_dir(d)
        os.makedirs(stage_dir)
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        hist_entry = {"step": step, **metrics}
        self._metrics_history.append(hist_entry)
        meta = {
            "step": step, "metrics": metrics,
            "metrics_history": list(self._metrics_history),
            "process_count": 1, "device_count": 1,
        }
        if data_state is not None:
            meta["data_state"] = dict(data_state)
        if self.save_dtype is not None:
            state = _downcast(state, self.save_dtype)
            meta["save_dtype"] = self.save_dtype

        def fail_cleanup() -> None:
            # The save died on a classified storage error: the step never
            # existed.
            if hist_entry in self._metrics_history:
                self._metrics_history.remove(hist_entry)
            shutil.rmtree(stage_dir, ignore_errors=True)

        self._pending_fail = (step, fail_cleanup)
        taken = self._pool.taken

        def commit(nbytes: int) -> None:
            # Marker inside the staging dir, then one rename publishes the
            # payload and the metadata together; retention runs after.
            marker = os.path.join(stage_dir, _META_FILE)
            raw.retry_io(lambda: _atomic_write_json(marker, meta),
                         op="write_meta", path=marker,
                         retries=self.policy.retries,
                         backoff_s=self.policy.backoff_s)
            raw.retry_io(lambda: os.replace(stage_dir, final_dir),
                         op="commit", path=final_dir,
                         retries=self.policy.retries,
                         backoff_s=self.policy.backoff_s)
            dur = time.monotonic() - t0
            self.saves.append({"step": step, "bytes": nbytes, "seconds": dur,
                               "gbps": nbytes / dur / 1e9 if dur else 0.0,
                               "host_copy_s": self._saver.gather_s,
                               "recycled": self._pool.taken - taken})
            self._retain()

        self._saver.save(os.path.join(stage_dir, _STATE_DIR), state,
                         pool=self._pool, on_commit=commit)
        if not self._async:
            self.wait_until_finished()
        return Checkpoint(path=final_dir, metadata=meta)

    def _retain(self) -> None:
        """Keep the newest ``max_to_keep`` steps plus the best step."""
        if self.max_to_keep is None:
            return
        steps = self._all_steps()
        keep = set(steps[-self.max_to_keep:]) if self.max_to_keep else set()
        best = self._best_step()
        if best is not None:
            keep.add(best)
        for s in steps:
            if s not in keep:
                self._drop_step_dir(self._step_dir(s))

    def prewarm(self, state) -> None:
        """Create pool files, in the background, for the saves of
        ``state`` (a tree of tensors, ``meta`` ones included): one a leaf
        at the size ``save`` writes it, for ``max_to_keep`` steps plus the
        best step plus one save in flight. Call once the state exists: the
        first saves then overwrite warm files. Only on memory-backed
        storage (tmpfs), where overwriting a file skips the zeroing of
        fresh pages: on a disk the saves' fsync sets their pace, warm files
        gained nothing there (PERF.md) and writing them costs the disk
        several copies of the state. Best-effort: a prewarm that fails
        leaves the saves to write fresh files."""
        if not raw._fs_is_memory_backed(self.directory):
            return
        sizes = [_saved_nbytes(leaf, self.save_dtype)
                 for _, leaf in raw.flatten(state)]
        steps = (self.max_to_keep or 1) + (2 if self.best_metric else 1)
        self._pool.prewarm(sizes * steps)

    def prewarm_wait(self) -> None:
        self._pool.prewarm_wait()

    def wait_until_finished(self) -> None:
        """Drain the save in flight. A save that died on a
        ``CheckpointIOError`` fails that step's save only (its staging is
        removed, its history entry dropped, a line printed); any other
        error propagates."""
        pending_fail, self._pending_fail = self._pending_fail, None
        try:
            self._saver.wait()
        except raw.CheckpointIOError as e:
            if pending_fail is not None:
                pending_fail[1]()
            step = pending_fail[0] if pending_fail else None
            print(f"[tpuflow_torch] checkpoint save for step {step} failed "
                  f"after retries; training continues on the previous "
                  f"committed step: {e}")

    def close(self) -> None:
        self.wait_until_finished()
        # A prewarm still writing into .recycle would race a caller that
        # deletes the directory after close.
        self._pool.cancel_prewarm()
        # A prewarmed restore that never ran must not pin its buffers for
        # the process's life. abandon, not clear: closing one manager never
        # joins another's prewarm (the arena is process-wide).
        raw._ARENA.abandon()

    # ------------------------------------------------------------ restore
    def _resolve_step(self, step: int | None, best: bool) -> int:
        self.wait_until_finished()
        if step is None:
            steps = self._all_steps()
            chosen = self._best_step() if best else (steps[-1] if steps
                                                     else None)
        else:
            chosen = step
        if chosen is None or not self._committed(chosen):
            raise FileNotFoundError(
                f"no checkpoint {'(best) ' if best else ''}found in "
                f"{self.directory}")
        return chosen

    def prewarm_restore(self, step: int | None = None, *, best: bool = False,
                        background: bool = True,
                        pinned: bool = False) -> None:
        """Back the destination buffers of a later ``restore`` of ``step``
        (``raw.RestoreArena``; ``pinned``: page-locked, needs CUDA), on a
        background thread unless ``background`` is off. Call as soon as
        the step is known, before the work that precedes the restore. One
        restore per prewarm. A restore that will cast (a ``save_dtype``
        checkpoint into a wider template) takes none of the buffers: do
        not prewarm it. No step to restore: nothing."""
        try:
            chosen = self._resolve_step(step, best)
        except FileNotFoundError:
            return
        _prewarm_state_dir(os.path.join(self._step_dir(chosen), _STATE_DIR),
                           background=background, pinned=pinned)

    def prewarm_restore_wait(self) -> None:
        prewarm_restore_wait()

    def restore(self, step: int | None = None, *, abstract_state=None,
                weights_only: bool = False, best: bool = False,
                zero_copy: bool = False):
        """The state saved at ``step`` (default the latest; ``best=True``
        the best), as a nested dict of CPU tensors cast to
        ``abstract_state``'s dtypes when given (see ``raw.restore_raw``);
        ``weights_only`` reads only the ``params`` subtree; ``zero_copy``
        maps the shard files (see ``raw.restore_raw``). Shards are
        crc-verified; a corrupt step falls back to the previous committed
        one, and with none left the CorruptShardError propagates. The
        record counts the buffers the restore took from the arena and the
        leaves it hands out page-locked."""
        chosen = self._resolve_step(step, best)
        while True:
            state_dir = os.path.join(self._step_dir(chosen), _STATE_DIR)
            t0 = time.monotonic()
            try:
                with raw._RESTORE_LOCK:  # no other restore's takes counted
                    taken = raw._ARENA.taken
                    out = raw.restore_raw(
                        state_dir, abstract_state,
                        subtree=("params",) if weights_only else None,
                        policy=self.policy, zero_copy=zero_copy)
                    taken = raw._ARENA.taken - taken
            except raw.CorruptShardError as e:
                prev = [s for s in self._all_steps() if s < chosen]
                if not prev:
                    raise
                print(f"[tpuflow_torch] checkpoint step {chosen} corrupt "
                      f"({e}); falling back to step {prev[-1]}")
                chosen = prev[-1]
                continue
            dur = time.monotonic() - t0
            nbytes = raw.payload_bytes(
                state_dir, ("params",) if weights_only else None)
            self.restores.append({
                "step": chosen, "bytes": nbytes, "seconds": dur,
                "gbps": nbytes / dur / 1e9 if dur else 0.0,
                "arena_buffers": taken,
                "pinned": sum(t.is_pinned() for _, t in raw.flatten(out))})
            return out

    def verify_step(self, step: int | None = None, *, best: bool = False
                    ) -> bool:
        """Recompute one step's shard crc32s; True when all match."""
        chosen = self._resolve_step(step, best)
        _, bad = raw.verify_dir(
            os.path.join(self._step_dir(chosen), _STATE_DIR), self.policy)
        return not bad

    def restore_metadata(self, step: int | None = None, *,
                         best: bool = False) -> dict:
        chosen = self._resolve_step(step, best)
        meta = self._read_meta(chosen)
        if meta is None:
            raise FileNotFoundError(f"no metadata for step {chosen}")
        return meta

    def checkpoint(self, step: int | None = None, *, best: bool = False
                   ) -> Checkpoint:
        """A handle to a committed step (path and metadata, no tensors)."""
        chosen = self._resolve_step(step, best)
        return Checkpoint(path=self._step_dir(chosen),
                          metadata=self._read_meta(chosen) or {})


def _prewarm_state_dir(state_dir: str, *,
                       subtree: tuple[str, ...] | None = None,
                       background: bool = True, pinned: bool = False) -> None:
    """Back the restore arena for one state dir (nothing for a dir that
    holds no raw checkpoint)."""
    if raw.is_raw(state_dir):
        raw._ARENA.prewarm(raw.manifest_shard_sizes(state_dir, subtree),
                           background=background, pinned=pinned)


def prewarm_restore_wait() -> None:
    """Block until a background restore prewarm has backed its buffers
    (call before the restore: a restore that starts first takes only
    what has landed, and the rest would stay backed, unused, until the
    next restore)."""
    raw._ARENA.prewarm_wait()


def prewarm_restore_handle(checkpoint: Checkpoint, *,
                           weights_only: bool = False,
                           pinned: bool = False) -> None:
    """Back, in the background, the destination buffers of a later
    ``restore_from_handle(checkpoint, weights_only=...)`` (``pinned``:
    page-locked, needs CUDA). Call as soon as the handle is known.
    ``weights_only`` must be the restore's, so only the ``params``
    buffers are backed. Best-effort: a handle that cannot be read backs
    nothing and leaves the restore to pay its own cost."""
    try:
        _prewarm_state_dir(os.path.join(checkpoint.path, _STATE_DIR),
                           subtree=("params",) if weights_only else None,
                           pinned=pinned)
    except (OSError, ValueError, KeyError, AttributeError):
        pass


def restore_from_handle(checkpoint: Checkpoint, *, abstract_state=None,
                        weights_only: bool = False,
                        subtree: tuple | None = None,
                        zero_copy: bool = False):
    """Restore from a ``Checkpoint`` handle: the full state, or with
    ``weights_only`` the ``params`` subtree (``subtree`` names another,
    e.g. ``("ema_params",)``); ``abstract_state`` is then that subtree's
    template. CPU tensors, as ``CheckpointManager.restore``; ``zero_copy``
    maps the shard files (sound once no writer can recycle them: the
    producing run finished)."""
    with checkpoint.as_directory() as path:
        if not os.path.exists(os.path.join(path, _META_FILE)):
            raise FileNotFoundError(
                f"checkpoint at {path} is not committed (no {_META_FILE}): "
                "drain the CheckpointManager (wait_until_finished/close) "
                "before consuming the handle")
        if weights_only or subtree is not None:
            subtree = tuple(subtree or ("params",))
        return raw.restore_raw(os.path.join(path, _STATE_DIR),
                               abstract_state, subtree=subtree,
                               zero_copy=zero_copy)
