"""Per-step checkpoints with best/latest policies and retention.

Counterpart of ``tpuflow/ckpt/manager.py`` for the raw format, with its
on-disk layout::

    directory/
      step_8/
        state/          # tpuflow-raw-v2: manifest.json + one file per leaf
        metadata.json   # step, metrics, metrics_history, data_state, ...
      step_16/ ...

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

Not here yet (ROADMAP Queue 1 item 6): the node-local tier and its upload,
``emergency_save``, the recycle pool and restore prewarm, the Orbax
format, and the JAX package's ``obs`` events and fault-injection hooks.
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
        """Delete staged ``step_K.tmp`` dirs and step dirs without
        ``metadata.json``: no save is in flight at construction."""
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if not name.startswith(_STEP_PREFIX) or not os.path.isdir(path):
                continue
            if name.endswith(_STAGE_SUFFIX) or not os.path.exists(
                    os.path.join(path, _META_FILE)):
                shutil.rmtree(path, ignore_errors=True)

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
            if os.path.isdir(d):
                try:
                    os.unlink(os.path.join(d, _META_FILE))
                except OSError:
                    pass
                shutil.rmtree(d, ignore_errors=True)
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
                               "host_copy_s": self._saver.gather_s})
            self._retain()

        self._saver.save(os.path.join(stage_dir, _STATE_DIR), state,
                         on_commit=commit)
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
                try:
                    os.unlink(os.path.join(self._step_dir(s), _META_FILE))
                except OSError:
                    pass
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

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

    def restore(self, step: int | None = None, *, abstract_state=None,
                weights_only: bool = False, best: bool = False):
        """The state saved at ``step`` (default the latest; ``best=True``
        the best), as a nested dict of CPU tensors cast to
        ``abstract_state``'s dtypes when given (see ``raw.restore_raw``);
        ``weights_only`` reads only the ``params`` subtree. Shards are
        crc-verified; a corrupt step falls back to the previous committed
        one, and with none left the CorruptShardError propagates."""
        chosen = self._resolve_step(step, best)
        while True:
            state_dir = os.path.join(self._step_dir(chosen), _STATE_DIR)
            t0 = time.monotonic()
            try:
                out = raw.restore_raw(
                    state_dir, abstract_state,
                    subtree=("params",) if weights_only else None,
                    policy=self.policy)
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
            self.restores.append({"step": chosen, "bytes": nbytes,
                                  "seconds": dur,
                                  "gbps": nbytes / dur / 1e9 if dur else 0.0})
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


def restore_from_handle(checkpoint: Checkpoint, *, abstract_state=None,
                        weights_only: bool = False,
                        subtree: tuple | None = None):
    """Restore from a ``Checkpoint`` handle: the full state, or with
    ``weights_only`` the ``params`` subtree (``subtree`` names another,
    e.g. ``("ema_params",)``); ``abstract_state`` is then that subtree's
    template. CPU tensors, as ``CheckpointManager.restore``."""
    with checkpoint.as_directory() as path:
        if not os.path.exists(os.path.join(path, _META_FILE)):
            raise FileNotFoundError(
                f"checkpoint at {path} is not committed (no {_META_FILE}): "
                "drain the CheckpointManager (wait_until_finished/close) "
                "before consuming the handle")
        if weights_only or subtree is not None:
            subtree = tuple(subtree or ("params",))
        return raw.restore_raw(os.path.join(path, _STATE_DIR),
                               abstract_state, subtree=subtree)
