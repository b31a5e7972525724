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

With ``multi_process`` every process of the ``torch.distributed`` world
saves its own shards of a sharded state (``raw.Piece`` leaves) into the
same staging directory, each with its manifest fragment, and the commit
is collective, as the JAX package's multi-host save
(``tpuflow/ckpt/manager.py:545-554``, ``:844-881``): two barriers around
process 0's clean-up of a stale step; the files written on each
process's thread; at the next drain (the next save, a query, a restore,
``close``) every process's verdict gathered (1 written, 2 failed on a
classified storage error, 0 failed otherwise), the commit aborted
everywhere if any failed, else a barrier, process 0 merging the
fragments, writing the metadata and renaming the step into place, and a
second barrier before any process reads it. Retention is process 0's
decision; each process recycles the shard files it wrote into its own
pool (``.recycle.p<rank>``). Every process therefore sees the same
committed steps. A data-parallel run whose process 0 alone saves a full
replica keeps the default (``multi_process`` False).

``format="dcp"`` (the JAX package's ``orbax`` choice, ``ckpt/dcp.py``)
writes each step's ``state`` with ``torch.distributed.checkpoint``
instead, synchronously and committed at once; the step directories,
metadata, metrics history and retention are the same, and a restore reads
whichever format a step holds. A DCP step does not cross into the JAX
package.

The node-local fast tier (``local_dir``, the JAX package's
``TPUFLOW_CKPT_LOCAL_DIR``): a root on node-local storage under which
each run keys a directory by ``sha1(abspath(directory))[:16]``, the JAX
package's own key, so a requeued attempt of the same run on the same
node finds its copies again. With it a save stages and commits in that
directory, then uploads the committed step to ``directory`` (a copy into
``step_K.tmp`` and one rename, through ``retry_io``, on the saver
thread; a failed upload leaves the step durable locally, never fatal:
the ``ckpt.upload`` span says ``ok=False``). The local tier keeps its
newest ``local_keep`` steps. ``emergency_save`` commits synchronously
on the fastest tier without the upload, for a closing preemption-grace
window. The committed steps are the union of the tiers; a restore walks
a ladder — the local copy, then the persistent one, then the previous
committed step — recording ``ckpt.restore_tier`` for the tier that
served and one ``ckpt.corrupt`` a rejected hop, and never returns
corrupt weights. The manager records the JAX package's ``ckpt.*`` events
(``obs``: ``ckpt.gc`` for the orphans a new manager reclaims,
``ckpt.save_failed``, ``ckpt.emergency_save``) and runs the fault plan's
``ckpt_partial_commit`` and ``upload_stall`` hooks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import time
from typing import Any

import errno
import hashlib

import torch
import torch.distributed as tdist

from tpuflow_torch import obs
from tpuflow_torch.ckpt import dcp, raw
from tpuflow_torch.ckpt.handle import Checkpoint
from tpuflow_torch.testing import faults
from tpuflow_torch.utils.preempt import grace_remaining_s

_STATE_DIR = "state"
_META_FILE = "metadata.json"
_STEP_PREFIX = "step_"
_STAGE_SUFFIX = ".tmp"
_POOL_DIR = ".recycle"
_SAVE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
FORMATS = ("raw", "dcp")


def local_tier_root(local_dir: str | None, directory: str) -> str | None:
    """The node-local tier's directory for the run checkpointing into
    ``directory``: ``local_dir`` keyed by a hash of ``directory``'s
    absolute path (concurrent runs never collide; a requeued attempt of
    the same run finds its copies). None: no local tier."""
    if not local_dir:
        return None
    key = hashlib.sha1(os.path.abspath(directory).encode()).hexdigest()[:16]
    return os.path.join(os.path.abspath(local_dir), key)


def _downcast(tree, dtype_name: str):
    """Floating leaves wider than ``dtype_name`` cast down to it; integer
    and already-narrow leaves pass through."""
    target = _SAVE_DTYPES[dtype_name]
    width = torch.empty((), dtype=target).element_size()

    def cast(leaf):
        if isinstance(leaf, raw.Piece):
            if leaf.data is None:
                narrow = (leaf.dtype.is_floating_point and torch.empty(
                    (), dtype=leaf.dtype).element_size() > width)
                return dataclasses.replace(
                    leaf, dtype=target if narrow else leaf.dtype)
            return dataclasses.replace(leaf, data=cast(leaf.data))
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and leaf.element_size() > width):
            return leaf.to(target)
        return leaf

    return raw.map_leaves(cast, tree)


def _saved_nbytes(leaf, dtype_name: str | None) -> int:
    """A leaf's shard bytes as ``save`` writes it (``_downcast``'s widths;
    ``meta`` tensors count too; a ``raw.Piece``'s shard, 0 without one)."""
    if isinstance(leaf, raw.Piece):
        if leaf.data is None or not leaf.owner:
            return 0
        leaf = leaf.data
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
    ``save()`` blocks for; a restore's ``tier``). ``multi_process``: every
    process of the world saves its shards and commits collectively (see
    the module docstring); every process must then call the manager's
    methods at the same points. ``format``: ``raw`` (``tpuflow-raw-v2``,
    which crosses into the JAX package) or ``dcp``
    (``torch.distributed.checkpoint``). ``local_dir``: the node-local
    tier's root (None: no local tier), which keeps its newest
    ``local_keep`` steps (at least 1)."""

    def __init__(self, directory: str, *, max_to_keep: int | None = 2,
                 best_metric: str = "val_loss", best_mode: str = "min",
                 async_save: bool = True, save_dtype: str | None = None,
                 io_retries: int = 4, io_backoff_s: float = 0.05,
                 multi_process: bool = False, format: str = "raw",
                 local_dir: str | None = None, local_keep: int = 2):
        if format not in FORMATS:
            raise ValueError(f"format must be one of {FORMATS}, got "
                             f"{format!r}")
        self.format = format
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
        self.local_dir = local_tier_root(local_dir, self.directory)
        self.local_keep = max(1, int(local_keep))
        self.policy = raw.RetryPolicy(io_retries, io_backoff_s)
        self._saver = raw.AsyncRawSaver(self.policy)
        up = tdist.is_available() and tdist.is_initialized()
        self.world = tdist.get_world_size() if up and multi_process else 1
        self.rank = tdist.get_rank() if self.world > 1 else 0
        pool_dir = _POOL_DIR + (f".p{self.rank:05d}" if self.world > 1
                                else "")
        self._pool = raw.RecyclePool(
            os.path.join(self.directory, pool_dir), policy=self.policy)
        self._metrics_history: list[dict[str, Any]] = []
        # (step, cleanup) of the save in flight, consumed by
        # wait_until_finished when that save dies on a CheckpointIOError.
        self._pending_fail = None
        # A multi-process save's commit, run at the next drain.
        self._pending_commit = None
        self.saves: list[dict] = []
        self.restores: list[dict] = []
        # The world's process 0 sweeps (a one-process manager on another
        # rank of a world only reads the directory).
        if (tdist.get_rank() if up else 0) == 0:
            self._sweep_orphans()
        self._barrier()
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

    def _barrier(self) -> None:
        if self.world > 1:
            tdist.barrier()

    # ------------------------------------------------------------ queries
    def _sweep_orphans(self) -> None:
        """Reclaim every leftover of a killed writer (``ckpt.gc``): staged
        ``step_K.tmp`` dirs and step dirs without ``metadata.json`` (their
        shard files recycled), and on the local tier its stale staging,
        uncommitted dirs and the steps beyond its retention (deleted). No
        save is in flight at construction."""
        removed = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if not name.startswith(_STEP_PREFIX) or not os.path.isdir(path):
                continue
            if name.endswith(_STAGE_SUFFIX) or not os.path.exists(
                    os.path.join(path, _META_FILE)):
                self._pool.adopt_dir(path)
                removed.append(name)
        if self.local_dir and os.path.isdir(self.local_dir):
            for name in sorted(os.listdir(self.local_dir)):
                path = os.path.join(self.local_dir, name)
                if not name.startswith(_STEP_PREFIX) or not os.path.isdir(
                        path):
                    continue
                if name.endswith(_STAGE_SUFFIX) or not os.path.exists(
                        os.path.join(path, _META_FILE)):
                    shutil.rmtree(path, ignore_errors=True)
                    removed.append(f"local:{name}")
            for step in self._committed_in(self.local_dir)[:-self.local_keep]:
                shutil.rmtree(self._local_step_dir(step), ignore_errors=True)
                removed.append(f"local:{_STEP_PREFIX}{step}")
        if removed:
            obs.event("ckpt.gc", reclaimed=len(removed),
                      dirs=sorted(removed)[:16])

    def _drop_step_dir(self, step_dir: str) -> None:
        """Make a persistent step dir invisible (its metadata first), then
        recycle its shard files and delete the rest (a DCP step's files
        are deleted: the pool serves raw saves)."""
        if dcp.is_dcp(os.path.join(step_dir, _STATE_DIR)):
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(step_dir, _META_FILE))
            shutil.rmtree(step_dir, ignore_errors=True)
        elif os.path.isdir(step_dir):
            self._pool.adopt_dir(step_dir)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step}")

    def _local_step_dir(self, step: int) -> str | None:
        if self.local_dir is None:
            return None
        return os.path.join(self.local_dir, f"{_STEP_PREFIX}{step}")

    def _restore_tiers(self, step: int) -> list[tuple[str, str]]:
        """``(tier, step_dir)`` of every committed copy of ``step``, the
        fastest first: the local copy, then the persistent one."""
        out = []
        local = self._local_step_dir(step)
        if local is not None and os.path.exists(
                os.path.join(local, _META_FILE)):
            out.append(("local", local))
        if os.path.exists(os.path.join(self._step_dir(step), _META_FILE)):
            out.append(("persistent", self._step_dir(step)))
        return out

    def _committed_dir(self, step: int) -> str | None:
        """The first committed copy of ``step`` (the local tier's first),
        or None."""
        tiers = self._restore_tiers(step)
        return tiers[0][1] if tiers else None

    @staticmethod
    def _committed_in(root: str | None) -> list[int]:
        """The committed steps under one tier's root, sorted."""
        if root is None:
            return []
        try:
            names = os.listdir(root)
        except FileNotFoundError:
            return []
        steps = []
        for name in names:
            if name.startswith(_STEP_PREFIX) and not name.endswith(
                    _STAGE_SUFFIX):
                try:
                    step = int(name[len(_STEP_PREFIX):])
                except ValueError:
                    continue
                if os.path.exists(os.path.join(root, name, _META_FILE)):
                    steps.append(step)
        return sorted(steps)

    def _all_steps(self) -> list[int]:
        """The committed steps over both tiers (an emergency save may be
        on the local tier only; a requeued attempt still resumes from
        it)."""
        return sorted(set(self._committed_in(self.directory))
                      | set(self._committed_in(self.local_dir)))

    def _read_meta(self, step: int) -> dict | None:
        for _, step_dir in self._restore_tiers(step):
            try:
                with open(os.path.join(step_dir, _META_FILE)) as f:
                    return json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
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

    def rewind_history(self, step: int) -> None:
        """Drop the metrics-history entries newer than ``step``: a health
        rollback (``obs/health.py``) restores ``step`` and replays the
        discarded trajectory, whose epochs save their steps again, so the
        embedded ``metrics_history`` would otherwise hold duplicate (and
        diverged) entries. The disk is untouched: newer step directories
        go with the next saves' retention."""
        self._metrics_history = [
            m for m in self._metrics_history if m.get("step", 0) <= step]

    # --------------------------------------------------------------- save
    def save(self, step: int, state, metrics: dict | None = None, *,
             data_state: dict | None = None, _upload: bool = True
             ) -> Checkpoint:
        """Save ``state`` (a nested dict of tensors) for ``step`` with
        ``metrics`` and the loader cursor ``data_state``. The host copy is
        made before this returns; the files are written on a thread (at
        once when the manager is not asynchronous). With the local tier
        the step commits there and then uploads (see the module
        docstring)."""
        self.wait_until_finished()
        t0 = time.monotonic()
        ts0 = time.time()
        final_dir = self._step_dir(step)
        local_final = self._local_step_dir(step)
        commit_root = local_final if local_final is not None else final_dir
        stage_dir = commit_root + _STAGE_SUFFIX
        # A step saved again first becomes invisible in every tier, then
        # is replaced: process 0's job, fenced so no process writes before
        # it is done.
        self._barrier()
        if self.rank == 0:
            for d in (final_dir, final_dir + _STAGE_SUFFIX):
                self._drop_step_dir(d)
            if local_final is not None:
                shutil.rmtree(local_final, ignore_errors=True)
                shutil.rmtree(stage_dir, ignore_errors=True)
        self._barrier()
        os.makedirs(stage_dir, exist_ok=True)
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        hist_entry = {"step": step, **metrics}
        self._metrics_history.append(hist_entry)
        meta = {
            "step": step, "metrics": metrics,
            "metrics_history": list(self._metrics_history),
            "process_count": self.world, "device_count": self.world,
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
            if self.rank == 0:
                shutil.rmtree(stage_dir, ignore_errors=True)

        self._pending_fail = (step, fail_cleanup)
        taken = self._pool.taken
        state_dir = os.path.join(stage_dir, _STATE_DIR)
        written: dict = {}

        def record(nbytes: int) -> None:
            # This process's shards are on disk.
            dur = time.monotonic() - t0
            written.update({"step": step, "bytes": nbytes, "seconds": dur,
                            "gbps": nbytes / dur / 1e9 if dur else 0.0,
                            "host_copy_s": self._saver.gather_s,
                            "recycled": self._pool.taken - taken})

        def commit() -> None:
            # Marker inside the staging dir, then one rename publishes the
            # payload and the metadata together; the upload runs after it,
            # retention after the commit. A fault plan's
            # ``ckpt_partial_commit`` leaves the staging dir as a writer
            # killed before the marker would.
            if self.rank == 0:
                if faults.partial_commit():
                    return
                if self.world > 1 and self.format == "raw":
                    raw.merge_manifests(state_dir, policy=self.policy)
                # The marker's stage-and-replace write is the one the
                # KV-page store commits through: one idiom, no drift.
                from tpuflow_torch.infer import kv_store

                marker = os.path.join(stage_dir, _META_FILE)
                raw.retry_io(
                    lambda: kv_store.atomic_write_json(marker, meta),
                    op="write_meta", path=marker,
                    retries=self.policy.retries,
                    backoff_s=self.policy.backoff_s)
                raw.retry_io(lambda: os.replace(stage_dir, commit_root),
                             op="commit", path=commit_root,
                             retries=self.policy.retries,
                             backoff_s=self.policy.backoff_s)
            # One span from save() to the commit (the upload after it is
            # its own), recorded off the training path: on the saver
            # thread when asynchronous.
            rec = obs.recorder()
            if rec is not None:
                dur = time.monotonic() - t0
                rec.record("span", "ckpt.save", ts=ts0, dur_s=dur, step=step,
                           bytes=written["bytes"],
                           gbps=written["bytes"] / dur / 1e9 if dur else 0.0)
            if self.rank == 0 and local_final is not None:
                if _upload:
                    self._upload_step(step, local_final, final_dir)
                self._local_retain()
            self.saves.append(dict(written))

        # The pool's files live on the persistent filesystem: a save
        # staging on the local tier writes fresh files (a rename across
        # filesystems would strand the pool's file).
        pool = self._pool if local_final is None else None
        if self.format == "dcp":
            # A collective write; committed at once, as one process would.
            self._pending_fail = None
            nbytes = dcp.save(state_dir, state)
            record(nbytes)
            del written["host_copy_s"]  # no host copy of its own
            self._barrier()
            commit()
            self._barrier()
            self._retain()
        elif self.world > 1:
            # The commit needs every process: it runs at the next drain,
            # on the main thread (wait_until_finished).
            self._saver.save(state_dir, state, pool=pool,
                             on_commit=record, process_count=self.world,
                             process_index=self.rank)
            self._pending_commit = commit
        else:
            def commit_now(nbytes: int) -> None:
                record(nbytes)
                commit()
                self._retain()

            self._saver.save(state_dir, state, pool=pool,
                             on_commit=commit_now)
        if not self._async:
            self.wait_until_finished()
        if local_final is None:
            return Checkpoint(path=final_dir, metadata=meta)
        if _upload:
            return Checkpoint(path=final_dir, metadata=meta,
                              alt_paths=[local_final])
        return Checkpoint(path=local_final, metadata=meta,
                          alt_paths=[final_dir])

    def _upload_step(self, step: int, src: str, dst: str) -> None:
        """Copy a committed local step to the persistent directory: into
        ``dst.tmp``, then one rename, through ``retry_io``. A failed upload
        leaves the step durable locally: the ``ckpt.upload`` span says
        ``ok=False``, and the save goes on."""
        tmp = dst + _STAGE_SUFFIX

        def copy() -> None:
            faults.maybe_upload_stall()
            shutil.rmtree(tmp, ignore_errors=True)
            try:
                shutil.copytree(src, tmp)
            except shutil.Error as e:  # copytree's many-file error
                raise OSError(errno.EIO, f"upload copy failed: {e}") from e
            os.replace(tmp, dst)

        nbytes = 0
        with contextlib.suppress(OSError, ValueError, KeyError):
            state_dir = os.path.join(src, _STATE_DIR)
            if raw.is_raw(state_dir):
                nbytes = sum(raw.manifest_shard_sizes(state_dir))
        with obs.span("ckpt.upload", step=step, bytes=nbytes) as sp:
            t0 = time.monotonic()
            try:
                raw.retry_io(copy, op="upload", path=dst,
                             retries=self.policy.retries,
                             backoff_s=self.policy.backoff_s)
            except raw.CheckpointIOError as e:
                sp.set(ok=False, error=str(e)[:300])
                return
            dur = time.monotonic() - t0
            sp.set(ok=True, gbps=nbytes / dur / 1e9 if nbytes and dur
                   else 0.0)

    def emergency_save(self, step: int, state, metrics: dict | None = None,
                       *, data_state: dict | None = None,
                       grace_s: float | None = None) -> Checkpoint:
        """The last checkpoint of a closing termination-grace window:
        staged and committed synchronously on the fastest tier (the local
        one when configured), without the upload; the requeued attempt
        resumes from this step, and its next save uploads normally.
        Records ``ckpt.emergency_save`` with the grace left of the budget
        ``grace_s`` (the process's own when None)."""
        ckpt = self.save(step, state, metrics or {}, data_state=data_state,
                         _upload=False)
        self.wait_until_finished()
        grace = grace_remaining_s(grace_s)
        obs.event("ckpt.emergency_save", step=step,
                  tier="local" if self.local_dir else "persistent",
                  ok=self._committed_dir(step) is not None,
                  grace_s=round(grace, 3) if grace is not None else -1.0)
        return ckpt

    def _retain(self) -> None:
        """Keep the newest ``max_to_keep`` steps (of both tiers) plus the
        best step, deleting persistent steps only (the local tier keeps
        its own count). With several processes (a collective): process 0
        decides and makes the doomed steps invisible, each process
        recycles the shard files its manifest fragment lists, then
        process 0 deletes the rest."""
        if self.max_to_keep is None:
            return
        doomed = None
        if self.rank == 0:
            steps = self._all_steps()
            keep = (set(steps[-self.max_to_keep:]) if self.max_to_keep
                    else set())
            best = self._best_step()
            if best is not None:
                keep.add(best)
            doomed = [s for s in self._committed_in(self.directory)
                      if s not in keep]
        if self.world == 1:
            for s in doomed:
                self._drop_step_dir(self._step_dir(s))
            return
        box = [doomed]
        tdist.broadcast_object_list(box, src=0)
        doomed = box[0]
        if not doomed:
            return
        if self.rank == 0:
            for s in doomed:
                with contextlib.suppress(OSError):
                    os.unlink(os.path.join(self._step_dir(s), _META_FILE))
        self._barrier()
        for s in doomed:
            state_dir = os.path.join(self._step_dir(s), _STATE_DIR)
            frag = os.path.join(state_dir, f"manifest.p{self.rank:05d}.json")
            try:
                with open(frag) as f:
                    leaves = json.load(f)["leaves"]
            except (OSError, ValueError):
                continue
            self._pool.adopt_files(os.path.join(state_dir, sh["file"])
                                   for e in leaves for sh in e["shards"])
        self._barrier()
        if self.rank == 0:
            for s in doomed:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _local_retain(self) -> None:
        """The local tier keeps its newest ``local_keep`` steps (plain
        deletes: the pool lives on the persistent filesystem)."""
        for s in self._committed_in(self.local_dir)[:-self.local_keep]:
            shutil.rmtree(self._local_step_dir(s), ignore_errors=True)

    def prewarm(self, state) -> None:
        """Create pool files, in the background, for the saves of
        ``state`` (a tree of tensors, ``meta`` ones included): one a leaf
        at the size ``save`` writes it, for ``max_to_keep`` steps plus the
        best step plus one save in flight. Call once the state exists: the
        first saves then overwrite warm files. Only on memory-backed
        storage (tmpfs), where overwriting a file skips the zeroing of
        fresh pages: on a disk the saves' fsync sets their pace, warm files
        gained nothing there (PERF.md) and writing them costs the disk
        several copies of the state. Not with the local tier, whose saves
        write fresh files. Best-effort: a prewarm that fails leaves the
        saves to write fresh files."""
        if (self.format == "dcp" or self.local_dir is not None
                or not raw._fs_is_memory_backed(self.directory)):
            return
        sizes = [_saved_nbytes(leaf, self.save_dtype)
                 for _, leaf in raw.flatten(state)
                 if self.rank == 0 or isinstance(leaf, raw.Piece)]
        steps = (self.max_to_keep or 1) + (2 if self.best_metric else 1)
        self._pool.prewarm(sizes * steps)

    def prewarm_wait(self) -> None:
        self._pool.prewarm_wait()

    def wait_until_finished(self) -> None:
        """Drain the save in flight (and, with several processes, commit
        it: see the module docstring). A save that died on a
        ``CheckpointIOError`` fails that step's save only (its staging is
        removed, its history entry dropped, ``ckpt.save_failed``
        recorded, a line printed); any other error propagates."""
        pending, self._pending_commit = self._pending_commit, None
        pending_fail, self._pending_fail = self._pending_fail, None
        err = None
        try:
            self._saver.wait()
        except BaseException as e:  # judged below, with the peers' verdicts
            err = e
        soft = isinstance(err, raw.CheckpointIOError)
        if pending is not None:
            # Every process's verdict before the commit barrier, so one
            # failed writer aborts the commit everywhere instead of its
            # peers waiting in the barrier until the collective timeout.
            codes = [None] * self.world
            tdist.all_gather_object(
                codes, 1 if err is None else (2 if soft else 0))
            if 0 in codes:
                if err is not None and not soft:
                    raise err
                raise RuntimeError("checkpoint shard write failed on a "
                                   "peer process; commit aborted on all "
                                   "processes")
            if 2 not in codes:
                self._barrier()
                pending()
                # No process reads the step before process 0 published it.
                self._barrier()
                self._retain()
                return
        if err is not None and not soft:
            raise err
        if err is not None or (pending is not None and 2 in codes):
            if pending_fail is not None:
                pending_fail[1]()
            step = pending_fail[0] if pending_fail else None
            obs.event("ckpt.save_failed",
                      step=step if step is not None else -1,
                      error=str(err)[:300] if err is not None
                      else "a peer process failed")
            print(f"[tpuflow_torch] checkpoint save for step {step} failed "
                  f"after retries; training continues on the previous "
                  f"committed step: {err or 'a peer process failed'}")

    def abandon_pending(self) -> None:
        """Drop a save that can no longer commit (``tpuflow/ckpt/manager.py
        ::abandon_pending``): after an elastic gang lost a member, the dead
        peer's shards never arrive and the commit's collectives would
        raise on every survivor. Joins this process's own shard writes
        only (no collective), drops the step's history entry and records
        ``ckpt.save_failed``; the staging directory stays for the next
        manager's startup sweep (deleting it here would race peers still
        writing into it). The resume point is the last committed step. A
        no-op when nothing is pending; the manager can then ``close``."""
        pending, self._pending_commit = self._pending_commit, None
        pending_fail, self._pending_fail = self._pending_fail, None
        err = None
        try:
            self._saver.wait()
        except BaseException as e:  # the save is abandoned either way
            err = e
        if pending is None and err is None:
            return
        step = pending_fail[0] if pending_fail is not None else None
        if step is not None:
            self._metrics_history = [m for m in self._metrics_history
                                     if m.get("step") != step]
        obs.event("ckpt.save_failed", step=step if step is not None else -1,
                  error=(str(err)[:300] if err is not None else
                         "abandoned: mesh re-form (staging left for the "
                         "startup sweep)"))

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
        if chosen is None or self._committed_dir(chosen) is None:
            raise FileNotFoundError(
                f"no checkpoint {'(best) ' if best else ''}found in "
                f"{self.directory}")
        return chosen

    def prewarm_restore(self, step: int | None = None, *, best: bool = False,
                        background: bool = True, pinned: bool = False,
                        template=None) -> None:
        """Back the destination buffers of a later ``restore`` of ``step``
        (``raw.RestoreArena``; ``pinned``: page-locked, needs CUDA), on a
        background thread unless ``background`` is off. Call as soon as
        the step is known, before the work that precedes the restore. One
        restore per prewarm. A restore that will cast (a ``save_dtype``
        checkpoint into a wider template) takes none of the buffers: do
        not prewarm it. ``template``: the restore's, whose leaves (a
        sharded state's regions) set the buffers' sizes. No step to
        restore: nothing."""
        try:
            chosen = self._resolve_step(step, best)
        except FileNotFoundError:
            return
        state_dir = os.path.join(self._committed_dir(chosen), _STATE_DIR)
        if dcp.is_dcp(state_dir):
            return
        if template is not None:
            raw._ARENA.prewarm(region_sizes(template), background=background,
                               pinned=pinned)
            return
        _prewarm_state_dir(state_dir, background=background, pinned=pinned)

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
        crc-verified as they are read, down the ladder of the module
        docstring: the step's local copy, its persistent copy, then the
        previous committed step; with none left the CorruptShardError
        propagates. The record names the tier and counts the buffers the
        restore took from the arena and the leaves it hands out
        page-locked. A DCP step is read by ``torch.distributed
        .checkpoint`` (no checksums)."""
        chosen = self._resolve_step(step, best)
        corrupt = None
        while True:
            for tier, step_dir in self._restore_tiers(chosen):
                out = self._restore_from(tier, step_dir, chosen,
                                         abstract_state, weights_only,
                                         zero_copy)
                if not isinstance(out, raw.CorruptShardError):
                    obs.event("ckpt.restore_tier", step=chosen, tier=tier)
                    return out
                corrupt = out
                obs.event("ckpt.corrupt", step=chosen, tier=tier,
                          error=str(out)[:300])
                print(f"[tpuflow_torch] checkpoint step {chosen} corrupt on "
                      f"the {tier} tier: {out}")
            prev = [s for s in self._all_steps() if s < chosen]
            if not prev:
                if corrupt is not None:
                    raise corrupt
                raise FileNotFoundError(
                    f"no restorable copy of step {chosen} in "
                    f"{self.directory}")
            print(f"[tpuflow_torch] no valid copy of step {chosen}; falling "
                  f"back to step {prev[-1]}")
            chosen = prev[-1]

    def _restore_from(self, tier: str, step_dir: str, step: int,
                      abstract_state, weights_only: bool, zero_copy: bool):
        """One rung of the ladder: the state read from ``step_dir``, or the
        ``CorruptShardError`` that rejects it (with several processes,
        when any process read a corrupt shard: they fall back together)."""
        state_dir = os.path.join(step_dir, _STATE_DIR)
        t0 = time.monotonic()
        ts0 = time.time()
        if dcp.is_dcp(state_dir):
            out, nbytes = dcp.load(state_dir, abstract_state,
                                   ("params",) if weights_only else None)
            dur = time.monotonic() - t0
            self.restores.append({
                "step": step, "tier": tier, "bytes": nbytes, "seconds": dur,
                "gbps": nbytes / dur / 1e9 if dur else 0.0,
                "arena_buffers": 0, "pinned": 0, "format": "dcp"})
            _restore_span(ts0, self.restores[-1])
            return out
        stats: dict = {}
        corrupt = None
        try:
            with raw._RESTORE_LOCK:  # no other restore's takes counted
                taken = raw._ARENA.taken
                out = raw.restore_raw(
                    state_dir, abstract_state,
                    subtree=("params",) if weights_only else None,
                    policy=self.policy, zero_copy=zero_copy, stats=stats)
                taken = raw._ARENA.taken - taken
        except raw.CorruptShardError as e:
            corrupt = e
        if self.world > 1:
            flags = [None] * self.world
            tdist.all_gather_object(flags, corrupt is not None)
            if any(flags) and corrupt is None:
                corrupt = raw.CorruptShardError(
                    f"step {step}: a peer process read a corrupt shard")
        if corrupt is not None:
            return corrupt
        dur = time.monotonic() - t0
        nbytes = stats["bytes"]
        self.restores.append({
            "step": step, "tier": tier, "bytes": nbytes, "seconds": dur,
            "gbps": nbytes / dur / 1e9 if dur else 0.0,
            "arena_buffers": taken,
            "pinned": sum(t.is_pinned() for _, t in raw.flatten(out))})
        _restore_span(ts0, self.restores[-1])
        return out

    def verify_step(self, step: int | None = None, *, best: bool = False
                    ) -> bool:
        """Recompute one step's shard crc32s on the tier a restore reads
        first; True when all match (a DCP step, which keeps none:
        ``dcp.verify``, its metadata read and its files whole)."""
        chosen = self._resolve_step(step, best)
        state_dir = os.path.join(self._committed_dir(chosen), _STATE_DIR)
        if dcp.is_dcp(state_dir):
            return dcp.verify(state_dir)
        _, bad = raw.verify_dir(state_dir, self.policy)
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
        """A handle to a committed step (path and metadata, no tensors):
        the persistent copy, with the local one as its alternate; the
        local copy alone when the step is committed only there."""
        chosen = self._resolve_step(step, best)
        meta = self._read_meta(chosen) or {}
        pers = self._step_dir(chosen)
        local = self._local_step_dir(chosen)
        if local is None or not os.path.exists(
                os.path.join(local, _META_FILE)):
            return Checkpoint(path=pers, metadata=meta)
        if os.path.exists(os.path.join(pers, _META_FILE)):
            return Checkpoint(path=pers, metadata=meta, alt_paths=[local])
        return Checkpoint(path=local, metadata=meta)


def region_sizes(template) -> list[int]:
    """The bytes of each buffer a restore into ``template`` takes from the
    arena: a ``raw.Piece``'s region, a plain leaf whole."""
    out = []
    for _, leaf in raw.flatten(template):
        t = leaf.data if isinstance(leaf, raw.Piece) else leaf
        out.append(t.numel() * t.element_size())
    return out


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


def _restore_span(ts0: float, record: dict) -> None:
    """One ``ckpt.restore`` span for a restore ``record`` (bytes this
    process read; the GB/s a wall-clock lower bound)."""
    rec = obs.recorder()
    if rec is not None:
        attrs = {"step": record["step"], "bytes": record["bytes"]}
        if record["bytes"] and record["seconds"] > 0:
            attrs["gbps"] = record["gbps"]
        rec.record("span", "ckpt.restore", ts=ts0, dur_s=record["seconds"],
                   **attrs)


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
        state_dir = os.path.join(path, _STATE_DIR)
        if dcp.is_dcp(state_dir):
            return dcp.load(state_dir, abstract_state, subtree)[0]
        return raw.restore_raw(os.path.join(path, _STATE_DIR),
                               abstract_state, subtree=subtree,
                               zero_copy=zero_copy)
