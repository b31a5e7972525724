"""Trainer runtime: the Ray-Train-shaped API over PyTorch data parallelism.

Counterpart of ``tpuflow/train/trainer.py``: ``Trainer(train_loop_per_worker,
train_loop_config, scaling_config, run_config).fit() -> Result``. The loop
body runs once per process (one process per card, ``dist.initialize``),
and ``get_context().report(metrics, state=...)`` records each epoch's
metrics and saves its checkpoint through the ``CheckpointManager``
(retention of ``num_to_keep`` plus the best by ``val_loss``). ``Result``
carries the metrics, their history and checkpoint handles (paths and
metadata, never tensors).

Left out, each with its ROADMAP Queue 1 item: the elastic mesh re-form
(``membership``), the ``HealthMonitor``, goodput, heartbeats, the
preemption drain and the ``obs`` events (items 12 and 15).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable

import torch

from tpuflow_torch import dist
from tpuflow_torch.ckpt import Checkpoint, CheckpointManager
from tpuflow_torch.device import resolve_device

logger = logging.getLogger("tpuflow_torch.train")


@dataclasses.dataclass
class ScalingConfig:
    """``num_workers``: data-parallel processes, one card each (None: the
    processes of the world the rendezvous variables name, else 1).
    ``device``: None means ``cuda`` (``device.resolve_device``, which
    raises where CUDA is absent); the CPU tests pass ``"cpu"``."""

    num_workers: int | None = None
    device: str | None = None
    rendezvous_timeout_s: float = 300.0


@dataclasses.dataclass
class CheckpointConfig:
    """Retention: the newest ``num_to_keep`` steps plus the best by
    ``best_metric`` (``best_mode`` "min" or "max")."""

    num_to_keep: int | None = 2
    best_metric: str = "val_loss"
    best_mode: str = "min"


@dataclasses.dataclass
class RunConfig:
    """``storage_path``: the run's directory (checkpoints under
    ``checkpoints/``, ``metrics.jsonl``); None saves nothing."""

    storage_path: str | None = None
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )


@dataclasses.dataclass
class Result:
    """Metrics and checkpoint handles of a run, JSON-serializable;
    ``mesh_axes`` is the mesh the run trained on (axis → size)."""

    metrics: dict[str, Any]
    metrics_history: list[dict[str, Any]]
    checkpoint: Checkpoint | None
    best_checkpoint: Checkpoint | None
    path: str | None
    mesh_axes: dict[str, int] | None = None

    def to_json(self) -> dict:
        return {
            "metrics": self.metrics,
            "metrics_history": self.metrics_history,
            "checkpoint": self.checkpoint.to_json() if self.checkpoint
            else None,
            "best_checkpoint": (
                self.best_checkpoint.to_json() if self.best_checkpoint
                else None
            ),
            "path": self.path,
            "mesh_axes": self.mesh_axes,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Result":
        def handle(key):
            return Checkpoint.from_json(obj[key]) if obj.get(key) else None

        return cls(
            metrics=obj.get("metrics", {}),
            metrics_history=obj.get("metrics_history", []),
            checkpoint=handle("checkpoint"),
            best_checkpoint=handle("best_checkpoint"),
            path=obj.get("path"),
            mesh_axes=obj.get("mesh_axes"),
        )


class TrainContext:
    """Per-process context: the mesh, the world size and rank, and
    ``report``. Every process opens the checkpoint directory (to resume
    from it); only rank 0 writes to it."""

    def __init__(self, mesh: dist.Mesh, run_config: RunConfig):
        self.mesh = mesh
        self.run_config = run_config
        self._reported: list[dict[str, Any]] = []
        self._manager: CheckpointManager | None = None
        if run_config.storage_path:
            cc = run_config.checkpoint_config
            self._manager = CheckpointManager(
                os.path.join(run_config.storage_path, "checkpoints"),
                max_to_keep=cc.num_to_keep,
                best_metric=cc.best_metric,
                best_mode=cc.best_mode,
            )

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def get_world_size(self) -> int:
        return dist.data_axis_size(self.mesh)

    def get_world_rank(self) -> int:
        return dist.process_index()

    @property
    def checkpoint_manager(self) -> CheckpointManager | None:
        return self._manager

    def prewarm_checkpoints(self, state) -> None:
        """Create the checkpoint pool's files for the saves of ``state``
        (the checkpoint tree, ``meta`` tensors will do) in the background,
        on the rank that saves: called once the state exists, the first
        epoch's compute hides the work (``CheckpointManager.prewarm``)."""
        if self._manager is not None and dist.process_index() == 0:
            self._manager.prewarm(state)

    def report(self, metrics: dict[str, Any], *, state=None,
               step: int | None = None,
               data_state: dict[str, Any] | None = None) -> None:
        """Record one epoch's metrics (cast to floats); with ``state``, save
        it as step ``step``'s checkpoint (asynchronous on one process;
        committed before the barrier on several, so every rank sees it),
        with the loader cursor ``data_state``; append ``metrics.jsonl`` on
        rank 0; end at a barrier."""
        metrics = {k: (float(v) if hasattr(v, "__float__") else v)
                   for k, v in metrics.items()}
        self._reported.append(metrics)
        save_step = step if step is not None else len(self._reported)
        rank0 = dist.process_index() == 0
        if state is not None and self._manager is not None and rank0:
            self._manager.save(save_step, state, metrics=metrics,
                               data_state=data_state)
            if dist.process_count() > 1:
                self._manager.wait_until_finished()
        if self.run_config.storage_path and rank0:
            with open(os.path.join(self.run_config.storage_path,
                                   "metrics.jsonl"), "a") as f:
                f.write(json.dumps({"step": save_step, "time": time.time(),
                                    **metrics}) + "\n")
        logger.info("report[%d]: %s", len(self._reported), metrics)
        dist.barrier(self.mesh)

    def latest_metrics(self) -> dict[str, Any]:
        return self._reported[-1] if self._reported else {}


_ACTIVE_CONTEXT: TrainContext | None = None


def get_context() -> TrainContext:
    """The running ``fit()``'s context."""
    if _ACTIVE_CONTEXT is None:
        raise RuntimeError("get_context() called outside a Trainer.fit() run")
    return _ACTIVE_CONTEXT


class Trainer:
    """``Trainer(loop, train_loop_config=..., scaling_config=...,
    run_config=...).fit()`` runs ``loop(config)`` once in this process
    under a ``TrainContext`` and returns its ``Result``."""

    def __init__(self, train_loop_per_worker: Callable[[dict], None], *,
                 train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()

    def _build_mesh(self) -> dist.Mesh:
        sc = self.scaling_config
        device = resolve_device(sc.device)
        dist.initialize(device, timeout_s=sc.rendezvous_timeout_s)
        world = dist.process_count()
        if sc.num_workers not in (None, -1, world):
            raise ValueError(
                f"num_workers={sc.num_workers} but the world has {world} "
                "process(es): the port runs one worker per process (start "
                "them with RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT)")
        return dist.make_mesh(device)

    def fit(self) -> Result:
        global _ACTIVE_CONTEXT
        start = time.monotonic()
        mesh = self._build_mesh()
        ctx = TrainContext(mesh, self.run_config)
        _ACTIVE_CONTEXT = ctx
        try:
            self.train_loop_per_worker(dict(self.train_loop_config))
        finally:
            _ACTIVE_CONTEXT = None
            if ctx.checkpoint_manager is not None:
                ctx.checkpoint_manager.wait_until_finished()
        dist.barrier(mesh)
        logger.info("fit() finished in %.1fs (%d reports)",
                    time.monotonic() - start, len(ctx._reported))
        mgr = ctx.checkpoint_manager
        latest = best = None
        metrics_history = list(ctx._reported)
        if mgr is not None:
            if mgr.latest_step() is not None:
                latest = mgr.checkpoint()
            if mgr.best_step() is not None:
                best = mgr.checkpoint(best=True)
            mgr.close()
            # After an in-run resume this run reported only its own epochs;
            # the newest checkpoint's history holds them all.
            if latest is not None:
                history = latest.metadata.get("metrics_history", [])
                if len(history) > len(metrics_history):
                    metrics_history = [dict(m) for m in history]
        return Result(
            metrics=ctx.latest_metrics(),
            metrics_history=metrics_history,
            checkpoint=latest,
            best_checkpoint=best,
            path=self.run_config.storage_path,
            mesh_axes=dict(mesh.shape),
        )
