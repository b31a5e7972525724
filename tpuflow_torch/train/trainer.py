"""Trainer runtime: the Ray-Train-shaped API over PyTorch data parallelism.

Counterpart of ``tpuflow/train/trainer.py``: ``Trainer(train_loop_per_worker,
train_loop_config, scaling_config, run_config).fit() -> Result``. The loop
body runs once per process (one process per card, ``dist.initialize``),
and ``get_context().report(metrics, state=...)`` records each epoch's
metrics and saves its checkpoint through the ``CheckpointManager``
(retention of ``num_to_keep`` plus the best by ``val_loss``). ``Result``
carries the metrics, their history and checkpoint handles (paths and
metadata, never tensors).

``report`` is the loop's step boundary, as in the JAX package: it
records a ``train.report`` event; the ``HealthMonitor`` judges the
reported loss (``loss``, ``train_loss`` or ``val_loss``, with
``grad_norm`` when reported), and a diverged report skips its save,
waits for the manager and raises ``TrainingDiverged`` (a custom loop
owns its state, so the rollback is the gang retry's, from the clean
newest committed step); after the save the member's gang heartbeat is
stamped with the step, the fault plan's ``step_boundary`` hook runs, and
with the preemption flag up it waits for the save it just made (the
drain checkpoint) and raises ``Preempted``. A requeued attempt resumes
from ``latest_step()`` (``restore_latest``).
``RunConfig(ckpt_local_dir=, faults=, health=)`` take the node-local
checkpoint tier, the fault plan and the health policy (the JAX
package's ``TPUFLOW_CKPT_LOCAL_DIR``, ``TPUFLOW_FAULT`` and
``TPUFLOW_HEALTH*``).

In an elastic gang (``dist/membership.py``) ``report`` is the loop's
step fence: a pending generation (``membership.fence``, on which the
members agree) raises ``MeshReform`` before the report lands, and a
report whose fence, barrier or save fails because a peer died raises it
once the supervisor's plan names the survivors (without a plan the
error goes on unchanged). The fence is a collective, so a step rank 0
commits is one every member of the generation reached. ``fit`` then
re-forms: at a grow it commits what is in flight (abandoning it if that
fails), after a loss it abandons it, closes the manager, joins the next
generation (``quiesce_and_reform``) and runs the loop body again on the
new world, which resumes from ``latest_step()``; the metrics reported so
far carry over, and a ``num_workers`` set for the first world is clamped
to the new one. From generation 1 on every save commits before
``report`` returns.

Custom loops have no ``StepClock``: each report feeds the live goodput
ledger (``obs.goodput_live()``: the step number and the last loss, the
rates derived from the report fences) that a live export serves.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable

import torch

from tpuflow_torch import dist, obs
from tpuflow_torch.ckpt import Checkpoint, CheckpointManager
from tpuflow_torch.device import resolve_device
from tpuflow_torch.dist import membership
from tpuflow_torch.obs.health import (
    HealthConfig,
    HealthMonitor,
    TrainingDiverged,
)
from tpuflow_torch.testing import faults as faults_mod
from tpuflow_torch.utils import heartbeat
from tpuflow_torch.utils.preempt import (
    Preempted,
    launch_attempt,
    preemption_requested,
)

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
    ``checkpoints/``, ``metrics.jsonl``); None saves nothing.
    ``ckpt_local_dir``: the checkpoints' node-local tier (None: none).
    ``faults``: a fault plan (``testing/faults.py``) installed for the
    run as this process's rank (None: the process's own, if any).
    ``health``: the policy ``report`` judges the metrics by
    (``obs/health.py``; True the defaults, False no monitor).
    ``http_port`` / ``http_host``: the live ``/metrics`` + ``/status``
    export ``fit`` starts on process 0 (the JAX package's
    ``TPUFLOW_OBS_HTTP_PORT`` / ``_HOST``; None: no export)."""

    storage_path: str | None = None
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )
    ckpt_local_dir: str | None = None
    faults: str | None = None
    health: HealthConfig | bool = True
    http_port: int | None = None
    http_host: str = "127.0.0.1"


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
        self._health = HealthMonitor.of(run_config.health)
        if run_config.storage_path:
            cc = run_config.checkpoint_config
            self._manager = CheckpointManager(
                os.path.join(run_config.storage_path, "checkpoints"),
                max_to_keep=cc.num_to_keep,
                best_metric=cc.best_metric,
                best_mode=cc.best_mode,
                local_dir=run_config.ckpt_local_dir,
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
        """Record one epoch's metrics (cast to floats; a ``train.report``
        event); a diverged report (the health monitor's verdict) saves
        nothing and raises ``TrainingDiverged``; with ``state``, save it
        as step ``step``'s checkpoint (asynchronous on one process;
        committed before the barrier on several, so every rank sees it,
        and on a retried or requeued attempt or a re-formed generation),
        with the loader cursor ``data_state``; append ``metrics.jsonl`` on
        rank 0; end at a barrier. Then the step boundary: the heartbeat,
        the fault plan's hook, and with the preemption flag up the save
        just made is the drain checkpoint: wait for it and raise
        ``Preempted``. In an elastic gang a pending generation raises
        ``MeshReform`` first, and a failed barrier or save raises it once
        the supervisor's plan is out (see the module docstring)."""
        # Every member reached this step before rank 0 commits it: the
        # fence is a collective in an elastic gang.
        plan = self._reforming(membership.fence)
        if plan is not None:
            raise membership.MeshReform(plan)
        metrics = {k: (float(v) if hasattr(v, "__float__") else v)
                   for k, v in metrics.items()}
        self._reported.append(metrics)
        save_step = step if step is not None else len(self._reported)
        obs.event("train.report", step=save_step,
                  **{k: v for k, v in metrics.items()
                     if isinstance(v, (int, float))})
        obs.goodput_live().note_report(
            save_step, loss=next((metrics[k] for k in ("loss", "train_loss",
                                                       "val_loss")
                                  if isinstance(metrics.get(k), (int, float))),
                                 None))
        if self._health is not None:
            loss = next((metrics[k] for k in ("loss", "train_loss",
                                              "val_loss")
                         if isinstance(metrics.get(k), float)), None)
            if loss is not None:
                gn = metrics.get("grad_norm")
                anomaly = self._health.observe(
                    save_step, loss, gn if isinstance(gn, float) else None)
                if anomaly is not None:
                    if self._manager is not None:
                        self._manager.wait_until_finished()
                    raise TrainingDiverged(
                        anomaly,
                        hint="report skipped the checkpoint save; the "
                        "newest committed step is clean — a gang retry "
                        "resumes from it")
        self._reforming(lambda: self._land(save_step, metrics, state,
                                           data_state))
        heartbeat.beat(save_step)
        faults_mod.step_boundary(save_step)
        if preemption_requested():
            if self._manager is not None:
                self._manager.wait_until_finished()
            raise Preempted(
                f"preempted; drained checkpoint at step {save_step}")

    def _land(self, save_step: int, metrics: dict, state,
              data_state) -> None:
        """The report's save (rank 0), ``metrics.jsonl`` line and barrier."""
        rank0 = dist.process_index() == 0
        if state is not None and self._manager is not None and rank0:
            self._manager.save(save_step, state, metrics=metrics,
                               data_state=data_state)
            if (dist.process_count() > 1 or launch_attempt() > 0
                    or membership.current_generation() > 0):
                # A retried attempt (or a re-formed generation, which may
                # replay) commits each step before going on, so a crash
                # that repeats at a later step cannot keep the resume
                # point from moving.
                self._manager.wait_until_finished()
        if self.run_config.storage_path and rank0:
            with open(os.path.join(self.run_config.storage_path,
                                   "metrics.jsonl"), "a") as f:
                f.write(json.dumps({"step": save_step, "time": time.time(),
                                    **metrics}) + "\n")
        logger.info("report[%d]: %s", len(self._reported), metrics)
        dist.barrier(self.mesh)

    @staticmethod
    def _reforming(fn):
        """``fn()``; an error of a collective whose peer died (the
        supervisor's plan appears within ``REFORM_WAIT_S``) becomes
        ``MeshReform``, any other error goes on unchanged."""
        try:
            return fn()
        except Exception as e:
            plan = membership.reform_after_failure(e)
            if plan is None:
                raise
            raise membership.MeshReform(plan) from e

    def latest_step(self) -> int:
        """The newest committed checkpoint step, 0 when there is none: a
        retried or requeued attempt resumes from ``latest_step() + 1``."""
        if self._manager is None:
            return 0
        return self._manager.latest_step() or 0

    def restore_latest(self, abstract_state=None):
        """The newest committed checkpoint's state (crc-verified, the local
        tier first, down the manager's fallback ladder); None when there
        is none."""
        if self._manager is None or self._manager.latest_step() is None:
            return None
        return self._manager.restore(abstract_state=abstract_state)

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
        membership.check_world()
        world = dist.process_count()
        n = sc.num_workers
        if n not in (None, -1, world) and membership.current_generation():
            # A re-formed elastic world: the one the caller asked for is
            # gone, and the data axis absorbs the resize.
            logger.info("elastic generation %d: num_workers %d -> %d",
                        membership.current_generation(), n, world)
            n = world
        if n not in (None, -1, world):
            raise ValueError(
                f"num_workers={sc.num_workers} but the world has {world} "
                "process(es): the port runs one worker per process (start "
                "them with RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT)")
        return dist.make_mesh(device)

    def fit(self) -> Result:
        """Run the loop body to its end, once a mesh generation (see the
        module docstring: an elastic gang re-enters it after each
        re-form)."""
        global _ACTIVE_CONTEXT
        # The live goodput ledger restarts for this fit; the reports feed
        # it, and process 0 serves it when an export port is configured.
        obs.goodput_live().reset()
        if self.run_config.http_port is not None:
            obs.start_export(self.run_config.http_port,
                             host=self.run_config.http_host,
                             proc=dist.process_index())
        start = time.monotonic()
        carry: list[dict[str, Any]] = []
        reforms = 0
        mesh = self._build_mesh()
        rank = (membership.member_id() if membership.enabled()
                else dist.process_index())
        with faults_mod.installing(self.run_config.faults, rank=rank):
            while True:
                ctx = TrainContext(mesh, self.run_config)
                ctx._reported = list(carry)
                _ACTIVE_CONTEXT = ctx
                plan = None
                try:
                    self.train_loop_per_worker(dict(self.train_loop_config))
                except membership.MeshReform as rf:
                    plan = rf.plan
                except Exception as e:
                    # The body's own collective died with a peer.
                    plan = membership.reform_after_failure(e)
                    if plan is None:
                        raise
                finally:
                    _ACTIVE_CONTEXT = None
                    if plan is None and ctx.checkpoint_manager is not None:
                        ctx.checkpoint_manager.wait_until_finished()
                if plan is None:
                    break
                mgr = ctx.checkpoint_manager
                if mgr is not None:
                    if plan.reason == "grow":
                        # Everyone is alive at a grow: what is in flight
                        # commits.
                        try:
                            mgr.wait_until_finished()
                        except Exception:
                            mgr.abandon_pending()
                    else:
                        mgr.abandon_pending()
                    mgr.close()
                carry = list(ctx._reported)
                reforms += 1
                logger.info("mesh re-form: generation %d (%s, %d members)",
                            plan.generation, plan.reason,
                            plan.num_processes)
                membership.quiesce_and_reform(plan)
                mesh = self._build_mesh()
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
            # the manager's history (rebuilt from the newest committed
            # step, plus this run's saves, a torn commit's too) holds them
            # all. After a re-form it is also the one without the steps
            # the next generation replayed.
            if mgr._metrics_history and (
                    reforms or len(mgr._metrics_history)
                    > len(metrics_history)):
                metrics_history = [dict(m) for m in mgr._metrics_history]
        return Result(
            metrics=ctx.latest_metrics(),
            metrics_history=metrics_history,
            checkpoint=latest,
            best_checkpoint=best,
            path=self.run_config.storage_path,
            mesh_axes=dict(mesh.shape),
        )
