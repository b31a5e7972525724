"""Training health: the numerics policy and divergence handling
(counterpart of ``tpuflow/obs/health.py``).

- ``HealthMonitor`` — a host-side policy fed one observation per fenced
  train step (loss, global grad norm, the nonfinite flag the step
  computes on the device, ``train/optim.py::health_stats``). Detectors: a
  budget of consecutive nonfinite steps, an absolute grad-norm threshold,
  and a rolling median+MAD loss-spike test. A detection records a
  ``health.anomaly`` event and returns an ``Anomaly`` for the loop.
- ``handle_anomaly`` — rollback or halt: with rollback on (the default)
  the newest checkpoint step whose shards pass crc32 verification
  (``last_verified_step``) for the loop to restore; otherwise
  ``TrainingDiverged`` with a diagnostic.
- ``ProfileWindow`` — a ``torch.profiler`` trace of exactly the train
  steps ``start..stop``, saved under ``<obs dir>/profile/`` and recorded
  as a ``health.profile`` event.
- ``health_summary`` — the run-health view of an event stream.

The JAX package reads its policy from ``TPUFLOW_HEALTH*`` and its window
from ``TPUFLOW_PROFILE``; here ``HealthConfig`` and ``ProfileWindow.make``
take them as arguments (``train_gpt(health=, profile=)``,
``RunConfig(health=)``).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import statistics
from typing import Any

from tpuflow_torch import obs


@dataclasses.dataclass
class HealthConfig:
    """The training-health policy, with the JAX package's defaults.

    - ``enabled``        False removes the monitor (the JAX
                         ``TPUFLOW_HEALTH=0``)
    - ``rollback``       False halts with a diagnostic instead of rolling
                         back to the newest verified checkpoint
    - ``nan_budget``     consecutive nonfinite steps that trip the
                         detector (1: the first NaN/Inf step, whose update
                         has already poisoned params and moments)
    - ``window``         the rolling loss window
    - ``warmup``         observations before the spike test judges
    - ``spike_mads``     the spike threshold in robust sigmas above the
                         window's median (sigma = 1.4826 MAD, floored at 1%
                         of the median)
    - ``grad_norm_max``  absolute grad-norm threshold (0: off)
    - ``max_rollbacks``  rollbacks before anomalies halt anyway
    - ``lr_backoff``     the learning-rate factor each rollback applies
                         (1.0: off)
    """

    enabled: bool = True
    rollback: bool = True
    nan_budget: int = 1
    window: int = 64
    warmup: int = 16
    spike_mads: float = 12.0
    grad_norm_max: float = 0.0
    max_rollbacks: int = 2
    lr_backoff: float = 1.0


@dataclasses.dataclass(frozen=True)
class Anomaly:
    """One detected divergence: what tripped, at which optimizer step."""

    kind: str          # nonfinite | grad_explosion | loss_spike
    step: int
    detail: dict[str, Any]

    def describe(self) -> str:
        parts = ", ".join(f"{k}={v}" for k, v in sorted(self.detail.items()))
        return f"{self.kind} at step {self.step} ({parts})"


class TrainingDiverged(RuntimeError):
    """Raised when an anomaly cannot (or must not) be rolled back: the run
    halts with a diagnostic instead of reporting NaN losses."""

    def __init__(self, anomaly: Anomaly, *, hint: str = ""):
        self.anomaly = anomaly
        msg = (f"training diverged: {anomaly.describe()}. "
               "No rollback was performed")
        if hint:
            msg += f" ({hint})"
        msg += (". Arguments: health=HealthConfig(rollback=True) re-enables "
                "checkpoint rollback, health=False disables monitoring, "
                "HealthConfig(nan_budget=, spike_mads=, grad_norm_max=) "
                "tune the detectors (README: Training health on the port).")
        super().__init__(msg)


class HealthMonitor:
    """Rolling-statistics divergence detector, one a run. Feed it one
    observation per fenced step; it returns an ``Anomaly`` when a detector
    trips (recording a ``health.anomaly`` event), else None."""

    def __init__(self, cfg: HealthConfig | None = None):
        self.cfg = cfg or HealthConfig()
        self._window: collections.deque[float] = collections.deque(
            maxlen=self.cfg.window)
        self._nan_streak = 0
        self.rollbacks = 0
        self.last: dict[str, float] = {}

    @classmethod
    def of(cls, health: HealthConfig | bool) -> "HealthMonitor | None":
        """The run's monitor for ``health`` (True: the defaults), or None
        when it disables monitoring."""
        cfg = (health if isinstance(health, HealthConfig)
               else HealthConfig(enabled=bool(health)))
        return cls(cfg) if cfg.enabled else None

    def observe(self, step: int, loss: float,
                grad_norm: float | None = None,
                nonfinite: bool | None = None) -> Anomaly | None:
        if nonfinite is None:
            nonfinite = not math.isfinite(loss) or (
                grad_norm is not None and not math.isfinite(grad_norm))
        self.last = {
            "step": step,
            "loss": loss,
            "grad_norm": grad_norm if grad_norm is not None else float("nan"),
        }
        if nonfinite:
            self._nan_streak += 1
            if self._nan_streak >= self.cfg.nan_budget:
                return self._anomaly(
                    "nonfinite", step, loss=loss, grad_norm=grad_norm,
                    streak=self._nan_streak, budget=self.cfg.nan_budget)
            return None
        self._nan_streak = 0
        if (self.cfg.grad_norm_max > 0.0 and grad_norm is not None
                and grad_norm > self.cfg.grad_norm_max):
            return self._anomaly("grad_explosion", step, grad_norm=grad_norm,
                                 threshold=self.cfg.grad_norm_max)
        if len(self._window) >= self.cfg.warmup:
            med = statistics.median(self._window)
            mad = statistics.median(abs(x - med) for x in self._window)
            # A flat window (MAD ~ 0) must not brand ordinary jitter.
            sigma = max(1.4826 * mad, 0.01 * abs(med), 1e-6)
            threshold = med + self.cfg.spike_mads * sigma
            if loss > threshold:
                # Not appended: the window stays the pre-spike baseline.
                return self._anomaly(
                    "loss_spike", step, loss=loss, median=round(med, 6),
                    threshold=round(threshold, 6), window=len(self._window))
        self._window.append(loss)
        return None

    def rolled_back(self) -> None:
        """After a rollback: the streak belonged to the discarded
        trajectory; the loss window is pre-anomaly history and stays."""
        self.rollbacks += 1
        self._nan_streak = 0

    def _anomaly(self, kind: str, step: int, **detail) -> Anomaly:
        detail = {k: (float(v) if isinstance(v, float) else v)
                  for k, v in detail.items() if v is not None}
        # 'detector', not 'kind': the record schema owns "kind".
        obs.event("health.anomaly", detector=kind, step=step, **detail)
        return Anomaly(kind=kind, step=step, detail=detail)


# ------------------------------------------------------------- rollback
def last_verified_step(manager) -> int | None:
    """The newest checkpoint step whose shards pass verification
    (``CheckpointManager.verify_step``), or None (also without a
    manager). A manager of several processes (``multi_process``) is
    collective: every process waits for its saves, process 0 alone
    verifies, and its answer is broadcast, so every process restores the
    same step."""
    if manager is None:
        return None
    steps = manager.all_steps()  # drains (and commits) the saves in flight
    world = getattr(manager, "world", 1)
    target = None
    if getattr(manager, "rank", 0) == 0:
        for step in reversed(steps):
            try:
                if manager.verify_step(step):
                    target = step
                    break
            except (OSError, ValueError):
                continue
    if world > 1:
        import torch.distributed as tdist

        box = [target]
        tdist.broadcast_object_list(box, src=0)
        target = box[0]
    return target


def handle_anomaly(monitor: HealthMonitor, anomaly: Anomaly, manager) -> int:
    """The anomaly's fate: the verified step to roll back to, or
    ``TrainingDiverged`` when the policy forbids it, the budget is spent
    or nothing verified exists. The caller restores and records the
    ``health.rollback`` event."""
    cfg = monitor.cfg
    if not cfg.rollback:
        raise TrainingDiverged(anomaly,
                               hint="health=HealthConfig(rollback=False)")
    if monitor.rollbacks >= cfg.max_rollbacks:
        raise TrainingDiverged(
            anomaly, hint=f"rollback budget exhausted "
            f"({monitor.rollbacks}/{cfg.max_rollbacks})")
    target = last_verified_step(manager)
    if target is None:
        raise TrainingDiverged(anomaly,
                               hint="no verified checkpoint to restore")
    monitor.rolled_back()
    return target


class _RollbackSignal(Exception):
    """Control flow: unwind the epoch loop to the restore point, with the
    verified target step and the anomaly that caused it."""

    def __init__(self, target: int, anomaly: Anomaly):
        self.target = target
        self.anomaly = anomaly
        super().__init__(f"rollback to step {target}: {anomaly.describe()}")


# ------------------------------------------------------ windowed profiler
class ProfileWindow:
    """A ``torch.profiler`` trace of exactly the train steps
    ``start..stop`` (1-based optimizer steps, inclusive), CUDA activity
    included on the card, exported as a chrome trace into ``out_dir``.
    Best effort: a profiler failure is printed, never raised."""

    def __init__(self, start: int, stop: int, out_dir: str, *,
                 cuda: bool = False):
        self.start = start
        self.stop = stop
        self.out_dir = out_dir
        self.cuda = cuda
        self.path: str | None = None
        self._tracer = None
        self._active = False
        self._done = False

    @classmethod
    def make(cls, window: tuple[int, int] | None, out_dir: str | None = None,
             *, cuda: bool = False) -> "ProfileWindow | None":
        """The window ``(start, stop)``, or None (printing why) when there
        is none, it is empty, or there is nowhere to write: ``out_dir``
        defaults to ``<obs dir>/profile`` of the configured recorder."""
        if window is None:
            return None
        start, stop = (int(v) for v in window)
        if start < 1 or stop < start:
            print(f"[tpuflow_torch] profile window {window!r} is empty; "
                  "profiling disabled")
            return None
        if out_dir is None:
            rec = obs.recorder()
            if rec is not None:
                out_dir = os.path.join(rec.directory, "profile")
        if not out_dir:
            print("[tpuflow_torch] profile window set but no obs recorder is "
                  "configured and no directory was given; profiling disabled")
            return None
        return cls(start, stop, out_dir, cuda=cuda)

    def maybe_start(self, step: int) -> None:
        """Call before optimizer step ``step``."""
        if self._active or self._done or step < self.start:
            return
        try:
            from tpuflow_torch.obs.profcap import TorchTracer

            self._tracer = TorchTracer(cuda=self.cuda)
            self._tracer.start(self.out_dir)
            self._active = True
        except Exception as e:
            self._done = True
            print(f"[tpuflow_torch] profiler start failed (ignored): {e!r}")

    def maybe_stop(self, step: int) -> None:
        """Call after fencing optimizer step ``step``."""
        if not self._active or step < self.stop:
            return
        self._active = False
        self._done = True
        try:
            self._tracer.stop(
                f"trace_steps{self.start}-{self.stop}.pid{os.getpid()}.json")
            self.path = self._tracer.trace_path
        except Exception as e:
            print(f"[tpuflow_torch] profiler stop failed (ignored): {e!r}")
        self._tracer = None
        obs.event("health.profile", start_step=self.start,
                  stop_step=self.stop, dir=self.out_dir)

    def close(self) -> None:
        """End of run: a window whose stop step never came must not leave
        the profiler running."""
        if self._active:
            self.maybe_stop(self.stop)


# ------------------------------------------------------------- summaries
def health_summary(events) -> dict[str, Any]:
    """Fold an event stream into the run-health view (``Run.health()``):
    anomalies, rollbacks and profile windows (compact dicts), the last
    ``health.*`` gauges, the nonfinite-step and dropped-event totals."""
    out: dict[str, Any] = {
        "anomalies": [],
        "rollbacks": [],
        "profiles": [],
        "last": {},
        "nonfinite_steps": 0.0,
        "dropped_events": 0.0,
    }
    for ev in events:
        name = ev.get("name", "")
        kind = ev.get("kind")
        if kind == "event":
            compact = {k: v for k, v in ev.items()
                       if k not in ("kind", "name", "pid")}
            if name == "health.anomaly":
                out["anomalies"].append(compact)
            elif name == "health.rollback":
                out["rollbacks"].append(compact)
            elif name == "health.profile":
                out["profiles"].append(compact)
            elif name == "obs.dropped":
                out["dropped_events"] += float(ev.get("value", 0.0))
        elif kind == "counter" and name == "health.nonfinite":
            out["nonfinite_steps"] += float(ev.get("value", 1.0))
        elif kind == "gauge" and name.startswith("health."):
            out["last"][name[len("health."):]] = float(ev.get("value", 0.0))
    return out
