"""Client API: Run / Task / Flow handles and the namespace.

Counterpart of ``tpuflow/flow/client.py``: how a flow reads another run's
artifacts (``Run(pathspec).data.result``, ``Task(pathspec).data...``) and
resolves runs within a namespace. A run's merged telemetry
(``<run_dir>/events.jsonl``) reads as ``Run.telemetry()`` (``obs.
summarize``: aggregates and the headline), ``Run.goodput()`` (``obs.
compute_goodput``: the wall decomposed into buckets) and ``Run.health()``
(``obs.health_summary``); ``Run.events`` here lists the run's records in
the store's event log.
"""

from __future__ import annotations

import getpass
import os
from typing import Any

from tpuflow_torch.flow import store

# Sentinel telling "never set" (the default user namespace) from an
# explicit namespace(None) (global: resolve everything).
_UNSET = object()
_NAMESPACE: Any = _UNSET


def default_namespace() -> str:
    """The namespace runs are produced under when none is set:
    ``user:<login>``."""
    try:
        user = getpass.getuser()
    except (KeyError, OSError):
        user = f"uid{os.getuid()}"
    return f"user:{user}"


def get_namespace() -> str | None:
    """The active namespace: the explicit ``namespace(...)`` value if one
    was set in this process (None = global), else the default."""
    if _NAMESPACE is _UNSET:
        return default_namespace()
    return _NAMESPACE


def namespace(ns: str | None) -> str | None:
    """Scope which runs the client resolves: ``Run``/``Task``/``Flow``
    raise on objects produced under another namespace. ``namespace(None)``
    switches to the global namespace (everything resolves)."""
    global _NAMESPACE
    _NAMESPACE = ns
    return ns


def _check_visible(kind: str, pathspec: str, produced_ns: str | None) -> None:
    """Raise when an object lies outside the active namespace. Runs without
    a recorded namespace stay visible everywhere."""
    active = get_namespace()
    if active is None or produced_ns is None:
        return
    if produced_ns != active:
        raise KeyError(
            f"{kind} {pathspec} belongs to namespace {produced_ns!r}, not "
            f"the active {active!r}; call namespace({produced_ns!r}) to "
            "read it, or namespace(None) for the global namespace"
        )


class _DataNamespace:
    """Attribute access over a dict of artifacts (``run.data.result``)."""

    def __init__(self, artifacts: dict[str, Any]):
        self._artifacts = artifacts

    def __getattr__(self, name: str) -> Any:
        try:
            return self._artifacts[name]
        except KeyError:
            raise AttributeError(f"no artifact {name!r}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._artifacts


def _read_meta(flow: str, run_id) -> dict:
    try:
        return store.read_run_meta(flow, run_id)
    except (OSError, ValueError):  # missing or mid-write run.json
        return {}


class Task:
    """Handle to one task: ``Task("Flow/run_id/step/task_id")``."""

    def __init__(self, pathspec: str):
        parts = pathspec.strip("/").split("/")
        if len(parts) != 4:
            raise ValueError(
                f"task pathspec must be Flow/run_id/step/task_id, got "
                f"{pathspec!r}"
            )
        self.flow, self.run_id, self.step = parts[:3]
        self.task_id = int(parts[3])
        self.pathspec = pathspec
        if not os.path.isdir(
            store.task_dir(self.flow, self.run_id, self.step, self.task_id)
        ):
            raise KeyError(f"no such task: {pathspec}")
        _check_visible("task", pathspec,
                       _read_meta(self.flow, self.run_id).get("namespace"))

    @property
    def data(self) -> _DataNamespace:
        return _DataNamespace(
            store.load_artifacts(self.flow, self.run_id, self.step,
                                 self.task_id)
        )


class Run:
    """Handle to one run: ``Run("Flow/run_id")``. ``run.data`` merges the
    artifacts along the executed steps, later steps winning."""

    def __init__(self, pathspec: str):
        parts = pathspec.strip("/").split("/")
        if len(parts) != 2:
            raise ValueError(
                f"run pathspec must be Flow/run_id, got {pathspec!r}")
        self.flow, self.run_id = parts
        self.pathspec = pathspec
        if not os.path.isdir(store.run_dir(self.flow, self.run_id)):
            raise KeyError(f"no such run: {pathspec}")
        self._meta = _read_meta(self.flow, self.run_id)
        _check_visible("run", pathspec, self._meta.get("namespace"))

    @property
    def meta(self) -> dict:
        # A finished run's metadata does not change; a running one's is
        # read again.
        if self._meta.get("status") not in ("success", "failed"):
            self._meta = _read_meta(self.flow, self.run_id) or self._meta
        return self._meta

    @property
    def successful(self) -> bool:
        return self.meta.get("status") == "success"

    @property
    def data(self) -> _DataNamespace:
        merged: dict[str, Any] = {}
        for rec in self.meta.get("steps", []):
            merged.update(
                store.load_artifacts(
                    self.flow, self.run_id, rec["step"], rec["head_task"]
                )
            )
        return _DataNamespace(merged)

    def __getitem__(self, step: str) -> Task:
        for rec in self.meta.get("steps", []):
            if rec["step"] == step:
                return Task(
                    f"{self.flow}/{self.run_id}/{step}/{rec['head_task']}"
                )
        raise KeyError(f"step {step!r} not found in {self.pathspec}")

    def events(self) -> list[dict]:
        """This run's records in the store's event log (its finish event
        when it succeeded)."""
        return [e for e in store.read_events(self.flow)
                if e.get("run") == self.pathspec]

    def _telemetry_events(self) -> list[dict]:
        """The run's merged telemetry (``events.jsonl``, else merged now
        from the per-process files; empty with telemetry off)."""
        from tpuflow_torch import obs

        return obs.load_run_events(store.run_dir(self.flow, self.run_id))

    def telemetry(self) -> dict:
        """The run's telemetry summary (``obs.summarize``): span
        aggregates, counters, histograms, the health view, the goodput
        ledger, and the headline the timeline card shows (step time,
        tokens/s, checkpoint GB/s, goodput fraction, HBM peak)."""
        from tpuflow_torch import obs

        return obs.summarize(self._telemetry_events())

    def health(self) -> dict:
        """The run's training-health view (``obs.health_summary`` of the
        run's merged telemetry): its anomaly, rollback and profile events,
        the last ``health.*`` gauges, the nonfinite-step and
        dropped-event totals."""
        from tpuflow_torch import obs

        return obs.health_summary(self._telemetry_events())

    def goodput(self) -> dict:
        """The run's goodput ledger (``obs.compute_goodput`` of the merged
        telemetry): the wall decomposed into productive step seconds and
        the compile, restore, data-wait, checkpoint, replay, resize and
        requeue-gap buckets, stitched across gang members and launch
        attempts; ``fraction`` is the productive share."""
        from tpuflow_torch import obs

        return obs.compute_goodput(self._telemetry_events())


class Flow:
    """Handle to a flow's run history: ``Flow("TorchTrain")``, resolved
    within the active namespace."""

    def __init__(self, name: str):
        self.name = name
        if not os.path.isdir(store.flow_dir(name)):
            raise KeyError(f"no such flow: {name}")

    def runs(self) -> list[Run]:
        """All runs in the active namespace, newest first; runs of other
        namespaces are skipped."""
        out = []
        for entry in sorted(
            (e for e in os.listdir(store.flow_dir(self.name)) if e.isdigit()),
            key=int,
            reverse=True,
        ):
            try:
                out.append(Run(f"{self.name}/{entry}"))
            except KeyError:
                continue  # another namespace, or not a run directory
        return out

    @property
    def latest_run(self) -> Run:
        for run in self.runs():
            return run
        raise KeyError(
            f"flow {self.name} has no runs in namespace {get_namespace()!r}")

    @property
    def latest_successful_run(self) -> Run:
        for run in self.runs():
            if run.successful:
                return run
        raise KeyError(
            f"flow {self.name} has no successful runs in namespace "
            f"{get_namespace()!r}"
        )
