"""Flow execution engine and CLI.

Counterpart of ``tpuflow/flow/runner.py``. Steps execute in transition
order from ``start`` to ``end``; ``@retry`` reruns failures after a
jittered exponential backoff, and a member's requeue exit reruns a step
without spending its retries; gang steps (``num_parallel`` > 1 or
``@gpu``) launch N processes that form one ``torch.distributed`` world
(``flow/gang_exec.py``), only the head persisting artifacts, and a join
step sees the members as inputs (members without artifacts raise
``AttributeError``, which a tolerant join absorbs); a run that succeeds
appends a trigger event that ``--triggered`` runs downstream consume.

CLI (``main``): ``run`` / ``trigger`` / ``show``, parameters as
``--name value``, ``--triggered``, ``--home <dir>`` for the store's root,
and ``--registry <path>`` for the run registry. ``deploy`` waits for the
flow layer's remainder and raises.

Run registry (``FlowRunner(registry_path=)``, the JAX package's
``TPUFLOW_REGISTRY_PATH``; None: off): a run that succeeds in process
appends one ``train`` record of the live goodput ledger's headline
(``obs/registry.py::maybe_append_live``) before its telemetry is
finalised, while the recorder is still open; a run with a gang step
appends none here, its member 0 did (``flow/gang_exec.py``).

A flow whose ``device`` parameter asks for ``cuda`` on a machine without
a card raises before the run is created; nothing falls back to the CPU.

Telemetry and robustness, as the JAX runner's (which reads them from its
environment): with ``obs`` (the default) the head records the run under
``<run_dir>/obs`` (``flow.run``, a ``flow.step`` span an attempt, the
supervisor's ``flow.preempt`` and ``flow.member_failed`` events), each
gang member its own file there, and the run's end merges them into
``<run_dir>/events.jsonl``. ``faults`` (a fault plan) is installed in
every step, as rank 0 in process and as its rank in each member;
``ckpt_local_dir`` (the node-local checkpoint tier) reaches the steps as
``current.ckpt_local_dir``. A member's grace budget after a SIGTERM is
the supervisor's ``KILL_GRACE_S``. Each gang member stamps its own
heartbeat file (``heartbeat_<i>`` in the task directory, cleared before
every launch); the supervisor kills a gang whose member's stamp is older
than the step's ``@gpu(heartbeat_timeout=)`` (the JAX package's
``TPUFLOW_STALL_TIMEOUT_S``) and records ``flow.heartbeat_stall``.

Elastic gangs (``FlowRunner(elastic=True)``, the JAX package's
``TPUFLOW_ELASTIC=1``): each launch gets a membership directory
(``dist/membership.py``), and a member's loss no longer fails the step.
The supervisor records ``flow.member_lost`` and announces a shrink
generation over the survivors, which re-form at their next step fence;
a member that crashed (not a ``member_lost`` fault) is relaunched once
the survivors have stamped a heartbeat in the new generation (or after
``REJOIN_HOLD_S``), asks to join, and a grow generation re-adds it.
Each formed generation records a ``flow.gang_resize`` span. The classic
verdict stays when the coordinator (member 0) is lost, when the
survivors fall below the step's ``@gpu(min_members=)`` (None: 2), when
``max_resizes`` re-forms are spent, and when a re-form misses its
``reform_timeout_s`` deadline (reported as ``member_failed``). The stall
verdict is suspended while a re-form is in flight.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import pickle
import random
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from typing import Any

import torch

from tpuflow_torch import obs
from tpuflow_torch.device import resolve_device
from tpuflow_torch.dist import membership
from tpuflow_torch.flow import store
from tpuflow_torch.flow.cards import CardBuffer
from tpuflow_torch.flow.client import Run, default_namespace, get_namespace
from tpuflow_torch.flow.spec import FlowSpec, _Trigger, current
from tpuflow_torch.testing import faults as faults_mod
from tpuflow_torch.utils.preempt import REQUEUE_EXIT_CODE

ROADMAP_DEPLOY = ("ROADMAP Queue 1 item 8b (the flow layer's remainder: "
                  "flow/deploy.py)")


class StepFailed(Exception):
    pass


class StepPreempted(StepFailed):
    """A gang member exited with the requeue code: the step reruns without
    spending its ``@retry`` budget."""


# Injectable time sources: tests pin the jitter and capture the sleeps.
_sleep = time.sleep
_random = random.random

# Supervisor poll cadence: fail-fast reaction in tens of milliseconds.
_GANG_POLL_S = 0.05
# Seconds a gang member may take to start (interpreter, imports) before its
# rendezvous timeout starts to count, in the supervisor's formation
# deadline.
FORMATION_SLACK_S = 60.0
# Seconds between the SIGTERM and the SIGKILL a failed gang's survivors
# get (each drains at its next step boundary and exits with the requeue
# code); also the grace budget the members are told.
KILL_GRACE_S = 5.0
# Requeues a step may take before its run fails (a preemption storm).
MAX_REQUEUES = 8
# Seconds a member's heartbeat may stay silent when the step's @gpu names
# no heartbeat_timeout (the JAX package's default).
HEARTBEAT_TIMEOUT_S = 600.0
# An elastic gang's floor when the step's @gpu names no min_members (the
# JAX package's TPUFLOW_GANG_MIN_MEMBERS default).
MIN_MEMBERS = 2
# The longest an elastic gang holds a relaunch for the survivors' first
# heartbeat in their new generation (the JAX package's
# TPUFLOW_REJOIN_HOLD_S).
REJOIN_HOLD_S = 10.0


def _backoff_delay(attempt: int, backoff_s: float,
                   max_backoff_s: float) -> float:
    """Exponential backoff with 0.5-1.0 jitter for retry ``attempt``
    (1-based)."""
    base = min(max_backoff_s, backoff_s * (2.0 ** (attempt - 1)))
    return base * (0.5 + 0.5 * _random())


class _GangInput:
    """One gang member as a join step sees it: members other than the head
    have no artifacts, and reading one raises ``AttributeError``."""

    def __init__(self, artifacts: dict[str, Any] | None):
        self._artifacts = artifacts or {}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._artifacts[name]
        except KeyError:
            raise AttributeError(
                f"no artifact {name!r} on this gang member") from None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _DeviceProfiler:
    """Background sampler of each card's memory: every ``interval``
    seconds ``torch.cuda.memory_allocated`` and ``max_memory_allocated``
    per card. Writes ``profile.json`` with the platform (``gpu`` or
    ``cpu``) and the cards' names."""

    def __init__(self, interval: float, out_path: str, device: torch.device):
        self.interval = interval
        self.out_path = out_path
        self.cuda = device.type == "cuda"
        self.samples: list[dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _sample(self) -> None:
        devices = []
        if self.cuda:
            for i in range(torch.cuda.device_count()):
                devices.append({
                    "id": i,
                    "bytes_in_use": torch.cuda.memory_allocated(i),
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                })
        self.samples.append({"ts": time.time(), "devices": devices})

    def _loop(self):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(self.interval)

    def __enter__(self):
        if self.cuda:
            for i in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(i)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self._sample()  # the step's final peak
        kinds = ([torch.cuda.get_device_name(i)
                  for i in range(torch.cuda.device_count())]
                 if self.cuda else [])
        with open(self.out_path, "w") as f:
            json.dump({"interval": self.interval,
                       "platform": "gpu" if self.cuda else "cpu",
                       "device_kinds": kinds, "samples": self.samples}, f)


@contextlib.contextmanager
def _step_trace(trace_dir: str, device: torch.device):
    """A ``torch.profiler`` chrome trace of the step into
    ``trace_dir/trace.json`` (CUDA activity too on the card)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class FlowRunner:
    """Runs one flow class. ``faults``: a fault plan for every step (the
    JAX package's ``TPUFLOW_FAULT``); ``ckpt_local_dir``: the node-local
    checkpoint tier (its ``TPUFLOW_CKPT_LOCAL_DIR``); ``obs``: record the
    run's telemetry (its ``TPUFLOW_OBS``). ``elastic``: gang steps shrink
    and grow on member loss instead of failing (its ``TPUFLOW_ELASTIC``;
    see the module docstring), with ``reform_timeout_s`` for a re-form to
    complete and ``max_resizes`` re-forms a launch (its
    ``TPUFLOW_REFORM_TIMEOUT_S`` and ``TPUFLOW_MAX_RESIZES``).
    ``registry_path``: the run registry a successful run appends its
    ``train`` record to (its ``TPUFLOW_REGISTRY_PATH``; None: none)."""

    def __init__(self, flow_cls: type[FlowSpec], *,
                 faults: str | None = None,
                 ckpt_local_dir: str | None = None, obs: bool = True,
                 elastic: bool = False, reform_timeout_s: float = 120.0,
                 max_resizes: int = 8, registry_path: str | None = None):
        self.flow_cls = flow_cls
        self.flow_name = flow_cls.__name__
        faults_mod.parse(faults or "")  # a malformed plan raises here
        self.faults = faults
        self.ckpt_local_dir = ckpt_local_dir
        self.obs = obs
        self.elastic = elastic
        self.reform_timeout_s = float(reform_timeout_s)
        self.max_resizes = int(max_resizes)
        self.registry_path = registry_path
        self._obs_dir = None

    # ----------------------------------------------------------------- run
    def run(self, params: dict[str, Any], *, triggered: bool = False,
            run_id: int | None = None) -> str:
        steps = self.flow_cls.steps()
        if "start" not in steps or "end" not in steps:
            raise ValueError("flow must define 'start' and 'end' steps")
        # A flow asked for the card on a machine without one raises here,
        # before any run exists.
        self.device = resolve_device(params["device"]) if "device" in params \
            else torch.device("cpu")
        run_id = run_id if run_id is not None else store.new_run_id(
            self.flow_name)
        meta = {
            "flow": self.flow_name,
            "run_id": run_id,
            "status": "running",
            # A run is always produced under a concrete namespace: the
            # global scope (None) reads only.
            "namespace": get_namespace() or default_namespace(),
            "params": {k: _jsonable(v) for k, v in params.items()},
            "started": time.time(),
            "steps": [],
            "schedule": getattr(self.flow_cls, "__schedule__", None),
            "trigger_on_finish": getattr(self.flow_cls,
                                         "__trigger_on_finish__", None),
        }
        flow = self.flow_cls()
        for name, value in params.items():
            setattr(flow, name, value)
        self._trigger_run = None
        upstream = getattr(self.flow_cls, "__trigger_on_finish__", None)
        if triggered and upstream:
            events = [e for e in store.read_events(upstream)
                      if e.get("status") == "success"]
            if events:
                self._trigger_run = Run(events[-1]["run"])
                meta["triggered_by"] = events[-1]["run"]
        store.write_run_meta(self.flow_name, run_id, meta)

        pathspec = f"{self.flow_name}/{run_id}"
        print(f"[tpuflow_torch] run {pathspec} starting")
        rdir = store.run_dir(self.flow_name, run_id)
        if self.obs:
            # The head records here; each gang member writes its own file
            # beside it; the run's end merges them.
            self._obs_dir = os.path.join(rdir, "obs")
            obs.configure(self._obs_dir, proc=0)
        run_span = obs.span("flow.run", flow=self.flow_name,
                            run=str(run_id))
        run_span.__enter__()
        step_name, task_counter = "start", 0
        ran_gang = False
        try:
            while True:
                fn = steps[step_name]
                task_id = task_counter
                gang = getattr(fn, "__gang__", None) or {}
                num_parallel = 1
                transition = getattr(flow, "_next", None)
                if transition is not None and transition.target == step_name:
                    num_parallel = transition.num_parallel
                if gang.get("num_parallel"):
                    num_parallel = max(num_parallel, gang["num_parallel"])
                task_counter += num_parallel  # members own task_id..+N-1
                ran_gang = ran_gang or num_parallel > 1
                object.__setattr__(flow, "_next", None)
                gang_inputs = self._run_step(flow, fn, step_name, run_id,
                                             task_id, num_parallel, gang)
                meta["steps"].append({"step": step_name, "head_task": task_id,
                                      "tasks": num_parallel})
                store.write_run_meta(self.flow_name, run_id, meta)
                if step_name == "end":
                    break
                transition = getattr(flow, "_next", None)
                if transition is None:
                    raise StepFailed(
                        f"step {step_name!r} did not call self.next(...)")
                # A join step (a second positional argument) gets the
                # members as inputs.
                if _takes_inputs(steps[transition.target]):
                    object.__setattr__(flow, "_join_inputs", gang_inputs)
                step_name = transition.target
        except Exception as e:
            meta.update(status="failed", error=repr(e), finished=time.time())
            run_span.set(status="failed")
            run_span.__exit__(None, None, None)
            self._finalize_obs(rdir, pathspec, meta)
            store.write_run_meta(self.flow_name, run_id, meta)
            print(f"[tpuflow_torch] run {pathspec} FAILED: {e!r}")
            raise
        meta.update(status="success", finished=time.time())
        run_span.set(status="success")
        run_span.__exit__(None, None, None)
        if not ran_gang:
            # While the recorder is open: the registry.append event lands
            # in events.jsonl. A gang's member 0 already appended.
            from tpuflow_torch.obs import registry

            registry.maybe_append_live("train", path=self.registry_path)
        self._finalize_obs(rdir, pathspec, meta)
        store.write_run_meta(self.flow_name, run_id, meta)
        store.append_event({"flow": self.flow_name, "run": pathspec,
                            "status": "success"})
        print(f"[tpuflow_torch] run {pathspec} succeeded")
        return pathspec

    def _finalize_obs(self, rdir: str, pathspec: str, meta: dict) -> None:
        """Close the head's recorder, merge the run's event files into
        ``<rdir>/events.jsonl``, render the timeline card into
        ``<rdir>/timeline.html``, and stamp the headline summary
        (``meta["telemetry"]``, ``{}`` with telemetry off) and, when
        anything happened, the training-health view (``meta["health"]``)
        into run.json. Telemetry never fails the run."""
        meta.setdefault("telemetry", {})
        if self._obs_dir is None:
            return
        self._obs_dir = None
        try:
            obs.configure(None)
            events = obs.merge_run_events(rdir)
            if not events:
                return
            summary = obs.summarize(events)
            from tpuflow_torch.flow.cards import timeline_card

            buf = CardBuffer()
            timeline_card(buf, events, summary=summary)
            with open(os.path.join(rdir, "timeline.html"), "w") as f:
                f.write(buf.render_html(f"{pathspec} timeline"))
            meta["telemetry"] = summary.get("headline", {})
            health = summary.get("health") or {}
            if (health.get("anomalies") or health.get("rollbacks")
                    or health.get("profiles") or health.get("dropped_events")):
                # Only when noteworthy: a clean run's run.json stays small.
                meta["health"] = health
        except Exception as e:
            print(f"[tpuflow_torch] telemetry finalize failed (ignored): "
                  f"{e!r}")

    def _run_step(self, flow, fn, step_name, run_id, task_id, num_parallel,
                  gang) -> list[_GangInput]:
        """One step with its retries and requeues; returns the inputs a
        following join step sees."""
        retries = getattr(fn, "__retry_times__", 0)
        backoff_s = getattr(fn, "__retry_backoff_s__", 2.0)
        max_backoff_s = getattr(fn, "__retry_max_backoff_s__", 60.0)
        attempt = requeues = 0
        while True:
            try:
                with obs.span("flow.step", step=step_name, task=task_id,
                              attempt=attempt, num_parallel=num_parallel):
                    if num_parallel > 1:
                        return self._exec_gang(
                            flow, step_name, run_id, task_id, num_parallel,
                            timeout=gang.get("timeout", 300.0),
                            stall_timeout=gang.get("heartbeat_timeout"),
                            attempt=attempt + requeues,
                            min_members=gang.get("min_members"))
                    self._exec_local(flow, fn, step_name, run_id, task_id,
                                     attempt + requeues)
                # A following join sees this task as a gang of one.
                return [_GangInput(dict(flow._artifacts))]
            except StepPreempted:
                # Routine, not a failure: the rerun spends no retry. A cap
                # bounds a preemption storm.
                requeues += 1
                if requeues > MAX_REQUEUES:
                    raise
                print(f"[tpuflow_torch] step {step_name} preempted (requeue "
                      f"{requeues}/{MAX_REQUEUES}), relaunching without "
                      "spending a retry")
            except Exception:
                attempt += 1
                if attempt > retries:
                    raise
                delay = _backoff_delay(attempt, backoff_s, max_backoff_s)
                print(f"[tpuflow_torch] step {step_name} failed (attempt "
                      f"{attempt}/{retries}), retrying in {delay:.1f}s:\n"
                      f"{traceback.format_exc(limit=3)}")
                _sleep(delay)

    # ----------------------------------------------------- single-task exec
    def _set_current(self, step_name: str, run_id, task_id: int) -> None:
        current.flow_name = self.flow_name
        current.run_id = str(run_id)
        current.step_name = step_name
        current.task_id = task_id
        current.gang_index, current.gang_size = 0, 1
        current.trigger = (_Trigger(self._trigger_run)
                           if self._trigger_run is not None else None)
        current.tpu_storage_path = store.storage_dir(self.flow_name, run_id,
                                                     step_name)
        current.ckpt_local_dir = self.ckpt_local_dir
        os.makedirs(current.tpu_storage_path, exist_ok=True)

    def _exec_local(self, flow: FlowSpec, fn, step_name: str, run_id,
                    task_id: int, attempt: int) -> None:
        tdir = store.task_dir(self.flow_name, run_id, step_name, task_id)
        os.makedirs(tdir, exist_ok=True)
        self._set_current(step_name, run_id, task_id)
        current.card = CardBuffer() if getattr(fn, "__card__", None) else None
        profile_cfg = getattr(fn, "__device_profile__", None)
        join_inputs = getattr(flow, "_join_inputs", None)
        object.__setattr__(flow, "_join_inputs", None)
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(faults_mod.installing(self.faults))
                if profile_cfg:
                    stack.enter_context(_DeviceProfiler(
                        profile_cfg["interval"],
                        os.path.join(tdir, "profile.json"), self.device))
                    if profile_cfg.get("trace"):
                        stack.enter_context(_step_trace(
                            os.path.join(tdir, "trace"), self.device))
                if _takes_inputs(fn):
                    fn(flow, join_inputs or [])
                else:
                    fn(flow)
            if current.card is not None:
                with open(os.path.join(tdir, "card.html"), "w") as f:
                    f.write(current.card.render_html(
                        f"{self.flow_name}/{run_id}/{step_name}"))
            store.save_artifacts(self.flow_name, run_id, step_name, task_id,
                                 flow._artifacts, attempt)
        finally:
            current.card = None

    # ------------------------------------------------------------ gang exec
    def _exec_gang(self, flow: FlowSpec, step_name: str, run_id,
                   task_id: int, num_parallel: int, *, timeout: float,
                   stall_timeout: float | None = None,
                   attempt: int = 0,
                   min_members: int | None = None) -> list[_GangInput]:
        """Launch ``num_parallel`` processes running the step body as one
        ``torch.distributed`` world (``flow/gang_exec.py``) and supervise
        them (``_supervise_gang``, judging heartbeats by
        ``stall_timeout``, None: ``HEARTBEAT_TIMEOUT_S``). Each member
        gets the flow's artifacts, the device, the formation timeout and
        the store's root through a pickled state file, and its rank, the
        world size and the rendezvous port through argv, and the run's
        fault plan, grace budget (``KILL_GRACE_S``), node-local checkpoint
        tier, obs directory, run registry, its heartbeat file
        (``heartbeat_<rank>`` in the task directory) and, in an elastic
        gang, the membership directory (``membership`` in the task
        directory, emptied first) through the state. ``min_members``: the elastic floor (None:
        ``MIN_MEMBERS``)."""
        tdir = store.task_dir(self.flow_name, run_id, step_name, task_id)
        os.makedirs(tdir, exist_ok=True)
        for name, value in flow._artifacts.items():
            # The datastore's contract holds for the gang's pickle too.
            store.reject_device_arrays(name, value)
        mdir = None
        if self.elastic:
            # A previous launch's plan must not reach this world.
            mdir = os.path.join(tdir, "membership")
            shutil.rmtree(mdir, ignore_errors=True)
            os.makedirs(mdir)
        state_path = os.path.join(tdir, "gang_state.pkl")
        with open(state_path, "wb") as f:
            pickle.dump({"artifacts": flow._artifacts,
                         "device": str(self.device), "timeout": timeout,
                         "home": store.home(), "attempt": attempt,
                         "trigger": (self._trigger_run.pathspec
                                     if self._trigger_run else None),
                         "faults": self.faults, "grace_s": KILL_GRACE_S,
                         "ckpt_local_dir": self.ckpt_local_dir,
                         "obs_dir": self._obs_dir,
                         "registry_path": self.registry_path,
                         "heartbeat_file": os.path.join(
                             tdir, "heartbeat_{rank}"),
                         "membership_dir": mdir}, f)
        for i in range(num_parallel):
            with contextlib.suppress(FileNotFoundError):
                os.unlink(os.path.join(tdir, f"joined_{i}"))
        port = _free_port()
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")

        def launch_member(i: int, rejoin: bool = False):
            # A previous launch's stamp (or a lost member's last one)
            # would read as an instant stall.
            with contextlib.suppress(FileNotFoundError):
                os.unlink(os.path.join(tdir, f"heartbeat_{i}"))
            cmd = [sys.executable, "-m", "tpuflow_torch.flow.gang_exec",
                   self._flow_module(), self.flow_name, step_name,
                   str(run_id), str(task_id), state_path, str(i),
                   str(num_parallel), str(port)]
            if rejoin:
                # Returning capacity skips the first rendezvous and asks
                # for a place in the next (grow) generation.
                cmd.append("rejoin")
            log = open(os.path.join(tdir, f"gang_{i}.log"),
                       "a" if rejoin else "w")
            try:
                return (subprocess.Popen(cmd, env=env, stdout=log,
                                         stderr=subprocess.STDOUT,
                                         cwd=os.getcwd()), log)
            except BaseException:
                log.close()
                raise

        procs: list[tuple[subprocess.Popen, Any]] = []
        try:
            for i in range(num_parallel):
                procs.append(launch_member(i))
        except BaseException:
            # A launch that fails midway leaks no member.
            self._kill_survivors(procs, [None] * len(procs))
            for _, log in procs:
                log.close()
            raise
        failure = self._supervise_gang(
            procs, tdir, timeout=timeout, step_name=step_name,
            stall_timeout=(HEARTBEAT_TIMEOUT_S if stall_timeout is None
                           else stall_timeout),
            membership_dir=mdir,
            launch_member=launch_member if self.elastic else None,
            min_members=min_members)
        if failure is not None:
            kind, member, detail = failure
            if kind == "preempt":
                raise StepPreempted(
                    f"gang step {step_name!r} preempted (member {member} "
                    f"exited with requeue code {REQUEUE_EXIT_CODE})")
            tails = [f"--- gang member {i} ---\n{self._log_tail(tdir, i)}"
                     for i in range(num_parallel)]
            raise StepFailed(f"gang step {step_name!r} failed ({detail}):\n"
                             + "\n".join(tails))
        head = store.load_artifacts(self.flow_name, run_id, step_name,
                                    task_id)
        for k, v in head.items():
            setattr(flow, k, v)
        next_path = os.path.join(tdir, "next.json")
        if os.path.exists(next_path):
            with open(next_path) as f:
                flow.next(getattr(flow, json.load(f)["target"]))
        return [_GangInput(head)] + [
            _GangInput(store.load_artifacts(self.flow_name, run_id,
                                            step_name, task_id + i))
            for i in range(1, num_parallel)
        ]

    def _supervise_gang(self, procs: list, tdir: str, *, timeout: float,
                        step_name: str, stall_timeout: float = 0.0,
                        membership_dir: str | None = None,
                        launch_member=None, min_members: int | None = None):
        """Poll every member until all exit 0 or one fails.

        The first non-zero exit fails the step at once ("preempt" for the
        requeue code, recorded as ``flow.preempt``; else "member_failed",
        recorded as ``flow.member_failed`` with the member's log tail and
        flight dump), and the survivors are killed
        (``_kill_survivors``). Formation deadline: every member writes
        ``joined_<i>`` once its process group is up; if any has not
        within ``timeout`` + ``FORMATION_SLACK_S`` of the launch, the step
        fails ("formation"). A member stuck in its own rendezvous raises
        after ``timeout`` by itself; the deadline also catches members
        that never reach it. Heartbeats (``stall_timeout`` > 0): of the
        running members that have stamped ``heartbeat_<i>``, one whose
        stamp is older than ``stall_timeout`` seconds is stalled, the one
        with the oldest stamp the culprit (its peers went silent later,
        waiting for it in a collective): the step fails
        ("heartbeat_stall", recorded as ``flow.heartbeat_stall`` with its
        age, last step and log tail). A member that never stamped is not
        judged.

        Elastic (``membership_dir`` and ``launch_member`` given; the JAX
        runner's elastic mode): see ``_Elastic``. Returns None or
        ``(kind, member, detail)``."""
        n = len(procs)
        rcs: list[int | None] = [None] * n
        failure = None
        formed = False
        deadline = time.monotonic() + timeout + FORMATION_SLACK_S
        el = None
        if membership_dir is not None and launch_member is not None:
            el = _Elastic(self, procs, rcs, tdir, step_name, membership_dir,
                          launch_member, min_members or MIN_MEMBERS)
        try:
            while True:
                for i, (p, log) in enumerate(procs):
                    if rcs[i] is not None:
                        continue
                    rc = p.poll()
                    if rc is None:
                        continue
                    rcs[i] = rc
                    log.close()
                    if rc == 0 or failure is not None:
                        continue
                    if el is not None:
                        failure = el.exited(i, rc)
                    elif rc == REQUEUE_EXIT_CODE:
                        failure = ("preempt", i, "requeue")
                        obs.event("flow.preempt", step=step_name, member=i)
                    else:
                        failure = ("member_failed", i,
                                   f"member {i} exited {rc}")
                        self._member_failed(step_name, tdir, i, rc)
                if failure is not None:
                    break
                if el is not None:
                    if el.finished():
                        break
                    failure = el.poll()
                    if failure is not None:
                        break
                elif all(rc is not None for rc in rcs):
                    break
                if not formed:
                    formed = all(os.path.exists(os.path.join(
                        tdir, f"joined_{i}")) for i in range(n))
                    if not formed and time.monotonic() > deadline:
                        failure = (
                            "formation", None,
                            f"the gang did not form within its {timeout:.0f}"
                            f" s timeout (+{FORMATION_SLACK_S:.0f} s to "
                            "start)")
                        break
                # Suspended while a re-form is in flight: the drain and
                # the rendezvous stop step fences by design, and the
                # re-form's deadline bounds that window.
                if stall_timeout > 0 and (el is None or el.forming is None):
                    failure = self._stalled(
                        tdir, rcs, stall_timeout, step_name,
                        judged=None if el is None else el.roster)
                    if failure is not None:
                        break
                time.sleep(_GANG_POLL_S)
        finally:
            # A failure, or success with a straggler (a relaunched member
            # still waiting for a grow the finished gang never forms).
            if any(rc is None for rc in rcs):
                self._kill_survivors(procs, rcs)
            for _, log in procs:
                log.close()  # idempotent
        if el is not None:
            failure = el.verdict(failure)
        return failure

    def _stalled(self, tdir: str, rcs: list, stall_timeout: float,
                 step_name: str, judged: set | None = None):
        """The heartbeat verdict of one poll (see ``_supervise_gang``):
        None, or the ``heartbeat_stall`` failure of the member with the
        oldest stamp past ``stall_timeout``. ``judged``: the members to
        judge (None: all; an elastic gang's roster)."""
        now = time.time()
        stalled = []
        for i, rc in enumerate(rcs):
            if rc is not None or (judged is not None and i not in judged):
                continue
            try:
                age = now - os.path.getmtime(
                    os.path.join(tdir, f"heartbeat_{i}"))
            except OSError:
                continue  # never stamped: not judged
            if age > stall_timeout:
                stalled.append((age, i))
        if not stalled:
            return None
        age, culprit = max(stalled)
        last_step = self._heartbeat_step(tdir, culprit)
        at = f" at step {last_step}" if last_step is not None else ""
        obs.event("flow.heartbeat_stall", step=step_name, member=culprit,
                  age_s=round(age, 2),
                  last_step=last_step if last_step is not None else -1,
                  log_tail=self._log_tail(tdir, culprit, limit=500))
        return ("heartbeat_stall", culprit,
                f"member {culprit} heartbeat stalled {age:.1f}s "
                f"(> {stall_timeout:.0f}s){at}")

    @staticmethod
    def _heartbeat_step(tdir: str, member: int) -> int | None:
        """The last step the member stamped into its heartbeat file
        (``utils/heartbeat.py``), or None for a step-less or absent
        stamp."""
        try:
            with open(os.path.join(tdir, f"heartbeat_{member}")) as f:
                raw = f.read().strip()
            return int(raw) if raw else None
        except (OSError, ValueError):
            return None

    def _member_failed(self, step_name: str, tdir: str, member: int,
                       rc: int) -> None:
        """``flow.member_failed`` with the member's log tail and, when it
        wrote one before dying, its flight dump."""
        attrs = {"step": step_name, "member": member, "rc": rc,
                 "log_tail": self._log_tail(tdir, member, limit=500)}
        if self._obs_dir:
            path = obs.flight_path(self._obs_dir, member)
            if os.path.exists(path):
                attrs["flight"] = path
        obs.event("flow.member_failed", **attrs)

    @staticmethod
    def _log_tail(tdir: str, member: int, limit: int = 2000) -> str:
        try:
            with open(os.path.join(tdir, f"gang_{member}.log")) as f:
                return f.read()[-limit:]
        except OSError:
            return ""

    @staticmethod
    def _kill_survivors(procs: list, rcs: list) -> None:
        """SIGTERM every member still running (each exits with the requeue
        code), then SIGKILL whichever is left after ``KILL_GRACE_S``."""
        live = [i for i, rc in enumerate(rcs) if rc is None]
        for i in live:
            with contextlib.suppress(OSError):
                procs[i][0].send_signal(signal.SIGTERM)
        t_end = time.monotonic() + KILL_GRACE_S
        while live and time.monotonic() < t_end:
            live = [i for i in live if procs[i][0].poll() is None]
            if live:
                time.sleep(_GANG_POLL_S)
        for i in live:
            with contextlib.suppress(OSError):
                procs[i][0].kill()
        for i, rc in enumerate(rcs):
            if rc is None:
                try:
                    rcs[i] = procs[i][0].wait(timeout=10)
                except subprocess.TimeoutExpired:
                    rcs[i] = -9

    def _flow_module(self) -> str:
        path = getattr(inspect.getmodule(self.flow_cls), "__file__", None)
        if path is None:
            raise RuntimeError("flow class must live in an importable file")
        return os.path.abspath(path)


class _Elastic:
    """An elastic gang's supervision state (the JAX runner's elastic
    ``_supervise_gang``): the roster, the generation in flight, the
    members waiting to be relaunched or to rejoin.

    A non-zero exit of a roster member (``exited``) shrinks the gang when
    the member is not the coordinator (member 0, whose process hosts
    every generation's store), no re-form is in flight, the resize
    budget is not spent and the survivors (members still running or
    finished cleanly) number at least the floor: ``flow.member_lost``,
    then a shrink plan. Else the classic verdict. A member that crashed
    or was preempted is relaunched (``launch_member(i, rejoin=True)``)
    once the formed generation's survivors have all stamped a heartbeat
    again (or ``REJOIN_HOLD_S`` passed): a grow that arrives before the
    shrunk gang banked progress would replay from scratch. A
    ``member_lost`` fault is permanent capacity loss and is not
    relaunched. ``poll`` watches the formation (every roster member's
    ``gen_<g>.joined.<m>``; then ``flow.gang_resize`` is recorded and the
    heartbeats cleared) and its deadline, relaunches, and turns a join
    request into a grow plan. A member whose done mark exists is
    forgiven a non-zero exit after its step body."""

    def __init__(self, runner: FlowRunner, procs: list, rcs: list,
                 tdir: str, step_name: str, mdir: str, launch_member,
                 floor: int):
        self.runner, self.procs, self.rcs = runner, procs, rcs
        self.tdir, self.step_name, self.mdir = tdir, step_name, mdir
        self.launch_member = launch_member
        self.floor = int(floor)
        self.roster: set[int] = set(range(len(procs)))
        self.generation = self.resizes = 0
        self.forming: dict | None = None
        self.formed_at = time.monotonic()
        self.pending_rejoin: list[int] = []
        self.awaiting_join: set[int] = set()
        # member_lost faults stay gone; a crash's capacity comes back.
        self.suppressed = {f.rank for f in faults_mod.parse(
            runner.faults or "") if f.kind == "member_lost"}

    def _announce(self, reason: str, joining: int | None = None) -> None:
        self.generation += 1
        self.resizes += 1
        timeout = self.runner.reform_timeout_s
        plan = membership.Generation(
            generation=self.generation, roster=tuple(sorted(self.roster)),
            coordinator=f"127.0.0.1:{_free_port()}", reason=reason,
            deadline=time.time() + timeout)
        membership.announce(self.mdir, plan)
        self.forming = {"plan": plan, "t0": time.monotonic(),
                        "ts": time.time(),
                        "from": len(self.roster)
                        + (1 if reason == "shrink" else -1),
                        "joining": joining}
        print(f"[tpuflow_torch] gang {reason}: generation {self.generation}"
              f" over members {sorted(self.roster)} (deadline "
              f"{timeout:.0f}s)")

    def exited(self, i: int, rc: int):
        """Member ``i`` exited ``rc`` != 0: None (forgiven, counted out or
        shrunk) or the classic failure."""
        if i in self.awaiting_join:
            # The relaunch died before it asked to join: the shrunk gang
            # goes on without it.
            self.awaiting_join.discard(i)
            return None
        if i in membership.done_members(self.mdir):
            # Its step body finished (a crash in its exit path).
            self.rcs[i] = 0
            return None
        if i not in self.roster:
            return None
        survivors = {j for j in self.roster
                     if j != i and self.rcs[j] in (None, 0)}
        if (i == 0 or self.forming is not None
                or self.resizes >= self.runner.max_resizes
                or len(survivors) < self.floor):
            why = ("the coordinator" if i == 0 else "a re-form in flight"
                   if self.forming is not None else "the resize budget"
                   if self.resizes >= self.runner.max_resizes
                   else f"below the floor of {self.floor}")
            if rc == REQUEUE_EXIT_CODE:
                obs.event("flow.preempt", step=self.step_name, member=i)
                return ("preempt", i, "requeue")
            self.runner._member_failed(self.step_name, self.tdir, i, rc)
            return ("member_failed", i,
                    f"member {i} exited {rc} (elastic fallback: {why})")
        self.roster.discard(i)
        attrs = {"step": self.step_name, "member": i, "rc": rc,
                 "survivors": len(self.roster),
                 "log_tail": self.runner._log_tail(self.tdir, i, limit=500)}
        if self.runner._obs_dir:
            path = obs.flight_path(self.runner._obs_dir, i)
            if os.path.exists(path):
                attrs["flight"] = path
        obs.event("flow.member_lost", **attrs)
        self._announce("shrink")
        if i not in self.suppressed:
            self.pending_rejoin.append(i)
        return None

    def poll(self):
        """One supervisor poll of the re-form machinery: None or the
        ``reform_timeout`` failure."""
        if self.forming is not None:
            plan = self.forming["plan"]
            if self.roster <= membership.joined_members(self.mdir,
                                                        plan.generation):
                dur = time.monotonic() - self.forming["t0"]
                rec = obs.recorder()
                if rec is not None:
                    rec.record("span", "flow.gang_resize",
                               ts=self.forming["ts"], dur_s=dur,
                               step=self.step_name,
                               generation=plan.generation,
                               reason=plan.reason,
                               from_members=self.forming["from"],
                               to_members=len(self.roster))
                # A member's first fence in the new generation trails its
                # restore: its stall clock starts at its next stamp.
                for j in self.roster:
                    with contextlib.suppress(OSError):
                        os.unlink(os.path.join(self.tdir, f"heartbeat_{j}"))
                print(f"[tpuflow_torch] gang generation {plan.generation} "
                      f"formed ({plan.reason} -> {len(self.roster)} "
                      f"members, {dur:.1f}s)")
                self.forming = None
                self.formed_at = time.monotonic()
            elif time.time() > plan.deadline:
                return ("reform_timeout", None,
                        f"generation {plan.generation} ({plan.reason}) "
                        f"missed its {self.runner.reform_timeout_s:.0f}s "
                        "re-form deadline; falling back to the requeue")
        if self.forming is None and self.pending_rejoin and (
                all(os.path.exists(os.path.join(self.tdir, f"heartbeat_{j}"))
                    for j in self.roster if self.rcs[j] is None)
                or time.monotonic() - self.formed_at
                > REJOIN_HOLD_S):
            m = self.pending_rejoin.pop(0)
            self.procs[m] = self.launch_member(m, rejoin=True)
            self.rcs[m] = None
            self.awaiting_join.add(m)
        if self.forming is None and self.awaiting_join:
            ready = membership.join_requests(self.mdir) & self.awaiting_join
            if ready:
                m = min(ready)
                self.awaiting_join.discard(m)
                membership.clear_join_request(self.mdir, m)
                self.roster.add(m)
                self._announce("grow", joining=m)
        return None

    def finished(self) -> bool:
        """Every roster member exited cleanly and nothing is in flight, or
        a generation is forming that no fence will see: every member it
        keeps has finished the step body already (a joining member is a
        straggler, reaped with the gang)."""
        if self.forming is None:
            return all(self.rcs[j] is not None for j in self.roster)
        joining = self.forming["joining"]
        return all(self.rcs[j] == 0 for j in self.roster if j != joining)

    def verdict(self, failure):
        """The step's verdict: a missed re-form deadline is reported as a
        member failure, so ``@retry`` requeues the world as without
        elasticity."""
        if failure is None and self.resizes:
            print(f"[tpuflow_torch] elastic gang step {self.step_name!r} "
                  f"completed after {self.resizes} resize(s), final "
                  f"generation {self.generation}")
        if failure is not None and failure[0] == "reform_timeout":
            return ("member_failed", failure[1], failure[2])
        return failure


def _takes_inputs(fn) -> bool:
    params = list(inspect.signature(fn).parameters)
    return len(params) >= 2 and params[1] not in ("args", "kwargs")


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return str(v)


# --------------------------------------------------------------------- CLI
def main(flow_cls: type[FlowSpec], argv: list[str] | None = None):
    """``run`` / ``trigger`` (returns the run's pathspec), ``show``, or
    ``deploy`` (raises). ``--home <dir>`` anywhere after the command roots
    the store there (``store.set_home``) for this process; ``--registry
    <path>`` appends the run's ``train`` record to that run registry
    (``FlowRunner(registry_path=)``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "show"):
        _show(flow_cls)
        return None
    cmd, rest = argv[0], argv[1:]
    home, rest = _take_option(rest, "--home", "a directory")
    if home is not None:
        store.set_home(home)
    registry_path, rest = _take_option(rest, "--registry", "a path")
    if cmd in ("run", "trigger"):
        params, triggered = _parse_params(flow_cls, rest)
        return FlowRunner(flow_cls, registry_path=registry_path).run(
            params, triggered=triggered or cmd == "trigger")
    if cmd == "deploy":
        raise NotImplementedError(f"deploy is not ported yet: {ROADMAP_DEPLOY}")
    raise SystemExit(f"unknown command {cmd!r}; use run|trigger|show")


def _take_option(rest: list[str], flag: str,
                 what: str) -> tuple[str | None, list[str]]:
    """(the value after ``flag`` or None, ``rest`` without the pair)."""
    if flag not in rest:
        return None, rest
    i = rest.index(flag)
    if i + 1 >= len(rest):
        raise SystemExit(f"{flag} requires {what}")
    return rest[i + 1], rest[:i] + rest[i + 2:]


def _parse_params(flow_cls, rest: list[str]):
    specs = flow_cls.parameters()
    by_cli = {}
    for attr, p in specs.items():
        by_cli[p.name.replace("_", "-")] = (attr, p)
        by_cli[p.name] = (attr, p)
    params = {attr: p.default for attr, p in specs.items()}
    triggered = False
    i = 0
    while i < len(rest):
        arg = rest[i]
        if arg == "--triggered":
            triggered = True
            i += 1
            continue
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument {arg!r}")
        key = arg[2:]
        if key not in by_cli:
            raise SystemExit(
                f"unknown parameter --{key}; known: "
                + ", ".join(sorted(c for c in by_cli
                                   if "-" in c or "_" not in c)))
        if i + 1 >= len(rest):
            raise SystemExit(f"--{key} requires a value")
        attr, p = by_cli[key]
        params[attr] = p.parse(rest[i + 1])
        i += 2
    missing = [p.name for a, p in specs.items()
               if p.required and params[a] is None]
    if missing:
        raise SystemExit(f"missing required parameters: {missing}")
    return params, triggered


def _show(flow_cls) -> None:
    print(f"Flow {flow_cls.__name__}")
    doc = (flow_cls.__doc__ or "").strip()
    if doc:
        print(f"  {doc.splitlines()[0]}")
    print("Steps:")
    for name, fn in flow_cls.steps().items():
        tags = []
        if getattr(fn, "__retry_times__", 0):
            tags.append(f"retry×{fn.__retry_times__}")
        if getattr(fn, "__gang__", None):
            tags.append("gang")
        if getattr(fn, "__card__", None):
            tags.append("card")
        print(f"  {name}{(' [' + ', '.join(tags) + ']') if tags else ''}")
    print("Parameters:")
    for attr, p in flow_cls.parameters().items():
        print(f"  --{p.name.replace('_', '-')} (default {p.default!r}) "
              f"{p.help}")
