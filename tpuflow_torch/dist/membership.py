"""Elastic gang membership: numbered mesh generations over a file
rendezvous (counterpart of ``tpuflow/dist/membership.py``).

A classic gang treats a member loss at process granularity: the
supervisor kills the survivors and ``@retry`` requeues the whole attempt
from the last checkpoint. An elastic gang (``FlowRunner(elastic=True)``)
turns the loss into a **mesh generation** instead: the supervisor
announces a plan naming the surviving roster and a fresh rendezvous
address; at their next step fence the survivors drain, abandon the old
``torch.distributed`` world, rendezvous again as the smaller generation,
restore the checkpoint resharded (the any-world restore of
``ckpt/manager.py``) and go on. A relaunched member asks to join, and
the next generation grows the gang back.

Protocol (every file in the membership directory the gang launcher makes
for each launch; the format is the JAX package's, so a plan written by
either package reads in the other):

- ``plan.json``           the current generation, written atomically by
  the supervisor; a member polls it (one ``stat`` a step fence), and a
  plan whose ``generation`` exceeds the member's is a pending re-form;
- ``gen_<g>.joined.<m>``  member ``m`` formed generation ``g``'s world
  (the supervisor's formation watch counts these);
- ``join.<m>``            a relaunched member ``m`` asks to be in the
  next (grow) generation;
- ``done.<m>``            member ``m`` finished the step body (the exit
  ordering handshake and the supervisor's forgiveness marker).

A member's identity is its ORIGINAL gang rank: it keys the heartbeat
file, the log and the telemetry ``proc`` across generations. Its
``torch.distributed`` rank in a generation is its index in the sorted
roster, so the lowest surviving member is always rank 0, which hosts the
rendezvous store (member 0 in practice: losing it falls back to the
requeue, ``flow/runner.py``).

The JAX package reads ``TPUFLOW_MEMBERSHIP_DIR`` and
``TPUFLOW_PROCESS_ID``; the port takes no environment settings:
``configure(directory, member=)`` installs them (a gang member's come
from the runner's pickled state, ``flow/gang_exec.py``). Its
``TPUFLOW_REFORM_WAIT_S`` is ``REFORM_WAIT_S``.

Runtime: an elastic world runs over gloo only. A dead peer's sockets
close, so a gloo collective that touches it raises within milliseconds:
the survivors learn of the loss there, and ``mesh.teardown`` destroys
the world at once and drops the ``DeviceMesh`` caches. Over NCCL a
survivor blocked in a collective with a dead peer learns of it only at
the process group's timeout, when torch's NCCL watchdog ends the
process, so no re-form could happen: ``elastic_initialize`` and
``check_world`` refuse an NCCL world (ROADMAP Queue 1 item 12c-4).
Nothing of the old world is kept alive, so unlike the JAX package (whose
XLA clients keep polling threads that must outlive their peers, and are
leaked on purpose) the port leaks nothing; the coordinator still leaves
last after a re-form (``await_done``), because it hosts the rendezvous
store its peers' shutdown talks to.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

__all__ = [
    "Generation",
    "MeshReform",
    "MembershipTimeout",
    "configure",
    "reset",
    "enabled",
    "member_id",
    "membership_dir",
    "current_generation",
    "current_plan",
    "is_coordinator",
    "pending_reform",
    "fence",
    "reform_after_failure",
    "check_world",
    "elastic_initialize",
    "join_generation",
    "quiesce_and_reform",
    "announce",
    "read_plan",
    "joined_members",
    "await_formed",
    "request_join",
    "join_requests",
    "clear_join_request",
    "await_plan_including",
    "mark_done",
    "done_members",
    "await_done",
    "roster_diff",
]

_PLAN_FILE = "plan.json"
# How long a failed collective waits for the supervisor's plan before it
# counts as a genuine error (the JAX package's TPUFLOW_REFORM_WAIT_S).
REFORM_WAIT_S = 10.0


class MembershipTimeout(TimeoutError):
    """A rendezvous (formation acks, a plan) missed its deadline: the
    caller falls back to the requeue verdict."""


@dataclasses.dataclass(frozen=True)
class Generation:
    """One epoch of gang membership: who is in the world and where it
    rendezvouses. ``roster`` holds ORIGINAL member ids; a member's rank
    in the generation is its index in the sorted roster."""

    generation: int
    roster: tuple[int, ...]
    coordinator: str            # host:port of this generation's store
    reason: str = "init"        # init | shrink | grow
    deadline: float = 0.0       # unix time by which the re-form completes

    def __post_init__(self):
        object.__setattr__(self, "roster", tuple(sorted(self.roster)))

    @property
    def num_processes(self) -> int:
        return len(self.roster)

    def process_id(self, member: int) -> int:
        """``member``'s rank in this generation."""
        return self.roster.index(member)

    def to_json(self) -> dict:
        return {
            "generation": self.generation,
            "roster": list(self.roster),
            "coordinator": self.coordinator,
            "reason": self.reason,
            "deadline": self.deadline,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Generation":
        return cls(
            generation=int(obj["generation"]),
            roster=tuple(int(m) for m in obj["roster"]),
            coordinator=str(obj["coordinator"]),
            reason=str(obj.get("reason", "init")),
            deadline=float(obj.get("deadline", 0.0)),
        )


class MeshReform(Exception):
    """Raised at a step fence when a new generation is pending: the loop
    has handed its state to the checkpoint, and its re-form handler tears
    the world down and rendezvouses again (as ``obs/health.py``'s
    ``_RollbackSignal`` unwinds to its handler)."""

    def __init__(self, plan: Generation):
        self.plan = plan
        super().__init__(
            f"mesh re-form to generation {plan.generation} "
            f"({plan.reason}, {plan.num_processes} members)"
        )


def roster_diff(old, new) -> tuple[list[int], list[int]]:
    """``(lost, gained)`` members between two rosters."""
    o, n = set(old), set(new)
    return sorted(o - n), sorted(n - o)


# ----------------------------------------------------------- member state
# The process's configuration (``configure``); its view of the current
# generation and the device and backend its worlds form on
# (``elastic_initialize``); the plan file's (mtime, plan) of the last read.
_CONF: dict[str, Any] = {"dir": None, "member": 0}
_STATE: dict[str, Any] = {"plan": None, "generation": 0, "device": None,
                          "backend": None}
_PLAN_CACHE: tuple[int, Generation | None] = (-1, None)


def configure(directory: str | None, *, member: int = 0) -> None:
    """Make this process member ``member`` of the elastic gang whose
    membership files live in ``directory`` (None: not in one)."""
    _CONF.update(dir=directory or None, member=int(member))
    reset()


def reset() -> None:
    """Forget the member-side view (generation 0, no plan read, no
    world formed)."""
    global _PLAN_CACHE
    _STATE.update(plan=None, generation=0, device=None, backend=None)
    _PLAN_CACHE = (-1, None)


def membership_dir() -> str | None:
    return _CONF["dir"]


def enabled() -> bool:
    """Whether this process is a member of an elastic gang."""
    return _CONF["dir"] is not None


def member_id() -> int:
    """This process's ORIGINAL gang rank (stable across generations)."""
    return int(_CONF["member"])


def current_generation() -> int:
    return int(_STATE["generation"])


def current_plan() -> Generation | None:
    return _STATE["plan"]


def is_coordinator() -> bool:
    """True when this member is rank 0 of its generation after a re-form:
    it hosts the rendezvous store and leaves last."""
    plan = current_plan()
    return (plan is not None and plan.generation > 0
            and plan.process_id(member_id()) == 0)


# ------------------------------------------------------------- plan files
def _atomic_write(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def announce(mdir: str, plan: Generation) -> None:
    """Supervisor: publish ``plan`` as the current generation (atomic)."""
    os.makedirs(mdir, exist_ok=True)
    _atomic_write(os.path.join(mdir, _PLAN_FILE), plan.to_json())


def read_plan(mdir: str) -> Generation | None:
    try:
        with open(os.path.join(mdir, _PLAN_FILE)) as f:
            return Generation.from_json(json.load(f))
    except (OSError, ValueError, KeyError):
        return None


def pending_reform() -> Generation | None:
    """The step fence's check: the current plan when it names a LATER
    generation that includes this member, else None. One ``stat`` a call
    while the plan file is unchanged."""
    global _PLAN_CACHE
    mdir = membership_dir()
    if mdir is None:
        return None
    try:
        mtime = os.stat(os.path.join(mdir, _PLAN_FILE)).st_mtime_ns
    except OSError:
        return None
    cached_mtime, plan = _PLAN_CACHE
    if mtime != cached_mtime:
        plan = read_plan(mdir)
        _PLAN_CACHE = (mtime, plan)
    if plan is None or plan.generation <= current_generation():
        return None
    if member_id() not in plan.roster:
        # Counted out (judged lost while alive): nothing to re-form into.
        return None
    return plan


def fence() -> Generation | None:
    """An elastic loop's step fence: the pending generation every process
    of the world agrees on, or None (always None outside an elastic
    gang). Each process reads the plan (``pending_reform``), then one
    all-reduce takes the newest generation any of them read, so no
    process drains while a peer that read the plan a moment earlier
    steps on into a collective. Every process must call it at the same
    points. A collective error (a dead peer) propagates: the caller
    classifies it with ``reform_after_failure``. The JAX package checks
    each process's own read: XLA's step collectives leave its processes
    no room to part there."""
    if not enabled():
        return None
    plan = pending_reform()
    from tpuflow_torch.dist import mesh

    if not mesh.is_initialized() or mesh.process_count() == 1:
        return plan
    import torch
    import torch.distributed as tdist

    current = current_generation()
    # The world is gloo's (``check_world``): the all-reduce runs on the host.
    seen = torch.tensor([plan.generation if plan is not None else current],
                        dtype=torch.int64)
    tdist.all_reduce(seen, op=tdist.ReduceOp.MAX)
    agreed = int(seen.item())
    if agreed <= current:
        return None
    # A peer read it first; the supervisor announces no plan while one
    # is forming, so the file holds exactly this one.
    while plan is None or plan.generation < agreed:
        time.sleep(0.01)
        plan = read_plan(membership_dir())
    return plan


def reform_after_failure(exc: BaseException | None = None,
                         timeout_s: float | None = None
                         ) -> Generation | None:
    """Classify a failed collective: a dead peer's sockets close at once,
    so the survivors' collective raises within milliseconds of the loss,
    before the supervisor (which polls) has announced the re-form. Wait
    up to ``timeout_s`` (``REFORM_WAIT_S`` when None) for
    the plan: the plan (the failure was a member loss), or None (a
    genuine error: the caller re-raises ``exc``)."""
    if not enabled():
        return None
    if timeout_s is None:
        timeout_s = REFORM_WAIT_S
    deadline = time.monotonic() + max(timeout_s, 0.0)
    while True:
        plan = pending_reform()
        if plan is not None:
            return plan
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.05)


# ------------------------------------------------------- ack / done files
def _touch(mdir: str, name: str) -> None:
    try:
        os.makedirs(mdir, exist_ok=True)
        _atomic_write(os.path.join(mdir, name), {"ts": time.time()})
    except OSError:
        pass


def _present(mdir: str, prefix: str) -> set[int]:
    out: set[int] = set()
    try:
        names = os.listdir(mdir)
    except OSError:
        return out
    for n in names:
        if n.startswith(prefix) and ".tmp" not in n:
            try:
                out.add(int(n[len(prefix):].partition(".")[0]))
            except ValueError:
                continue
    return out


def joined_members(mdir: str, generation: int) -> set[int]:
    return _present(mdir, f"gen_{generation}.joined.")


def await_formed(mdir: str, plan: Generation, *, poll_s: float = 0.05,
                 now=time.time) -> None:
    """Supervisor: block until every roster member acked ``plan``'s
    generation, or raise ``MembershipTimeout`` past its deadline."""
    want = set(plan.roster)
    while True:
        if joined_members(mdir, plan.generation) >= want:
            return
        if plan.deadline and now() > plan.deadline:
            have = sorted(joined_members(mdir, plan.generation))
            raise MembershipTimeout(
                f"generation {plan.generation} missed its re-form deadline:"
                f" joined {have} of {sorted(want)}")
        time.sleep(poll_s)


def request_join(member: int | None = None) -> None:
    """Relaunched member: ask for a place in the next (grow) generation."""
    mdir = membership_dir()
    if mdir is not None:
        _touch(mdir, f"join.{member if member is not None else member_id()}")


def join_requests(mdir: str) -> set[int]:
    return _present(mdir, "join.")


def clear_join_request(mdir: str, member: int) -> None:
    try:
        os.unlink(os.path.join(mdir, f"join.{member}"))
    except OSError:
        pass


def await_plan_including(member: int, timeout_s: float, *,
                         poll_s: float = 0.05) -> Generation:
    """Relaunched member: block until the current plan's roster includes
    ``member`` (the supervisor's grow), or raise ``MembershipTimeout``."""
    mdir = membership_dir()
    if mdir is None:
        raise MembershipTimeout("no membership directory configured")
    deadline = time.monotonic() + timeout_s
    while True:
        plan = read_plan(mdir)
        if plan is not None and member in plan.roster:
            return plan
        if time.monotonic() > deadline:
            raise MembershipTimeout(
                f"no generation included member {member} within "
                f"{timeout_s:.0f}s")
        time.sleep(poll_s)


def mark_done(member: int | None = None) -> None:
    """Member: the step body finished. The supervisor forgives a done
    member's later non-zero exit, and the coordinator waits for every
    peer's mark before it leaves."""
    mdir = membership_dir()
    if mdir is not None:
        _touch(mdir, f"done.{member if member is not None else member_id()}")


def done_members(mdir: str) -> set[int]:
    return _present(mdir, "done.")


def await_done(members: set[int], timeout_s: float) -> bool:
    """Wait (bounded) for ``members``' done marks; False on timeout."""
    mdir = membership_dir()
    if mdir is None:
        return True
    deadline = time.monotonic() + timeout_s
    while not members <= done_members(mdir):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


# -------------------------------------------------- runtime (re)lifecycle
def _record(plan: Generation) -> None:
    from tpuflow_torch import obs

    _STATE["plan"] = plan
    _STATE["generation"] = plan.generation
    obs.gauge("dist.mesh_generation", float(plan.generation),
              members=plan.num_processes, reason=plan.reason)


_NCCL_GAP = (
    "an elastic gang runs over gloo only: over NCCL a survivor blocked in "
    "a collective with a dead peer learns of the loss only at the process "
    "group's timeout, when torch's NCCL watchdog ends the process, so the "
    "gang cannot re-form (ROADMAP Queue 1 item 12c-4); form the world "
    "with backend 'gloo' (TorchGptTrain's dist_backend parameter)")


def check_world() -> None:
    """Raise ``ValueError`` when this process is an elastic gang member
    whose world runs over NCCL (see the module docstring); the train
    loops call it before their first step."""
    from tpuflow_torch.dist import mesh

    if enabled() and mesh.is_initialized():
        import torch.distributed as tdist

        if tdist.get_backend() == "nccl":
            raise ValueError(_NCCL_GAP)


def elastic_initialize(plan: Generation, *, device=None,
                       timeout_s: float = 300.0,
                       backend: str | None = None) -> None:
    """Form ``plan``'s world for this member: ``init_process_group`` at the
    plan's coordinator with rank ``plan.process_id(me)`` and world
    ``plan.num_processes`` (``dist/mesh.py::initialize``). ``device`` and
    ``backend`` (None: the ones this process formed its last world with)
    are kept for the next generation; a backend that resolves to NCCL
    raises ``ValueError`` (see the module docstring). A generation of one
    member starts no group. Records the ``dist.mesh_generation`` gauge."""
    import torch

    from tpuflow_torch.dist import mesh

    device = device if device is not None else _STATE["device"]
    backend = backend if backend is not None else _STATE["backend"]
    if device is not None:
        resolved = backend or ("nccl" if torch.device(device).type == "cuda"
                               else "gloo")
        if resolved == "nccl":
            raise ValueError(_NCCL_GAP)
    _STATE.update(device=device, backend=backend)
    if plan.num_processes > 1:
        if device is None:
            raise ValueError(
                f"generation {plan.generation} has {plan.num_processes} "
                "members, but no device was given for its world")
        mesh.initialize(device, rank=plan.process_id(member_id()),
                        world_size=plan.num_processes,
                        init_method=f"tcp://{plan.coordinator}",
                        timeout_s=timeout_s, backend=backend)
    _record(plan)


def join_generation(plan: Generation, *, device=None,
                    timeout_s: float = 300.0,
                    backend: str | None = None) -> None:
    """Enter ``plan``'s world (``elastic_initialize``) and ack the join
    for the supervisor's formation watch."""
    elastic_initialize(plan, device=device, timeout_s=timeout_s,
                       backend=backend)
    mdir = membership_dir()
    if mdir is not None:
        _touch(mdir, f"gen_{plan.generation}.joined.{member_id()}")


def quiesce_and_reform(plan: Generation) -> None:
    """Member-side re-form: abandon the current world and join ``plan``'s
    on the device and backend of the last one.

    The caller (a train loop's ``MeshReform`` handler) has drained and
    handed its state to the checkpoint; every tensor of the old world's
    sharded state is garbage from here. ``init_process_group`` is the
    rendezvous barrier, bounded by the plan's deadline. A one-process
    world re-forming into a one-member generation (the degenerate case
    the in-process tests run) has no world to replace: it records the
    generation and acks."""
    from tpuflow_torch.dist import mesh

    timeout = max(plan.deadline - time.time(), 5.0) if plan.deadline \
        else 120.0
    mesh.teardown()
    join_generation(plan, timeout_s=timeout)
