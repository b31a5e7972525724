"""Fault injection: every failure path exercisable in tests (counterpart
of ``tpuflow/testing/faults.py``).

A fault plan is a comma-separated list of specs. The JAX package reads it
from ``TPUFLOW_FAULT`` in every process; the port takes it as an argument
(``train_gpt(faults=)``, ``RunConfig(faults=)``, ``FlowRunner(faults=)``)
and ``install``s it in the process, as gang rank ``rank``
(``flow/gang_exec.py`` installs the runner's plan in each member).
Grammar (one spec per entry)::

    member_exit:<rank>@step<k>   die (os._exit(1)) on member <rank> at the
                                 end of train step/report <k>
    member_lost:<rank>@step<k>   like member_exit, but permanent capacity
                                 loss: the elastic supervisor
                                 (``flow/runner.py``) shrinks the gang and
                                 does not relaunch the member
    rejoin_delay:<seconds>@<rank>
                                 a relaunched member sleeps before asking
                                 to rejoin the elastic gang
    preempt:<rank>@step<k>       set the preemption flag on member <rank>
                                 at the end of step <k> (a simulated
                                 SIGTERM: the loop drains a checkpoint and
                                 exits with the requeue code)
    nan_grad:<rank>@step<k>      poison member <rank>'s params with NaN
                                 before step <k> (single-shot)
    loss_spike:<rank>@step<k>    scale params x1e3 before step <k>
                                 (single-shot)
    heartbeat_stall:<rank>       member <rank> hangs (3600 s) inside its
                                 first heartbeat, after the stamp
    rendezvous_delay:<seconds>[@<rank>]
                                 sleep before joining the process group
                                 (all members, or just <rank>)
    ckpt_truncate                truncate the first raw shard file written
                                 after the plan is installed
    ckpt_flip_byte               flip one byte in the first raw shard file
                                 written after the plan is installed
                                 (caught by the shard's crc32 on restore)
    ckpt_io_flaky:p<n>           every distinct checkpoint I/O operation
                                 (op + path) raises a transient EIO on its
                                 first <n> attempts, then succeeds
    ckpt_partial_commit          single-shot: the next commit leaves its
                                 staged step_<k>.tmp dir and never writes
                                 the marker (a writer killed between
                                 payload and commit)
    upload_stall[:<seconds>]     sleep in the local -> persistent upload
                                 of the fast checkpoint tier (default 5 s)
    replica_kill:<id>@<t>, replica_stall:<id>@<t>, prefill_kill:<id>@<t>
                                 serving chaos: kill (or wedge) the fleet
                                 replica <id> <t> seconds into a drive
                                 (``replica_plan``, applied by
                                 ``testing/chaos.py::apply_replica_plan``)

Hooks: ``maybe_rendezvous_delay`` and ``maybe_rejoin_delay`` (gang
exec), ``step_boundary`` (the
train loops and ``TrainContext.report``), ``grad_poison`` (the train
loops, before a step), ``maybe_stall_heartbeat`` (``utils/heartbeat.py``,
after a stamp), ``ckpt_io_fault``
(``ckpt/raw.py::retry_io``), ``corrupt_after_write`` (the raw shard
writer), ``partial_commit`` and ``maybe_upload_stall`` (the manager's
commit and upload); ``replica_plan`` (the serving-chaos harness). With no
plan installed every hook returns at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno as _errno
import os
import sys
import time


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    rank: int | None = None
    step: int | None = None
    value: float | None = None
    target: str | None = None  # serving chaos: a fleet replica id


KINDS = (
    "member_exit",
    "member_lost",
    "rejoin_delay",
    "preempt",
    "nan_grad",
    "loss_spike",
    "heartbeat_stall",
    "rendezvous_delay",
    "ckpt_truncate",
    "ckpt_flip_byte",
    "ckpt_io_flaky",
    "ckpt_partial_commit",
    "upload_stall",
    "replica_kill",
    "replica_stall",
    "prefill_kill",
)

# The installed plan (raw string, parsed specs) and this process's rank;
# the single-shot faults that fired; per-(op, path) injected failures.
_PLAN: tuple[str, list[Fault]] | None = None
_RANK = 0
_FIRED: set[str] = set()
_IO_FLAKY_COUNTS: dict[str, int] = {}


def parse(raw: str) -> list[Fault]:
    out = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, _, payload = entry.partition(":")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in fault plan "
                             f"{raw!r}; known: {KINDS}")
        rank = step = value = target = None
        if kind in ("member_exit", "member_lost", "preempt", "nan_grad",
                    "loss_spike"):
            rank_s, _, step_s = payload.partition("@")
            rank = int(rank_s)
            if not step_s.startswith("step"):
                raise ValueError(
                    f"{kind} spec needs '<rank>@step<k>', got {entry!r}")
            step = int(step_s[len("step"):])
        elif kind == "heartbeat_stall":
            rank = int(payload)
        elif kind == "rendezvous_delay":
            secs_s, _, rank_s = payload.partition("@")
            value = float(secs_s)
            rank = int(rank_s) if rank_s else None
        elif kind == "rejoin_delay":
            secs_s, _, rank_s = payload.partition("@")
            if not rank_s:
                raise ValueError(f"rejoin_delay spec needs "
                                 f"'<seconds>@<rank>', got {entry!r}")
            value = float(secs_s)
            rank = int(rank_s)
        elif kind == "ckpt_io_flaky":
            if not payload.startswith("p"):
                raise ValueError(
                    f"ckpt_io_flaky spec needs 'p<n>', got {entry!r}")
            value = float(int(payload[1:]))
        elif kind == "upload_stall":
            value = float(payload) if payload else 5.0
        elif kind in ("replica_kill", "replica_stall", "prefill_kill"):
            target_s, _, t_s = payload.partition("@")
            if not target_s or not t_s:
                raise ValueError(
                    f"{kind} spec needs '<id>@<t>' (fleet replica id @ "
                    f"seconds into the drive), got {entry!r}")
            target = target_s
            value = float(t_s)
        elif payload:
            raise ValueError(f"fault {kind} takes no payload, got {entry!r}")
        out.append(Fault(kind, rank=rank, step=step, value=value,
                         target=target))
    return out


def reset() -> None:
    """Forget the fired single-shot faults and the flaky-IO counts."""
    _FIRED.clear()
    _IO_FLAKY_COUNTS.clear()


def install(plan: str | None, *, rank: int = 0) -> None:
    """Install ``plan`` (None or "" for none) in this process as gang rank
    ``rank``, with nothing fired yet. A malformed plan raises here."""
    global _PLAN, _RANK
    _PLAN = (plan, parse(plan)) if plan else None
    _RANK = int(rank)
    reset()


def installed() -> str | None:
    """The installed plan's spec string, or None."""
    return _PLAN[0] if _PLAN is not None else None


@contextlib.contextmanager
def installing(plan: str | None, *, rank: int = 0):
    """``install(plan, rank=rank)`` for the block (nothing when ``plan`` is
    None: the process's installed plan stays in force), the previous plan
    and its fired state back after it."""
    global _PLAN, _RANK
    if plan is None:
        yield
        return
    saved = (_PLAN, _RANK, set(_FIRED), dict(_IO_FLAKY_COUNTS))
    install(plan, rank=rank)
    try:
        yield
    finally:
        _PLAN, _RANK = saved[0], saved[1]
        reset()
        _FIRED.update(saved[2])
        _IO_FLAKY_COUNTS.update(saved[3])


def _specs() -> list[Fault]:
    return _PLAN[1] if _PLAN is not None else []


def matching(kind: str) -> list[Fault]:
    return [f for f in _specs() if f.kind == kind]


def active(kind: str) -> Fault | None:
    for f in _specs():
        if f.kind == kind:
            return f
    return None


# ------------------------------------------------------------------ hooks
def step_boundary(step: int) -> None:
    """Train-loop hook: called after step/report ``step`` completed."""
    if _PLAN is None:
        return
    for f in matching("preempt"):
        if f.rank == _RANK and f.step == step:
            from tpuflow_torch.utils.preempt import request_preemption

            print(f"[faults] preempt injected at step {step}",
                  file=sys.stderr)
            request_preemption()
    for kind in ("member_exit", "member_lost"):
        for f in matching(kind):
            if f.rank == _RANK and f.step == step:
                print(f"[faults] {kind} injected at step {step}",
                      file=sys.stderr)
                sys.stderr.flush()
                # os._exit skips atexit: dump the flight ring and drain
                # the telemetry buffer first, or the dying member's last
                # steps vanish from the run's events.
                from tpuflow_torch import obs

                obs.dump_flight(f"faults.{kind}")
                obs.flush()
                os._exit(1)


_POISON = {"nan_grad": float("nan"), "loss_spike": 1e3}


def grad_poison(step: int) -> float | None:
    """A parameter multiplier to apply before optimizer step ``step``, or
    None: NaN for ``nan_grad``, 1e3 for ``loss_spike``. Single-shot per
    spec, so a step replayed after a rollback runs clean."""
    if _PLAN is None:
        return None
    for kind, mult in _POISON.items():
        for f in matching(kind):
            if f.rank != _RANK or f.step != step:
                continue
            key = f"{kind}:{f.rank}@{f.step}"
            if key in _FIRED:
                continue
            _FIRED.add(key)
            print(f"[faults] {kind} injected before step {step}",
                  file=sys.stderr)
            return mult
    return None


def maybe_stall_heartbeat() -> None:
    """Heartbeat hook: a matching member hangs here and never stamps
    again, a livelocked process the supervisor must reap."""
    for f in matching("heartbeat_stall"):
        if f.rank == _RANK:
            print("[faults] heartbeat_stall: hanging", file=sys.stderr)
            sys.stderr.flush()
            time.sleep(3600.0)


def maybe_rendezvous_delay() -> None:
    """Gang-bootstrap hook: called before the process group forms."""
    for f in matching("rendezvous_delay"):
        if f.rank is None or f.rank == _RANK:
            time.sleep(f.value or 0.0)


def maybe_rejoin_delay() -> None:
    """Elastic-rejoin hook (gang exec): a relaunched member sleeps before
    it asks to join the next (grow) generation, so the grow fence races
    the survivors' step fences."""
    for f in matching("rejoin_delay"):
        if f.rank == _RANK:
            print(f"[faults] rejoin_delay: sleeping {f.value}s before the "
                  "join request", file=sys.stderr)
            sys.stderr.flush()
            time.sleep(f.value or 0.0)


def ckpt_io_fault(op: str, path: str) -> None:
    """``retry_io`` hook: with ``ckpt_io_flaky:p<n>`` installed, every
    distinct (op, path) raises a transient EIO on its first <n> attempts
    and succeeds after them."""
    if _PLAN is None:
        return
    f = active("ckpt_io_flaky")
    if f is None:
        return
    n = int(f.value or 0)
    key = f"{op}:{path}"
    fired = _IO_FLAKY_COUNTS.get(key, 0)
    if fired < n:
        _IO_FLAKY_COUNTS[key] = fired + 1
        raise OSError(_errno.EIO,
                      f"[faults] injected flaky IO ({fired + 1}/{n}) for {op}",
                      path)


def partial_commit() -> bool:
    """Commit hook: with ``ckpt_partial_commit`` installed, True once — the
    manager then leaves the staged ``.tmp`` dir without its marker."""
    if _PLAN is None:
        return False
    if active("ckpt_partial_commit") is None or (
            "ckpt_partial_commit" in _FIRED):
        return False
    _FIRED.add("ckpt_partial_commit")
    print("[faults] ckpt_partial_commit: leaving staged dir", file=sys.stderr)
    return True


def maybe_upload_stall() -> None:
    """Upload hook: with ``upload_stall[:s]`` installed, sleep inside the
    local -> persistent copy."""
    if _PLAN is None:
        return
    f = active("upload_stall")
    if f is not None:
        print(f"[faults] upload_stall: sleeping {f.value}s", file=sys.stderr)
        time.sleep(f.value or 0.0)


def corrupt_after_write(path: str) -> None:
    """Raw-writer hook: single-shot corruption of the first shard written
    after the plan was installed (its crc32 was computed from the bytes in
    memory, so the restore's check catches it)."""
    if _PLAN is None:
        return
    for kind in ("ckpt_truncate", "ckpt_flip_byte"):
        if active(kind) is None or kind in _FIRED:
            continue
        try:
            size = os.path.getsize(path)
        except OSError:
            continue
        if size == 0:
            continue
        _FIRED.add(kind)
        if kind == "ckpt_truncate":
            os.truncate(path, size // 2)
        else:
            with open(path, "r+b") as f:
                f.seek(size // 2)
                byte = f.read(1)
                f.seek(size // 2)
                f.write(bytes([byte[0] ^ 0xFF]))
        print(f"[faults] {kind} applied to {path}", file=sys.stderr)


def replica_plan() -> list[tuple[str, str, float]]:
    """Serving-chaos hook: the ``(kind, replica_id, at_s)`` schedule of
    every installed ``replica_kill`` / ``replica_stall`` / ``prefill_kill``
    spec, sorted by fire time. ``testing/chaos.py::apply_replica_plan``
    applies it against in-process replicas."""
    if _PLAN is None:
        return []
    plan = [
        (f.kind, f.target or "", float(f.value or 0.0))
        for f in _specs()
        if f.kind in ("replica_kill", "replica_stall", "prefill_kill")
    ]
    plan.sort(key=lambda x: x[2])
    return plan
