"""Gang member bootstrap: one process of a gang step.

Counterpart of ``tpuflow/flow/gang_exec.py``. ``FlowRunner._exec_gang``
starts each member as::

    python -m tpuflow_torch.flow.gang_exec <flow_file> <class> <step> \\
        <run_id> <task_id> <state_path> <rank> <world_size> <port> [rejoin]

The pickled state holds the flow's artifacts, the device, the formation
timeout, the store's root, the launch attempt and the run's robustness
settings (the JAX package passes them in its environment): the fault
plan, installed as the member's rank; the grace budget and the attempt,
installed in ``utils/preempt.py``; the obs directory, where the member
records ``events.p<rank>.<pid>.jsonl`` with its launch stamped; the
node-local checkpoint tier, as ``current.ckpt_local_dir``; the run
registry, to which member 0 appends the leg's ``train`` record (the live
goodput ledger's headline) before it saves its artifacts; and the
member's heartbeat file, ``configure``d in ``utils/heartbeat.py`` (the
member does not stamp it itself: its train loops and reports do). The member sets torch's
own rendezvous variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), joins the process group
(``dist.initialize``: NCCL on the card, one process per card; gloo on the
CPU), which fails the member if the world has not formed within the
timeout. A flow whose ``dist_backend`` parameter names a backend
(``gloo``) forms the world over it, and a device with a card index
(``cuda:0``) puts every member on that card: the two together run a gang
of several processes on one card, which NCCL refuses. The member then
marks itself joined for the supervisor's formation deadline, runs the
step body, and saves its artifacts: the head (rank 0) its own
at ``task_id`` and the step's transition, the others none at
``task_id + rank``.

In an elastic gang (the state names a membership directory) the member
is ``membership.configure``d with its original rank, which keys its
artifacts, heartbeat and telemetry across generations, and forms
generation 0 through ``membership.elastic_initialize``. A relaunched
member (``rejoin``) skips that rendezvous: it runs the fault plan's
``rejoin_delay``, asks to join, waits for the supervisor's grow plan and
enters that generation's world, which the survivors reach at their next
step fence. ``current.gang_index``/``gang_size`` are the world's when
the body starts and the generation's it ends in afterwards. After a
re-form each member marks itself done and the generation's coordinator,
which hosts the rendezvous store, waits for its peers' marks and leaves
last.

A SIGTERM only sets the preemption flag (and dumps the flight ring: a
SIGKILL may follow the grace window); the training loops drain a
checkpoint at their next step boundary and raise ``Preempted``, which
the member turns into the requeue exit code after flushing its events.
Any other failure dumps the flight ring with its stack and propagates.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pickle
import signal
import sys

from tpuflow_torch import obs
from tpuflow_torch.dist import membership
from tpuflow_torch.testing import faults
from tpuflow_torch.utils import heartbeat, preempt
from tpuflow_torch.utils.preempt import (
    REQUEUE_EXIT_CODE,
    Preempted,
    request_preemption,
)


def _on_sigterm(signum, frame):
    # The flag first, then the flight ring: this may be the supervisor's
    # kill, whose SIGKILL leaves no later chance. Neither raises.
    request_preemption(signum, frame)
    obs.dump_flight("sigterm")


def main(argv: list[str]) -> None:
    rejoin = argv[9:] == ["rejoin"]
    (flow_file, class_name, step_name, run_id, task_id, state_path, rank,
     world, port) = argv[:9]
    rank, world, base_task = int(rank), int(world), int(task_id)
    signal.signal(signal.SIGTERM, _on_sigterm)
    with open(state_path, "rb") as f:
        state = pickle.load(f)
    faults.install(state["faults"], rank=rank)
    preempt.configure(grace_s=state["grace_s"], attempt=state["attempt"])
    if state["obs_dir"]:
        obs.configure(state["obs_dir"], proc=rank, attempt=state["attempt"])
    heartbeat.configure(state["heartbeat_file"].format(rank=rank))
    membership.configure(state.get("membership_dir"), member=rank)

    from tpuflow_torch.flow import store

    store.set_home(state["home"])
    # The flow's module runs before the rendezvous, as in the JAX package.
    spec = importlib.util.spec_from_file_location("_tpuflow_torch_gang_flow",
                                                  flow_file)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    flow_cls = getattr(module, class_name)

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from tpuflow_torch import dist
    from tpuflow_torch.device import resolve_device
    from tpuflow_torch.flow.client import Run
    from tpuflow_torch.flow.spec import _Trigger, current

    device = resolve_device(state["device"])
    timeout = float(state["timeout"])
    backend = state["artifacts"].get("dist_backend") or None
    flow_name = flow_cls.__name__
    tdir = store.task_dir(flow_name, run_id, step_name, base_task)
    if rejoin:
        faults.maybe_rejoin_delay()
        membership.request_join(rank)
        plan = membership.await_plan_including(rank, timeout_s=timeout)
        membership.join_generation(plan, device=device, timeout_s=timeout,
                                   backend=backend)
    else:
        faults.maybe_rendezvous_delay()
        if membership.enabled():
            membership.elastic_initialize(
                membership.Generation(0, tuple(range(world)),
                                      f"127.0.0.1:{port}"),
                device=device, timeout_s=timeout, backend=backend)
        else:
            dist.initialize(device, timeout_s=timeout, backend=backend,
                            device_index=device.index)
        with open(os.path.join(tdir, f"joined_{rank}"), "w") as f:
            f.write(str(os.getpid()))

    flow = flow_cls()
    for k, v in state["artifacts"].items():
        setattr(flow, k, v)
    current.flow_name = flow_name
    current.run_id = str(run_id)
    current.step_name = step_name
    current.task_id = base_task + rank
    current.gang_index = dist.process_index()
    current.gang_size = dist.process_count()
    current.trigger = (_Trigger(Run(state["trigger"])) if state["trigger"]
                       else None)
    current.tpu_storage_path = store.storage_dir(flow_name, run_id, step_name)
    current.ckpt_local_dir = state["ckpt_local_dir"]
    os.makedirs(current.tpu_storage_path, exist_ok=True)

    try:
        with obs.span("flow.gang_member", step=step_name, gang_index=rank,
                      gang_size=world):
            flow_cls.steps()[step_name](flow)
    except Preempted as e:
        # The loop committed its drain checkpoint. os._exit: a peer may be
        # gone, and the shutdown barrier below would wait for it.
        grace = preempt.grace_remaining_s()
        spare = (f" with {grace:.1f}s grace to spare" if grace is not None
                 else "")
        print(f"[tpuflow_torch] gang member preempted, requeueing{spare}: "
              f"{e}")
        obs.flush()
        sys.stdout.flush()
        os._exit(REQUEUE_EXIT_CODE)
    except BaseException as e:
        obs.dump_flight("unhandled_exception", e)
        obs.flush()
        raise
    if dist.process_index() == 0:
        from tpuflow_torch.obs import registry

        registry.maybe_append_live("train", path=state.get("registry_path"))
    obs.flush()
    current.gang_index = dist.process_index()
    current.gang_size = dist.process_count()
    store.save_artifacts(flow_name, run_id, step_name, base_task + rank,
                         flow._artifacts if rank == 0 else {},
                         state["attempt"])
    transition = getattr(flow, "_next", None)
    if rank == 0 and transition is not None:
        with open(os.path.join(tdir, "next.json"), "w") as f:
            json.dump({"target": transition.target}, f)
    dist.barrier()
    if membership.current_generation() > 0:
        membership.mark_done(rank)
        if membership.is_coordinator():
            others = set(membership.current_plan().roster) - {rank}
            membership.await_done(others, timeout_s=state["grace_s"])
    dist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
