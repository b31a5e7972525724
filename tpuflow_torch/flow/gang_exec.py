"""Gang member bootstrap: one process of a gang step.

Counterpart of ``tpuflow/flow/gang_exec.py``. ``FlowRunner._exec_gang``
starts each member as::

    python -m tpuflow_torch.flow.gang_exec <flow_file> <class> <step> \\
        <run_id> <task_id> <state_path> <rank> <world_size> <port>

The pickled state holds the flow's artifacts, the device, the formation
timeout, the store's root and the launch attempt. The member sets torch's
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
``task_id + rank``. A SIGTERM exits at once with the requeue code (the
training loops' checkpoint drain is ROADMAP Queue 1 item 12c).
"""

from __future__ import annotations

import importlib.util
import json
import os
import pickle
import signal
import sys

from tpuflow_torch.utils.preempt import REQUEUE_EXIT_CODE, request_preemption


def _on_sigterm(signum, frame):
    request_preemption(signum, frame)
    sys.stdout.flush()
    os._exit(REQUEUE_EXIT_CODE)


def main(argv: list[str]) -> None:
    (flow_file, class_name, step_name, run_id, task_id, state_path, rank,
     world, port) = argv
    rank, world, base_task = int(rank), int(world), int(task_id)
    signal.signal(signal.SIGTERM, _on_sigterm)
    with open(state_path, "rb") as f:
        state = pickle.load(f)

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
    dist.initialize(device, timeout_s=float(state["timeout"]),
                    backend=state["artifacts"].get("dist_backend") or None,
                    device_index=device.index)
    flow_name = flow_cls.__name__
    tdir = store.task_dir(flow_name, run_id, step_name, base_task)
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
    os.makedirs(current.tpu_storage_path, exist_ok=True)

    flow_cls.steps()[step_name](flow)
    store.save_artifacts(flow_name, run_id, step_name, base_task + rank,
                         flow._artifacts if rank == 0 else {},
                         state["attempt"])
    transition = getattr(flow, "_next", None)
    if rank == 0 and transition is not None:
        with open(os.path.join(tdir, "next.json"), "w") as f:
            json.dump({"target": transition.target}, f)
    dist.barrier()
    dist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
