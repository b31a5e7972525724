"""Flows the port's gang tests run as 2-process gloo gangs
(``tests/test_torch_flow_gang.py``). A gang member loads this file by
path, so it imports torch and the port only."""

import os
import sys
import time

import torch
import torch.distributed as tdist

from tpuflow_torch.flow import FlowSpec, Parameter, current, gpu, step

# A member of SlowJoinFlow with rank 1 (gang_exec's argv: <flow_file>
# <class> <step> <run_id> <task_id> <state> <rank> <world> <port>) starts
# too late for its gang's 2 s formation timeout.
if (len(sys.argv) == 10 and sys.argv[2] == "SlowJoinFlow"
        and sys.argv[7] == "1"):
    time.sleep(60)


class GangFlow(FlowSpec):
    device = Parameter("device", default="cpu")

    @step
    def start(self):
        self.seed_value = 5
        self.next(self.work, num_parallel=2)

    @step
    def work(self):
        t = torch.tensor([float(current.gang_index + 1)])
        tdist.all_reduce(t)
        self.total = float(t)
        self.rank_seen = current.gang_index
        self.size_seen = current.gang_size
        self.task_seen = current.task_id
        self.inherited = self.seed_value
        self.next(self.join)

    @step
    def join(self, inputs):
        found, missing = [], 0
        for inp in inputs:
            try:
                found.append(inp.total)
            except AttributeError:
                missing += 1
        self.found, self.missing = found, missing
        self.next(self.end)

    @step
    def end(self):
        pass


class FailingGangFlow(FlowSpec):
    device = Parameter("device", default="cpu")

    @step
    def start(self):
        self.next(self.work, num_parallel=2)

    @step
    def work(self):
        if current.gang_index == 1:
            raise RuntimeError("member 1 fails")
        time.sleep(60)  # the survivor: killed by the supervisor
        self.next(self.end)

    @step
    def end(self):
        pass


class SlowJoinFlow(FlowSpec):
    device = Parameter("device", default="cpu")

    @step
    def start(self):
        self.next(self.work)

    @gpu(num_parallel=2, all_hosts_started_timeout=2)
    @step
    def work(self):
        self.next(self.end)

    @step
    def end(self):
        pass


class RequeueFlow(FlowSpec):
    """Member 1 exits with the requeue code on the first launch only (a
    marker in the step's storage remembers); the step has no retries."""

    device = Parameter("device", default="cpu")

    @step
    def start(self):
        self.next(self.work, num_parallel=2)

    @step
    def work(self):
        marker = os.path.join(current.tpu_storage_path, "preempted_once")
        if current.gang_index == 1 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(75)
        tdist.barrier()
        self.done = True
        self.next(self.end)

    @step
    def end(self):
        pass
