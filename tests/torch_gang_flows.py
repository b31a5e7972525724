"""Flows the port's gang tests run as 2-process gloo gangs
(``tests/test_torch_flow_gang.py``), and the worlds of spawned gloo
processes the FSDP tests run (``spawn_world``, ``tests/test_torch_fsdp_*``).
A gang member loads this file by path, and a spawned process imports it,
so it imports torch and the port only."""

import dataclasses
import json
import multiprocessing as mp
import os
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as tdist

from tpuflow_torch.flow import (
    FlowSpec,
    Parameter,
    current,
    gpu,
    retry,
    step,
)
from tpuflow_torch.flows.gpt_flow import TorchGptTrain

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


class DuraChaos(FlowSpec):
    """Twin of the JAX suite's ``DuraChaos`` (``tests/test_faults.py``): a
    gang of 2 whose ``Trainer`` loop reports steps 1-3, each saving the
    state, resuming from ``latest_step()`` (restoring it) when a previous
    attempt left one. No retries: a requeue must not need one."""

    device = Parameter("device", default="cpu")

    @step
    def start(self):
        self.next(self.train, num_parallel=2)

    @retry(times=0)
    @step
    def train(self):
        from tpuflow_torch.train.trainer import (
            RunConfig,
            ScalingConfig,
            Trainer,
            get_context,
        )

        def loop(cfg):
            ctx = get_context()
            start = ctx.latest_step()
            self.resumed_from = start
            if start:
                restored = ctx.restore_latest()
                assert float(restored["w"][0]) == float(start)
            for stp in range(start + 1, 4):
                ctx.report({"val_loss": 1.0 / stp},
                           state={"w": torch.full((2,), float(stp))},
                           step=stp)

        result = Trainer(loop, scaling_config=ScalingConfig(device="cpu"),
                         run_config=RunConfig(
                             storage_path=os.path.join(
                                 current.tpu_storage_path, "trainer"),
                             ckpt_local_dir=current.ckpt_local_dir)).fit()
        self.history_steps = [m["step"] for m in result.metrics_history]
        self.next(self.end)

    @step
    def end(self):
        pass


class HeartbeatStall(FlowSpec):
    """Twin of the JAX suite's ``HB`` flow
    (``tests/test_faults.py::test_heartbeat_stall_detected_and_killed``):
    each member stamps its heartbeat with a step every 0.2 s; under the
    fault plan ``heartbeat_stall:1`` member 1 hangs inside its first
    beat, and member 0 keeps stamping, so the supervisor must name
    member 1 (the oldest stamp)."""

    device = Parameter("device", default="cpu")

    @step
    def start(self):
        self.next(self.work, num_parallel=2)

    @gpu(all_hosts_started_timeout=120, heartbeat_timeout=2)
    @step
    def work(self):
        from tpuflow_torch.utils.heartbeat import beat

        for i in range(150):
            beat(i + 1)
            time.sleep(0.2)
        self.next(self.end)

    @step
    def end(self):
        pass


class Elastic(FlowSpec):
    """Twin of the JAX suite's ``Elastic`` flow
    (``tests/test_membership.py::_ELASTIC_FLOW``): a gang of 3 whose
    ``Trainer`` loop reports steps 1-``total``, each saving a 12-element
    state holding the step, resuming from ``latest_step()`` (its restore
    checked bit-equal) in every generation; the members record their
    loop's invocations, its resumes as (step, world) and the final
    world."""

    device = Parameter("device", default="cpu")
    total = Parameter("total", default=8)
    step_sleep = Parameter("step_sleep", default=0.1)

    @step
    def start(self):
        self.next(self.train, num_parallel=3)

    @retry(times=0)
    @gpu(all_hosts_started_timeout=120, heartbeat_timeout=6, min_members=2)
    @step
    def train(self):
        from tpuflow_torch.train.trainer import (
            RunConfig,
            ScalingConfig,
            Trainer,
            get_context,
        )

        info = {"invocations": 0, "resumes": []}

        def loop(cfg):
            ctx = get_context()
            info["invocations"] += 1
            start = ctx.latest_step()
            info["resumes"].append([start, ctx.get_world_size()])
            if start:
                restored = ctx.restore_latest()
                assert torch.equal(restored["w"],
                                   torch.full((12,), float(start)))
            for stp in range(start + 1, int(self.total) + 1):
                ctx.report({"val_loss": 1.0 / stp},
                           state={"w": torch.full((12,), float(stp))},
                           step=stp)
                time.sleep(float(self.step_sleep))

        result = Trainer(loop, scaling_config=ScalingConfig(device="cpu"),
                         run_config=RunConfig(storage_path=os.path.join(
                             current.tpu_storage_path, "trainer"))).fit()
        # Rank 0 saves, so the head's history holds the steps.
        self.history_steps = [m.get("step") for m in result.metrics_history]
        self.invocations = info["invocations"]
        self.resumes = info["resumes"]
        self.final_world = result.mesh_axes.get("data")
        self.next(self.end)

    @step
    def end(self):
        pass


class ElasticFloor(Elastic):
    """``Elastic`` with the floor at all three members: any loss falls
    back to the classic verdict."""

    @retry(times=0)
    @gpu(all_hosts_started_timeout=120, heartbeat_timeout=6, min_members=3)
    @step
    def train(self):
        Elastic.train(self)


class ElasticGpt(TorchGptTrain):
    """``TorchGptTrain`` as an elastic gang (floor 2, no retries), dropout
    off, each member recording its steps and restores
    (``tpuflow_torch/testing/elastic_record.py``) into
    ``elastic.p<member>.jsonl`` in the step's storage."""

    @retry(times=0)
    @gpu(all_hosts_started_timeout=120, min_members=2)
    @step
    def train(self):
        from tpuflow_torch.dist import membership
        from tpuflow_torch.testing.elastic_record import record_elastic

        _jax_init(None, True)
        record_elastic(os.path.join(
            current.tpu_storage_path,
            f"elastic.p{membership.member_id()}.jsonl"),
            os.path.join(current.tpu_storage_path, "checkpoints"))
        TorchGptTrain.train(self)


class ElasticGptSolo(ElasticGpt):
    """``ElasticGpt`` with the floor at one member: a gang of 2 shrinks to
    a generation of one process."""

    @retry(times=0)
    @gpu(all_hosts_started_timeout=120, min_members=1)
    @step
    def train(self):
        ElasticGpt.train(self)


# ----------------------------------------------------------------- FSDP
WORLD_TIMEOUT_S = 240


def spawn_world(world: int, task: str, **kwargs) -> list:
    """Run ``task`` (a function of this module, ``kwargs`` its arguments)
    in ``world`` spawned processes forming one gloo world on the CPU;
    returns each rank's result, in rank order. A process that fails
    raises here with its traceback."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_world_member,
                         args=(r, world, port, task, kwargs, out))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(out.get(timeout=WORLD_TIMEOUT_S) for _ in procs)
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
    errors = [v for v in got.values() if isinstance(v, str)]
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(world)]


def _world_member(rank, world, port, task, kwargs, out):
    torch.set_num_threads(1)
    from tpuflow_torch import dist

    try:
        if world > 1:
            dist.initialize("cpu", rank=rank, world_size=world,
                            init_method=f"tcp://localhost:{port}",
                            timeout_s=120)
        out.put((rank, globals()[task](**kwargs)))
    except BaseException:
        out.put((rank, f"rank {rank}: {traceback.format_exc()}"))
    finally:
        dist.shutdown()


def _jax_init(init_npz: str | None, dropout0: bool):
    """Patch the port's ``train_gpt`` to start from the JAX init stored in
    ``init_npz`` (flattened Flax params, '/'-joined paths) and, with
    ``dropout0``, to train without dropout."""
    from tpuflow_torch.ckpt.raw import unflatten
    from tpuflow_torch.models.convert import params_from_jax
    from tpuflow_torch.models.gpt2 import GPT2
    from tpuflow_torch.train import gpt as tgpt

    if dropout0:
        real = tgpt.GptTrainConfig.model_config
        tgpt.GptTrainConfig.model_config = (
            lambda self: dataclasses.replace(real(self), dropout=0.0))
    if init_npz is None:
        return
    with np.load(init_npz) as z:
        tree = unflatten((k.split("/"), z[k]) for k in z.files)
    sd = params_from_jax(tree)
    real_init = tgpt._init_model

    def init_model(model_cfg, device, seed=0):
        if seed is None:
            return real_init(model_cfg, device, seed)
        m = GPT2(model_cfg, seed=None, device=device)
        m.load_state_dict(sd)
        return m

    tgpt._init_model = init_model


def _mesh_axes(cfg) -> dict:
    from tpuflow_torch.train.gpt import mesh_axes

    return mesh_axes(cfg)


def fsdp_train(cfg: dict, ckpt_dir=None, init_npz=None, dropout0=True,
               resume=None, comm_overlap=True, drop_last=False,
               ckpt_format="raw"):
    """``train_gpt`` on this world (``cfg``: ``GptTrainConfig`` fields);
    ``resume``: a checkpoint directory to restore from (a handle).
    Returns the losses, the validation losses, the checkpoint records and
    whether the state was sharded."""
    from tpuflow_torch.ckpt import Checkpoint
    from tpuflow_torch.parallel import has_sharded_leaf
    from tpuflow_torch.train import gpt as tgpt

    _jax_init(init_npz, dropout0)
    plans = []
    real_state = tgpt.init_state

    def init_state(*a, **kw):
        state = real_state(*a, **kw)
        plans.append(state.plan)
        return state

    tgpt.init_state = init_state
    res = tgpt.train_gpt(
        tgpt.GptTrainConfig(**cfg), ckpt_dir=ckpt_dir,
        resume_checkpoint=(Checkpoint.from_directory(resume)
                           if resume else None),
        device="cpu", log=lambda m: None, comm_overlap=comm_overlap,
        ckpt_format=ckpt_format)
    return {"step_losses": res.step_losses,
            "loss_history": res.loss_history,
            "val": [m.get("val_loss") for m in res.metrics_history],
            "sample": res.sample,
            "io": res.checkpoint_io,
            "sharded": plans[0] is not None and has_sharded_leaf(plans[0])}


def fsdp_resave(cfg: dict, src: str, dst: str, step: int = 1,
                fmt: str = "raw", scan: bool = False):
    """Restore the checkpoint directory ``src`` (a step, either format)
    onto this world's sharded state (``cfg``'s model and optimizer;
    ``scan``: in the scan-layers layout) and save it again in ``fmt`` into
    the manager directory ``dst`` as ``step``; returns the bytes this
    process read and wrote and its local parameter shapes."""
    from tpuflow_torch import dist
    from tpuflow_torch.ckpt import CheckpointManager, dcp, raw
    from tpuflow_torch.ckpt.tree import checkpoint_tree, load_checkpoint_tree
    from tpuflow_torch.train import gpt as tgpt

    tcfg = tgpt.GptTrainConfig(**cfg)
    mc = tcfg.model_config()
    if scan:
        mc = dataclasses.replace(mc, scan_layers=True)
    mesh = None
    if dist.process_count() > 1:
        mesh = dist.make_mesh("cpu", _mesh_axes(tcfg))
    state = tgpt.init_state(tcfg, mc, "cpu", materialize=False, mesh=mesh)
    tmpl = checkpoint_tree(state, scan_layers=mc.scan_layers, abstract=True)
    stats = {}
    if dcp.is_dcp(os.path.join(src, "state")):
        tree, stats["bytes"] = dcp.load(os.path.join(src, "state"), tmpl)
    else:
        tree = raw.restore_raw(os.path.join(src, "state"), tmpl,
                               stats=stats)
    load_checkpoint_tree(state, tree)
    mgr = CheckpointManager(dst, max_to_keep=None,
                            multi_process=mesh is not None, format=fmt)
    mgr.save(step, checkpoint_tree(state, scan_layers=mc.scan_layers))
    mgr.wait_until_finished()
    saves = list(mgr.saves)
    mgr.close()
    return {"read": stats["bytes"], "wrote": saves[0]["bytes"],
            "local": [tuple(t.shape) for t in state.params]}


def fsdp_local_shards(cfg: dict):
    """A fresh sharded state of ``cfg`` on this world: each parameter's
    local part (``ShardPlan.local``) and FSDP's placement of it."""
    from tpuflow_torch import dist
    from tpuflow_torch.train import gpt as tgpt

    tcfg = tgpt.GptTrainConfig(**cfg)
    mesh = dist.make_mesh("cpu", _mesh_axes(tcfg))
    state = tgpt.init_state(tcfg, device="cpu", mesh=mesh)
    return {"index": mesh.index, "dims": state.plan.dims,
            "local": {n: t.detach().numpy().copy() for n, t in
                      zip(state.plan.names, state.params)},
            "moments": [tuple(t.shape) for t in state.tx.mu]}


def mesh_layout(axes=None, dcn=None, ici=None, rows: int = 8,
                cols: int = 0):
    """This process's place on a named (or hybrid) mesh and the rows of a
    global batch of ``rows`` rows (of ``cols`` columns: a 2-D batch whose
    sequence a ``seq`` axis splits) that ``shard_batch`` hands it."""
    from tpuflow_torch import dist

    mesh = (dist.make_hybrid_mesh(dcn, ici, "cpu") if dcn is not None
            else dist.make_mesh("cpu", axes))
    x = np.arange(rows * max(cols, 1)).reshape(rows, cols) if cols else (
        np.arange(rows))
    got = dist.shard_batch({"x": x}, mesh)
    return {"index": mesh.index, "shape": mesh.shape,
            "coords": list(mesh.device_mesh.get_coordinate()),
            "all_coords": dict(mesh.coords), "rows": got["x"].tolist(),
            "groups": {a: mesh.group(a) is not None for a in mesh.shape}}


def moe_aux(cfg: dict, init_npz: str):
    """The load-balance loss of layer 0's MoE ``test`` layer (weights from
    the JAX init in ``init_npz``) on this process's rows of a seeded
    global input, as a model sharded over the world computes it (its
    means over the FSDP group), and the aux of the process's rows alone;
    also the global input."""
    import types

    import torch.distributed as tdist

    from tpuflow_torch.models.moe import MoEMLP
    from tpuflow_torch.train import gpt as tgpt

    mc = tgpt.GptTrainConfig(**cfg).model_config()
    C = mc.n_embd
    m = MoEMLP(C, 4 * C, mc.n_experts)
    with np.load(init_npz) as z, torch.no_grad():
        m.gate.weight.copy_(torch.from_numpy(z["h0/moe/gate/kernel"]).T)
        m.gate.bias.copy_(torch.from_numpy(z["h0/moe/gate/bias"]))
        for k in ("w1", "b1", "w2", "b2"):
            getattr(m, k).copy_(torch.from_numpy(z[f"h0/moe/{k}"]))
    x = np.random.default_rng(0).standard_normal(
        (4, 16, C)).astype(np.float32)
    rank, world = tdist.get_rank(), tdist.get_world_size()
    rows = torch.from_numpy(x[rank * 4 // world:(rank + 1) * 4 // world])
    own = float(m(rows)[1].detach())
    m.tp = types.SimpleNamespace(fsdp_group=tdist.group.WORLD, t=1, e=1)
    aux = m(rows.clone().requires_grad_())[1]
    aux.backward()
    return {"aux": float(aux.detach()), "own_aux": own, "want_input": x.tolist()}


# ------------------------------------------------- sequence and pipeline
def _qkv(shape, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def seq_attention(B: int, T: int, H: int, D: int, h_ragged: int):
    """This world's ``seq`` mesh (data 1 x seq <world>) runs ring,
    Ulysses and the gathered xla attention on its block of seeded q, k, v
    (B, T, H, D) (the same whole arrays on every rank), causal, with the
    backward of a seeded cotangent; Ulysses again at ``h_ragged`` heads
    (its fallback); and one ``ppermute`` around the ring with its
    gradient. Returns each one's block of the output and of dq, dk, dv."""
    from tpuflow_torch import dist
    from tpuflow_torch.ops.attention import attention
    from tpuflow_torch.parallel.p2p import AxisGroup, ppermute, ring_perm
    from tpuflow_torch.parallel.ring_attention import ring_attention
    from tpuflow_torch.parallel.ulysses import ulysses_attention

    world = tdist.get_world_size()
    mesh = dist.make_mesh("cpu", {"data": 1, "seq": world})
    seq = AxisGroup.of(mesh, "seq")
    blk = slice(seq.rank * T // world, (seq.rank + 1) * T // world)

    def run(fn, heads):
        q, k, v, do = (torch.from_numpy(a[:, blk].copy())
                       for a in _qkv((B, T, heads, D), heads))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = fn(q, k, v, causal=True, seq=seq)
        o.backward(do)
        return [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]

    out = {
        "ring": run(ring_attention, H),
        "ulysses": run(ulysses_attention, H),
        "xla": run(lambda *a, **kw: attention(*a, impl="xla", **kw), H),
        "ulysses_ragged": run(ulysses_attention, h_ragged),
    }
    x = torch.full((3,), float(seq.rank), requires_grad=True)
    y = ppermute(x, seq, ring_perm(world))
    (y * (seq.rank + 1)).sum().backward()
    out["ppermute"] = [y.detach().numpy(), x.grad.numpy()]
    return out


def pipeline_loss(cfg: dict, init_npz: str, tokens: list):
    """The pipeline loss of ``cfg``'s mesh (data x stage, its
    microbatches) on the global batch ``tokens`` (B, T + 1), the model
    from the JAX init in ``init_npz``, and its gradients summed as the
    train step sums them; rank 0 returns the loss and the gradients of
    the whole model (every stage's blocks gathered), as the JAX param
    tree's leaves ('/'-joined paths)."""
    from tpuflow_torch import dist
    from tpuflow_torch.ckpt.raw import flatten, unflatten
    from tpuflow_torch.ckpt.tree import params_to_jax
    from tpuflow_torch.models.convert import params_from_jax
    from tpuflow_torch.models.gpt2 import GPT2
    from tpuflow_torch.parallel.p2p import gather
    from tpuflow_torch.parallel.pipeline import (
        gpt2_pipeline_loss,
        keep_stage_blocks,
    )
    from tpuflow_torch.train import gpt as tgpt
    from tpuflow_torch.train.step import pipeline_gradients

    tcfg = tgpt.GptTrainConfig(**cfg)
    mc = dataclasses.replace(tcfg.model_config(), dropout=0.0)
    mesh = dist.make_mesh("cpu", tgpt.mesh_axes(tcfg))
    with np.load(init_npz) as z:
        tree = unflatten((k.split("/"), z[k]) for k in z.files)
    model = GPT2(mc, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    keep_stage_blocks(model, mesh)
    state = tgpt._init_pipeline_state(tcfg, mc, torch.device("cpu"), False,
                                      mesh)
    state.model.load_state_dict(model.state_dict())
    batch = dist.shard_batch({"x": np.asarray(tokens)[:, :-1],
                              "y": np.asarray(tokens)[:, 1:]}, mesh)
    cell, loss = gpt2_pipeline_loss(
        state.model, mesh=mesh,
        n_microbatches=tcfg.microbatches)(batch["x"], batch["y"])
    cell.backward()
    grads = pipeline_gradients(state)
    names = [n for n, _ in state.model.named_parameters()]
    local = params_to_jax(dict(zip(names, grads)), scan_layers=True)
    whole = {"/".join(p): (gather(g, mesh.stage_group, 0)
                           if p[0] == "h" else g).numpy()
             for p, g in flatten(local)}
    return {"loss": float(loss), "cell": float(cell),
            "grads": whole if dist.process_index() == 0 else None}


# ------------------------------------------------------------ preemption
def record_step_losses(tgpt, patch=setattr) -> list:
    """Patch ``tgpt``'s train-step makers (through ``patch``, e.g. a
    test's ``monkeypatch.setattr``) so that every step's loss is appended
    to the returned list (as the loop reads it, after the step), the
    steps of a call that ends in ``Preempted`` included."""
    losses = []

    def recording(make):
        def maker(*a, **kw):
            step = make(*a, **kw)

            def run(*args):
                state, metrics = step(*args)
                losses.append(float(metrics["loss"]))
                return state, metrics

            return run

        return maker

    patch(tgpt, "make_train_step", recording(tgpt.make_train_step))
    patch(tgpt, "make_pipeline_step", recording(tgpt.make_pipeline_step))
    return losses


def preempt_train(cfg: dict, ckpt_dir: str | None, local_dir=None,
                  faults=None, grace_s=None):
    """``train_gpt`` on this world (dropout off) with the fault plan
    ``faults``, the grace budget ``grace_s`` and the node-local tier
    ``local_dir``: whether it was preempted, every step's loss, and when
    it ran to its end the final step and the epochs."""
    from tpuflow_torch.train import gpt as tgpt
    from tpuflow_torch.utils.preempt import Preempted, clear_preemption

    _jax_init(None, True)
    losses = record_step_losses(tgpt)
    try:
        res = tgpt.train_gpt(tgpt.GptTrainConfig(**cfg), ckpt_dir,
                             device="cpu", log=lambda m: None, faults=faults,
                             preempt_grace_s=grace_s,
                             ckpt_local_dir=local_dir)
    except Preempted:
        clear_preemption()
        return {"preempted": True, "step_losses": losses}
    return {"preempted": False, "step_losses": losses,
            "step": res.checkpoint.metadata["step"] if res.checkpoint
            else None,
            "epochs": [m["epoch"] for m in res.metrics_history]}


# ---------------------------------------------------------------- health
def health_train(cfg: dict, ckpt_dir: str | None, faults=None):
    """``train_gpt`` on this world (dropout off) with the fault plan
    ``faults`` and the health monitor on: every step's loss as the loop
    read it (a NaN step's too), the result's step losses and loss
    history, its restores' (step, tier), and the final step."""
    from tpuflow_torch.train import gpt as tgpt

    _jax_init(None, True)
    raw = record_step_losses(tgpt)
    res = tgpt.train_gpt(tgpt.GptTrainConfig(**cfg), ckpt_dir, device="cpu",
                         log=lambda m: None, faults=faults)
    io = res.checkpoint_io or {"restores": []}
    return {"raw": raw, "step_losses": res.step_losses,
            "loss_history": res.loss_history,
            "restores": [(r["step"], r["tier"]) for r in io["restores"]],
            "step": res.checkpoint.metadata["step"] if res.checkpoint
            else None}
