"""GPT-family training (counterpart of ``tpuflow/train/gpt.py``).

``train_gpt(cfg)`` runs the JAX package's FSDP recipe
(``_run_fsdp_generation``): the epoch loop over the seeded LM loaders,
per-epoch held-out validation with perplexity, tokens/s that exclude the
cold first step, the loss and metrics histories, and the optional greedy
sample through the port's ``generate`` (byte-level text from the prompt
"The " on ``lm_text``). The optimizers (AdamW, SGD, Lion, Adafactor),
Switch-MoE blocks (``experts``) and both datasets (``lm_synth``, the
byte-level ``lm_text``) run as in the JAX leg. With a ``ckpt_dir`` it
checkpoints as the JAX leg does: a save of the full state at every epoch
end (the JAX checkpoint tree, ``ckpt/tree.py``), an in-run resume from
the newest committed step, and a resume from a handle.

A mesh of ``data_axis`` x ``fsdp_axis`` x ``tensor_axis`` x
``seq_axis`` x ``expert_axis`` > 1 runs on that many processes, one per
card (each calls ``train_gpt`` with its rendezvous variables set, as the
``TorchGptTrain`` gang's members do), laid out in the JAX device order
(``dist.make_mesh``): the state is sharded by the JAX rule over them
(``parallel/sharding.py``: ``gpt2_tensor_rules`` on the ``tensor`` and
``expert`` axes, then FSDP2 over ``data`` x ``fsdp``), the blocks run
Megatron-style on the tensor group and the MoE experts on the expert
group (``parallel/tensor.py``), the sequence over the seq group (ring,
Ulysses or the gathered attention, ``attn_impl``), each process trains
on its rows of the global batch (its tensor and expert peers on the same
rows, its seq peers each on its block of their columns), the metrics
and the validation loss are the world's, the checkpoints are written
shard by shard as manifest fragments
(``CheckpointManager(multi_process=True)``, ``ckpt_format`` ``raw`` or
``dcp``) and restore at whatever world the resume runs. Process 0 alone
logs and samples.

``stage_axis`` > 1 takes the JAX pipeline leg (``_train_pipeline``): a
``data_axis`` x ``stage_axis`` mesh of processes, each stage holding its
``n_layer / stage_axis`` blocks (``parallel/pipeline.py``), the GPipe
schedule over ``microbatches`` with dropout off, per-epoch saves on the
pipeline rule whose metric is the epoch's train loss (as ``val_loss``),
the in-run resume, no validation, no EMA.

Both loops honour a preemption at every step boundary, as the JAX legs
do: after each step the fault plan's ``step_boundary`` hook runs, and if
the flag is up (a SIGTERM, or the plan's ``preempt``) the loop drains —
it commits the current step with its mid-epoch loader cursor
(``emergency_save`` on the fastest tier when the grace window is
closing, else a full save), unless that step is already the newest
committed one, and raises ``Preempted``. The requeued call restores it
through the manager's tier ladder and replays the epoch's unconsumed
tail. The JAX package's ``TPUFLOW_FAULT``, ``TPUFLOW_PREEMPT_GRACE_S``
and ``TPUFLOW_CKPT_LOCAL_DIR`` are the arguments ``faults``,
``preempt_grace_s`` and ``ckpt_local_dir``.

Both loops judge every step's numerics, as the JAX legs do
(``obs/health.py``, on by default: ``health=True``): each step's fence
reads the loss, the grad norm and the nonfinite flag in one host copy;
a nonfinite step (or a loss spike, or a grad explosion when configured)
rolls the run back to the newest crc-verified checkpoint (every process
the same one) and replays from its loader cursor, bit for bit what the
run would have computed from there, or halts with ``TrainingDiverged``
when rollback is off, its budget is spent or nothing verified exists.
The fault plan's ``nan_grad`` and ``loss_spike`` poison the parameters
before their step; ``profile=(start, stop)`` traces those steps with
``torch.profiler``; each fence stamps the process's gang heartbeat
(``utils/heartbeat.py``); with the obs recorder configured each step
records the ``health.*`` gauges. The JAX package's ``TPUFLOW_HEALTH*``
and ``TPUFLOW_PROFILE`` are the arguments ``health`` (a ``HealthConfig``
or a bool) and ``profile``.

Run and device telemetry (the JAX legs' ``StepClock``): with the obs
recorder configured each leg records the cold first step as one
``train.compile`` span, each steady step's wall as ``train.step_s`` and
its tokens as ``train.tokens``, the ``train.epoch`` and
``train.validation`` spans, the goodput-so-far and memory gauges
(``device.hbm_*`` on the card, every ``hbm_poll_s`` seconds), the comm
attribution gauges at each epoch's end (FSDP leg, on a card of the
table), and the step's program entry in ``programs.json``
(``device_ledger``: its first fenced run, FLOP estimate and memory
marks, with the kernel libraries built; the JAX package's
``TPUFLOW_DEVICE_LEDGER``). ``http_port`` serves the live ``/metrics`` +
``/status`` export from process 0 (``TPUFLOW_OBS_HTTP_PORT``), fed with
the rolling step rate and MFU; ``capture`` arms the anomaly-triggered
``torch.profiler`` capture (``obs/profcap.py``; ``TPUFLOW_PROF_*``). None
of it touches a step's numerics: the losses are bit-equal with telemetry
on and off.

In an elastic gang (the process's ``dist/membership.py`` configured, as
``FlowRunner(elastic=True)`` configures its members) the FSDP leg is a
loop of mesh generations, as the JAX leg's: at every step boundary the
members agree on a pending generation (``membership.fence``); at a grow
they commit the current step with its loader cursor, after a loss they
abandon the save that can no longer commit, and a collective that died
with a peer is checked against the supervisor's plan. Then the world is
torn down and formed again (``quiesce_and_reform``), and the next
generation resumes from the newest committed step, resharded to its
world: the ``data`` axis absorbs the resize, the model-parallel axes stay
(a world they do not divide fails loudly). Every epoch's save commits
before the next epoch (a loss then resumes from it), and the per-step
record is cut back to the resumed step. The pipeline leg cannot absorb a
lost stage: its fence commits at a grow, abandons after a loss, and
raises ``Preempted`` (the requeue).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import time
from typing import Any

import torch

from tpuflow_torch.ckpt import (
    CheckpointManager,
    prewarm_restore_wait,
    release_pinned,
    restore_from_handle,
)
from tpuflow_torch.ckpt.tree import (
    JaxLeaves,
    checkpoint_tree,
    load_checkpoint_tree,
)
from tpuflow_torch import dist, obs
from tpuflow_torch.data.lm import make_lm_loaders
from tpuflow_torch.dist import membership
from tpuflow_torch.device import resolve_device
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
from tpuflow_torch.obs import device as obs_device
from tpuflow_torch.obs import goodput as obs_goodput
from tpuflow_torch.obs.health import (
    HealthConfig,
    HealthMonitor,
    ProfileWindow,
    TrainingDiverged,
    _RollbackSignal,
    handle_anomaly,
)
from tpuflow_torch.obs.profcap import (
    AnomalyCapturer,
    CaptureConfig,
    make_capturer,
)
from tpuflow_torch.ops.flash_attention import BWD_MODES
from tpuflow_torch.parallel import (
    ShardPlan,
    gpt2_tensor_rules,
    localize,
    shard_model,
)
from tpuflow_torch.parallel.pipeline import keep_stage_blocks
from tpuflow_torch.parallel.tensor import TensorParallel, attach
from tpuflow_torch.testing import faults as faults_mod
from tpuflow_torch.train.optim import make_optimizer, make_schedule
from tpuflow_torch.train.step import (
    Preempted,
    StepClock,
    TrainState,
    comm_attribution,
    emit_comm_gauges,
    emergency_save_advised,
    make_eval_step,
    make_pipeline_step,
    make_train_step,
    preemption_requested,
    run_validation,
    with_ema,
)
from tpuflow_torch.utils import heartbeat

# The step metrics a fence reads, in one host copy.
_FENCE_KEYS = ("loss", "grad_norm", "nonfinite", "update_norm", "param_norm")

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
_SELECTORS = ("full", "dots", "none")


def _resume_cursor(
    data_state: dict | None,
    step: int,
    steps_per_epoch: int,
    epochs: int,
    seed: int,
) -> tuple[int, int]:
    """(start_epoch, batches_to_skip) for a resume landing on ``step``.

    With a persisted loader cursor whose shuffle seed matches, the resume
    lands mid-epoch and replays exactly the epoch's unconsumed tail;
    without one, it falls back to the epoch head the step floors to."""
    if data_state and int(data_state.get("seed", -1)) == int(seed):
        epoch = min(int(data_state.get("epoch", 0)), epochs)
        skip = max(int(data_state.get("batch_index", 0)), 0)
        if skip >= steps_per_epoch:
            # Drained exactly at the epoch boundary: next epoch, no skip.
            return min(epoch + 1, epochs), 0
        return epoch, skip
    return min(step // steps_per_epoch, epochs), 0


def _apply_remat_selector(model_cfg: GPT2Config, selector: str) -> GPT2Config:
    """Map a remat selector onto a GPT2Config.

    ``none`` — remat off: every activation is saved, the flash residuals
               (q, k, v, o, lse) included; the backward recomputes nothing.
    ``dots`` — remat on, saving the matrix products and the flash forward's
               outputs; the elementwise work is recomputed.
    ``full`` — remat on, saving only block inputs.
    """
    if selector == "none":
        return dataclasses.replace(model_cfg, remat=False, remat_policy=None)
    if selector == "full":
        return dataclasses.replace(model_cfg, remat=True, remat_policy=None)
    if selector == "dots":
        return dataclasses.replace(model_cfg, remat=True, remat_policy="dots")
    raise ValueError(
        f"unknown remat selector {selector!r}; the port takes full|dots|none"
    )


def active_remat_policy(model_cfg: GPT2Config) -> str:
    """'none' when remat is off, 'full' for policy-less remat, else the
    policy name."""
    if not model_cfg.remat:
        return "none"
    return model_cfg.remat_policy or "full"


@dataclasses.dataclass
class GptTrainConfig:
    """Everything the GPT training recipe needs: the JAX package's fields
    and defaults. The mesh's ``data_axis`` x ``fsdp_axis`` x
    ``tensor_axis`` x ``seq_axis`` x ``expert_axis`` (``data_axis`` x
    ``stage_axis`` in pipeline mode) is the number of processes that
    train (the default data 2 x fsdp 2 needs four); ``data_axis=1,
    fsdp_axis=1`` trains in this one."""

    preset: str = "test"            # test | gpt2 | medium
    epochs: int = 2
    steps_per_epoch: int = 16
    batch_size: int = 8             # global
    seq_len: int = 64
    learning_rate: float = 3e-4
    data_axis: int = 2
    fsdp_axis: int = 2
    tensor_axis: int = 1
    seq_axis: int = 1
    expert_axis: int = 1
    experts: int = 0                # Switch-MoE experts per block (0=dense)
    stage_axis: int = 1             # >1 = GPipe pipeline mode
    microbatches: int = 2
    attn_impl: str = "auto"         # auto | xla | flash | ring | ulysses
    dataset: str = "lm_synth"       # lm_synth | lm_text
    text_path: str | None = None    # pin the lm_text corpus file
    sample_tokens: int = 0
    accum_steps: int = 1
    optimizer_name: str = "adamw"   # adamw | sgd | adafactor | lion
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    grad_clip: float = 0.0
    weight_decay: float = 1e-4
    ema_decay: float = 0.0
    ckpt_dtype: str | None = None
    decay_steps: int = 0            # 0 = this run's epochs*steps
    # Remat selector: '' = the preset's default (full remat for gpt2 and
    # medium, none for test), else full | dots | none.
    remat_policy: str = ""
    # Activation dtype: '' = f32, 'bfloat16' = mixed precision (bf16
    # products, f32 master weights, optimizer state and loss head).
    dtype: str = ""

    def model_config(self) -> GPT2Config:
        act_dtype = None
        if self.dtype:
            if self.dtype not in _DTYPES:
                raise ValueError(
                    f"unknown dtype {self.dtype!r}; supported: bfloat16, "
                    "float16, float32"
                )
            act_dtype = _DTYPES[self.dtype]
        cfg = GPT2Config.from_preset(
            self.preset,
            attn_impl=self.attn_impl,
            seq_len=self.seq_len,
            stage_axis=self.stage_axis,
            n_experts=self.experts,
            dtype=act_dtype,
        )
        if self.remat_policy:
            if self.remat_policy not in _SELECTORS:
                raise ValueError(
                    f"unknown remat_policy {self.remat_policy!r}; the port "
                    "takes full|dots|none (jax.checkpoint_policies names "
                    "have no counterpart)"
                )
            cfg = _apply_remat_selector(cfg, self.remat_policy)
        return cfg

    def _schedule_kw(self) -> dict:
        total = self.epochs * self.steps_per_epoch
        return dict(warmup_steps=self.warmup_steps,
                    decay_steps=self.decay_steps
                    or max(total - self.warmup_steps, 1),
                    schedule=self.lr_schedule)

    def optimizer(self, params, leaves=None):
        """The optimizer over ``params``; ``leaves`` groups them into the
        JAX param tree's leaves (``ckpt/tree.py::JaxLeaves``), which
        Adafactor keeps its statistics for."""
        return make_optimizer(
            params,
            self.learning_rate,
            optimizer=self.optimizer_name,
            weight_decay=self.weight_decay,
            grad_clip_norm=self.grad_clip or None,
            leaves=leaves,
            **self._schedule_kw(),
        )

    def schedule(self, lr_scale: float = 1.0):
        """The optimizer's learning-rate schedule with its peak scaled by
        ``lr_scale`` (the JAX leg rebuilds its optimizer at
        ``learning_rate * lr_scale`` after a backed-off rollback)."""
        return make_schedule(self.learning_rate * lr_scale,
                             **self._schedule_kw())

    def validate(self) -> None:
        """Reject incoherent knob combinations with actionable messages."""
        if self.stage_axis > 1:
            if (
                self.tensor_axis > 1
                or self.seq_axis > 1
                or self.expert_axis > 1
            ):
                raise ValueError(
                    "pipeline (stage_axis) composes with data_axis only"
                )
            if self.accum_steps > 1:
                raise ValueError(
                    "accum_steps applies to the FSDP/DP step only; the "
                    "pipeline schedule already microbatches via "
                    "microbatches"
                )
            if self.ema_decay > 0.0:
                raise ValueError(
                    "ema_decay is not supported in pipeline mode "
                    "(stage_axis > 1); the pipeline step tracks no EMA"
                )
        if self.experts and self.experts % self.expert_axis:
            raise ValueError(
                f"experts {self.experts} must be divisible by "
                f"expert_axis {self.expert_axis}"
            )


@dataclasses.dataclass
class GptTrainResult:
    checkpoint: Any                  # the newest step's handle; None without
                                     # a ckpt_dir
    loss_history: list[float]        # per-epoch mean train loss
    metrics_history: list[dict]      # per epoch: losses, ppl, tokens/s
    sample: list[int] | None = None  # greedy tokens when sample_tokens > 0
    # The port's additions: each step's loss and host wall seconds (every
    # step ends in a synchronizing read of its loss).
    step_losses: list[float] = dataclasses.field(default_factory=list)
    step_s: list[float] = dataclasses.field(default_factory=list)
    # With a ckpt_dir: the manager's save and restore records (step,
    # bytes, seconds, GB/s).
    checkpoint_io: dict | None = None


def mesh_axes(cfg: GptTrainConfig) -> dict[str, int]:
    """The named mesh ``train_gpt`` runs ``cfg`` on: ``data`` x ``stage``
    in pipeline mode, else ``data`` x ``fsdp`` x ``tensor`` x ``seq`` x
    ``expert``. In a re-formed elastic generation of the FSDP leg the
    ``data`` axis is the world over the fixed axes' product (the axes
    as configured when that does not divide the world, which then fails
    against it)."""
    if cfg.stage_axis > 1:
        return {"data": cfg.data_axis, "stage": cfg.stage_axis}
    axes = {"data": cfg.data_axis, "fsdp": cfg.fsdp_axis,
            "tensor": cfg.tensor_axis, "seq": cfg.seq_axis,
            "expert": cfg.expert_axis}
    if membership.current_generation() > 0:
        fixed = math.prod(v for k, v in axes.items() if k != "data")
        if dist.process_count() % fixed == 0:
            axes["data"] = dist.process_count() // fixed
    return axes


def _check_supported(cfg: GptTrainConfig, ckpt_dir, elastic: bool) -> None:
    """Raise for every option of the JAX recipe the port does not run, for
    a mesh the world does not fill, for ``elastic`` outside an elastic
    gang and for an elastic gang over NCCL."""
    if cfg.stage_axis > 1 and cfg.optimizer_name == "adafactor":
        raise ValueError(
            "adafactor in pipeline mode (stage_axis > 1): the JAX leg "
            "places every optimizer leaf under an 'h' path on 'stage' "
            "(gpt2_pipeline_shardings), and Adafactor's (1,) placeholders "
            "do not split; use adamw, sgd or lion")
    axes = mesh_axes(cfg)
    desc = " x ".join(f"{k}_axis={v}" for k, v in axes.items())
    if cfg.stage_axis > 1:
        desc += " (pipeline)"
    n = math.prod(axes.values())
    world = dist.process_count()
    if n != world:
        raise ValueError(
            f"a mesh of {desc} = {n} processes, but the world has {world}: "
            "the port runs one process per mesh coordinate (start that many "
            "processes with their rendezvous variables, or run the "
            "TorchGptTrain gang)")

    if cfg.ckpt_dtype and ckpt_dir is None:
        raise ValueError(f"ckpt_dtype={cfg.ckpt_dtype!r} casts checkpoints, "
                         "but no ckpt_dir was given to save them in")
    if elastic and not membership.enabled():
        raise ValueError(
            "elastic=True outside an elastic gang: this process has no "
            "membership directory (FlowRunner(elastic=True) configures its "
            "gang members; elsewhere call dist.membership.configure(dir, "
            "member=))")
    if membership.enabled() and ckpt_dir is None:
        raise ValueError("an elastic gang re-forms from its checkpoints: "
                         "train_gpt needs a ckpt_dir")
    membership.check_world()


def _init_model(model_cfg: GPT2Config, device, seed: int | None = 0) -> GPT2:
    """The model at step 0: random weights from ``seed`` (None: left
    uninitialised, for a restore to fill)."""
    return GPT2(model_cfg, seed=seed, device=device)


def init_state(cfg: GptTrainConfig, model_cfg: GPT2Config | None = None,
               device=None, *, materialize: bool = True,
               mesh=None) -> TrainState:
    """Model, optimizer and (with ``ema_decay``) EMA weights at step 0.
    ``materialize=False`` skips the random weights (a restore overwrites
    them); the optimizer's moments are zeros on the device either way.

    ``mesh`` (``dist.make_mesh`` over several processes): the state born
    sharded (``tpuflow/parallel/sharding.py::create_sharded_state``), by
    ``gpt2_tensor_rules`` where the mesh has a ``tensor`` or ``expert``
    axis (as the JAX recipe passes them). Fresh, every process builds the
    same seed-0 model on its device, keeps its tensor and expert blocks
    (``localize``) and ``shard_model`` its FSDP shards of them; for a
    restore the model is built on the ``meta`` device and only the local
    parts are allocated (the JAX package shape-evaluates the init for the
    same reason). The moments and the EMA weights are made from the local
    parts."""
    model_cfg = model_cfg or cfg.model_config()
    dev = resolve_device(device)
    if mesh is not None and mesh.shape.get("stage", 1) > 1:
        return _init_pipeline_state(cfg, model_cfg, dev, materialize, mesh)
    if mesh is None or math.prod(mesh.shape.values()) == 1:
        model = _init_model(model_cfg, dev, seed=0 if materialize else None)
        state = TrainState(model=model, tx=cfg.optimizer(
            model.parameters(), JaxLeaves(model, model_cfg.scan_layers)))
    else:
        model = _init_model(model_cfg, dev if materialize else "meta",
                            seed=0 if materialize else None)
        rules = gpt2_tensor_rules if mesh.model_parallel else None
        plan = ShardPlan(model, model_cfg.scan_layers, mesh,
                         tensor_rules=rules)
        localize(model, plan)
        attach(model, TensorParallel(mesh, plan, model_cfg))
        leaves = JaxLeaves(model, model_cfg.scan_layers, plan, mesh)
        shard_model(model, mesh, plan)
        if not materialize:
            model.to_empty(device=dev)
        tx = cfg.optimizer(plan.local(model), leaves)
        tx.owned = plan.owned
        state = TrainState(model=model, tx=tx, plan=plan, mesh=mesh)
    if cfg.ema_decay > 0.0:
        state = with_ema(state)
    return state


def _init_pipeline_state(cfg: GptTrainConfig, model_cfg: GPT2Config, dev,
                         materialize: bool, mesh) -> TrainState:
    """The state of one stage of a pipeline mesh: the seed-0 model (or a
    ``meta`` one for a restore) with this stage's blocks alone
    (``keep_stage_blocks``), placed by the pipeline rule
    (``ShardPlan`` on the ``stage`` mesh), the optimizer over its
    parameters. No FSDP: ``data`` peers hold replicas."""
    model = _init_model(model_cfg, dev if materialize else "meta",
                        seed=0 if materialize else None)
    keep_stage_blocks(model, mesh)
    plan = ShardPlan(model, model_cfg.scan_layers, mesh)
    leaves = JaxLeaves(model, model_cfg.scan_layers, plan, mesh)
    if not materialize:
        model.to_empty(device=dev)
    tx = cfg.optimizer(plan.local(model), leaves)
    tx.owned = plan.owned
    return TrainState(model=model, tx=tx, plan=plan, mesh=mesh)


def _step_boundary(mgr, step: int, tree, data_state: dict,
                   grace_s: float | None) -> None:
    """The loops' step boundary (``tpuflow/train/gpt.py``'s
    ``drain_preempt``): the fault plan's hook, then, with the preemption
    flag up, the drain — commit ``step`` (``tree()``, its state, with the
    loader cursor ``data_state``) unless it is already the newest
    committed step, by ``emergency_save`` when the grace budget
    ``grace_s`` is closing, else a full save; close the manager; raise
    ``Preempted``. Without a manager there is nothing to commit."""
    faults_mod.step_boundary(step)
    if not preemption_requested():
        return
    if mgr is not None:
        if mgr.latest_step() != step:
            if emergency_save_advised(budget=grace_s):
                mgr.emergency_save(step, tree(), data_state=data_state,
                                   grace_s=grace_s)
            else:
                mgr.save(step, tree(), metrics={}, data_state=data_state)
                mgr.wait_until_finished()
        mgr.close()
    raise Preempted(f"drained checkpoint at step {step}")


def _reform_fence(mgr, step: int, tree, data_state: dict,
                  pipeline: bool = False) -> None:
    """An elastic loop's fence after the step boundary (the JAX legs'
    ``drain_reform`` and ``drain_reform_fallback``): with a generation
    pending on every process, hand the state to the checkpoint and unwind.
    At a grow every member is alive, so ``step`` (``tree()``, with the
    loader cursor ``data_state``) commits unless it is already the newest
    committed step; after a loss the save in flight cannot commit and is
    abandoned (the resume replays from the last committed step). Then the
    manager closes and ``MeshReform`` unwinds to the generation loop, or,
    for the pipeline (``pipeline``: a lost stage cannot be absorbed),
    ``Preempted`` to the requeue."""
    plan = membership.fence()
    if plan is None:
        return
    if mgr is not None and plan.reason == "grow":
        if mgr.latest_step() != step:
            mgr.save(step, tree(), metrics={}, data_state=data_state)
        mgr.wait_until_finished()
    _unwind(plan, mgr, pipeline)


def _member_lost(exc: Exception, mgr, pipeline: bool = False) -> None:
    """A loop's error in an elastic gang: a collective that died with a
    peer becomes ``MeshReform`` (the pipeline's ``Preempted``) once the
    supervisor's plan is out, the save in flight abandoned and the
    manager closed; any other error (no plan within ``REFORM_WAIT_S``)
    goes on unchanged."""
    plan = membership.reform_after_failure(exc)
    if plan is None:
        raise exc
    _unwind(plan, mgr, pipeline, exc)


def _unwind(plan, mgr, pipeline: bool, cause=None) -> None:
    """Abandon what is still in flight (nothing after a grow's commit),
    close the manager, and raise ``MeshReform`` (the pipeline:
    ``Preempted``)."""
    if mgr is not None:
        mgr.abandon_pending()
        mgr.close()
    if pipeline:
        raise Preempted(f"mesh re-form (generation {plan.generation}) "
                        "requeues the pipeline leg") from cause
    raise membership.MeshReform(plan) from cause


class _Health:
    """The loops' per-step health work (the JAX legs' ``settle`` and the
    poison and profile hooks around it): ``before`` a step, the fault
    plan's parameter poison and the profile window's start; ``fence``
    after it, the one host copy of the step's scalars, the run's per-step
    record (``steps``, ``step_losses``, ``step_s``), the heartbeat, the
    ``health.*`` gauges and the monitor, raising ``_RollbackSignal`` with
    the verified target (or ``TrainingDiverged``) when it flags the step;
    ``after`` the step boundary's profile stop; ``recover`` from what
    ``fence`` raised. ``lr_scale``: the product of the rollbacks'
    backoffs. ``begin`` starts a generation's ``StepClock`` (the
    telemetry of the module docstring), which ``fence`` feeds: the
    generation's first step is its cold one."""

    def __init__(self, health: HealthConfig | bool,
                 profile: tuple[int, int] | None, dev, *,
                 capture: AnomalyCapturer | None = None,
                 hbm_poll_s: float = obs_device.DEFAULT_POLL_S,
                 device_ledger: bool = True):
        self.monitor = HealthMonitor.of(health)
        self.profile = ProfileWindow.make(profile, cuda=dev.type == "cuda")
        self.capture = capture
        self.hbm_poll_s = hbm_poll_s
        self.device_ledger = device_ledger
        self.lr_scale = 1.0
        self.steps, self.step_losses, self.step_s = [], [], []
        self.clock: StepClock | None = None
        self.cold = True

    def begin(self, state: TrainState, dev, program: str,
              tokens_per_step: int, stages: int = 1, **compile_attrs) -> None:
        """A generation's telemetry: its clock, the rolling-MFU feed (6 N
        FLOPs a token, counted once while feeding) and the cold step's
        program entry (``program``, FLOPs 6 N x ``tokens_per_step``)."""
        self.clock = StepClock(capture=self.capture,
                               hbm_poll_s=self.hbm_poll_s)
        self.cold = True
        self.dev = dev
        self.program = program
        self.compile_attrs = compile_attrs
        self.flops_per_step = None
        self.mark = None
        self.n_params = None
        if self.clock.feeding:
            self.n_params = _n_params(state, stages)
            obs_goodput.live().set_model_flops_per_token(6.0 * self.n_params)
            self.flops_per_step = 6.0 * self.n_params * tokens_per_step

    def before(self, state: TrainState) -> None:
        if self.cold and self.clock is not None and self.clock.recording:
            self.mark = obs_device.allocated_bytes(self.dev)
        step = state.step + 1
        poison = faults_mod.grad_poison(step)
        if poison is not None:
            # The JAX leg's ``p * poison`` over its params; a sharded
            # state's are this process's shards.
            with torch.no_grad():
                torch._foreach_mul_(state.params, poison)
        if self.profile is not None:
            self.profile.maybe_start(step)

    def fence(self, step: int, metrics: dict, mgr, t0: float,
              tokens: int = 0) -> float:
        """Wait for step ``step`` (dispatched at ``t0``, a monotonic time,
        ``tokens`` the global batch's), record and judge it; returns its
        loss."""
        loss, gn, nf, un, pn = torch.stack(
            [metrics[k].detach().float() for k in _FENCE_KEYS]).tolist()
        self.steps.append(step)
        self.step_losses.append(loss)
        self.step_s.append(time.monotonic() - t0)
        nonfinite = bool(nf)
        heartbeat.beat(step)
        clock = self.clock
        if self.cold:
            # The cold step's tokens stay out of the rates.
            self.cold = False
            run_s = clock.compile_done(**self.compile_attrs)
            if run_s is not None:
                obs_device.note_program(
                    self.program, run_s=run_s, flops=self.flops_per_step,
                    argument_bytes=self.mark, device=self.dev,
                    ledger=self.device_ledger)
        else:
            clock.step_done(tokens=tokens, step=step)
        clock.health_done(loss=loss, grad_norm=gn, update_norm=un,
                          param_norm=pn, nonfinite=nonfinite)
        if self.monitor is not None:
            anomaly = self.monitor.observe(step, loss, gn,
                                           nonfinite=nonfinite)
            if anomaly is not None:
                target = handle_anomaly(self.monitor, anomaly, mgr)
                raise _RollbackSignal(target, anomaly)
        return loss

    def after(self, step: int) -> None:
        if self.profile is not None:
            self.profile.maybe_stop(step)

    def cut(self, step: int) -> None:
        """Drop the per-step record past ``step`` (a resume replays it)."""
        keep = bisect.bisect_right(self.steps, step)
        del self.steps[keep:], self.step_losses[keep:], self.step_s[keep:]

    def close(self) -> None:
        if self.profile is not None:
            self.profile.close()
        if self.capture is not None:
            self.capture.close()

    def recover(self, exc: Exception, cfg: GptTrainConfig,
                state: TrainState, mgr, scan: bool, seed: int,
                log) -> tuple[int, int]:
        """Handle what ``fence`` raised. ``TrainingDiverged`` waits for the
        in-flight saves (only committed checkpoints stay behind a halted
        run) and goes on up. ``_RollbackSignal``: restore its target into
        ``state`` (params, moments, step and EMA: the replay is bit for
        bit), drop the per-step record past it (no result holds a
        discarded step), apply the learning-rate backoff, rewind the
        manager's history and record ``health.rollback`` (from the step
        the run had reached). Returns the cursor (start epoch, batches to
        skip) of the restored step for a loader of shuffle seed ``seed``;
        the caller cuts its per-epoch records to the start epoch."""
        if not isinstance(exc, _RollbackSignal):
            if mgr is not None:
                mgr.wait_until_finished()
            raise exc
        from_step = state.step
        if self.monitor.cfg.lr_backoff != 1.0:
            self.lr_scale *= self.monitor.cfg.lr_backoff
            state.tx.schedule = cfg.schedule(self.lr_scale)
        tmpl = checkpoint_tree(state, scan_layers=scan, abstract=True)
        restored = mgr.restore(exc.target, abstract_state=tmpl)
        load_checkpoint_tree(state, restored)
        del restored
        self.cut(state.step)
        meta = mgr.restore_metadata(state.step)
        cursor = _resume_cursor(meta.get("data_state"), state.step,
                                cfg.steps_per_epoch, cfg.epochs, seed)
        mgr.rewind_history(state.step)
        obs.event("health.rollback", step=state.step, from_step=from_step,
                  detector=exc.anomaly.kind, lr_scale=self.lr_scale,
                  rollbacks=self.monitor.rollbacks)
        log(f"[gpt] health rollback: {exc.anomaly.describe()} -> restored "
            f"verified step {state.step} (epoch {cursor[0]}, lr_scale "
            f"{self.lr_scale:g})")
        return cursor


def _n_params(state: TrainState, stages: int = 1) -> int:
    """The whole model's parameter count: the plan's global shapes of a
    sharded state (a pipeline stage holds its blocks, ``h.*``, of
    ``stages``), else the module's own."""
    if state.plan is None:
        return sum(p.numel() for p in state.model.parameters())
    return sum(math.prod(shape) * (stages if name.startswith("h.") else 1)
               for name, shape in state.plan.shapes.items())


def _fsdp_world(mesh) -> int:
    """The processes a step's gradients reduce over (``data`` x ``fsdp``,
    the JAX leg's rule for its comm roofline)."""
    if mesh is None:
        return 1
    return math.prod(int(mesh.shape.get(ax, 1)) for ax in ("fsdp", "data"))


def full_model(state: TrainState):
    """The whole model of a sharded state, on process 0 (a plain ``GPT2``
    with the weights gathered over the FSDP, tensor and expert groups;
    every process must call this, the others get None); an unsharded
    state's own model."""
    if state.plan is None:
        return state.model
    full = {name: state.plan.full(name, t, state.mesh)
            for name, t in zip(state.plan.names, state.params)}
    if dist.process_index() != 0:
        return None
    model = GPT2(state.model.config, seed=None,
                 device=next(iter(full.values())).device)
    model.load_state_dict(full)
    return model


def train_gpt(
    cfg: GptTrainConfig,
    ckpt_dir: str | None = None,
    resume_checkpoint=None,
    log=print,
    *,
    device=None,
    flash_bwd: str = "fused",
    health: HealthConfig | bool = True,
    profile: tuple[int, int] | None = None,
    elastic: bool = False,
    comm_overlap: bool = True,
    ckpt_format: str = "raw",
    faults: str | None = None,
    preempt_grace_s: float | None = None,
    ckpt_local_dir: str | None = None,
    capture: CaptureConfig | AnomalyCapturer | bool | None = None,
    hbm_poll_s: float = obs_device.DEFAULT_POLL_S,
    device_ledger: bool = True,
    http_port: int | None = None,
    http_host: str = "127.0.0.1",
) -> GptTrainResult:
    """Run the configured GPT training leg end to end on this process's
    device (``cuda`` unless ``device`` says otherwise; ``cuda:<i>`` puts
    the process on card i), sharded over the world's processes when the
    mesh has several (see the module docstring).

    ``ckpt_dir``: a ``CheckpointManager(max_to_keep=2,
    save_dtype=cfg.ckpt_dtype)`` there saves the full state at every epoch
    end (metrics ``val_loss``/``train_loss``/``ppl``, the loader cursor as
    ``data_state``), and a directory that already holds committed steps
    resumes from the newest (state, histories, start epoch). None trains
    without checkpoints; the manager's pool is prewarmed for the saves
    (on memory-backed storage), and an in-run resume's restore buffers
    while the model is built (page-locked on the card, and handed back
    once the state is on it).
    ``resume_checkpoint``: a ``Checkpoint`` handle to restore the full
    state from; it wins over the in-run resume. A caller that knows the
    handle early backs its restore first (``prewarm_restore_handle``, as
    ``TorchGptTrain`` does).
    ``flash_bwd``: the flash attention backward, ``fused`` | ``split`` |
    ``blockwise`` (the JAX package's ``TPUFLOW_FLASH_BWD``; ``blockwise``,
    the plain version, on the CPU only). ``health``: the training-health
    policy (``obs/health.py``; True the JAX defaults, False no monitor,
    the JAX package's ``TPUFLOW_HEALTH*``). ``profile``: ``(start, stop)``,
    the optimizer steps to trace with ``torch.profiler`` into the obs
    recorder's ``profile/`` directory (its ``TPUFLOW_PROFILE``; None: no
    trace). ``elastic``: assert that this process is in an elastic gang
    (a ``ValueError`` names what is missing otherwise); the re-forms run
    whenever the process's membership is configured, as in the JAX leg
    (see the module docstring). ``faults``: a fault plan
    (``testing/faults.py``) installed for the call as this process's rank
    (None: the process's own, if any).
    ``preempt_grace_s``: the termination grace after a SIGTERM that
    decides between the drain's emergency and full save (None: the
    process's own, ``utils/preempt.py``). ``ckpt_local_dir``: the
    manager's node-local tier (None: none). ``comm_overlap``: on several
    processes with ``accum_steps > 1``, reduce-scatter each microbatch's
    gradients right after its backward (the JAX package's
    ``TPUFLOW_COMM_OVERLAP``, on by default), else once after the last.
    ``ckpt_format``: the saves' format, ``raw`` (crosses into the JAX
    package) or ``dcp`` (``torch.distributed.checkpoint``; the JAX
    package's ``TPUFLOW_CKPT_FORMAT=orbax``); a resume reads either.
    ``capture``, ``hbm_poll_s``, ``device_ledger``, ``http_port`` and
    ``http_host``: the run and device telemetry of the module docstring
    (``capture``: a ``CaptureConfig``, True for its defaults, or a built
    ``AnomalyCapturer``; None: no capture)."""
    cfg.validate()
    _check_supported(cfg, ckpt_dir, elastic)
    rank = (membership.member_id() if membership.enabled()
            else dist.process_index())
    if http_port is not None:
        obs.start_export(http_port, host=http_host,
                         proc=dist.process_index())
    hl_kw = dict(capture=make_capturer(capture), hbm_poll_s=hbm_poll_s,
                 device_ledger=device_ledger)
    with faults_mod.installing(faults, rank=rank):
        return _train_gpt(cfg, ckpt_dir, resume_checkpoint, log, device,
                          flash_bwd, comm_overlap, ckpt_format,
                          preempt_grace_s, ckpt_local_dir, health, profile,
                          hl_kw)


def _train_gpt(cfg: GptTrainConfig, ckpt_dir, resume_checkpoint, log,
               device, flash_bwd: str, comm_overlap: bool, ckpt_format: str,
               grace_s: float | None, local_dir: str | None,
               health: HealthConfig | bool, profile, hl_kw: dict
               ) -> GptTrainResult:
    """``train_gpt``'s body, under its fault plan."""
    if flash_bwd not in BWD_MODES:
        raise ValueError(f"unknown flash_bwd {flash_bwd!r}; use "
                         f"{'|'.join(BWD_MODES)}")
    model_cfg = dataclasses.replace(cfg.model_config(), flash_bwd=flash_bwd)
    dev = resolve_device(device)
    hl = _Health(health, profile, dev, **hl_kw)
    try:
        if cfg.stage_axis > 1:
            if cfg.fsdp_axis > 1:
                log("[gpt] note: fsdp_axis does not apply in pipeline mode; "
                    "params shard by layer slice over 'stage' instead")
            return _train_pipeline(cfg, model_cfg, dev, ckpt_dir,
                                   resume_checkpoint, log, ckpt_format,
                                   grace_s, local_dir, hl)
        return _train_fsdp(cfg, model_cfg, dev, ckpt_dir, resume_checkpoint,
                           log, comm_overlap, ckpt_format, grace_s,
                           local_dir, hl)
    finally:
        hl.close()


def _train_fsdp(cfg: GptTrainConfig, model_cfg: GPT2Config, dev, ckpt_dir,
                resume_checkpoint, log, comm_overlap: bool, ckpt_format: str,
                grace_s: float | None, local_dir: str | None, hl: _Health
                ) -> GptTrainResult:
    """The JAX FSDP leg on this process's device, sharded over the world's
    processes when it has several: one pass a mesh generation (one in
    all, outside an elastic gang). A ``MeshReform`` has handed the state
    to the checkpoint; the next generation forms and resumes from the
    newest committed step (never a cross-run handle again)."""
    while True:
        try:
            return _run_fsdp_generation(
                cfg, model_cfg, dev, ckpt_dir, resume_checkpoint, log,
                comm_overlap, ckpt_format, grace_s, local_dir, hl)
        except membership.MeshReform as rf:
            if membership.member_id() == 0:
                log(f"[gpt] mesh re-form -> generation {rf.plan.generation}"
                    f" ({rf.plan.reason}, {rf.plan.num_processes} members)")
            plan = rf.plan
        membership.quiesce_and_reform(plan)
        resume_checkpoint = None


def _run_fsdp_generation(cfg: GptTrainConfig, model_cfg: GPT2Config, dev,
                         ckpt_dir, resume_checkpoint, log,
                         comm_overlap: bool, ckpt_format: str,
                         grace_s: float | None, local_dir: str | None,
                         hl: _Health) -> GptTrainResult:
    """One mesh generation of the FSDP leg (the JAX
    ``_run_fsdp_generation``)."""
    generation = membership.current_generation()
    elastic = membership.enabled()
    mesh = None
    if dist.process_count() > 1:
        mesh = dist.make_mesh(dev, mesh_axes(cfg))
        dev = mesh.device
        if dist.process_index() != 0:
            log = _quiet
        log(f"[gpt] mesh {dict(mesh.shape)}, preset {cfg.preset}"
            + (f", generation {generation}" if generation else ""))
    multi = mesh is not None
    loader, val_loader = make_lm_loaders(
        cfg.batch_size, cfg.steps_per_epoch, cfg.seq_len,
        model_cfg.vocab_size, dataset=cfg.dataset, text_path=cfg.text_path,
    )
    log(f"[gpt] device {dev}, preset {cfg.preset}, remat "
        f"{active_remat_policy(model_cfg)}, attn {model_cfg.attn_impl}"
        f" (flash backward {model_cfg.flash_bwd})")
    mgr = None
    resume_step = None
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, max_to_keep=2,
                                save_dtype=cfg.ckpt_dtype or None,
                                multi_process=multi, format=ckpt_format,
                                local_dir=local_dir)
        # In-run resume: a previous attempt of this run left committed
        # steps; an explicit handle (a cross-run resume) wins.
        if resume_checkpoint is None:
            resume_step = mgr.latest_step()
        if resume_step is not None and not cfg.ckpt_dtype and not multi:
            # Back the restore's buffers while the model is built (a
            # ckpt_dtype step is cast on restore and would take none).
            mgr.prewarm_restore(resume_step, pinned=dev.type == "cuda")
    resuming = resume_checkpoint is not None or resume_step is not None
    state = init_state(cfg, model_cfg, dev, materialize=not resuming,
                       mesh=mesh)
    scan = model_cfg.scan_layers
    if resuming:
        t0 = time.monotonic()
        tmpl = checkpoint_tree(state, scan_layers=scan, abstract=True)
        if resume_step is not None and multi and not cfg.ckpt_dtype:
            # Buffers for this process's regions, sized by the template.
            mgr.prewarm_restore(resume_step, pinned=dev.type == "cuda",
                                template=tmpl)
        prewarm_restore_wait()  # a restore takes only the landed buffers
        if resume_checkpoint is not None:
            restored = restore_from_handle(resume_checkpoint,
                                           abstract_state=tmpl)
        else:
            # crc-verified; a corrupt newest step falls back to the one
            # before it, and the cursor below is read from the step that
            # was restored.
            restored = mgr.restore(resume_step, abstract_state=tmpl)
            resume_step = mgr.restores[-1]["step"]
        load_checkpoint_tree(state, restored)
        del restored
        release_pinned()
        log(f"[gpt] {'sharded ' if multi else ''}full state restored"
            f"{' (in-run resume)' if resume_step is not None else ''}: "
            f"{time.monotonic() - t0:.1f}s")
    if mgr is not None:
        # Pool files for the saves, written while the first epoch trains.
        mgr.prewarm(checkpoint_tree(state, scan_layers=scan, abstract=True))
    train_step = make_train_step(
        accum_steps=cfg.accum_steps, ema_decay=cfg.ema_decay or None,
        mesh=mesh, comm_overlap=comm_overlap,
    )
    eval_step = make_eval_step()
    rng = 1
    history, epoch_records = [], []
    start_epoch = skip = 0
    if resume_step is not None:
        # Continuous histories across the resume, as the restored step
        # recorded them (drain-only saves carry no metrics and are
        # skipped).
        meta = mgr.restore_metadata(resume_step)
        for m in meta.get("metrics_history", []):
            if "train_loss" in m:
                history.append(m["train_loss"])
                epoch_records.append({
                    "epoch": len(epoch_records),
                    "train_loss": m.get("train_loss"),
                    "val_loss": m.get("val_loss"), "ppl": m.get("ppl"),
                    "tokens_per_s": None,
                })
        start_epoch, skip = _resume_cursor(
            meta.get("data_state"),
            state.step, cfg.steps_per_epoch, cfg.epochs, loader.seed,
        )
        log(f"[gpt] in-run resume from step {state.step} → epoch "
            f"{start_epoch}"
            + (f" (replaying from batch {skip})" if skip else ""))
    # An earlier generation's steps past the resumed one are replayed.
    hl.cut(state.step)
    per_step_tokens = cfg.batch_size * cfg.seq_len
    hl.begin(state, dev, "train.step", per_step_tokens, preset=cfg.preset)
    overlap = comm_overlap and cfg.accum_steps > 1
    obs.gauge("train.dispatch_depth", 1.0)
    obs.event("train.remat_policy", policy=active_remat_policy(model_cfg),
              comm_overlap=bool(overlap), accum_steps=cfg.accum_steps)
    while True:
        try:
            for epoch in range(start_epoch, cfg.epochs):
                loader.set_epoch(epoch)
                cursor = skip  # the epoch's batches consumed
                if skip:
                    loader.skip_batches(skip)
                    skip = 0
                t_epoch = time.monotonic()
                ts_epoch = time.time()
                losses, n_tokens = [], 0
                hl.clock.reset()
                for batch in loader:
                    hl.before(state)
                    cold = hl.cold
                    t0 = time.monotonic()
                    state, metrics = train_step(state, batch, rng)
                    # The global batch's tokens (every process loads it).
                    tokens = int(batch["y"].size)
                    losses.append(hl.fence(state.step, metrics, mgr, t0,
                                           tokens))
                    if cold:
                        # The first step pays the kernel builds and
                        # allocator warm-up: its tokens stay out of the
                        # rate.
                        t_epoch = time.monotonic()
                        ts_epoch = time.time()
                    else:
                        n_tokens += tokens
                    cursor += 1
                    hl.after(state.step)
                    _step_boundary(
                        mgr, state.step,
                        lambda: checkpoint_tree(state, scan_layers=scan),
                        loader.state_dict(cursor), grace_s)
                    if elastic:
                        _reform_fence(
                            mgr, state.step,
                            lambda: checkpoint_tree(state, scan_layers=scan),
                            loader.state_dict(cursor))
                epoch_s = time.monotonic() - t_epoch
                tok_s = n_tokens / max(epoch_s, 1e-9) if n_tokens else None
                epoch_loss = sum(losses) / len(losses)
                history.append(epoch_loss)
                rec = obs.recorder()
                if rec is not None:
                    rec.record("span", "train.epoch", ts=ts_epoch,
                               dur_s=epoch_s, epoch=epoch, loss=epoch_loss,
                               tokens_per_s=round(tok_s, 1) if tok_s else None)
                hl.clock.goodput_mark()
                if n_tokens and hl.n_params:
                    # The epoch's mean step against the compute and comm
                    # rooflines (gauges only on a card of the tables).
                    emit_comm_gauges(comm_attribution(
                        epoch_s / max(n_tokens // per_step_tokens, 1),
                        tokens=per_step_tokens, n_params=hl.n_params,
                        accum_steps=cfg.accum_steps,
                        fsdp_world=_fsdp_world(mesh), overlapped=overlap))
                with obs.span("train.validation", epoch=epoch):
                    val_loss = run_validation(state, val_loader, eval_step)
                ppl = math.exp(min(val_loss, 30.0))
                epoch_records.append({
                    "epoch": epoch,
                    "train_loss": epoch_loss,
                    "val_loss": val_loss,
                    "ppl": ppl,
                    "tokens_per_s": round(tok_s, 1) if tok_s else None,
                })
                rate = f" ({tok_s:.0f} tok/s)" if tok_s else ""
                log(f"[gpt] epoch {epoch}: loss={epoch_loss:.4f} "
                    f"val_loss={val_loss:.4f} ppl={ppl:.2f}{rate}")
                if mgr is not None:
                    mgr.save(
                        state.step, checkpoint_tree(state, scan_layers=scan),
                        metrics={"val_loss": val_loss,
                                 "train_loss": epoch_loss, "ppl": ppl},
                        # Epoch boundary: a resume starts at the next
                        # epoch's head.
                        data_state={"epoch": epoch + 1, "batch_index": 0,
                                    "seed": loader.seed},
                    )
                    if elastic:
                        # A sharded save commits at the next drain, which
                        # comes only with the next epoch's save: a loss
                        # before it would strand this one and replay the
                        # epoch (the JAX leg commits eagerly from
                        # generation 1 on, for the same reason).
                        mgr.wait_until_finished()
            break
        except (TrainingDiverged, _RollbackSignal) as exc:
            start_epoch, skip = hl.recover(exc, cfg, state, mgr, scan,
                                           loader.seed, log)
            history = history[:start_epoch]
            epoch_records = epoch_records[:start_epoch]
        except (membership.MeshReform, Preempted):
            raise
        except Exception as exc:
            # A collective died mid-epoch: in an elastic gang a dead
            # peer's sockets close at once, and this is where a survivor
            # first learns of it.
            if not elastic:
                raise
            _member_lost(exc, mgr)
    checkpoint = None
    if mgr is not None:
        mgr.wait_until_finished()
        checkpoint = mgr.checkpoint()
        mgr.close()
    result = GptTrainResult(
        checkpoint=checkpoint, loss_history=history,
        metrics_history=epoch_records, step_losses=hl.step_losses,
        step_s=hl.step_s,
        checkpoint_io=({"saves": mgr.saves, "restores": mgr.restores}
                       if mgr is not None else None),
    )
    if cfg.sample_tokens > 0:
        model = full_model(state)
        if model is not None:
            result.sample = _sample_greedy(cfg, model, log)
    return result


def _train_pipeline(cfg: GptTrainConfig, model_cfg: GPT2Config, dev,
                    ckpt_dir, resume_checkpoint, log, ckpt_format: str,
                    grace_s: float | None, local_dir: str | None,
                    hl: _Health) -> GptTrainResult:
    """The JAX pipeline leg (``tpuflow/train/gpt.py::_train_pipeline``):
    GPipe over a ``data`` x ``stage`` mesh of processes, the scan-stacked
    blocks sharded by layer slice, per-epoch saves of the pipeline-sharded
    state whose metric is the epoch's train loss (``val_loss``), the
    in-run resume from the newest committed step, the health monitor's
    rollback, the preemption drain and (in an elastic gang) the re-form
    fence's requeue at every step boundary, no validation, no EMA, no
    sample."""
    mesh = dist.make_mesh(dev, mesh_axes(cfg))
    dev = mesh.device
    if dist.process_index() != 0:
        log = _quiet
    log(f"[gpt] pipeline mesh {dict(mesh.shape)}, "
        f"microbatches={cfg.microbatches}")
    if cfg.sample_tokens > 0:
        log("[gpt] note: sample_tokens does not apply in pipeline mode "
            "(the JAX leg samples nothing)")
    loader, _ = make_lm_loaders(
        cfg.batch_size, cfg.steps_per_epoch, cfg.seq_len,
        model_cfg.vocab_size, dataset=cfg.dataset, text_path=cfg.text_path,
    )
    mgr = resume_step = None
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, max_to_keep=2,
                                save_dtype=cfg.ckpt_dtype or None,
                                multi_process=True, format=ckpt_format,
                                local_dir=local_dir)
        if resume_checkpoint is None:
            resume_step = mgr.latest_step()
    resuming = resume_checkpoint is not None or resume_step is not None
    state = init_state(cfg, model_cfg, dev, materialize=not resuming,
                       mesh=mesh)
    if resuming:
        tmpl = checkpoint_tree(state, scan_layers=True, abstract=True)
        if resume_checkpoint is not None:
            restored = restore_from_handle(resume_checkpoint,
                                           abstract_state=tmpl)
        else:
            restored = mgr.restore(resume_step, abstract_state=tmpl)
            resume_step = mgr.restores[-1]["step"]
        load_checkpoint_tree(state, restored)
        del restored
        log("[gpt] pipeline-sharded state restored"
            + (" (in-run resume)" if resume_step is not None else ""))
    train_step = make_pipeline_step(cfg.microbatches)
    elastic = membership.enabled()
    history = []
    start_epoch = skip = 0
    if resume_step is not None:
        # Each committed epoch's train loss was its save metric.
        meta = mgr.restore_metadata(resume_step)
        history += [m["val_loss"] for m in meta.get("metrics_history", [])
                    if "val_loss" in m]
        start_epoch, skip = _resume_cursor(
            meta.get("data_state"), state.step, cfg.steps_per_epoch,
            cfg.epochs, loader.seed)
        log(f"[gpt] pipeline in-run resume from step {state.step} → epoch "
            f"{start_epoch}"
            + (f" (replaying from batch {skip})" if skip else ""))
    hl.begin(state, dev, "train.pp_step", cfg.batch_size * cfg.seq_len,
             stages=cfg.stage_axis, mode="pipeline")
    obs.gauge("train.dispatch_depth", 1.0)
    # The pipeline schedule microbatches itself.
    obs.event("train.remat_policy", policy=active_remat_policy(model_cfg),
              comm_overlap=False, accum_steps=1)
    while True:
        try:
            for epoch in range(start_epoch, cfg.epochs):
                loader.set_epoch(epoch)
                cursor = skip
                if skip:
                    loader.skip_batches(skip)
                    skip = 0
                losses = []
                hl.clock.reset()
                for batch in loader:
                    hl.before(state)
                    t0 = time.monotonic()
                    state, metrics = train_step(state, batch)
                    losses.append(hl.fence(state.step, metrics, mgr, t0,
                                           int(batch["y"].size)))
                    cursor += 1
                    hl.after(state.step)
                    _step_boundary(
                        mgr, state.step,
                        lambda: checkpoint_tree(state, scan_layers=True),
                        loader.state_dict(cursor), grace_s)
                    if elastic:
                        _reform_fence(
                            mgr, state.step,
                            lambda: checkpoint_tree(state, scan_layers=True),
                            loader.state_dict(cursor), pipeline=True)
                epoch_loss = sum(losses) / len(losses)
                history.append(epoch_loss)
                hl.clock.goodput_mark()
                log(f"[gpt] pipeline epoch {epoch}: loss={epoch_loss:.4f}")
                if mgr is not None:
                    mgr.save(state.step,
                             checkpoint_tree(state, scan_layers=True),
                             metrics={"val_loss": epoch_loss},
                             data_state={"epoch": epoch + 1,
                                         "batch_index": 0,
                                         "seed": loader.seed})
                    if elastic:
                        # A re-form may strand a deferred commit.
                        mgr.wait_until_finished()
            break
        except (TrainingDiverged, _RollbackSignal) as exc:
            start_epoch, skip = hl.recover(exc, cfg, state, mgr, True,
                                           loader.seed, log)
            history = history[:start_epoch]
        except Preempted:
            raise
        except Exception as exc:
            if not elastic:
                raise
            _member_lost(exc, mgr, pipeline=True)
    checkpoint = None
    if mgr is not None:
        mgr.wait_until_finished()
        checkpoint = mgr.checkpoint()
        mgr.close()
    return GptTrainResult(
        checkpoint=checkpoint, loss_history=history,
        metrics_history=[{"epoch": i, "train_loss": v}
                         for i, v in enumerate(history)],
        step_losses=hl.step_losses, step_s=hl.step_s,
        checkpoint_io=({"saves": mgr.saves, "restores": mgr.restores}
                       if mgr is not None else None),
    )


def _quiet(*args, **kwargs) -> None:
    """The log of every process but 0."""


def _sample_greedy(cfg: GptTrainConfig, model, log) -> list[int]:
    """Greedy KV-cache decode of ``sample_tokens`` tokens, as the JAX leg
    samples: from the prompt "The " rendered as text on the byte-level
    ``lm_text``, from a 4-token zero prompt as ids on ``lm_synth``."""
    from tpuflow_torch.infer.generate import generate, render_tokens

    byte_level = cfg.dataset == "lm_text"
    prompt = (torch.tensor([list(b"The ")]) if byte_level
              else torch.zeros((1, 4), dtype=torch.long))
    toks = generate(model, prompt, max_new_tokens=cfg.sample_tokens,
                    temperature=0.0)
    sample = [int(t) for t in toks[0]]
    log(f"[gpt] greedy sample: "
        f"{render_tokens(sample, byte_level=byte_level)!r}")
    return sample
