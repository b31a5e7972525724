"""Train and eval steps (counterpart of ``tpuflow/train/step.py``).

PyTorch runs eagerly, so the JAX package's jitted ``train_step(state,
batch, rng)`` becomes a plain function with the same contract: dropout
seeded from ``fold_in(rng, state.step)`` (per microbatch ``fold_in(base,
i)``), gradients of equal microbatches summed then divided by
``accum_steps`` (so the step equals the full-batch step for mean losses),
one optimizer update, optional EMA of the weights, and the same metrics
(loss, accuracy and the health statistics). The state is updated in place
(the counterpart of the JAX step's donated state) and returned. The steps
take GPT token batches (``x``, ``y``: (B, T)) and image batches (``x``
(B, H, W[, C]) f32, ``y`` (B,)) alike; with a ``mesh`` of several
processes the gradients are averaged over its ``data`` axis before the
update (one flat all-reduce).

A sharded state (``state.plan``, ``parallel/sharding.py``: FSDP2 over the
``data`` x ``fsdp`` processes) takes the JAX package's FSDP step
(``make_train_step(grad_shardings=, comm_overlap=)``,
``tpuflow/train/step.py:358-420``): each process runs its rows of the
global batch (``dist.shard_batch``), its loss the mean over them. FSDP2
reduce-scatters the gradients, averaged over the world, so each shard is
the gradient of the global mean; with ``accum_steps > 1`` and
``comm_overlap`` (the default) right after each microbatch's backward,
the JAX overlap program, else once after the last (the sequential one:
``set_requires_gradient_sync`` off for the others). The parameters held
whole average their gradients with one all-reduce over the same group.

On a ``seq`` axis each process of a seq group holds its block of the
columns of the same rows (``dist.shard_batch``) and every parameter
whole over the group (the JAX rule never names ``seq``): its loss is the
mean over its T / s tokens, so the gradients, after the FSDP
reductions, are averaged over the seq group (one all-reduce of one flat
bucket) to the gradient of the global mean; the metrics and the
validation sums add over the ``data`` x ``fsdp`` x ``seq`` processes.

On a mesh with ``tensor`` or ``expert`` axes (``parallel/tensor.py``)
the processes of a tensor or expert group take the same rows and compute
their blocks of each layer; a parameter held whole but used in part by
each (the ``c_attn`` and ``mlp_fc`` biases) sums its gradient over the
group, and one used whole (the LayerNorms, the row-parallel biases)
already has the same gradient on every peer and is left as it is. The
optimizer updates the local parts; its global-norm clip and the metrics
count each element once over the world (the parts whose process sits at
coordinate 0 of the axes they are replicated over), and the loss and
accuracy sum over the ``data`` x ``fsdp`` (x ``seq``) processes only
(``_global_metrics``), so ``loss``, ``accuracy``, ``grad_norm``,
``update_norm``, ``param_norm`` and ``nonfinite`` are the global values,
bit-equal on every process.

A model that returns auxiliary losses (GPT-2 with MoE blocks:
``sows_losses``) has their sum added to the task loss of each
(micro)batch, as the JAX step adds the sown ``losses`` collection; the
reported loss holds it too.

BatchNorm models (``models/resnet.py``) keep their running statistics as
module buffers: every ``train=True`` forward moves them, so with
``accum_steps > 1`` they move once per microbatch, as the JAX step's scan
carries them (``tpuflow/train/step.py:431-530``); the eval step's
``train=False`` forward normalises by them. They are not parameters, so
the gradient bucket leaves them out; across processes they stay equal
because the statistics are global (the forward all-reduces them).

A pipeline state (``train.gpt`` on a ``data`` x ``stage`` mesh) takes
``make_pipeline_step``: the GPipe loss of ``parallel/pipeline.py``, its
gradients summed over the processes that hold each parameter
(``pipeline_gradients``).

Also here: ``create_train_state`` (an ``nn.Module`` with SGD at momentum
0.9, the MLP recipe), ``DispatchWindow`` (the host-side bookkeeping of
steps in flight), ``StepClock`` (the loops' per-step telemetry: the
``train.compile`` span of the cold first step, a ``train.step_s``
observation and ``train.tokens`` a steady step, the ``health.*`` gauges,
the live goodput ledger, the memory gauges and the anomaly capturer's
observations) and ``comm_attribution`` / ``emit_comm_gauges`` (a step's
wall split into compute at the card's peak and exposed communication).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as tdist

from tpuflow_torch import obs
from tpuflow_torch.dist.mesh import (
    average_gradients,
    data_axis_size,
    group_sum,
    shard_batch,
    world_sum,
)
from tpuflow_torch.models.gpt2 import fold_in
from tpuflow_torch.obs import device as _device
from tpuflow_torch.obs import goodput as _goodput
from tpuflow_torch.models.losses import (
    accuracy,
    cross_entropy_loss,
    sum_sown_losses,
)
from tpuflow_torch.train.optim import (
    Optimizer,
    health_stats,
    make_optimizer,
    square_sums,
)

# The train layer's preemption surface: gang_exec installs the SIGTERM
# handler; the loops check ``preemption_requested()`` at step boundaries,
# drain and commit a final checkpoint, and raise ``Preempted``, which
# gang_exec turns into REQUEUE_EXIT_CODE.
from tpuflow_torch.utils.preempt import (  # noqa: F401  (re-exported API)
    REQUEUE_EXIT_CODE,
    Preempted,
    clear_preemption,
    emergency_save_advised,
    grace_remaining_s,
    install_sigterm_handler,
    preemption_requested,
    request_preemption,
)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer (which holds the parameter list, the
    moments and the LR schedule), the count of steps taken, and the EMA of
    the parameters (None = EMA off). A sharded state also carries its
    ``plan`` (``parallel.ShardPlan``) and ``mesh`` (``dist.Mesh``); its
    optimizer then holds the local shards (``plan.local``)."""

    model: torch.nn.Module
    tx: Optimizer
    step: int = 0
    ema_params: list[torch.Tensor] | None = None
    plan: object | None = None
    mesh: object | None = None

    @property
    def params(self) -> list[torch.Tensor]:
        return self.tx.params


def create_train_state(model: torch.nn.Module, learning_rate: float, *,
                       momentum: float = 0.9) -> TrainState:
    """A fresh state for ``model`` (already on its device) with SGD at
    ``momentum`` and a constant learning rate: the MLP recipe's
    ``optax.sgd(lr, momentum=0.9)`` (``tpuflow/train/step.py:303``)."""
    return TrainState(model=model, tx=make_optimizer(
        model.parameters(), learning_rate, optimizer="sgd",
        momentum=momentum))


class DispatchWindow:
    """Bounded dispatch-ahead bookkeeping for a step loop (a copy of the
    JAX package's, pure host code): the loop ``push``es one entry per
    dispatched step; once ``depth`` entries are pending, ``push`` returns
    the oldest ones for the caller to settle (``float()`` of a loss on the
    card waits for that step). ``drain()`` matures every pending entry;
    ``clear()`` drops them unsettled."""

    def __init__(self, depth: int = 1):
        self.depth = max(1, int(depth))
        self._pending: collections.deque = collections.deque()

    def push(self, entry) -> list:
        """Queue one step's entry; return the entries due for settling,
        oldest first (depth 1: every entry at once)."""
        self._pending.append(entry)
        out = []
        while len(self._pending) >= self.depth:
            out.append(self._pending.popleft())
        return out

    def drain(self) -> list:
        out = list(self._pending)
        self._pending.clear()
        return out

    def clear(self) -> None:
        self._pending.clear()

    def __len__(self) -> int:
        return len(self._pending)


def with_ema(state: TrainState) -> TrainState:
    """Seed EMA tracking with a copy of the current parameters; pair with
    ``make_train_step(ema_decay=...)``."""
    state.ema_params = [p.detach().clone() for p in state.params]
    return state


def per_worker_batch_size(global_batch_size: int, num_workers: int) -> int:
    """Per-shard batch = global // num_workers (floor division)."""
    per = global_batch_size // num_workers
    if per < 1:
        raise ValueError(
            f"global batch {global_batch_size} too small for {num_workers} workers"
        )
    return per


def _place(batch: dict, device) -> dict:
    """Host arrays (or tensors) of a batch onto ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _rows(state: TrainState, batch: dict) -> dict:
    """This process's rows of the batch on its device: of the global batch
    for a sharded state, all of it otherwise."""
    if state.plan is not None:
        return shard_batch(batch, state.mesh)
    return _place(batch, state.params[0].device)


def sharded_gradients(state: TrainState) -> list[torch.Tensor]:
    """A sharded state's gradients after its backward, each as
    ``ShardPlan.local`` lays its parameter out: FSDP2's reduce-scatter
    already averaged the sharded ones; those held whole are averaged over
    the FSDP group, and those a tensor or expert group uses in parts are
    summed over it (``TensorParallel.sum_gradients``); on a ``seq`` axis
    all are then averaged over the seq group (``_seq_average``)."""
    plan, model = state.plan, state.model
    grads = plan.local_grads(model)
    whole = [i for i, sh in enumerate(plan.sharded) if not sh]
    for i, g in zip(whole, average_gradients([grads[i] for i in whole],
                                             state.mesh)):
        grads[i] = g
    tp = getattr(model, "tp", None)
    if tp is not None:
        tp.sum_gradients(plan.names, grads)
    _seq_average(grads, state.mesh)
    return grads


@torch.no_grad()
def _seq_average(grads: list[torch.Tensor], mesh) -> None:
    """Average, in place, the gradients over the mesh's ``seq`` group (one
    all-reduce of one flat bucket): each seq peer's loss is the mean over
    its block of the tokens. A no-op without a seq axis."""
    s = mesh.shape.get("seq", 1)
    if s == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    tdist.all_reduce(flat, group=mesh.seq_group)
    flat /= s
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def batch_sum(values: torch.Tensor, mesh) -> torch.Tensor:
    """``values`` summed over the processes that split the batch, the
    ``data`` x ``fsdp`` group and then the ``seq`` group (the same bits
    on each, ``group_sum``)."""
    if data_axis_size(mesh) > 1:
        values = group_sum(values, mesh.fsdp_group)
    if mesh.shape.get("seq", 1) > 1:
        values = group_sum(values, mesh.seq_group)
    return values


def _global_metrics(state: TrainState, loss, acc, grads, updates,
                    grad_norm=None) -> dict:
    """The sharded step's metrics over the world with one collective: the
    local loss and accuracy (means over this process's rows, counted by
    the process at tensor and expert coordinate 0 of each group of
    peers; a mean over the data x fsdp x seq processes' shares) and the
    square sums of the gradients', updates' and parameters' owned parts
    (``ShardPlan.owned``) are summed over the processes. ``grad_norm``:
    the clip's, already global."""
    plan, params, mesh = state.plan, state.params, state.mesh
    mask = plan.owned
    rows = plan.world * mesh.shape.get("seq", 1)

    def owned(tensors):
        sq = square_sums(tensors)
        return sq[torch.tensor(mask, device=sq.device)].sum()

    counts = float(mesh.coord("tensor") == 0 and mesh.coord("expert") == 0)
    local = torch.stack([loss.float() * counts, acc.float() * counts,
                         *(owned(t) for t in (grads, updates, params))])
    total = world_sum(local)
    g, u, p = (torch.sqrt(total[2 + i]) for i in range(3))
    if grad_norm is not None:
        g = grad_norm
    loss, acc = total[0] / rows, total[1] / rows
    finite = torch.isfinite(loss) & torch.isfinite(g) & torch.isfinite(u)
    return {"loss": loss, "accuracy": acc, "grad_norm": g,
            "update_norm": u, "param_norm": p,
            "nonfinite": (~finite).float()}


def make_train_step(
    loss_fn: Callable = cross_entropy_loss,
    *,
    accum_steps: int = 1,
    ema_decay: float | None = None,
    mesh=None,
    comm_overlap: bool = True,
) -> Callable:
    """Build ``train_step(state, batch, rng) -> (state, metrics)``.

    ``batch`` holds ``x`` (B, T) token ids and ``y`` (B, T) targets, or
    ``x`` (B, H, W[, C]) images and ``y`` (B,) labels (host arrays or
    tensors); ``rng`` is an int seed. ``mesh`` (``dist.make_mesh``): the
    gradients are averaged over its ``data`` axis before the update (one
    process: untouched); a sharded state (``state.plan``) takes the FSDP
    step below instead. ``accum_steps > 1`` splits
    the batch's rows into that many equal microbatches, runs forward and
    backward on each in turn (activation memory drops by that factor) and
    feeds the averaged gradients to one update (``comm_overlap``: see the
    module docstring; it changes nothing without a sharded state).
    ``metrics`` holds 0-dim tensors (``loss``, ``accuracy``, ``grad_norm``, ``update_norm``,
    ``param_norm``, ``nonfinite``); reading one synchronizes.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if ema_decay is not None and not 0.0 < ema_decay < 1.0:
        raise ValueError(
            f"ema_decay must be in (0, 1), got {ema_decay} (>= 1 freezes or "
            "diverges the average)"
        )

    def loss_of(model, x, y, rng):
        """The (micro)batch's loss, with the model's auxiliary losses, and
        its logits."""
        if getattr(model, "sows_losses", False):
            logits, aux = model(x, train=True, rng=rng, losses=True)
            return loss_fn(logits, y) + sum_sown_losses(aux), logits
        logits = model(x, train=True, rng=rng)
        return loss_fn(logits, y), logits

    def train_step(state: TrainState, batch, rng: int):
        model, params, plan = state.model, state.params, state.plan
        batch = _rows(state, batch)
        x, y = batch["x"], batch["y"]
        base = fold_in(rng, state.step)
        if plan is not None:
            model.zero_grad(set_to_none=True)
        for p in params:
            p.grad = None
        if accum_steps == 1:
            loss, logits = loss_of(model, x, y, base)
            loss.backward()
            loss = loss.detach()
            acc = accuracy(logits.detach(), y)
        else:
            n = x.shape[0]
            if n % accum_steps:
                raise ValueError(
                    f"batch of {n} rows does not split into "
                    f"accum_steps={accum_steps} equal microbatches"
                )
            mb = n // accum_steps
            lsum = asum = 0.0
            for i in range(accum_steps):
                if (plan is not None and plan.world > 1
                        and not comm_overlap):
                    # The sequential program: one reduce-scatter, after
                    # the last microbatch.
                    model.set_requires_gradient_sync(i == accum_steps - 1)
                rows = slice(i * mb, (i + 1) * mb)
                l, logits = loss_of(model, x[rows], y[rows],
                                    fold_in(base, i))
                l.backward()
                lsum = lsum + l.detach()
                asum = asum + accuracy(logits.detach(), y[rows])
            loss, acc = lsum / accum_steps, asum / accum_steps
        if plan is None:
            grads = average_gradients([p.grad for p in params], mesh)
        else:
            grads = sharded_gradients(state)
        if accum_steps > 1:
            # Equal microbatches: the mean of microbatch means IS the
            # full-batch mean, for the loss and its gradient alike.
            grads = [g / accum_steps for g in grads]
        updates = state.tx.update(grads)
        state.step += 1
        if ema_decay is not None:
            if state.ema_params is None:
                raise ValueError(
                    "ema_decay is set but the state carries no ema_params; "
                    "seed them with with_ema(state)"
                )
            with torch.no_grad():
                for e, p in zip(state.ema_params, params):
                    e.copy_(e * ema_decay + (1.0 - ema_decay) * p)
        if plan is None:
            metrics = {
                "loss": loss,
                "accuracy": acc,
                **health_stats(loss, grads, updates, params),
            }
        else:
            metrics = _global_metrics(state, loss, acc, grads, updates,
                                      state.tx.last_grad_norm)
            model.zero_grad(set_to_none=True)
        for p in params:
            p.grad = None
        return state, metrics

    return train_step


@torch.no_grad()
def pipeline_gradients(state: TrainState) -> list[torch.Tensor]:
    """A pipeline state's gradients after every process's ``cell``
    backward (``parallel/pipeline.py``): each process's gradients are of
    its own contribution, so they are summed. A stage's blocks over the
    ``data`` group (their holders), ``wte``, ``wpe`` and ``ln_f`` over
    the whole world: ``wte`` takes stage 0's embedding gradient and the
    last stage's head gradient. A parameter this process did not use
    (``wpe`` off stage 0) contributes zeros. One all-reduce of one flat
    bucket a group."""
    plan, mesh = state.plan, state.mesh
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in state.params]
    staged = [n in plan.staged for n in plan.names]
    for keep, group in ((True, mesh.group("data")), (False, None)):
        idx = [i for i, st in enumerate(staged) if st == keep]
        if not idx or (keep and group is None):
            continue
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        tdist.all_reduce(flat, group=group)
        offset = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[offset:offset + n].view_as(grads[i])
            offset += n
    return grads


def make_pipeline_step(n_microbatches: int) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)`` for a
    pipeline state (``train.gpt`` on a ``data`` x ``stage`` mesh): the
    GPipe loss of ``parallel/pipeline.py`` over this process's rows of
    the global batch (``dist.shard_batch``: its data shard's, the same on
    every stage), its backward, the gradients summed
    (``pipeline_gradients``), one optimizer update. ``metrics``: the loss
    (the world's, bit-equal on every process) and the norms of the owned
    parts of the gradients, updates and parameters summed over the world
    (``grad_norm``, ``update_norm``, ``param_norm``, ``nonfinite``), the
    JAX pipeline step's health statistics."""
    from tpuflow_torch.parallel.pipeline import gpt2_pipeline_loss

    def train_step(state: TrainState, batch, rng: int | None = None):
        loss_fn = gpt2_pipeline_loss(state.model, mesh=state.mesh,
                                     n_microbatches=n_microbatches)
        batch = shard_batch(batch, state.mesh)
        for p in state.params:
            p.grad = None
        cell, loss = loss_fn(batch["x"], batch["y"])
        cell.backward()
        grads = pipeline_gradients(state)
        updates = state.tx.update(grads)
        state.step += 1
        mask = torch.tensor(state.plan.owned, device=loss.device)
        norms = torch.sqrt(world_sum(torch.stack([
            square_sums(t)[mask].sum()
            for t in (grads, updates, state.params)])))
        g, u, p = norms
        if state.tx.last_grad_norm is not None:
            g = state.tx.last_grad_norm
        finite = torch.isfinite(loss) & torch.isfinite(g) & torch.isfinite(u)
        for q in state.params:
            q.grad = None
        return state, {"loss": loss, "grad_norm": g, "update_norm": u,
                       "param_norm": p, "nonfinite": (~finite).float()}

    return train_step


def make_eval_step() -> Callable:
    """Build ``eval_step(state, batch) -> {loss_sum, num_correct, count}``
    (0-dim tensors): token-level cross-entropy sums honouring a ``mask``
    entry (1 for real positions, 0 for tail padding), so the caller can
    accumulate across fixed-shape batches."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        batch = _rows(state, batch)
        labels = batch["y"].long()
        logits = state.model(batch["x"], train=False).float()
        per_row = -torch.log_softmax(logits, dim=-1).gather(
            -1, labels[..., None]
        )[..., 0]
        correct = (logits.argmax(dim=-1) == labels).float()
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, device=labels.device)
        return {
            "loss_sum": (per_row * mask).sum(),
            "num_correct": (correct * mask).sum(),
            "count": mask.sum(),
        }

    return eval_step


def run_validation(state, loader, eval_step) -> float:
    """Mean per-token loss over a (possibly pad_tail) eval loader: each
    batch's per-row mask is broadcast to the label shape (padded rows of
    an LM batch drop out whole) and the masked sums accumulate; a sharded
    state's processes each sum their rows and the sums add over the
    ``data`` x ``fsdp`` (x ``seq``) processes."""
    tot = cnt = 0.0
    for b in loader:
        batch = {"x": b["x"], "y": b["y"]}
        mask = b.get("mask")
        if mask is not None:
            if mask.shape != b["y"].shape:
                mask = np.broadcast_to(mask[:, None], b["y"].shape)
            batch["mask"] = np.ascontiguousarray(mask, np.float32)
        m = eval_step(state, batch)
        tot += float(m["loss_sum"])
        cnt += float(m["count"])
    plan = getattr(state, "plan", None)
    if plan is not None:
        if plan.world > 1:
            # A forward without a backward leaves the root's parameters
            # gathered; the next training forward must gather them anew.
            state.model.reshard()
        # Tensor and expert peers hold the same rows: the sums add over
        # the data x fsdp x seq processes alone.
        tot, cnt = batch_sum(
            torch.tensor([tot, cnt], dtype=torch.float64,
                         device=state.params[0].device),
            state.mesh).tolist()
    return tot / max(cnt, 1.0)


class StepClock:
    """Per-step wall-time telemetry for a fenced step loop (the JAX
    ``StepClock``, ``tpuflow/train/step.py:137-278``).

    The port's loops fence every step (the one host copy of its scalars),
    so monotonic deltas between fences are per-step wall times: the cold
    first step (kernel builds, cuBLAS and allocator warm-up) becomes one
    ``train.compile`` span, each steady step a ``train.step_s``
    observation and a ``train.tokens`` count. The clock also feeds the
    live goodput ledger (``obs.goodput_live()``: rolling step and token
    rates, MFU) when the recorder is on or a live export is serving, polls
    the card's memory gauges (``obs/device.py``) every ``hbm_poll_s``
    seconds on the 32-step cadence, and hands each step's wall and the
    nonfinite flag to ``capture`` (an ``obs/profcap.py::AnomalyCapturer``,
    or None). Disabled (no recorder, no export, no capturer) each method
    is one attribute check."""

    def __init__(self, *, capture=None,
                 hbm_poll_s: float = _device.DEFAULT_POLL_S):
        self._on = obs.enabled()
        from tpuflow_torch.obs import export as _export

        self._feed = self._on or _export.server() is not None
        self._cap = capture
        self.hbm_poll_s = hbm_poll_s
        track = self._feed or capture is not None
        self._last = time.monotonic() if track else 0.0
        self._t0 = self._last
        self._ts0 = time.time() if self._on else 0.0
        self._steps = 0
        if self._feed:
            # One clock a train leg: /metrics reflects this leg.
            _goodput.live().reset()

    @property
    def recording(self) -> bool:
        """Whether this leg records telemetry (the recorder is on)."""
        return self._on

    @property
    def feeding(self) -> bool:
        """Whether this leg feeds the live goodput ledger."""
        return self._feed

    def reset(self) -> None:
        """Restart the clock (an epoch's head)."""
        if self._feed or self._cap is not None:
            self._last = time.monotonic()

    def compile_done(self, **attrs) -> float | None:
        """The cold first step just fenced: record it as ``train.compile``.
        Returns its wall seconds when recording (the device ledger's entry
        for the step), else None."""
        if not (self._feed or self._cap is not None):
            return None
        now = time.monotonic()
        dur = now - self._t0
        self._last = now
        if self._feed:
            _goodput.live().note_compile(dur)
        if not self._on:
            return None
        rec = obs.recorder()
        if rec is not None:
            rec.record("span", "train.compile", ts=self._ts0, dur_s=dur,
                       **attrs)
        _goodput.emit_gauges()
        # The first reading after the step's buffers landed.
        _device.maybe_emit_hbm(force=True, poll_s=self.hbm_poll_s)
        return dur

    def step_done(self, tokens: int = 0, step: int | None = None) -> None:
        """A steady step just fenced: record its wall time."""
        cap = self._cap
        if not self._feed:
            if cap is not None:
                now = time.monotonic()
                cap.observe_step(now - self._last, step)
                self._last = now
            return
        now = time.monotonic()
        dur = now - self._last
        self._last = now
        if self._on:
            obs.histogram("train.step_s", dur)
            if tokens:
                obs.counter("train.tokens", tokens)
        _goodput.live().note_step(dur, tokens=tokens, step=step)
        if cap is not None:
            # The step-time spike detector; the same call advances a live
            # capture's bound.
            cap.observe_step(dur, step)
        self._steps += 1
        if self._on and self._steps % 32 == 0:
            # Goodput-so-far and memory gauges on a cadence, so a run that
            # dies mid-epoch still carries them.
            _goodput.emit_gauges()
            _device.maybe_emit_hbm(poll_s=self.hbm_poll_s)

    def goodput_mark(self) -> None:
        """Epoch fence: fresh goodput-so-far and memory gauges."""
        if self._on:
            _goodput.emit_gauges()
            _device.maybe_emit_hbm(poll_s=self.hbm_poll_s)

    def health_done(self, *, loss: float, grad_norm: float,
                    update_norm: float, param_norm: float,
                    nonfinite: bool) -> None:
        """Record the fenced step's numerics (four floats the fence has
        already copied to the host); a nonfinite step arms the capturer."""
        if nonfinite and self._cap is not None:
            self._cap.note_nonfinite()
        if self._on:
            obs.gauge("health.loss", loss)
            obs.gauge("health.grad_norm", grad_norm)
            obs.gauge("health.update_norm", update_norm)
            obs.gauge("health.param_norm", param_norm)
            if nonfinite:
                obs.counter("health.nonfinite")
        if self._feed:
            _goodput.live().note_health(loss, grad_norm, nonfinite)


# ---------------------------------------------- comm/compute attribution
# Per-card NVLink bandwidth (GB/s, both directions summed), matched in
# order against the lower-cased ``torch.cuda.get_device_name(0)``, from
# NVIDIA's datasheets: H100 SXM5 900 GB/s; H100 NVL and H100 PCIe with
# its NVLink bridge 600 GB/s; A100 SXM 600 GB/s. The denominator of an
# attribution model, not a measurement.
_LINK_GBPS = (
    ("h100 pcie", 600.0),
    ("h100 nvl", 600.0),
    ("h100", 900.0),
    ("a100", 600.0),
)


def _link_gbps() -> float | None:
    """The local card's NVLink GB/s from ``_LINK_GBPS``; None off the
    card or for a card off the table."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0).lower()
    except Exception:
        return None
    return next((v for k, v in _LINK_GBPS if k in name), None)


def _world() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def comm_attribution(step_s: float, *, tokens: int, n_params: int,
                     accum_steps: int = 1, fsdp_world: int = 1,
                     overlapped: bool = True,
                     peak_flops: float | None = None,
                     link_gbps: float | None = None,
                     devices: int | None = None) -> dict | None:
    """A roofline attribution of one step's wall into compute and exposed
    communication (the JAX function's model, stated as bounds, not a
    device measurement):

    - ``ideal_compute_s`` = 6 N FLOPs a token x tokens / (the card's bf16
      peak x ``devices``, default the world's process count);
    - ``exposed_comm_s`` = max(0, step_s - ideal_compute_s): an UPPER
      bound on exposed communication (memory stalls charge here too);
    - ``ideal_comm_s``: the FSDP step's collective volume over the
      interconnect: two parameter all-gathers a microbatch and a gradient
      reduce-scatter a microbatch when ``overlapped`` (once a step when
      not), each 4 bytes x N x (w - 1) / w a device;
    - ``comm_overlap_s`` = max(0, ideal_comm_s - exposed_comm_s): a LOWER
      bound on the communication hidden behind compute.

    ``peak_flops`` defaults to ``obs/goodput.py``'s table and
    ``link_gbps`` to ``_LINK_GBPS`` (both by the card's name). Returns
    None without a peak (on the CPU, or a card off the table): an
    invented attribution would be noise. At ``fsdp_world`` <= 1 or
    without a link figure the comm terms are 0."""
    if peak_flops is None:
        peak_flops = _goodput._peak_flops_per_device()
    if peak_flops is None or step_s <= 0.0 or n_params <= 0:
        return None
    ndev = max(int(devices if devices is not None else _world()), 1)
    ideal_compute_s = 6.0 * n_params * tokens / (peak_flops * ndev)
    exposed = max(0.0, step_s - ideal_compute_s)
    ideal_comm_s = 0.0
    link = link_gbps if link_gbps is not None else _link_gbps()
    if fsdp_world > 1 and link:
        bytes_per_pass = 4.0 * n_params * (fsdp_world - 1) / fsdp_world
        ag_passes = 2 * max(accum_steps, 1)
        rs_passes = max(accum_steps, 1) if overlapped else 1
        ideal_comm_s = (ag_passes + rs_passes) * bytes_per_pass / (
            link * 1e9)
    return {
        "ideal_compute_s": ideal_compute_s,
        "ideal_comm_s": ideal_comm_s,
        "exposed_comm_s": exposed,
        "comm_overlap_s": max(0.0, ideal_comm_s - exposed),
        "overlapped": bool(overlapped),
    }


def emit_comm_gauges(att: dict | None) -> None:
    """Publish a step's attribution as the ``train.exposed_comm_s`` and
    ``train.comm_overlap_s`` gauges (nothing without one or with the
    recorder off)."""
    if att is None or not obs.enabled():
        return
    obs.gauge("train.exposed_comm_s", round(att["exposed_comm_s"], 6))
    obs.gauge("train.comm_overlap_s", round(att["comm_overlap_s"], 6))
