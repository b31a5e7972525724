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

BatchNorm models (``models/resnet.py``) keep their running statistics as
module buffers: every ``train=True`` forward moves them, so with
``accum_steps > 1`` they move once per microbatch, as the JAX step's scan
carries them (``tpuflow/train/step.py:431-530``); the eval step's
``train=False`` forward normalises by them. They are not parameters, so
the gradient bucket leaves them out; across processes they stay equal
because the statistics are global (the forward all-reduces them).

Also here: ``create_train_state`` (an ``nn.Module`` with SGD at momentum
0.9, the MLP recipe) and ``DispatchWindow`` (the host-side bookkeeping of
steps in flight).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import numpy as np
import torch

from tpuflow_torch.dist.mesh import average_gradients
from tpuflow_torch.models.gpt2 import fold_in
from tpuflow_torch.models.losses import accuracy, cross_entropy_loss
from tpuflow_torch.train.optim import Optimizer, health_stats, make_optimizer


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer (which holds the parameter list, the
    moments and the LR schedule), the count of steps taken, and the EMA of
    the parameters (None = EMA off)."""

    model: torch.nn.Module
    tx: Optimizer
    step: int = 0
    ema_params: list[torch.Tensor] | None = None

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


def make_train_step(
    loss_fn: Callable = cross_entropy_loss,
    *,
    accum_steps: int = 1,
    ema_decay: float | None = None,
    mesh=None,
) -> Callable:
    """Build ``train_step(state, batch, rng) -> (state, metrics)``.

    ``batch`` holds ``x`` (B, T) token ids and ``y`` (B, T) targets, or
    ``x`` (B, H, W[, C]) images and ``y`` (B,) labels (host arrays or
    tensors); ``rng`` is an int seed. ``mesh`` (``dist.make_mesh``): the
    gradients are averaged over its ``data`` axis before the update (one
    process: untouched). ``accum_steps > 1`` splits
    the batch's rows into that many equal microbatches, runs forward and
    backward on each in turn (activation memory drops by that factor) and
    feeds the averaged gradients to one update. ``metrics`` holds 0-dim
    tensors (``loss``, ``accuracy``, ``grad_norm``, ``update_norm``,
    ``param_norm``, ``nonfinite``); reading one synchronizes.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if ema_decay is not None and not 0.0 < ema_decay < 1.0:
        raise ValueError(
            f"ema_decay must be in (0, 1), got {ema_decay} (>= 1 freezes or "
            "diverges the average)"
        )

    def train_step(state: TrainState, batch, rng: int):
        model, params = state.model, state.params
        batch = _place(batch, params[0].device)
        x, y = batch["x"], batch["y"]
        base = fold_in(rng, state.step)
        for p in params:
            p.grad = None
        if accum_steps == 1:
            logits = model(x, train=True, rng=base)
            loss = loss_fn(logits, y)
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
                rows = slice(i * mb, (i + 1) * mb)
                logits = model(x[rows], train=True, rng=fold_in(base, i))
                l = loss_fn(logits, y[rows])
                l.backward()
                lsum = lsum + l.detach()
                asum = asum + accuracy(logits.detach(), y[rows])
            loss, acc = lsum / accum_steps, asum / accum_steps
        grads = average_gradients([p.grad for p in params], mesh)
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
        metrics = {
            "loss": loss,
            "accuracy": acc,
            **health_stats(loss, grads, updates, params),
        }
        for p in params:
            p.grad = None
        return state, metrics

    return train_step


def make_eval_step() -> Callable:
    """Build ``eval_step(state, batch) -> {loss_sum, num_correct, count}``
    (0-dim tensors): token-level cross-entropy sums honouring a ``mask``
    entry (1 for real positions, 0 for tail padding), so the caller can
    accumulate across fixed-shape batches."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        batch = _place(batch, state.params[0].device)
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
    an LM batch drop out whole) and the masked sums accumulate."""
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
    return tot / max(cnt, 1.0)
