"""Optimizer factory: schedules, clipping and weight decay.

Counterpart of ``tpuflow/train/optim.py``. The JAX package chains optax
transformations; the port writes the same recipe out as one small class
with optax's semantics and op order:

1. global-norm clipping of the gradients (optional), before the update;
2. ``adamw`` (optax defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
   bias-corrected moments, decoupled weight decay on every parameter) or
   ``sgd`` (momentum trace g + momentum * trace, dampening 0);
3. the learning rate of the schedule at the count of updates made so far
   (the first update reads the schedule at 0).

``Optimizer.update`` applies the step in place and returns the update
tensors it added, which the train step's health statistics read, as the
JAX step reads ``tx.update``'s output.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

ROADMAP_TRAINING = "ROADMAP Queue 1 item 12 (GPT-2 training remainder)"
# optax.adamw's defaults.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def make_schedule(
    learning_rate: float,
    *,
    warmup_steps: int = 0,
    decay_steps: int = 0,
    schedule: str = "constant",
    final_scale: float = 0.1,
) -> Callable[[int], float]:
    """LR schedule: 'constant' | 'cosine' | 'linear', with optional linear
    warmup from 0. ``decay_steps`` counts AFTER warmup; ``final_scale`` is
    the floor as a fraction of the peak (cosine/linear end there, then
    hold). Returns ``count -> lr``."""
    n = max(decay_steps, 1)
    if schedule == "constant":
        def main(count):
            return learning_rate
    elif schedule == "cosine":
        def main(count):
            cos = 0.5 * (1 + math.cos(math.pi * min(count, n) / n))
            return learning_rate * ((1 - final_scale) * cos + final_scale)
    elif schedule == "linear":
        end = learning_rate * final_scale

        def main(count):
            frac = 1 - min(max(count, 0), n) / n
            return (learning_rate - end) * frac + end
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if warmup_steps <= 0:
        return main

    def warm(count):
        if count >= warmup_steps:
            return main(count - warmup_steps)
        frac = 1 - max(count, 0) / warmup_steps
        return -learning_rate * frac + learning_rate

    return warm


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """AdamW or SGD-with-momentum over a fixed list of parameters, with
    optional global-norm clipping and a schedule (see the module
    docstring). ``count`` is the number of updates made; ``scheduled`` is
    True when the learning rate depends on it (a schedule other than
    constant, or warmup), where optax keeps a second step count.

    Written out rather than built on ``torch.optim.AdamW``: that class
    computes the bias corrections in float64, optax in float32, and the
    params then drift apart by more than the 1e-6 that
    ``tests/test_torch_train_pieces.py::test_optimizer_matches_optax``
    allows. Each step is a fixed sequence of ``torch._foreach_*`` ops over
    all parameters (one multi-tensor launch per op on the card)."""

    def __init__(self, params, *, kind: str, schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, momentum: float = 0.9,
                 grad_clip_norm: float | None = None,
                 scheduled: bool = False):
        if kind not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.params = list(params)
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.grad_clip_norm = grad_clip_norm
        self.scheduled = scheduled
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        if kind == "adamw":
            self.mu, self.nu = zeros(), zeros()
        else:
            self.trace = zeros()

    def slots(self) -> dict[str, list[torch.Tensor]]:
        """The per-parameter state, named as optax names it: ``mu`` and
        ``nu`` (adamw) or ``trace`` (sgd), each in parameter order."""
        if self.kind == "adamw":
            return {"mu": self.mu, "nu": self.nu}
        return {"trace": self.trace}

    @torch.no_grad()
    def load_slots(self, count: int, slots: dict) -> None:
        """Set ``count`` and copy ``slots`` (as ``slots()`` returns them,
        tensors on any device) into the state in place."""
        mine = self.slots()
        if set(slots) != set(mine):
            raise ValueError(f"optimizer slots {sorted(slots)}, this "
                             f"{self.kind} optimizer has {sorted(mine)}")
        for name, dst in mine.items():
            if len(slots[name]) != len(dst):
                raise ValueError(f"{name}: {len(slots[name])} tensors for "
                                 f"{len(dst)} parameters")
            for d, s in zip(dst, slots[name]):
                d.copy_(s)
        self.count = int(count)

    @torch.no_grad()
    def update(self, grads) -> list[torch.Tensor]:
        """One step: clip, transform, scale by -lr, add to the params in
        place. Returns the update tensors."""
        grads = list(grads)
        if self.grad_clip_norm is not None:
            norm = global_norm(grads)
            keep = norm < self.grad_clip_norm
            grads = [torch.where(keep, g, g / norm * self.grad_clip_norm)
                     for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        if self.kind == "adamw":
            b1, b2 = _B1, _B2
            # Bias corrections in float32, as optax computes them (1 - b2^t
            # cancels: float64 would differ from it by ~1e-5 relative).
            t = np.float32(self.count)
            bc1 = float(np.float32(1) - np.power(np.float32(b1), t))
            bc2 = float(np.float32(1) - np.power(np.float32(b2), t))
            # m = (1 - b1) g + b1 m;  v = (1 - b2) g^2 + b2 v
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_add_(self.nu, g2)
            # u = (m / bc1) / (sqrt(v / bc2) + eps);  update = (u + wd p) -lr
            den = torch._foreach_div(self.nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, _EPS)
            updates = torch._foreach_div(self.mu, bc1)
            torch._foreach_div_(updates, den)
            torch._foreach_add_(
                updates, torch._foreach_mul(self.params, self.weight_decay))
            torch._foreach_mul_(updates, -lr)
        else:
            # trace = g + momentum trace;  update = -lr trace
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, grads)
            updates = torch._foreach_mul(self.trace, -lr)
        torch._foreach_add_(self.params, updates)
        return updates


def make_optimizer(
    params,
    learning_rate: float,
    *,
    optimizer: str = "adamw",
    weight_decay: float = 1e-4,
    momentum: float = 0.9,
    grad_clip_norm: float | None = None,
    warmup_steps: int = 0,
    decay_steps: int = 0,
    schedule: str = "constant",
    final_scale: float = 0.1,
) -> Optimizer:
    """'adamw' | 'sgd' over ``params`` with optional global-norm clipping
    (before the update) and LR schedule; 'adafactor' and 'lion' are not
    ported and raise."""
    if optimizer in ("adafactor", "lion"):
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet: {ROADMAP_TRAINING}"
        )
    if grad_clip_norm is not None and grad_clip_norm <= 0:
        raise ValueError(f"grad_clip_norm must be > 0, got {grad_clip_norm}")
    sched = make_schedule(
        learning_rate, warmup_steps=warmup_steps, decay_steps=decay_steps,
        schedule=schedule, final_scale=final_scale,
    )
    return Optimizer(
        params, kind=optimizer, schedule=sched, weight_decay=weight_decay,
        momentum=momentum, grad_clip_norm=grad_clip_norm,
        scheduled=not (schedule == "constant" and warmup_steps == 0),
    )


@torch.no_grad()
def health_stats(loss, grads, updates, new_params) -> dict:
    """On-device numerics of one train step: pre-clip gradient norm,
    update norm, parameter norm, and a NaN/Inf flag (1.0 when the loss or
    either norm is not finite). 0-dim tensors; no host sync."""
    grad_norm = global_norm(grads)
    update_norm = global_norm(updates)
    param_norm = global_norm(new_params)
    finite = (torch.isfinite(loss) & torch.isfinite(grad_norm)
              & torch.isfinite(update_norm))
    return {
        "grad_norm": grad_norm,
        "update_norm": update_norm,
        "param_norm": param_norm,
        "nonfinite": (~finite).float(),
    }
