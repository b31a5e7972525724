"""Optimizer factory: schedules, clipping and weight decay.

Counterpart of ``tpuflow/train/optim.py``. The JAX package chains optax
transformations; the port writes the same recipe out as one small class
with optax's semantics and op order:

1. global-norm clipping of the gradients (optional), before the update;
2. ``adamw`` (optax defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
   bias-corrected moments, decoupled weight decay on every parameter),
   ``sgd`` (momentum trace g + momentum * trace, dampening 0), ``lion``
   (``optax.lion``: sign((1 - b1) g + b1 mu) with b1 0.9, then mu =
   (1 - b2) g + b2 mu with b2 0.99, plus weight decay) or ``adafactor``
   (``optax.adafactor``, see ``Optimizer._adafactor``);
3. the learning rate of the schedule at the count of updates made so far
   (the first update reads the schedule at 0).

Adafactor keeps its statistics per leaf of the JAX param tree: the
factored second moments follow the leaf's shape (a Dense kernel is
(in, out) there, and under ``scan_layers`` one leaf stacks a name's
kernels of every layer), and its two block-RMS steps take one RMS over
the whole leaf. ``Leaves`` maps the parameter list onto those leaves
(``ckpt/tree.py::JaxLeaves`` for GPT-2); by default each parameter is
its own leaf. On a sharded state each process holds a block of a leaf:
which dims to factor is decided on the leaf's global shape, and every
mean and RMS is a local sum all-reduced over the groups that shard the
dims it runs over (``Leaves.reduce_sum``), so each equals optax's on the
whole leaf.

``Optimizer.update`` applies the step in place and returns the update
tensors it added, which the train step's health statistics read, as the
JAX step reads ``tx.update``'s output.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from tpuflow_torch.dist.mesh import world_sum

KINDS = ("adamw", "sgd", "lion", "adafactor")
# optax.adamw's defaults.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# optax.lion's defaults.
_LION_B1, _LION_B2 = 0.9, 0.99
# optax.adafactor's defaults: the second-moment decay exponent, the eps
# added to g^2, the smallest dimension that is factored, the block-RMS
# clip threshold and the floor of the parameter-scale RMS.
_AF_DECAY, _AF_EPS, _AF_MIN_DIM = 0.8, 1e-30, 128
_AF_CLIP, _AF_MIN_SCALE = 1.0, 1e-3


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


def square_sums(tensors) -> torch.Tensor:
    """Each tensor's sum of squares, f32, as one vector."""
    norms = torch.stack(torch._foreach_norm([t.float() for t in tensors]))
    return norms * norms


def global_norm(tensors, owned: list[bool] | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).
    ``owned`` (a sharded state, ``ShardPlan.owned``): per tensor, True
    where this process counts its part; the owned square sums add over
    the world (one collective), so every element of a parameter split
    over some axes and replicated over others counts once."""
    if owned is None:
        norms = torch._foreach_norm([t.float() for t in tensors])
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = square_sums(tensors)
    keep = torch.tensor(owned, device=sq.device)
    return torch.sqrt(world_sum(sq[keep].sum().reshape(1))[0])


class Leaves:
    """The default leaf grouping: each parameter is one leaf, as it is.
    A grouping maps the parameter list (or a list of tensors like it) to
    its leaves (``leaves``) and a list of leaf-shaped tensors back
    (``tensors``)."""

    def leaves(self, tensors) -> list[torch.Tensor]:
        return list(tensors)

    def tensors(self, leaves) -> list[torch.Tensor]:
        return list(leaves)

    def global_shapes(self, tensors) -> list[tuple]:
        """Each leaf's shape over every process (here: as held)."""
        return [tuple(t.shape) for t in self.leaves(tensors)]

    def reduce_sum(self, i: int, x: torch.Tensor, dims) -> torch.Tensor:
        """``x`` (leaf ``i``'s layout) summed over ``dims`` across every
        process that holds a block of them (here: locally)."""
        return x.sum(dims)


def _factored_dims(shape) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: the two largest axes of ``shape``
    (by ``np.argsort``, so equal sizes keep their order), or None when the
    leaf has fewer than two axes or the second largest is under 128."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _AF_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


class Optimizer:
    """AdamW, SGD with momentum, Lion or Adafactor over a fixed list of
    parameters, with optional global-norm clipping and a schedule (see the
    module docstring). ``count`` is the number of updates made;
    ``scheduled`` is True when the learning rate depends on it (a schedule
    other than constant, or warmup), where optax keeps a second step count.

    Written out rather than built on ``torch.optim.AdamW``: that class
    computes the bias corrections in float64, optax in float32, and the
    params then drift apart by more than the 1e-6 that
    ``tests/test_torch_train_pieces.py::test_optimizer_matches_optax``
    allows. Each step is a fixed sequence of ``torch._foreach_*`` ops over
    all parameters (one multi-tensor launch per op on the card)."""

    def __init__(self, params, *, kind: str, schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, momentum: float = 0.9,
                 grad_clip_norm: float | None = None,
                 scheduled: bool = False, leaves: Leaves | None = None):
        if kind not in KINDS:
            raise ValueError(f"unknown optimizer {kind!r}")
        self.params = list(params)
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.grad_clip_norm = grad_clip_norm
        self.scheduled = scheduled
        self.leaves = leaves or Leaves()
        self.count = 0
        # Per parameter of a sharded state: this process counts its part
        # in the clip's global norm (``ShardPlan.owned``).
        self.owned: list[bool] | None = None
        self.last_grad_norm = None  # the last clip's (global) norm
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mu = self.nu = self.trace = None
        self.v_row = self.v_col = self.v = None
        if kind == "adamw":
            self.mu, self.nu = zeros(), zeros()
        elif kind == "lion":
            self.mu = zeros()
        elif kind == "sgd":
            self.trace = zeros()
        else:
            self._init_factored()

    def _init_factored(self) -> None:
        """Adafactor's zero statistics, one of each a leaf as optax keeps
        them: ``v_row`` and ``v_col`` the leaf's shape without its
        column and without its row axis where it is factored, ``v`` its
        whole shape where it is not, and a (1,) placeholder for the
        unused ones."""
        dev = self.params[0].device
        self.v_row, self.v_col, self.v = [], [], []
        meta = [torch.empty_like(p, device="meta") for p in self.params]
        for leaf, whole in zip(self.leaves.leaves(meta),
                               self.leaves.global_shapes(meta)):
            shape = tuple(leaf.shape)
            # Factored or not by the whole leaf's shape; the statistics
            # have this process's block's.
            dims = _factored_dims(tuple(whole))
            one = (1,)
            if dims is None:
                row, col, full = one, one, shape
            else:
                d1, d0 = dims
                row = tuple(np.delete(shape, d0))
                col = tuple(np.delete(shape, d1))
                full = one
            for out, s in ((self.v_row, row), (self.v_col, col),
                           (self.v, full)):
                out.append(torch.zeros(s, dtype=leaf.dtype, device=dev))

    def slots(self) -> dict[str, list[torch.Tensor]]:
        """The per-parameter state, named as optax names it: ``mu`` and
        ``nu`` (adamw), ``trace`` (sgd) or ``mu`` (lion), each in
        parameter order; adafactor has none (``leaf_slots``)."""
        if self.kind == "adamw":
            return {"mu": self.mu, "nu": self.nu}
        if self.kind == "lion":
            return {"mu": self.mu}
        if self.kind == "sgd":
            return {"trace": self.trace}
        return {}

    def leaf_slots(self) -> dict[str, list[torch.Tensor]]:
        """The per-leaf state (adafactor's ``v_row``, ``v_col`` and ``v``,
        each in the order of ``leaves``' leaves); empty for the others."""
        if self.kind != "adafactor":
            return {}
        return {"v_row": self.v_row, "v_col": self.v_col, "v": self.v}

    @torch.no_grad()
    def load_slots(self, count: int, slots: dict,
                   leaf_slots: dict | None = None) -> None:
        """Set ``count`` and copy ``slots`` and ``leaf_slots`` (as
        ``slots()`` and ``leaf_slots()`` return them, tensors on any
        device) into the state in place."""
        leaf_slots = leaf_slots or {}
        for given, mine, what in ((slots, self.slots(), "parameters"),
                                  (leaf_slots, self.leaf_slots(), "leaves")):
            if set(given) != set(mine):
                raise ValueError(f"optimizer slots {sorted(given)}, this "
                                 f"{self.kind} optimizer has {sorted(mine)}")
            for name, dst in mine.items():
                if len(given[name]) != len(dst):
                    raise ValueError(f"{name}: {len(given[name])} tensors "
                                     f"for {len(dst)} {what}")
                for d, s in zip(dst, given[name]):
                    if d.shape != s.shape:
                        raise ValueError(f"{name}: a {tuple(s.shape)} tensor "
                                         f"for a {tuple(d.shape)} slot")
                    d.copy_(s)
        self.count = int(count)

    @torch.no_grad()
    def update(self, grads) -> list[torch.Tensor]:
        """One step: clip, transform, scale by -lr, add to the params in
        place. Returns the update tensors."""
        grads = list(grads)
        if self.grad_clip_norm is not None:
            norm = self.last_grad_norm = global_norm(grads, self.owned)
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
        elif self.kind == "lion":
            b1, b2 = _LION_B1, _LION_B2
            # u = sign((1 - b1) g + b1 mu);  mu = (1 - b2) g + b2 mu
            updates = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(updates, torch._foreach_mul(self.mu, b1))
            torch._foreach_sign_(updates)
            torch._foreach_mul_(self.mu, b2)
            torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b2))
            # update = (u + wd p) -lr
            torch._foreach_add_(
                updates, torch._foreach_mul(self.params, self.weight_decay))
            torch._foreach_mul_(updates, -lr)
        elif self.kind == "sgd":
            # trace = g + momentum trace;  update = -lr trace
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, grads)
            updates = torch._foreach_mul(self.trace, -lr)
        else:
            updates = self._adafactor(grads, lr, self.count - 1)
        torch._foreach_add_(self.params, updates)
        return updates

    def _adafactor(self, grads, lr: float, count: int) -> list[torch.Tensor]:
        """optax.adafactor's chain on each leaf: the factored RMS scaling
        (second moments decayed at 1 - (count + 1)^-0.8, in f32), the
        block-RMS clip at 1, the learning rate, the parameter block's RMS
        (at least 1e-3), the weight decay (after the learning rate: not
        scaled by it; absent when 0), and the sign flip. Returns the
        per-parameter updates. On a sharded state each leaf is this
        process's block: the factored dims come from the leaf's global
        shape, and the row and column means, the row mean of ``v_row`` and
        both block RMS values are sums over the processes that hold the
        dims they run over (``Leaves.reduce_sum``) divided by the global
        sizes."""
        decay = np.float32(1) - np.float32(count + 1) ** np.float32(-_AF_DECAY)
        keep, fresh = float(decay), float(np.float32(1) - decay)
        wd = self.weight_decay
        leaves = self.leaves
        g_leaves = leaves.leaves(grads)
        shapes = leaves.global_shapes(grads)
        out = []
        for i, (g, p, v_row, v_col, v) in enumerate(zip(
                g_leaves, leaves.leaves(self.params), self.v_row, self.v_col,
                self.v)):
            shape = shapes[i]
            every = tuple(range(len(shape)))
            size = float(math.prod(shape))
            g2 = g * g + _AF_EPS
            dims = _factored_dims(tuple(shape))
            if dims is None:
                v.copy_(v * keep + g2 * fresh)
                u = g * v.pow(-0.5)
            else:
                d1, d0 = dims
                v_row.copy_(v_row * keep
                            + leaves.reduce_sum(i, g2, (d0,)) / shape[d0]
                            * fresh)
                v_col.copy_(v_col * keep
                            + leaves.reduce_sum(i, g2, (d1,)) / shape[d1]
                            * fresh)
                # v_row lacks dim d0: its dim for d1 shifts down past it.
                row_sum = leaves.reduce_sum(i, v_row.unsqueeze(d0), (d1,))
                row = (v_row.unsqueeze(d0)
                       / (row_sum.unsqueeze(d1) / shape[d1])).pow(-0.5)
                u = g * row * v_col.pow(-0.5).unsqueeze(d1)
            rms_u = torch.sqrt(leaves.reduce_sum(i, u * u, every) / size)
            u = u / torch.clamp(rms_u / _AF_CLIP, min=1.0)
            u = u * lr
            rms = torch.sqrt(leaves.reduce_sum(i, p * p, every) / size)
            u = u * torch.where(rms <= _AF_MIN_SCALE, _AF_MIN_SCALE, rms)
            if wd:
                u = u + wd * p
            out.append(-u)
        return leaves.tensors(out)


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
    leaves: Leaves | None = None,
) -> Optimizer:
    """'adamw' | 'sgd' | 'lion' | 'adafactor' over ``params`` with
    optional global-norm clipping (before the update) and LR schedule.
    ``leaves`` groups the parameters into the leaves Adafactor keeps its
    statistics for (default: each parameter its own leaf)."""
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
        leaves=leaves,
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
