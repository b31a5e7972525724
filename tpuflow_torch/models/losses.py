"""Loss and metric functions (counterpart of ``tpuflow/models/losses.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits, labels):
    """Mean softmax cross-entropy with integer labels over every position
    (optax ``softmax_cross_entropy_with_integer_labels(...).mean()``);
    the softmax runs in f32."""
    V = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, V),
                           labels.reshape(-1).long())


def accuracy(logits, labels):
    """Fraction of argmax predictions matching labels."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def sum_sown_losses(values) -> torch.Tensor:
    """The f32 scalar sum of the auxiliary losses a forward returned (the
    MoE blocks' load-balance losses): 0 when there are none. The
    counterpart of summing the JAX model's sown ``losses`` collection."""
    total = torch.zeros((), dtype=torch.float32)
    for v in values:
        total = total.to(v.device) + v.float().sum()
    return total
