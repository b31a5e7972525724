"""The FashionMNIST MLP classifier (counterpart of ``tpuflow/models/mlp.py``).

Flatten → Linear(784, 512) → ReLU → Dropout(0.25) → Linear(512, 512) →
ReLU → Dropout → Linear(512, 10) [→ ReLU]. The ReLU after the last layer
is the reference's quirk (it clamps the logits at 0) and is on by default;
``final_relu=False`` is the corrected mode. The three dense layers are
plain ``nn.Linear`` products: the JAX package computes them with
``nn.Dense``, outside any Pallas kernel.

Dropout draws from a ``torch.Generator`` seeded from ``fold_in(rng,
site)`` (``rng`` is the train step's ``fold_in(seed, step)``), never from
a running state, so a resumed run draws the masks an uninterrupted one
does.
"""

from __future__ import annotations


import torch
from torch import nn

from tpuflow_torch.models.gpt2 import _dropout, variance_scaling_


class NeuralNetwork(nn.Module):
    """``forward(x, *, train=False, rng=None)``: x (B, 28, 28) → logits
    (B, num_classes). ``train=True`` with ``dropout_rate > 0`` needs
    ``rng``, an int seed; ``seed`` draws the initial weights."""

    def __init__(self, hidden_dim: int = 512, num_classes: int = 10,
                 dropout_rate: float = 0.25, final_relu: bool = True,
                 seed: int = 0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.final_relu = final_relu
        self.dense1 = nn.Linear(28 * 28, hidden_dim)
        self.dense2 = nn.Linear(hidden_dim, hidden_dim)
        self.dense3 = nn.Linear(hidden_dim, num_classes)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Flax ``nn.Dense``'s initialisers from ``seed``: lecun_normal
        kernels (truncated normal at +-2 std, variance 1/fan_in after
        truncation) and zero biases. Other numbers than JAX's from the
        same seed; the parity tests load one set of weights into both."""
        g = torch.Generator().manual_seed(seed)
        for m in (self.dense1, self.dense2, self.dense3):
            variance_scaling_(m.weight, m.in_features, 1.0, g)
            m.bias.zero_()

    def forward(self, x, *, train: bool = False, rng: int | None = None):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.dense1(x))
        x = _dropout(x, self.dropout_rate, train, rng, 0)
        x = torch.relu(self.dense2(x))
        x = _dropout(x, self.dropout_rate, train, rng, 1)
        x = self.dense3(x)
        return torch.relu(x) if self.final_relu else x
