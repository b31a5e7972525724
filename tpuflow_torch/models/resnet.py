"""ResNet-18/50 with Flax semantics (counterpart of ``tpuflow/models/resnet.py``).

The module tree carries the Flax auto-names (``Conv_0``, ``BatchNorm_0``,
``BasicBlock_3``/``BottleneckBlock_3``, ``Dense_0``; inside a block
``Conv_i``/``BatchNorm_i`` in call order), so ``models/convert.py`` maps it
onto the JAX param and ``batch_stats`` trees by name. Where Flax and torch
differ, this module does what Flax does:

- ``Conv`` pads ``"SAME"``: ``ceil(n / stride)`` outputs, the padding
  split with the odd element at the end. At stride 2 that is asymmetric
  (3 x 3 pads (0, 1), the 7 x 7 stem on 224 pads (2, 3)), which torch's
  symmetric ``padding=`` cannot express, so those take ``F.pad`` first.
  The stem's max pool pads the same way with -inf.
- ``BatchNorm`` is Flax's ``nn.BatchNorm``: momentum 0.99, epsilon 1e-5,
  the batch variance as ``mean(x^2) - mean(x)^2`` clipped at 0, and the
  running variance fed that biased value. In a multi-process world the
  statistics are global over the data axis, as under the JAX package's
  pjit (``tpuflow/train/step.py:284-292``): each forward all-reduces the
  per-channel sums, sums of squares and the row count, differentiably.
- Each block's last norm starts with a zero scale (``resnet.py:37, 64``).
- Input is NHWC (grayscale (B, H, W) gains a channel). The first op
  views it as NCHW with NHWC strides, so the convolutions run
  channels_last on the card.

Convolutions and the head are cuDNN/cuBLAS calls: the JAX package leaves
them to XLA, outside any Pallas kernel. Initial weights follow Flax's
initialisers (he_normal convolutions, lecun_normal head, zero biases) from
``seed``: other numbers than JAX's from the same seed; the parity tests
load one set of weights into both.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from tpuflow_torch.models.gpt2 import variance_scaling_

def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """Flax/XLA ``"SAME"`` padding of one spatial dim: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """``x`` (B, C, H, W) padded as ``"SAME"`` needs for a k x k window at
    stride s."""
    (ht, hb), (wl, wr) = (_same_pads(x.shape[2], k, s),
                          _same_pads(x.shape[3], k, s))
    if ht == hb == wl == wr == 0:
        return x
    return F.pad(x, (wl, wr, ht, hb), value=value)


class Conv(nn.Conv2d):
    """Flax ``nn.Conv(features, (k, k), strides=(s, s))`` with ``"SAME"``
    padding and no bias."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1):
        super().__init__(in_ch, out_ch, k, stride=stride, bias=False)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        if s == 1 and k % 2:  # symmetric: torch's own padding
            return F.conv2d(x, self.weight, None, 1, k // 2)
        return F.conv2d(_pad_same(x, k, s), self.weight, None, s)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the process group, differentiable: the gradient of each
    process's input is the sum of every process's output gradient."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        tdist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        tdist.all_reduce(g)
        return g


def _batch_moments(x):
    """Per-channel mean and biased variance of x (B, C, H, W) over every
    row of the data axis: Flax's fast variance, ``mean(x^2) - mean(x)^2``
    clipped at 0. With a process group of more than one process the sums
    and the count are all-reduced (one collective, differentiable)
    first."""
    s1 = x.sum(dim=(0, 2, 3))
    s2 = (x * x).sum(dim=(0, 2, 3))
    n = x.new_full((1,), x.numel() // x.shape[1])
    if tdist.is_available() and tdist.is_initialized() \
            and tdist.get_world_size() > 1:
        s1, s2, n = _AllReduceSum.apply(torch.cat([s1, s2, n])).split(
            [x.shape[1], x.shape[1], 1])
    mean = s1 / n
    return mean, torch.clamp_min(s2 / n - mean * mean, 0.0)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the channels of (B, C, H, W): ``weight``
    is its ``scale``, ``mean``/``var`` its ``batch_stats``. ``train=True``
    normalises by the (global) batch statistics and moves the running ones
    by ``momentum``; ``train=False`` uses the running ones."""

    def __init__(self, features: int, *, zero_scale: bool = False,
                 momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.full((features,),
                                              0.0 if zero_scale else 1.0))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, train: bool):
        if train:
            mean, var = _batch_moments(x)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, 3, strides)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        if in_ch != filters or strides != 1:
            self.Conv_2 = Conv(in_ch, filters, 1, strides)
            self.BatchNorm_2 = BatchNorm(filters)

    def forward(self, x, train: bool):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        if hasattr(self, "Conv_2"):
            x = self.BatchNorm_2(self.Conv_2(x), train)
        return F.relu(y + x)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck block (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int = 1):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_ch, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, 1)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True)
        if in_ch != out or strides != 1:
            self.Conv_3 = Conv(in_ch, out, 1, strides)
            self.BatchNorm_3 = BatchNorm(out)

    def forward(self, x, train: bool):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if hasattr(self, "Conv_3"):
            x = self.BatchNorm_3(self.Conv_3(x), train)
        return F.relu(y + x)


class ResNet(nn.Module):
    """NHWC ResNet: ``forward(x, *, train=False, rng=None)``, x (B, H, W, C)
    or (B, H, W) → logits (B, num_classes). ``small_inputs`` takes the
    CIFAR stem (3x3 conv, no max pool) instead of the ImageNet stem (7x7/2
    + 3x3/2 max pool). ``in_channels``: C of the input (Flax infers it from
    the first call; a torch module needs it up front). ``rng`` is accepted
    for the train step's interface; the model draws nothing."""

    def __init__(self, stage_sizes: Sequence[int], block: type = BasicBlock,
                 num_classes: int = 10, width: int = 64,
                 small_inputs: bool = False, in_channels: int = 3,
                 seed: int = 0):
        super().__init__()
        self.small_inputs = small_inputs
        self.Conv_0 = Conv(in_channels, width, 3 if small_inputs else 7,
                           1 if small_inputs else 2)
        self.BatchNorm_0 = BatchNorm(width)
        self.blocks = []  # registered by their Flax names below
        ch = width
        for i, n in enumerate(stage_sizes):
            for j in range(n):
                blk = block(ch, width * 2 ** i, 2 if i > 0 and j == 0 else 1)
                self.add_module(f"{block.__name__}_{len(self.blocks)}", blk)
                self.blocks.append(blk)
                ch = width * 2 ** i * block.expansion
        self.Dense_0 = nn.Linear(ch, num_classes)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, Conv):
                variance_scaling_(m.weight, m.weight[0].numel(), 2.0, g)
        variance_scaling_(self.Dense_0.weight, self.Dense_0.in_features, 1.0,
                          g)
        self.Dense_0.bias.zero_()

    def forward(self, x, *, train: bool = False, rng: int | None = None):
        if x.ndim == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        if not self.small_inputs:
            x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for blk in self.blocks:
            x = blk(x, train)
        return self.Dense_0(x.mean(dim=(2, 3)))


def ResNet18(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block=BasicBlock, **kwargs)


def ResNet50(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BottleneckBlock, **kwargs)
