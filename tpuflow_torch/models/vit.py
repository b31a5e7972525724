"""Vision Transformer classifier (counterpart of ``tpuflow/models/vit.py``).

Patches embed with one strided convolution (``patch_embed``), a learned
CLS token (``cls``, zeros) is prepended and ``pos_embed`` (normal, std
0.02) added, then ``n_layer`` pre-LN encoder blocks (``block{i}``:
``ln_1``, ``qkv``, ``proj``, ``ln_2``, ``mlp_fc``, ``mlp_proj``), ``ln_f``
and an f32 ``head`` on the CLS token. The names are the Flax module
names, so ``models/convert.py`` maps the tree by name.

As in Flax: LayerNorm epsilon 1e-6 (torch's default is 1e-5), the tanh
GELU, statistics in f32 with the output in ``dtype``, and Dense products
in ``dtype`` on f32 parameters (``models/gpt2.py::_dense``,
``_layer_norm``). Attention goes through ``ops.attention.attention(...,
causal=False, impl=attn_impl)``: with ``"flash"`` the port's flash
kernels on the card (the forward with lse and the fused dq and dk/dv pair
when a gradient is needed, else the no-lse forward), their plain versions
on the CPU. A failing kernel raises; nothing falls back to ``"xla"``.
Dropout masks are seeded from ``fold_in(rng, site)`` (site (0,) after the
embedding, (i + 1, 0) and (i + 1, 1) in block i), as in GPT-2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuflow_torch.models.gpt2 import (
    _dense,
    _dropout,
    _layer_norm,
    variance_scaling_,
)
from tpuflow_torch.ops.attention import attention


class EncoderBlock(nn.Module):
    """Pre-LN transformer encoder block (bidirectional attention)."""

    def __init__(self, n_embd: int, n_head: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, dtype=torch.float32,
                 attn_impl: str = "xla"):
        super().__init__()
        self.n_head, self.dropout = n_head, dropout
        self.dtype, self.attn_impl = dtype, attn_impl
        self.ln_1 = nn.LayerNorm(n_embd, eps=1e-6)
        self.qkv = nn.Linear(n_embd, 3 * n_embd)
        self.proj = nn.Linear(n_embd, n_embd)
        self.ln_2 = nn.LayerNorm(n_embd, eps=1e-6)
        self.mlp_fc = nn.Linear(n_embd, mlp_ratio * n_embd)
        self.mlp_proj = nn.Linear(mlp_ratio * n_embd, n_embd)

    def forward(self, x, train: bool, rng: int | None, layer: int):
        B, T, C = x.shape
        dt, H = self.dtype, self.n_head
        h = _layer_norm(self.ln_1, x, dt)
        q, k, v = _dense(self.qkv, h, dt).split(C, dim=-1)
        a = attention(q.reshape(B, T, H, C // H), k.reshape(B, T, H, C // H),
                      v.reshape(B, T, H, C // H), causal=False,
                      impl=self.attn_impl)
        a = _dense(self.proj, a.reshape(B, T, C), dt)
        x = x + _dropout(a, self.dropout, train, rng, layer + 1, 0)
        h = _layer_norm(self.ln_2, x, dt)
        h = F.gelu(_dense(self.mlp_fc, h, dt), approximate="tanh")
        h = _dense(self.mlp_proj, h, dt)
        return x + _dropout(h, self.dropout, train, rng, layer + 1, 1)


class ViT(nn.Module):
    """Images (B, H, W[, C]) → logits (B, num_classes):
    ``forward(x, *, train=False, rng=None)``; ``train=True`` with dropout
    needs ``rng``, an int seed.

    ``patch_size`` must divide H and W. ``image_shape`` — (H, W) or
    (H, W, C) of the input — sizes ``patch_embed``'s input channels and
    ``pos_embed``'s tokens, which Flax infers from the first call.
    Defaults are the JAX package's small config; ViT-S/16 is 384/12/6 at
    patch 16 (``get_model("vit_small")``). ``seed`` draws the initial
    weights with Flax's initialisers (other numbers than JAX's)."""

    def __init__(self, num_classes: int = 10, patch_size: int = 4,
                 n_embd: int = 192, n_layer: int = 6, n_head: int = 3,
                 mlp_ratio: int = 4, dropout: float = 0.0,
                 dtype=torch.float32, attn_impl: str = "xla",
                 image_shape: tuple = (32, 32, 3), seed: int = 0):
        super().__init__()
        H, W = image_shape[:2]
        C = image_shape[2] if len(image_shape) == 3 else 1
        if H % patch_size or W % patch_size:
            raise ValueError(f"patch_size {patch_size} must divide the "
                             f"image size ({H}x{W})")
        self.patch_size, self.n_embd = patch_size, n_embd
        self.dropout, self.dtype = dropout, dtype
        self.patch_embed = nn.Conv2d(C, n_embd, patch_size, patch_size)
        n_tok = (H // patch_size) * (W // patch_size)
        self.cls = nn.Parameter(torch.zeros(1, 1, n_embd))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok + 1, n_embd))
        self.blocks = []  # registered by their Flax names below
        for i in range(n_layer):
            blk = EncoderBlock(n_embd, n_head, mlp_ratio, dropout, dtype,
                               attn_impl)
            self.add_module(f"block{i}", blk)
            self.blocks.append(blk)
        self.ln_f = nn.LayerNorm(n_embd, eps=1e-6)
        self.head = nn.Linear(n_embd, num_classes)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """lecun_normal kernels and zero biases (Dense and the patch
        convolution), zero CLS, normal(0.02) ``pos_embed``, unit
        LayerNorms."""
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                variance_scaling_(m.weight, m.weight[0].numel(), 1.0, g)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.cls.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=g)

    def forward(self, x, *, train: bool = False, rng: int | None = None):
        if x.ndim == 3:
            x = x[..., None]
        B, H, W, _ = x.shape
        p, dt = self.patch_size, self.dtype
        if H % p or W % p:
            raise ValueError(f"patch_size {p} must divide the image size "
                             f"({H}x{W})")
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2),
                     self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=p)
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.n_embd)
        cls = self.cls.to(dt).expand(B, 1, self.n_embd)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        x = _dropout(x, self.dropout, train, rng, 0)
        for i, blk in enumerate(self.blocks):
            x = blk(x, train, rng, i)
        x = _layer_norm(self.ln_f, x, dt)
        return self.head(x[:, 0].float())
