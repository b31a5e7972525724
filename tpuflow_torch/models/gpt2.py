"""GPT-2 causal language model in PyTorch.

Counterpart of ``tpuflow/models/gpt2.py``: the same config, the same
pre-LN blocks (LN → MHA → residual, LN → MLP → residual), weights tied
between the token embedding and the LM head (f32 logits), attention behind
the pluggable ``tpuflow_torch.ops.attention`` dispatch, and the three
decode-mode caches of the JAX model:

- the shared-index KV cache (``KVCache``: per layer (B, n_ctx, H, D), one
  position index for every row), including the fresh-cache T x T fast path
  that reaches the flash kernel;
- ``pad_lens`` for LEFT-padded ragged batches;
- the paged slot mode (``PagedKVCache``: per layer one
  (n_pages, page_size, H, D) pool shared by every slot, page 0 the trash
  page), the serving engine's cache.

The caches are explicit state objects that a decode call takes and returns;
their tensors are updated IN PLACE (the counterpart of JAX's donated cache
buffers). The JAX model's ``scan_layers`` becomes an ``nn.ModuleList``
(``models/convert.py`` reads both JAX param layouts).

Training mode (``train=True``): dropout draws its masks from generators
seeded by ``fold_in(rng, site)`` (the counterpart of the JAX model's
``dropout`` rng stream), and with ``remat`` each block runs under
``torch.utils.checkpoint`` (non-reentrant): ``remat_policy`` None saves
only the block's input (the JAX ``full`` selector), ``'dots'`` saves every
matrix product without batch dims plus the flash forward's outputs (the
JAX ``dots_with_no_batch_dims_saveable`` + ``flash_out`` policy).
Deferred, each raising: MoE and the contiguous slot-row cache.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from tpuflow_torch.device import resolve_device
from tpuflow_torch.ops import flash_attention  # registers its custom op
from tpuflow_torch.ops.attention import attention
from tpuflow_torch.ops.int8_matmul import int8_matmul

_MASKED = -1e30


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_ctx: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.1
    ln_eps: float = 1e-5  # GPT-2's LayerNorm epsilon (HF-checkpoint parity)
    attn_impl: str = "xla"  # 'auto' | 'xla' | 'flash' | 'ring' | 'ulysses'
    dtype: torch.dtype = torch.float32  # activation dtype
    # Rematerialize each block in the backward (a train=True forward):
    # remat_policy None saves only block inputs, 'dots' also saves the
    # matrix products and the flash outputs (see the module docstring).
    remat: bool = False
    remat_policy: str | None = None
    # MoE blocks are not ported: n_experts > 0 raises at build.
    n_experts: int = 0
    # Decode-path (KV-cache, non-prefill) compute dtype: f32 by default so
    # decode numerics do not depend on how many tokens one call carries.
    decode_dtype: torch.dtype | None = torch.float32
    # KV-cache storage dtype; None = the decode compute dtype.
    cache_dtype: torch.dtype | None = None
    # 'highest' = true f32 matrix products on the decode path: generate(),
    # beam search, speculative decoding and the serving engine's steps
    # turn TF32 off on the card for their own calls
    # (device.f32_matmul_precision). None = the platform default.
    decode_precision: str | None = "highest"
    # The JAX package's nn.scan over the blocks: here only the checkpoint
    # layout (ckpt/tree.py stacks the blocks into h/block when set); the
    # port always holds its blocks in a ModuleList.
    scan_layers: bool = False
    # The flash attention backward: 'fused' | 'split' | 'blockwise' (the
    # JAX package's TPUFLOW_FLASH_BWD; 'blockwise' on the CPU only).
    flash_bwd: str = "fused"

    def compute_dtype(self, decode: bool):
        """``decode_dtype`` on the KV-cache path, ``dtype`` otherwise."""
        if decode and self.decode_dtype is not None:
            return self.decode_dtype
        return self.dtype

    def kv_cache_dtype(self):
        """Storage dtype of the KV cache."""
        if self.cache_dtype is not None:
            return self.cache_dtype
        return self.compute_dtype(decode=True)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def small_test(cls, **kw) -> "GPT2Config":
        """Tiny config for tests."""
        kw = {
            "vocab_size": 512,
            "n_ctx": 128,
            "n_embd": 128,
            "n_layer": 2,
            "n_head": 4,
            **kw,
        }
        return cls(**kw)

    @classmethod
    def medium(cls, **kw) -> "GPT2Config":
        """GPT-2-medium (355M): 24 layers, 1024 hidden, 16 heads."""
        kw = {"n_embd": 1024, "n_layer": 24, "n_head": 16, **kw}
        return cls(**kw)

    @classmethod
    def from_preset(
        cls,
        preset: str,
        *,
        attn_impl: str = "auto",
        seq_len: int = 64,
        stage_axis: int = 1,
        n_experts: int = 0,
        dtype=None,
    ) -> "GPT2Config":
        """The JAX package's preset table: ``test``, ``gpt2`` (124M),
        ``medium`` (355M), with its ``scan_layers`` (the checkpoint
        layout; the port always holds its blocks in a ModuleList)."""
        extra = {} if dtype is None else {"dtype": dtype}
        if preset == "medium":
            return cls.medium(
                attn_impl=attn_impl, scan_layers=True, remat=True,
                n_experts=n_experts, **extra,
            )
        if preset == "gpt2":
            return cls(
                attn_impl=attn_impl, scan_layers=True, remat=True,
                n_experts=n_experts, **extra,
            )
        if preset == "test":
            return cls.small_test(
                attn_impl=attn_impl,
                n_ctx=max(128, seq_len),
                scan_layers=stage_axis > 1,
                n_layer=max(2, stage_axis),
                n_experts=n_experts,
                **extra,
            )
        raise ValueError(
            f"unknown preset {preset!r}; available: test, gpt2, medium"
        )


@dataclasses.dataclass
class KVCache:
    """Shared-index KV cache: per layer (B, n_ctx, H, D) keys and values,
    and the one position index every row shares (the JAX model's
    ``cache_index``/``pos_index``). Updated in place by each decode call."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    index: int = 0


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV pool: per layer (n_pages, page_size, H, D) keys and values
    shared by every slot. Page 0 is the TRASH page: out-of-range writes and
    dead slots (zeroed page tables) land there and nothing reads it.
    Updated in place by each decode call and by the engine's page insert."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]

    @property
    def n_pages(self) -> int:
        return self.k[0].shape[0]

    @property
    def page_size(self) -> int:
        return self.k[0].shape[1]


def _masked_attention(q, k, v, valid):
    """Masked softmax attention, float32 statistics. ``valid`` broadcasts
    against the (B, H, Tq, Tk) scores. Fully masked rows degrade to a
    uniform softmax over the -1e30 constants (finite garbage no real query
    reads)."""
    D = q.shape[-1]
    scale = (1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))).to(
        q.device
    )
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(valid, s, _MASKED)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


# Flax's truncated-normal variance scaling draws at +-2 std and divides the
# std by this factor so the truncated distribution keeps the variance.
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(w: torch.Tensor, fan_in: int, scale: float,
                      g: torch.Generator) -> None:
    """Flax ``variance_scaling(scale, "fan_in", "truncated_normal")`` into
    ``w``, drawn from ``g``: ``lecun_normal`` at scale 1, ``he_normal`` at
    2."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit seed derived from ``seed`` and the non-negative ints
    ``data``: the counterpart of ``jax.random.fold_in`` (it gives other
    numbers than JAX from the same inputs)."""
    state = np.random.SeedSequence([seed, *data]).generate_state(2)
    return (int(state[0]) << 31 | int(state[1])) & (2 ** 63 - 1)


def _dropout(x, p: float, train: bool, rng: int | None, *site: int):
    """Flax's dropout: keep with probability 1 - p, kept values scaled by
    1 / (1 - p). The mask comes from a generator seeded by
    ``fold_in(rng, *site)``, so a remat'd block's recompute draws the same
    mask as its forward."""
    if not train or p == 0.0:
        return x
    if rng is None:
        raise ValueError("a train=True forward with dropout needs rng, "
                         "an int seed")
    g = torch.Generator(device=x.device).manual_seed(fold_in(rng, *site))
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


# Ops whose outputs the 'dots' remat policy saves: the matrix products
# without batch dims (the Dense layers) and the flash forward with lse.
_DOTS_SAVED = (
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.tpuflow_torch.flash_fwd_lse.default,
)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_CONTEXT = {
    None: noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _dots_policy),
}


def _remat(block, x, policy, **kw):
    """``block(x, **kw)`` under non-reentrant activation checkpointing."""
    return checkpoint(functools.partial(block, **kw), x, use_reentrant=False,
                      context_fn=_REMAT_CONTEXT[policy])


def _tied_head(x, wte, dt, rowwise: bool):
    """The weight-tied LM head in the JAX op order: wte rounded to the
    compute dtype ``dt`` first, then a product with an f32 accumulator and
    f32 logits. Both operands are upcast to f32 exactly, so for bf16 this
    is the bf16 x bf16 product with f32 accumulation that the JAX einsum's
    ``preferred_element_type=f32`` asks for. ``rowwise`` (decode steps)
    runs it one (row, position) at a time (see ``_tokenwise``)."""
    w = wte.to(dt).float()
    x = x.float()
    if rowwise:
        return _tokenwise(lambda r: F.linear(r, w), x)
    return F.linear(x, w)


def _rowwise(fn, *xs):
    """``fn`` applied to each batch row alone, results concatenated.

    Decode must not depend on how many rows share a call: the serving
    engine decodes 8 slots where a solo ``generate()`` decodes one, and
    each request's tokens must equal the solo ones. cuBLAS (and the CPU
    BLAS) pick their algorithm by shape, so a row's f32 product can round
    differently at 8 rows than at 1 — measured on an H100 for the batched
    score product and for ``F.linear`` at M = 8 vs M = 1. Running every
    row as its own one-row call makes the rounding the same by
    construction. (The int8 matmul needs no loop: its sums are exact.)"""
    if xs[0].shape[0] == 1:
        return fn(*xs)
    return torch.cat(
        [fn(*(x[i:i + 1] if x.shape[0] > 1 else x for x in xs))
         for i in range(xs[0].shape[0])]
    )


def _tokenwise(fn, x):
    """``fn`` (a product over the last axis) applied to each (row,
    position) of ``x`` (B, T, C) alone, results in place.

    A decode call with T > 1 (speculative decoding's verify chunk of K + 1
    tokens) must round every product as the single-token steps of
    ``generate()`` do, or the chunk's argmax can part from the token greedy
    decoding emits: the same M-dependence ``_rowwise`` avoids across rows
    holds across positions. Every product then has M = 1, as in a decode
    step. The price is launches: B x T products a layer where one would
    do (a (4, 5) chunk: 20 for each Dense layer and the head)."""
    if x.shape[1] == 1:
        return _rowwise(fn, x)
    return torch.cat(
        [_rowwise(fn, x[:, t:t + 1]) for t in range(x.shape[1])], dim=1
    )


def _decode_attention(q, k, v, valid):
    """Masked attention of decode queries q (B, T, H, D) over whole caches
    k, v (B, n_ctx, H, D), one (row, query) at a time: query t's mask
    ``valid[:, :, t]`` hides every key past its position behind -1e30,
    whose exponential is exactly 0, so each query computes the very
    products of the single-token step at its position (see
    ``_tokenwise``)."""
    if q.shape[1] == 1:
        return _rowwise(_masked_attention, q, k, v, valid)
    return torch.cat(
        [_rowwise(_masked_attention, q[:, t:t + 1], k, v,
                  valid[:, :, t:t + 1])
         for t in range(q.shape[1])], dim=1,
    )


def _left_pad_attention(q, k, v, pad_lens):
    """Causal attention over a LEFT-padded (B, T, H, D) batch: key columns
    ``< pad_lens[b]`` are masked out of row b."""
    T = q.shape[1]
    pos = torch.arange(T, device=q.device)
    valid = (pos[None, :] <= pos[:, None])[None, None]
    valid = valid & (pos[None, None, None, :] >= pad_lens[:, None, None, None])
    return _masked_attention(q, k, v, valid)


def _dense(linear: nn.Linear, x, dt, qleaf=None, int8_impl=None,
           rowwise: bool = False):
    """One Dense layer in compute dtype ``dt``; with a QuantLeaf, the W8A8
    int8 matmul plus the bias in f32, then cast to ``dt`` (the JAX
    interceptor's op order). ``rowwise`` (decode steps) runs the fp product
    one (row, position) at a time (see ``_tokenwise``); the int8 matmul
    takes the whole call, its sums being exact."""
    if qleaf is None:
        w, b = linear.weight.to(dt), linear.bias.to(dt)
        if rowwise:
            return _tokenwise(lambda r: F.linear(r, w, b), x.to(dt))
        return F.linear(x.to(dt), w, b)
    out = int8_matmul(
        x, qleaf.q, qleaf.scale, out_dtype=torch.float32, impl=int8_impl
    )
    return (out + linear.bias.float()).to(dt)


def _layer_norm(ln: nn.LayerNorm, x, dt):
    """LayerNorm with f32 statistics, output in ``dt``."""
    return F.layer_norm(
        x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
        ln.eps,
    ).to(dt)


class Block(nn.Module):
    """Pre-LN transformer block with the JAX block's parameter names."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        C = config.n_embd
        self.config = config
        self.ln_1 = nn.LayerNorm(C, eps=config.ln_eps)
        self.c_attn = nn.Linear(C, 3 * C)
        self.c_proj = nn.Linear(C, C)
        self.ln_2 = nn.LayerNorm(C, eps=config.ln_eps)
        self.mlp_fc = nn.Linear(C, 4 * C)
        self.mlp_proj = nn.Linear(4 * C, C)

    def forward(self, x, *, layer: int, train: bool = False,
                decode: bool = False, pad_lens=None, prefill: bool = False,
                cache=None, slot_index=None, page_table=None, quant=None,
                int8_impl=None, rng: int | None = None):
        cfg = self.config
        B, T, C = x.shape
        H, D = cfg.n_head, cfg.head_dim
        step = decode and not prefill
        dt = cfg.compute_dtype(step)
        quant = quant or {}
        pre = f"h.{layer}."

        def dense(name, h):
            return _dense(getattr(self, name), h, dt, quant.get(pre + name),
                          int8_impl, rowwise=step)

        h = _layer_norm(self.ln_1, x, dt)
        qkv = dense("c_attn", h)
        q, k, v = qkv.split(C, dim=-1)
        q = q.reshape(B, T, H, D)
        k = k.reshape(B, T, H, D)
        v = v.reshape(B, T, H, D)
        if decode:
            if isinstance(cache, PagedKVCache):
                a = self._paged_attention(
                    q, k, v, pad_lens, cache, layer, slot_index, page_table
                )
            else:
                a = self._cached_attention(q, k, v, pad_lens, cache, layer)
        elif pad_lens is not None:
            a = _left_pad_attention(q, k, v, pad_lens)
        else:
            a = attention(q, k, v, causal=True, impl=cfg.attn_impl,
                          flash_bwd=cfg.flash_bwd)
        a = dense("c_proj", a.reshape(B, T, C))
        x = x + _dropout(a, cfg.dropout, train, rng, layer + 1, 0)

        h = _layer_norm(self.ln_2, x, dt)
        h = F.gelu(dense("mlp_fc", h), approximate="tanh")  # flax default
        h = dense("mlp_proj", h)
        return x + _dropout(h, cfg.dropout, train, rng, layer + 1, 1)

    def _paged_attention(self, q, k, v, pad_lens, cache, layer, slot_index,
                         page_table):
        """Paged KV attention (the serving engine's slot mode).

        Writes: row b's T new k/v land at logical columns
        ``slot_index[b] + t``, each routed to
        ``page_table[b, col // ps] * ps + col % ps`` of the flattened pool.
        Columns >= n_ctx and dead slots (zeroed tables) route to the trash
        page 0; their duplicate indices make the write order there
        undefined, which is harmless because nothing reads page 0.
        Reads: each row gathers its logical (n_ctx, H, D) view through its
        table and runs the same masked attention as the contiguous cache,
        over columns ``[pad_lens[b], slot_index[b] + t]``.
        """
        cfg = self.config
        B, T, H, D = q.shape
        pool_k, pool_v = cache.k[layer], cache.v[layer]
        n_pages, ps = pool_k.shape[0], pool_k.shape[1]
        pages_per_row = cfg.n_ctx // ps
        pos = slot_index[:, None] + torch.arange(T, device=q.device)[None, :]
        page = torch.gather(
            page_table, 1, torch.clamp(pos // ps, 0, pages_per_row - 1)
        )
        flat = torch.where(
            pos < cfg.n_ctx, page * ps + pos % ps, torch.zeros_like(pos)
        ).reshape(-1)
        # In place: the pool is the engine's persistent state.
        pool_k.view(n_pages * ps, H, D).index_put_(
            (flat,), k.reshape(B * T, H, D).to(pool_k.dtype)
        )
        pool_v.view(n_pages * ps, H, D).index_put_(
            (flat,), v.reshape(B * T, H, D).to(pool_v.dtype)
        )
        k_all = pool_k[page_table].reshape(B, cfg.n_ctx, H, D)
        v_all = pool_v[page_table].reshape(B, cfg.n_ctx, H, D)
        k_pos = torch.arange(cfg.n_ctx, device=q.device)
        valid = k_pos[None, None, None, :] <= pos[:, None, :, None]
        if pad_lens is not None:
            valid = valid & (
                k_pos[None, None, None, :] >= pad_lens[:, None, None, None]
            )
        return _decode_attention(q, k_all, v_all, valid)

    def _cached_attention(self, q, k, v, pad_lens, cache, layer):
        """Shared-index KV-cache attention: the T new k/v are written (in
        place) at ``cache.index`` and q attends over the cache behind a
        mask. A fresh-cache multi-token call (``index == 0``) takes the
        exact T x T path instead — the pluggable dispatch when dense (the
        flash kernel's entry on the serving path), the left-padded masked
        form when ragged; chunked prefill at ``index > 0`` and single-token
        decode run masked attention over the whole cache."""
        cfg = self.config
        B, T, H, D = q.shape
        ck, cv = cache.k[layer], cache.v[layer]
        start = cache.index
        ck[:, start:start + T] = k.to(ck.dtype)
        cv[:, start:start + T] = v.to(cv.dtype)
        if T > 1 and start == 0:
            if pad_lens is None:
                return attention(
                    q, k, v, causal=True, impl=cfg.attn_impl, needs_bwd=False
                ).to(q.dtype)
            return _left_pad_attention(q, k, v, pad_lens)
        q_pos = start + torch.arange(T, device=q.device)[:, None]
        k_pos = torch.arange(cfg.n_ctx, device=q.device)[None, :]
        valid = (k_pos <= q_pos)[None, None]
        if pad_lens is not None:
            valid = valid & (k_pos[None, None] >= pad_lens[:, None, None, None])
        return _decode_attention(q, ck, cv, valid)


class GPT2(nn.Module):
    """Token ids (B, T) → logits (B, T, vocab) f32. LM head tied to wte.

    Built from a seed with the Flax initialisers' distributions (normal(0.02)
    wte, normal(0.01) wpe, lecun-normal Dense kernels, zero biases, unit
    LayerNorm scales) on ``device`` (default ``cuda``; raises when CUDA is
    absent). ``models/convert.py`` loads JAX params instead. ``seed=None``
    allocates the weights on ``device`` uninitialised, for a caller that
    loads them (a checkpoint restore).
    """

    def __init__(self, config: GPT2Config = GPT2Config(), *,
                 seed: int | None = 0, device=None):
        super().__init__()
        if config.n_experts > 0:
            raise NotImplementedError(
                "MoE blocks (n_experts > 0) are not ported yet: ROADMAP "
                "Queue 1 item 14"
            )
        if config.remat_policy not in _REMAT_CONTEXT:
            raise NotImplementedError(
                f"remat_policy {config.remat_policy!r}: the port takes None "
                "(full remat) or 'dots'; other jax.checkpoint_policies "
                "names have no counterpart"
            )
        dev = resolve_device(device)
        self.config = config
        C = config.n_embd
        with torch.device("meta" if seed is None else "cpu"):
            self.wte = nn.Parameter(torch.empty(config.vocab_size, C))
            self.wpe = nn.Parameter(torch.empty(config.n_ctx, C))
            self.h = nn.ModuleList(Block(config)
                                   for _ in range(config.n_layer))
            self.ln_f = nn.LayerNorm(C, eps=config.ln_eps)
        if seed is None:
            self.to_empty(device=dev)
        else:
            self._init_weights(seed)
            self.to(dev)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        self.wte.normal_(0.0, 0.02, generator=g)
        self.wpe.normal_(0.0, 0.01, generator=g)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                variance_scaling_(m.weight, m.in_features, 1.0, g)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def init_cache(self, batch: int, *, device=None) -> KVCache:
        """Zeroed shared-index cache for ``batch`` rows, on ``device``
        (None: the model's)."""
        cfg = self.config
        shape = (batch, cfg.n_ctx, cfg.n_head, cfg.head_dim)
        return KVCache(*self._zeros(shape, device))

    def init_paged_cache(self, n_pages: int, page_size: int, *,
                         device=None) -> PagedKVCache:
        """Zeroed paged pool of ``n_pages`` pages of ``page_size`` tokens,
        on ``device`` (None: the model's)."""
        cfg = self.config
        if page_size < 1 or cfg.n_ctx % page_size:
            raise ValueError(
                f"page_size must divide n_ctx={cfg.n_ctx}, got {page_size}"
            )
        shape = (n_pages, page_size, cfg.n_head, cfg.head_dim)
        return PagedKVCache(*self._zeros(shape, device))

    def _zeros(self, shape, device=None):
        dt = self.config.kv_cache_dtype()
        dev = self.device if device is None else device
        return [
            [torch.zeros(shape, dtype=dt, device=dev)
             for _ in range(self.config.n_layer)]
            for _ in range(2)
        ]

    def forward(self, tokens, *, train: bool = False, decode: bool = False,
                cache=None, pad_lens=None, prefill: bool = False,
                slot_index=None, page_table=None, quant=None,
                int8_impl=None, rng: int | None = None):
        """Logits (B, T, vocab) f32; in decode mode ``(logits, cache)``.

        ``decode=True`` runs against ``cache`` (a fresh ``KVCache`` when
        None): a ``KVCache`` continues from its shared index, a
        ``PagedKVCache`` needs ``slot_index`` (B,) per-row positions and
        ``page_table`` (B, n_ctx / page_size). ``pad_lens`` (B,) marks
        LEFT-padded rows (positions shift down, pad keys are masked).
        ``prefill=True`` marks prompt ingestion: it keeps the training
        dtype, while single-token steps run in ``decode_dtype``. ``quant``
        maps Dense names (``h.<i>.c_attn``, ...) and ``wte_q`` to
        ``QuantLeaf``s: those matmuls run the W8A8 int8 kernel.
        ``train=True`` turns dropout on, drawing its masks from ``rng`` (an
        int seed), and remats the blocks when the config asks for it.
        """
        cfg = self.config
        B, T = tokens.shape
        dev = self.wte.device
        ar = torch.arange(T, device=dev)
        if decode:
            if cache is None:
                cache = self.init_cache(B)
            if isinstance(cache, PagedKVCache):
                if slot_index is None or page_table is None:
                    raise ValueError(
                        "a PagedKVCache needs slot_index and page_table"
                    )
                base = slot_index[:, None] + ar[None, :]
                if pad_lens is not None:
                    base = base - pad_lens[:, None]
                pe = self.wpe[torch.clamp(base, 0, cfg.n_ctx - 1)]
            elif slot_index is not None:
                raise NotImplementedError(
                    "contiguous slot-row caches (the JAX engine's paged=False "
                    "reference) are not ported; pass a PagedKVCache"
                )
            elif pad_lens is not None:
                positions = cache.index + ar[None, :] - pad_lens[:, None]
                pe = self.wpe[torch.clamp(positions, 0, cfg.n_ctx - 1)]
            else:
                pe = self.wpe[cache.index:cache.index + T]
        elif pad_lens is not None:
            positions = ar[None, :] - pad_lens[:, None]
            pe = self.wpe[torch.clamp(positions, 0, cfg.n_ctx - 1)]
        else:
            pe = self.wpe[:T]
        dt = cfg.compute_dtype(decode and not prefill)
        x = self.wte[tokens].to(dt) + pe.to(dt)
        x = _dropout(x, cfg.dropout, train, rng, 0)
        for i, block in enumerate(self.h):
            kw = dict(
                layer=i, train=train, decode=decode, pad_lens=pad_lens,
                prefill=prefill, cache=cache, slot_index=slot_index,
                page_table=page_table, quant=quant, int8_impl=int8_impl,
                rng=rng,
            )
            if train and cfg.remat and torch.is_grad_enabled():
                x = _remat(block, x, cfg.remat_policy, **kw)
            else:
                x = block(x, **kw)
        x = _layer_norm(self.ln_f, x, dt)
        head = (quant or {}).get("wte_q")
        if head is not None:
            # Native int8 LM head: per-vocab-row scales, wte read in place.
            logits = int8_matmul(
                x, head.q, head.scale, w_contract_last=True,
                out_dtype=torch.float32, impl=int8_impl,
            )
        else:
            # Tied head, f32 logits; decode steps run it row by row, like
            # the Dense layers.
            logits = _tied_head(x, self.wte, dt, decode and not prefill)
        if not decode:
            return logits
        if isinstance(cache, KVCache):
            cache.index += T
        return logits, cache
