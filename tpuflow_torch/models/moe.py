"""Switch-style Mixture-of-Experts MLP (counterpart of
``tpuflow/models/moe.py``).

Top-1 routing written, as in the JAX package, as dense one-hot products
with static shapes:

- the router is a Dense layer in f32 whatever the block's dtype, a
  softmax over the experts, and each token's expert the argmax (the first
  index on ties);
- each expert takes at most ``max(1, int(-(-T * capacity_factor // E)))``
  tokens of a batch row, in the row's order (a cumsum over T); the tokens
  past it are dropped and their MoE output is 0 (the residual carries
  them);
- the dispatch and combine tensors are (B, T, E, capacity), cast to the
  block's dtype: the one-hot dispatch carries no gradient, the combine
  weights carry the router's;
- each expert is a tanh-GELU MLP, its weights raw parameters ``w1``
  (E, C, F), ``b1`` (E, F), ``w2`` (E, F, C), ``b2`` (E, C), laid out as
  the Flax ones (the router ``gate`` is an ``nn.Linear``, whose weight is
  the transposed Flax kernel);
- the Switch load-balance loss ``aux_weight * E * sum_e(frac_e *
  mean_prob_e)``, returned beside the output (the JAX module sows it).

The expert products are ``torch.einsum``: the JAX package writes them as
XLA einsums, not as kernels of its own.

Sharded (``tp``, ``parallel/tensor.py``): each process of the expert group
runs its E / e experts (their FFN dim split over ``tensor``), the partial
outputs summed over the groups; the load-balance loss takes ``frac`` and
``mean_prob`` over the FSDP group's whole batch before their product (the
loss is not linear in a split of the batch: a mean of the processes'
losses would differ from the JAX package's). The capacity counts a row's
tokens, so a split of the batch leaves it as it is.

On a ``seq`` axis (``tp.seq``) each process holds block c of every row's
sequence, and the JAX routing is over the whole row: the capacity is
taken from the whole T, and a token's slot in its expert's buffer counts
the row's tokens routed there before it, the preceding blocks' included
(their per-row, per-expert counts all-gathered over the ``seq`` group
and added to the block's cumsum). Each process then runs the experts on
its own tokens' slots. The load-balance loss's means run over the
``seq`` group too.

Serving (``forward(..., step=True)``: a decode step or a speculative
verify chunk of the KV-cache path). The exactness contract:

- an expert's capacity counts the T of ONE call, and a token's slot is a
  cumsum over its row's T. So the serving engine's left-padded bucket of
  width W (the pads come first and take slots), a chunked prefill, a
  prefix-cache hit that prefills only the suffix and a verify chunk of
  K + 1 tokens each route their own T, and may drop other tokens than a
  solo ``generate()`` of the same prompt. The port runs every call as it
  comes, as the JAX package does: its oracle is the JAX package under the
  same call structure (the same engine submissions, the same
  ``speculative_generate`` call), not solo ``generate()`` wherever T
  differs;
- a decode step has T = 1, so its capacity is 1 and every decode token is
  kept; capacity and slots are per row. A request's tokens therefore do
  not depend on which other requests share the engine, provided no
  product depends on how many rows share the call: a step routes the
  whole call (every routing op is per token or per row), then runs the
  router's product and each token's expert one (row, position) at a time
  (the dense layers' ``models/gpt2.py::_tokenwise`` rule), its expert's
  weights gathered on the card, so every product has M = 1;
- the fused-native int8 router (``gate_q``, the JAX interceptor's W8A8
  Dense) runs the whole call through ``ops/int8_matmul.py``: its sums are
  exact at any M. The expert weights stay float under int8, as in the JAX
  package.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuflow_torch.ops.int8_matmul import int8_matmul


def capacity(T: int, capacity_factor: float, n_experts: int) -> int:
    """Tokens an expert takes of a row of ``T``: the JAX expression, in
    Python float floor division."""
    return max(1, int(-(-T * capacity_factor // n_experts)))


class MoEMLP(nn.Module):
    """(B, T, C) → ((B, T, C), aux) through ``n_experts`` expert MLPs.
    ``tp``: the layer's place in a sharded model (None: whole)."""

    tp = None

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 capacity_factor: float = 1.25, aux_weight: float = 1e-2):
        super().__init__()
        E = n_experts
        self.n_experts = E
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        self.gate = nn.Linear(d_model, E)
        self.w1 = nn.Parameter(torch.empty(E, d_model, d_ff))
        self.b1 = nn.Parameter(torch.empty(E, d_ff))
        self.w2 = nn.Parameter(torch.empty(E, d_ff, d_model))
        self.b2 = nn.Parameter(torch.empty(E, d_model))

    @torch.no_grad()
    def init_experts(self, g: torch.Generator) -> None:
        """The Flax initialisers of the expert weights: normal(0.02) for
        ``w1``/``w2``, zero biases (the router is a Dense layer, set by
        the model's Dense rule)."""
        self.w1.normal_(0.0, 0.02, generator=g)
        self.w2.normal_(0.0, 0.02, generator=g)
        self.b1.zero_()
        self.b2.zero_()

    def gate_logits(self, x, *, step: bool = False, gate_q=None,
                    int8_impl=None):
        """The router's f32 logits (B, T, E) for ``x`` (B, T, C). ``gate_q``
        (a ``QuantLeaf``): the W8A8 int8 matmul over the whole call plus
        the f32 bias; else an f32 product, one (row, position) at a time
        on a decode ``step``."""
        b = self.gate.bias.float()
        if gate_q is not None:
            return int8_matmul(x.float(), gate_q.q, gate_q.scale,
                               out_dtype=torch.float32, impl=int8_impl) + b
        w = self.gate.weight.float()
        if step:
            from tpuflow_torch.models.gpt2 import _tokenwise

            return _tokenwise(lambda r: F.linear(r, w, b), x.float())
        return F.linear(x.float(), w, b)

    def route(self, x, seq=None, **gate):
        """The routing of ``x`` (B, T, C), in f32: the softmax
        probabilities (B, T, E), each token's expert one-hot (B, T, E),
        and the (B, T, E, cap) dispatch (0/1) and combine (dispatch x
        probability) tensors. ``seq`` (a ``p2p.AxisGroup``): ``x`` is
        block c of rows of s T tokens (see the module docstring);
        ``gate``: ``gate_logits``'s keywords."""
        B, T, _ = x.shape
        E = self.n_experts
        cap = capacity(T if seq is None else T * seq.size,
                       self.capacity_factor, E)
        probs = torch.softmax(self.gate_logits(x, **gate), dim=-1)
        onehot = F.one_hot(probs.argmax(-1), E).float()
        # Position of each token inside its expert's buffer.
        seen = torch.cumsum(onehot, dim=1)
        if seq is not None:
            from tpuflow_torch.parallel.p2p import gather

            counts = gather(onehot.sum(dim=1)[None], seq.group, 0)
            seen = seen + counts[:seq.rank].sum(dim=0)[:, None, :]
        pos = (seen - 1.0) * onehot
        keep = onehot * (pos < cap)
        # A position past the buffer is dropped by keep; clamp it first,
        # as one_hot takes no index out of range.
        pos_oh = (F.one_hot(pos.long().clamp(0, cap - 1), cap)
                  * keep[..., None])
        return probs, onehot, pos_oh, pos_oh * probs[..., None]

    def forward(self, x, dtype=None, *, step: bool = False, gate_q=None,
                int8_impl=None):
        """``x`` (B, T, C) in the block's dtype ``dtype`` (default: x's) →
        (output (B, T, C) in that dtype, the f32 load-balance loss).
        ``step``: a decode call (see the module docstring); its loss is
        None. ``gate_q``, ``int8_impl``: the fused-native int8 router."""
        dt = x.dtype if dtype is None else dtype
        E = self.n_experts
        tp = self.tp
        seq = getattr(tp, "seq", None)
        probs, onehot, pos_oh, combine = self.route(
            x, seq, step=step, gate_q=gate_q, int8_impl=int8_impl)
        if step:
            return self._tokenwise_experts(x, dt, onehot, combine), None
        groups = [g for g in (getattr(tp, "fsdp_group", None),
                              None if seq is None else seq.group)
                  if g is not None]
        if not groups:
            frac = onehot.mean(dim=(0, 1))
            mean_prob = probs.mean(dim=(0, 1))
        else:
            from tpuflow_torch.parallel.tensor import all_reduce_sum

            # The two means over the whole batch of the FSDP group and the
            # seq group.
            n = torch.full((1,), float(probs.shape[0] * probs.shape[1]),
                           device=probs.device)
            sums = torch.cat([onehot.sum(dim=(0, 1)), probs.sum(dim=(0, 1)),
                              n])
            for group in groups:
                sums = all_reduce_sum(sums, group)
            frac, mean_prob = sums[:E] / sums[-1], sums[E:2 * E] / sums[-1]
        aux = self.aux_weight * E * torch.sum(frac * mean_prob)
        if tp is not None and (tp.t > 1 or tp.e > 1):
            return self._sharded(x, dt, pos_oh, combine), aux
        dispatch, combine = pos_oh.to(dt), combine.to(dt)
        x = x.to(dt)
        xin = torch.einsum("btec,btm->ebcm", dispatch, x)
        h = F.gelu(torch.einsum("ebcm,emf->ebcf", xin, self.w1.to(dt))
                   + self.b1.to(dt)[:, None, None, :], approximate="tanh")
        out = (torch.einsum("ebcf,efm->ebcm", h, self.w2.to(dt))
               + self.b2.to(dt)[:, None, None, :])
        return torch.einsum("btec,ebcm->btm", combine, out), aux

    def _tokenwise_experts(self, x, dt, onehot, combine):
        """The expert MLPs of a decode call, one (row, position) at a
        time: each token through its own expert alone (the weights
        gathered by the expert's index on the card, no host sync), scaled
        by its combine weight, the router probability when the token was
        kept and 0 when its expert was full. The einsum form's combine
        sums one nonzero term, so this is that product."""
        B, T, _ = x.shape
        expert = onehot.argmax(dim=-1)
        weight = combine.sum(dim=(2, 3)).to(dt)
        w1, b1, w2, b2 = (p.to(dt) for p in (self.w1, self.b1, self.w2,
                                              self.b2))
        x = x.to(dt)
        out = torch.empty_like(x)
        for b in range(B):
            for t in range(T):
                e = expert[b, t:t + 1]
                h = F.linear(x[b, t:t + 1], w1.index_select(0, e)[0].t(),
                             b1.index_select(0, e)[0])
                h = F.gelu(h, approximate="tanh")
                o = F.linear(h, w2.index_select(0, e)[0].t(),
                             b2.index_select(0, e)[0])
                out[b, t] = weight[b, t] * o[0]
        return out

    def _sharded(self, x, dt, pos_oh, combine):
        """The output of this process's experts (E / e of them, their FFN
        dim split over ``tensor``), summed over the tensor and expert
        groups."""
        tp = self.tp
        n = self.n_experts // tp.e
        lo = tp.expert_rank * n
        dispatch = pos_oh[:, :, lo:lo + n].to(dt)
        # Each expert peer's combine gradient covers its own experts.
        combine = tp.copy_to(combine, "expert")[:, :, lo:lo + n].to(dt)
        # The expert inputs' gradient is partial over both groups; the
        # router's (from x directly) is the same on every peer.
        src = tp.copy_to(tp.copy_to(x.to(dt), "expert"), "tensor")
        xin = torch.einsum("btec,btm->ebcm", dispatch, src)
        w1, b1 = tp.view("moe.w1", self.w1), tp.view("moe.b1", self.b1)
        w2, b2 = tp.view("moe.w2", self.w2), tp.view("moe.b2", self.b2)
        h = F.gelu(torch.einsum("ebcm,emf->ebcf", xin, w1.to(dt))
                   + b1.to(dt)[:, None, None, :], approximate="tanh")
        out = tp.reduce_from(torch.einsum("ebcf,efm->ebcm", h, w2.to(dt)),
                             "tensor")
        out = out + b2.to(dt)[:, None, None, :]
        return tp.reduce_from(torch.einsum("btec,ebcm->btm", combine, out),
                              "expert")
