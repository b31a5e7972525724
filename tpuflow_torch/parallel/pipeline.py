"""Pipeline parallelism: the GPipe microbatch schedule over the ``stage``
axis (counterpart of ``tpuflow/parallel/pipeline.py``).

The JAX package stacks GPT-2's blocks on a leading layer axis
(``scan_layers``) and shards that axis over ``stage``
(``gpt2_pipeline_shardings``): each stage owns ``n_layer / S``
contiguous layers, the rows [s L / S, (s + 1) L / S) of every ``h/block``
leaf, and nothing else of the blocks. Here each stage's process holds
those blocks alone (``keep_stage_blocks``; the checkpoint tree stacks
them into its block of each leaf, ``parallel/sharding.py``'s pipeline
rule), and ``wte``, ``wpe`` and ``ln_f`` whole.

The schedule (``make_pipeline_loss``, the JAX ``spmd`` body :87-160):
the data shard's ``Bd`` rows are cut into M microbatches, microbatch m
the rows [m Bd / M, (m + 1) Bd / M). ``M + S - 1`` ticks run; at tick t
stage 0 embeds microbatch t (t < M), every stage runs its layers on what
it holds where that is real data (ticks [s, s + M)), the last stage runs
``ln_f`` and the tied head on microbatch t - (S - 1) and takes its mean
cross-entropy, and every stage hands its activation to the next through
``p2p.ppermute`` (no wraparound). A stage's MoE load-balance losses count
at its valid ticks only. The process's cell of the JAX (S, D)
contribution grid is its summed losses plus its summed aux, and the loss
is the sum of the cells over the world divided by D M (:167).

The JAX body computes the embedding and the head on every stage and
selects by ``where``; the port runs them where they count (stage 0, the
last stage) and skips a stage's layers at its bubble ticks, passing what
it holds on. The arithmetic of what counts is the same. Gradients flow
back through the shifts (the backward of ``ppermute`` is the reverse
shift), so every process must run the same shifts in the same order in
its backward too: each process's objective depends on every shift it
took part in (a stage 0 adds zero times what it receives, the final
activation enters times zero), so autograd runs each shift's backward on
every process, in tick order reversed.

Dropout is off (the JAX body applies its blocks with ``train=False``),
so nothing is rematerialized either.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpuflow_torch.parallel.p2p import AxisGroup, ppermute

AXIS_STAGE = "stage"


def stage_layers(n_layer: int, stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``stages`` holds."""
    if n_layer % stages:
        raise ValueError(f"n_layer={n_layer} not divisible by "
                         f"stage={stages}")
    per = n_layer // stages
    return range(stage * per, (stage + 1) * per)


def keep_stage_blocks(model, mesh) -> range:
    """Drop from ``model`` (a GPT-2) every block but this process's
    stage's (in place); returns the layers kept."""
    layers = stage_layers(model.config.n_layer, mesh.shape[AXIS_STAGE],
                          mesh.coord(AXIS_STAGE))
    model.h = torch.nn.ModuleList(model.h[i] for i in layers)
    return layers


def make_pipeline_loss(
    stage_apply: Callable,
    embed: Callable,
    head_loss: Callable,
    *,
    mesh,
    n_microbatches: int,
    width: int,
    dtype: torch.dtype = torch.float32,
    data_axis: str = "data",
) -> Callable:
    """Build ``loss(tokens, targets) -> (cell, loss)`` over a
    ``{"data": D, "stage": S}`` mesh (a ``dist.Mesh``).

    - ``stage_apply(x) -> (x, aux)``: this stage's layers on an
      activation, with the sum of their auxiliary losses (0 for plain
      blocks, the MoE load-balance losses for expert blocks);
    - ``embed(tokens) -> x``: the stage-0 ingress, (b, T) ids to
      (b, T, ``width``) activations of ``dtype``;
    - ``head_loss(x, targets) -> scalar``: the last stage's egress, the
      mean loss over a microbatch's tokens.

    ``tokens``/``targets``: this data shard's (Bd, T) rows, the same on
    every stage. ``cell`` is this process's contribution divided by D M,
    differentiable: every process calls ``cell.backward()``, and the
    gradients summed over the processes that hold each parameter are the
    gradient of ``loss``, the mean over the microbatches and data shards
    (the world's sum of the cells; the same bits on every process).
    """
    from tpuflow_torch.dist.mesh import world_sum

    S = mesh.shape.get(AXIS_STAGE, 1)
    D = mesh.shape.get(data_axis, 1)
    M = n_microbatches
    if S < 2:
        raise ValueError(f"pipeline needs >=2 stages, mesh has {S}")
    peers = AxisGroup.of(mesh, AXIS_STAGE)
    sid = mesh.coord(AXIS_STAGE)
    right = [(i, i + 1) for i in range(S - 1)]

    def loss(tokens, targets):
        Bd, T = tokens.shape
        if Bd % M:
            raise ValueError(f"per-data-shard batch {Bd} not divisible by "
                             f"M={M}")
        x_mb = tokens.reshape(M, Bd // M, T)
        y_mb = targets.reshape(M, Bd // M, T)
        # Before anything arrives a stage holds zeros that ask for a
        # gradient, so that every shift's output does on every stage.
        zeros = torch.zeros((Bd // M, T, width), dtype=dtype,
                            device=tokens.device, requires_grad=True)
        loss_acc = aux_acc = torch.zeros((), device=tokens.device)
        state, y = None, zeros
        for t in range(M + S - 1):
            if sid == 0:
                x = embed(x_mb[t]) if t < M else zeros
                if state is not None:
                    # Zero times what stage 0 receives: its objective then
                    # depends on every shift, whose backward it must join.
                    x = x + state * 0.0
            else:
                x = zeros if state is None else state
            if sid <= t < sid + M:
                y, aux = stage_apply(x)
                aux_acc = aux_acc + aux
                if sid == S - 1:
                    loss_acc = loss_acc + head_loss(y, y_mb[t - (S - 1)])
            else:
                y = x  # a bubble: what the stage holds passes on
            if t < M + S - 2:
                state = ppermute(y, peers, right)
        cell = loss_acc + aux_acc + (y * 0.0).sum()
        total = world_sum(cell.detach().float().reshape(1))[0] / (D * M)
        return cell / (D * M), total

    return loss


def gpt2_pipeline_loss(model, *, mesh, n_microbatches: int) -> Callable:
    """Pipeline-parallel LM loss for this stage's GPT-2 ``model`` (its
    blocks kept by ``keep_stage_blocks``, ``wte``/``wpe``/``ln_f`` whole)
    on ``mesh``: ``loss(tokens, targets) -> (cell, loss)`` (see
    ``make_pipeline_loss``). The layers run in inference mode (dropout
    off, as the JAX adapter's ``train=False``); the head is the model's
    tied LM head with f32 logits and the mean cross-entropy of the
    non-pipelined step."""
    from tpuflow_torch.models.gpt2 import _layer_norm, _tied_head
    from tpuflow_torch.models.losses import cross_entropy_loss

    cfg = model.config
    if not cfg.scan_layers:
        raise ValueError("pipeline params require "
                         "GPT2Config(scan_layers=True)")
    S = mesh.shape.get(AXIS_STAGE, 1)
    layers = stage_layers(cfg.n_layer, S, mesh.coord(AXIS_STAGE))
    if len(model.h) != len(layers):
        raise ValueError(f"the model holds {len(model.h)} blocks, stage "
                         f"{mesh.coord(AXIS_STAGE)} owns {len(layers)}")
    dt = cfg.compute_dtype(False)

    def stage_apply(x):
        aux = 0.0
        for i, block in zip(layers, model.h):
            x, a = block(x, layer=i, train=False)
            if a is not None:
                aux = aux + a
        return x, aux

    def embed(tokens):
        T = tokens.shape[1]
        return model.wte[tokens].to(dt) + model.wpe[:T].to(dt)

    def head_loss(x, targets):
        x = _layer_norm(model.ln_f, x, dt)
        return cross_entropy_loss(_tied_head(x, model.wte, dt, False),
                                  targets)

    return make_pipeline_loss(stage_apply, embed, head_loss, mesh=mesh,
                              n_microbatches=n_microbatches,
                              width=cfg.n_embd, dtype=dt)


def gpt2_pipeline_shardings(params: dict) -> dict:
    """The specs of a GPT-2 scan-layout tree under pipeline parallelism
    (``tpuflow/parallel/pipeline.py::gpt2_pipeline_shardings``): the
    stacked blocks split over ``stage`` on their layer axis, the rest
    replicated. ``params``: nested dicts of anything with a ``shape``."""
    from tpuflow_torch.ckpt.raw import flatten, unflatten
    from tpuflow_torch.parallel.sharding import pipeline_spec

    return unflatten((names, pipeline_spec(names, getattr(leaf, "shape", ())))
                     for names, leaf in flatten(params))
