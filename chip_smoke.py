#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpuflow_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches an error and carries on):

1. The card's name and power limit (``nvidia-smi``).
2. Build every kernel library from ``tpuflow_torch/csrc`` (one ``nvcc`` per
   source, started together) and print the build seconds.
3. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes — the flash forward within a stated
   tolerance, the W8A8 int8 matmul bit for bit, the flash forward with lse
   and the fused and split backward pairs (dq, dk/dv) within stated
   tolerances and bit-equal over two runs, the split pair bit-equal to the
   fused one — with the kernel's, the plain version's and one PyTorch
   library call's device times (profiler trace, L2 flushed before every
   launch), the least time the card could take and the kernel's share of
   it. The backward phase runs f32 and bf16 at both prefill shapes and at
   the training shape; the int8 phase also counts the kernels one call
   launches at M = 8. The head-dim phase runs the forward without and
   with lse and both backward pairs at D = 96 (zero-padded to the 128
   kernels), D = 256 and D = 512 (the wide-head kernels), f32 and bf16,
   at (1, 1024, 12, D),
   against the plain versions at the true D, the split pair bit-equal to
   the fused one, each time beside its bound and the D = 64 kernels'; at
   D = 512 also beside the plain versions' and SDPA's times.
   Then the no-lse forward, the forward with lse and both backward pairs
   at the ViT leg's attention shape (64, 197, 6, 64), not causal, f32 and
   bf16, within the same tolerances.
4. Serving slice on GPT-2 124M at full width, weights random from a seed:
   ``generate()`` on a 512-token dense prompt (its prefill must launch the
   flash kernel once per layer), then a paged ``ServeEngine`` answering
   fp and int8 requests, each held equal to a solo ``generate()``. Then
   disaggregated serving (``disagg_leg``): a prefill-role and a
   decode-role engine (8 slots, pages of 16) share a page-set store under
   ``build/``; exact ships of three prompts of 200-600 tokens, fp and
   int8, imported with no prefill and no flash launch on the decode
   engine; a suffix resume; a torn set's fallback; three feed admissions
   (the fp ship prompts again) whose pages promote from a host tier after
   a churn prompt evicted them. Every request held to a solo ``generate()`` on its numeric path,
   every part's flash and int8-tile launches to the counts the code
   implies; ship, load and import seconds, MB/s, and a shipped
   admission's TTFT beside a local one. Then the serving replica
   (``replica_leg``): ``serve_forever(http_port=0)`` on the main thread
   over an engine of 8 slots, pages of 16 and a store under ``build/``;
   client threads read ``generate_url`` off ``/status`` (the port's
   fleet observatory over the registration) and send, through
   ``http_forward``, the engine check's fp prompts, a replay of one id, a
   ``{"phase": "prefill"}`` ship hop and a forward of its ``kv_key``;
   then eight requests fill the slots, a ninth queues, and a real SIGTERM
   drains the loop: the ninth answers 503 "drained", every 200 answer
   equals its solo ``generate()``, ``/metrics`` parses with the
   ``tpuflow_serve_*`` gauges, the ledger's buckets sum to the loop's
   wall within 1%, and the flash launches are 12 per prefill whose
   prompt takes the flash path (the ship hop's included; none for the
   import). The SIGTERM handler and the preemption flag are put back.
5. Generation slice on the same model (``generation_phase``): beam search
   (K = 1 equal to greedy; K = 4 prefilled once at width B, its scores
   against ``sequence_logprob`` on the flash forward; the fused-native
   model on both int8 tiles), ``speculative_generate`` at batch 1 and 4,
   fp and fused-native, equal to ``generate()``, the engine's speculative
   verify with fp and int8 requests mixed, each equal to its solo
   ``generate()``, weight-only int8 against the fp model loaded with its
   dequantized leaves (bytes, teacher-forced agreement, decode ms a token
   of fp, weight-only and fused-native), and ``GenerationPredictor`` over
   ragged rows (the engine route) and a speculative int8 dense batch.
   Each leg's launches are read from zero; walls beside the card's name.
6. Training slice: ``train_gpt`` trains GPT-2 124M (full remat, dropout
   0.1, AdamW, f32) for 2 epochs of 8 steps at batch 8 x 1024 with the
   flash kernels; every loss finite, the last below the first and the
   second epoch's mean below the first's, each kernel launched the number
   of times the code implies. Then the same call with ``health=False``
   (no monitor; the fence's one host copy stays): its 16 losses bit-equal
   to the first call's, and both calls' step ms side by side, the
   monitor's cost. Then two steps under the profiler
   (device busy share, top kernels), and one forward+backward with flash
   against the einsum attention (dropout off, TF32 off): loss and every
   gradient within stated tolerances. Then the bf16 leg: the same call
   with ``dtype="bfloat16"`` for one epoch of 8 steps, the flash kernels
   on their tensor-core variants: every loss finite, exact launch counts
   (the bf16 ones included), its step ms and tokens/s.
7. Split + checkpoint leg: the same ``train_gpt`` call with the split
   backward and a checkpoint directory (saves at steps 8 and 16): its 16
   losses bit-equal to step 6's, exact launch counts. Resume leg: the same
   call on a copy of that directory without ``step_16``: an in-run resume
   from step 8, its 8 losses bit-equal to the split leg's last 8 and a
   ``step_16`` whose every shard crc32 equals the split leg's. Both legs
   run with the manager's prewarms on, and the records say what they
   did: every save drew from the pool each shard of 64 KiB or more where
   the manager prewarms it (memory-backed storage) and none on a disk,
   where it writes no warm files; the resume's restore took one
   prewarmed, page-locked buffer a leaf and handed every leaf out
   pinned, and the host allocator held less than the restored bytes
   after it. Save and restore seconds and GB/s (host disk of this
   machine). Then the same state's checkpoint taken
   apart outside training (``ckpt_io_phase``): (a) the disk's own fsync
   write rate at 1, 4 and 8 files at once, cold and warm reads and crc32
   at 1 and 8 threads; (b) saves to fresh files, to a prewarmed pool and
   three steady-state saves onto recycled files (every shard of 64 KiB or
   more drawn from the pool; manifests and crc32s equal); (c) restores in
   the parent's serial order, threaded cold and warm, into a prewarmed
   arena, pageable and pinned (one buffer a leaf taken; pinned tensors),
   and zero-copy, each bit-equal to the saved state; (d) the copy of the
   restored state onto the card from pageable, pinned and mapped buffers;
   (e) (b)-(d) on ``/dev/shm`` where it holds four copies of the state,
   else one line saying why not. Each with the card's name and power
   limit. The directories live under ``build/`` and are deleted at the
   end.
8. The README main path: ``train_fashion_mnist`` (the FashionMNIST MLP at
   784 -> 512 -> 512 -> 10, 3 epochs at batch 32, lr 1e-3, on the
   full-size synthetic set, per-epoch checkpoints): every val_loss
   finite, the third below the first, the best accuracy above a floor,
   the retained steps the manager's policy; a warm start from its
   checkpoint whose first val_loss is below the cold run's first; an
   in-run resume from a copy of its storage without the newest step that
   trains the last epoch only, with bit-equal metrics and shard crc32s;
   ``TorchPredictor`` + ``map_batches`` over the 10,000 test rows at
   batch 512, its misclassified count against the best epoch's accuracy.
   No kernel of the port runs on it (every counter must read 0). Then
   its numbers: step ms and samples/s, the epoch's wall, the device's
   busy share and kernels a step under the profiler, the checkpoint's
   save and restore seconds, eval rows/s.
9. The flow layer on the card through the flow CLIs' ``main(argv)``
   (``flow_phase``): the README contract (``TorchTrain`` 2 epochs on the
   full-size synthetic set, a ``--from-run`` warm start whose first
   val_loss is below run 1's, a triggered ``TorchEval`` at batch 512 whose
   count matches the best accuracy and whose card holds "Error analysis",
   a pathspec eval, the "no checkpoint source" error; no kernel launches),
   then ``TorchGptTrain`` at GPT-2 124M width on the flash kernels (exact
   launch counts, a finite last loss) and the triggered ``TorchGptEval``
   with ``--beam-size 4`` (a finite test loss, the beam sample on its
   card, exact no-lse launches). Each flow's wall, the
   wrapped call's wall and the flow layer's overhead, the GPT step ms
   inside the flow, ``profile.json``'s device and peak bytes.
10. The image phase: ResNet-18 / CIFAR-10 through the flows
   (``resnet18_flow_leg``: ``TorchTrain --model resnet18 --dataset
   cifar10`` 2 epochs on 10,000 synthetic train rows, a ``--from-run``
   warm start below run 1's first val_loss, the triggered ``TorchEval``
   over the 10,000 test rows and its card; no kernel launches); ResNet-50
   / imagenet_synth at 224 x 224, 1000 classes, global batch 64 through
   ``train_model`` (2 epochs, ``batch_stats`` in the checkpoint, a
   bit-exact in-run resume of metrics and shard crc32s), then its step
   ms, steps/s, images/s, peak memory and device busy share with cuDNN's
   TF32 off and on; ViT-S/16 / imagenet_synth on the flash kernels (f32,
   TF32 off): exact launch counts of the forward with lse and the fused
   pair for the steps taken and of the no-lse forward in validation and
   in the predictor, and one step's loss and gradients against
   ``attn_impl="xla"`` within the GPT step-parity limits.
11. The training recipes (``recipes_phase``), each leg GPT-2 124M at full
   depth and width, 2 epochs of 4 steps at 8 x 1024, f32, flash, full
   remat, its flash launches exact: (a) Lion and (b) Adafactor, each
   learning (the last epoch's mean loss below the first step's) and
   resumed in-run from its first epoch's checkpoint bit for bit (losses
   and shard crc32s), (b) with the optimizer state's bytes against
   AdamW's; (c) Switch MoE (8 experts, capacity 1.25, aux weight 1e-2,
   AdamW; at 6 of the 12 layers, ``MOE_LAYERS``) the same, the summed
   load-balance loss finite and above 0, its checkpoint's size and
   rates; (d) ``lm_text`` on this checkout's
   README.md: learning, the ``text_source`` sha256, a greedy byte-level
   sample from "The "; (e) ``TorchGptTrain --optimizer adafactor
   --experts 8 --dataset lm_text`` (2 x 2 steps) and the triggered
   ``TorchGptEval`` rebuilding the MoE model, checking the corpus and
   scoring it; (f) the 124M weights through ``params_to_hf_state_dict``
   and ``hf_gpt2_to_params``: bit-equal, equal logits; (g) the flash
   kernels against ``xla_attention`` at T 128-4096, (8, T, 12, 64),
   causal, f32 and bf16, forward, forward+backward and backward alone
   (medians of interleaved runs), the crossovers written to a tuning file that
   ``resolve_attention_impl`` must read back exactly. Each leg's step
   ms, tokens/s and wall beside the card's name and power limit.
12. GPT-2-medium FSDP (``fsdp_phase``): 1024 wide, 16 heads, at 3 of
   its 24 layers (a depth cut for the time limit, ``FSDP_LAYERS``),
   trained by two ranks, each a process of its own, sharing
   the one card over gloo (the mode the probe fixed, ``--gloo-probe``:
   ``FSDP_BACKEND``), the state sharded over them by the JAX rule;
   2 epochs of 2 steps at 8 x 1024, f32, flash, full remat, AdamW, a
   checkpoint each epoch. (a) The flash kernels at a rank's attention
   shape (4, 1024, 16, 64) against their plain versions with their
   times; (b) learning, each rank's flash launches exact, the state
   sharded (each rank about half the parameter and moment bytes), the
   ranks' metrics bit-equal; step ms, tokens/s, each rank's peak memory,
   the save GB/s a rank, and the collectives timed alone at a step's
   volume; (c) the epoch-1 checkpoint's merged manifest on the JAX
   rule's shards and every shard's crc32, an in-run resume at K = 2 bit
   for bit (losses, the last step's crc32s), and at K' = 1, one process,
   every leaf restored bit-equal and the epoch-2 losses within 1e-4
   relative; (d) the first step's loss and gradients on one device
   within the step-parity limits of the sharded step's; (e)
   ``TorchGptTrain`` at 124M as a two-member gang on the card (each
   member's ``heartbeat_<i>`` file holding its last trained step) and
   ``TorchGptEval`` from it at one process, its flash launches exact.
13. GPT-2 124M at full width, 3 of its 12 layers (a depth cut for the
   time limit, ``TP_LAYERS``), on the tensor and expert axes
   (``tp_phase``): four ranks, each a process of its own that runs both
   legs in turn, sharing the card over gloo (the probe's mode; it also
   holds ``all_reduce``);
   2 epochs of 2 steps at 8 x 1024, f32, flash, full remat, a checkpoint
   each epoch. (a) data 1 x fsdp 2 x tensor 2, AdamW; (b) data 1 x fsdp 2
   x expert 2, Switch MoE with 8 experts, Adafactor. The flash kernels at
   each leg's attention shape a rank against their plain versions; each
   leg learns, each rank's flash launches are exact, the ranks' metrics
   bit-equal, the state sharded on the leg's axis (a: each rank 1/4 of
   every leaf split over tensor and fsdp), the epoch-1 checkpoint on the
   rule's regions with every crc32 checked, the in-run resume at four
   ranks bit for bit, a restore at one process every leaf bit-equal, the
   first step (its loss with the MoE's load-balance losses, its gradients
   reduced by the train step's own reductions) on one device within the
   step-parity limits; (a) also a restore at fsdp 2 (two ranks) every
   leaf bit-equal, and the step saved as DCP and restored at one process
   bit-equal to the raw restore; (b)
   the summed load-balance loss finite, above 0 and bit-equal across
   ranks. Step ms, tokens/s, peak memory, save and restore GB/s a rank,
   the all-reduces of a step timed alone.
14. Sequence and pipeline parallelism (``seq_pipeline_phase``) on GPT-2
   124M at full width and 6 of its 12 layers (``SP_LAYERS``, a depth cut
   for the time limit), 8 x 1024 tokens a step, f32, two ranks
   sharing the card over gloo in each leg (their point-to-point shifts
   staged through pinned host buffers, the mode ``--p2p-probe`` fixed):
   the flash kernels at the phase's other rank shapes (a rank's 6 heads
   after Ulysses's all-to-all, a pipeline microbatch of 2 rows) against
   their plain versions with their times; (a) data 1 x seq 2, ring
   attention, AdamW, 2 x 2 steps with a checkpoint each epoch: learning,
   the ranks' losses bit-equal, no flash launch, the epoch-1 checkpoint
   on the rule's regions with every crc32, the in-run resume bit for
   bit, a restore at one process every leaf bit-equal, the first step
   within step parity of one device, the ring's shift alone (GB/s, bits
   equal); (b) the gathered flash path on the same mesh: one step within
   step parity, the flash launches a rank exact, and
   ``ulysses_attention(inner_impl="flash")`` at (8, 1024, 12, 64) against
   the plain version forward and backward; (c) data 1 x stage 2, 4
   microbatches, flash, AdamW, 2 x 2 steps: learning, exact launches,
   each rank half of every ``h/block`` leaf, the checkpoint on the stage
   rule, the in-run resume bit for bit, a restore at one process onto the
   scan model every leaf bit-equal, the first step's loss within 1e-5 of
   the one-device model's. Step ms, tokens/s and peak memory a leg.
15. Preemption (``preempt_phase``) on phase 6's ``train_gpt`` call (GPT-2
   124M at full width and depth, 2 x 8 steps of 8 x 1024, f32, full
   remat, dropout 0.1, AdamW, flash, the fused backward): (a) in this
   process, the fault plan ``preempt:0@step5`` with a 30 s grace budget
   drains step 5 by the full save on the persistent tier (the mid-epoch
   cursor in its metadata) and raises ``Preempted``; the call again,
   with the obs recorder configured, ``nan_grad:0@step11`` and
   ``profile=(13, 13)``, restores step 5 and runs steps 6-10, the NaN
   step 11 (one ``health.anomaly``, nonfinite), the health rollback to
   the verified epoch-0 save at step 8 (one ``health.rollback``) and the
   replayed steps 9-16: the raw losses phase 6's steps 1-10, a NaN, then
   its steps 9-16 bit for bit, the result's step losses phase 6's steps
   6-16, ``step_16``'s crc32s equal to phase 7's split leg's, the
   restores (5, persistent) then (8, persistent), the flash launches
   exact over both calls (three discarded steps' worth beyond phase
   6's), and step 13's profile trace holding the forward with lse and
   the fused backward pair; (b) a child process of this
   script (``--preempt-child``) makes the same call with a node-local
   tier and no grace; once its log reports step 3 it gets a real
   SIGTERM, drains by ``emergency_save`` on the local tier and exits 75
   with a local-only committed step k; a second child restores step k
   from the local tier (its ``ckpt.restore_tier`` event) and finishes
   with the same checks (no NaN). The drain times (flag to
   ``Preempted``), the rollback's time (anomaly to rollback: the crc32
   verify and the restore), the saves' and restores' seconds and GB/s,
   the phase's wall.
16. The elastic gang (``elastic_phase``): (a) the flash kernels at one
   rank's attention shape in each world the phase forms, (4, 1024, 12,
   64) at 3 members and (6, 1024, 12, 64) at 2, f32, against their plain
   versions (measured with the other kernel phases); (b)
   ``TorchGptTrain`` at GPT-2 124M
   width cut to 3 of its 12 layers, a gang of 3 members sharing the card
   over gloo under ``FlowRunner(elastic=True)`` (floor 2), 4 epochs of 10
   steps of 12 x 1024, f32, flash, AdamW, dropout 0, a checkpoint each
   epoch. Member 1 exits after step 12; the survivors shrink to 2,
   restore epoch 0's checkpoint (written by 3, read by 2) and replay two
   steps; the member is relaunched and the gang grows back to 3. One
   launch, one ``flow.member_lost``, resizes shrink 3 -> 2 then grow 2 ->
   3, no failure or stall event, every step once in the head's result,
   every restored region bit-equal to the committed step, the ranks'
   losses bit-equal in each generation, the replayed steps within 1e-4
   relative of their first run, exact flash launches per member and
   generation, learning. The re-form's seconds, step ms by generation.
17. One JSON line with every kernel's numbers (the int8 matmul both as one
   decode step at M = 8 and as the same 49 products at M = 512; the
   training kernels in f32 and bf16, their launches from the f32 legs and
   the bf16 leg, which runs the fused pair, so the bf16 split variants'
   count there is 0; the wide-head kernels at D = 512, their launches the
   wide-head runs the main paths' counters read; ``flow_launches``: the
   flash kernels' launches in the flow phase; ``generation_launches``:
   those of the generation phase; ``disagg_launches``: those of phase
   4's disaggregated leg (the flash forward, the int8 tiles);
   ``replica_launches``: those of phase 4's replica leg (the flash
   forward);
   ``recipe_launches``: those of phase 11;
   ``fsdp_launches``: those of phase 12's leg (b), both ranks';
   ``tp_launches``: those of phase 13's two training legs, every rank's;
   ``seq_launches``: those of phase 14's legs (a) and (b), every rank's;
   ``pipeline_launches``: those of its leg (c), every rank's;
   ``preempt_launches``: those of phase 15's legs, both calls of each
   (leg (a)'s three rolled-back steps included); ``elastic_launches``:
   those of phase 16, every member's in every generation; the
   ``_elastic_w3``/``_elastic_w2`` entries at phase 16's attention shape
   a rank in each world, f32, their launches the members' at that world;
   the ``_vit`` entries at the
   ViT shape, f32, their launches the ViT leg's), the ``nvidia-smi`` line,
   and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is absent or the package is not
beside this script. Details go to ``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --wide-compare DIR`` runs nothing of the above: it
times the 12 wide-head entries at (1, 1024, 12, 512) causal with the
kernels of the checkout in DIR (for example the parent commit, unpacked
by ``git archive``) and with this checkout's, in turns (DIR, this, this,
DIR), each in a process of its own that builds its kernels, and writes
them to ``chiprun_out/wide_compare.json``.

``python3 chip_smoke.py --slice`` builds the kernels and runs only phase
4, into ``chiprun_out/slice.json``; ``--recipes`` only
phase 11, into ``chiprun_out/recipes.json``; ``--fsdp`` only phase 12,
into ``chiprun_out/fsdp.json`` (its ranks are ``--fsdp-rank`` processes
of this script); ``--tp`` only phase 13, into ``chiprun_out/tp.json``
(its ranks are ``--tp-rank`` processes); ``--sp``
only phase 14, into ``chiprun_out/sp.json`` (its ranks are ``--sp-rank``
processes); ``--preempt`` only phase 15, after an uninterrupted run of
phase 6's call that stands for phases 6 and 7, into
``chiprun_out/preempt.json`` (its children are ``--preempt-child``
processes); ``--elastic`` only phase 16, into
``chiprun_out/elastic.json`` (its gang members load this file as their
flow's module). ``python3 chip_smoke.py --gloo-probe`` runs only the
probe that fixed phases 12 and 13's mode (``gloo_probe_rank``);
``--p2p-probe`` the probe that fixed phase 14's (``p2p_probe_rank``:
gloo's ``send``/``recv`` of CUDA tensors, its ``all_to_all_single`` on
them, the port's staged shift and all-to-all).

``python3 chip_smoke.py --ckpt-ab [ORDER]`` runs only the split and resume
legs, once for each letter of ORDER (default ``ABCCBA``): A as this
checkout runs them, B with the checkpoint pool prewarmed whatever the
storage (the JAX package's rule), C without the restore side (no restore
prewarm, the restored tree laid out on the host), into
``chiprun_out/ckpt_ab_<ORDER>.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.monotonic()

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate, and the
# operation rates by input type — f32 outside the tensor cores, bf16 and
# int8 on them.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

FLASH_TOL = {
    # f32: the kernel and blockwise_attention sum the same f32 products in
    # another order; 1e-4 is ~1000 ulps at the outputs' unit scale.
    "float32": (1e-4, 0.0),
    # bf16: both round P to bf16 before P.V, but at the running max of
    # their own key tiles (64 in the kernel, 512 in the plain version), and
    # the outputs round to bf16 (2^-8 relative): two bf16 ulps, and an atol
    # for rows near 0 where P's rounding outweighs the output's.
    "bfloat16": (4e-3, 8e-3),
}
FLASH_SHAPES = ((1, 512, 12, 64), (1, 1024, 12, 64))
# The training leg's attention shape: batch 8 x 1024 tokens, 12 heads of 64.
TRAIN_SHAPE = (8, 1024, 12, 64)
# Backward phase tolerances, kernel vs plain version on the same inputs
# (atol, rtol). lse: f32 sums of the same exponentials in another order
# and at other tile maxima (~1e-6 at lse ~ 7). delta: 64 f32 products
# summed in another order. dq/dk/dv: f32 — the same products summed in
# another order over up to 1024 keys; bf16 — also P and dS rounded to
# bf16 from f32 values that differ in their last bits, and the outputs
# rounded to bf16 (2^-8 relative): two bf16 ulps.
LSE_TOL = (2e-5, 1e-6)
DELTA_TOL = (1e-4, 1e-5)
BWD_TOL = {"float32": (2e-4, 1e-4), "bfloat16": (2e-2, 1.6e-2)}
# Training leg: GPT-2 124M as train_gpt builds it for this config. The
# lm_synth corpus holds batch x steps = 64 documents over the full 50257
# vocab with a uniform unigram: one epoch of 8 unseen batches has nothing
# the model can generalize yet, so the loss falls only once the second
# epoch revisits the corpus.
TRAIN_EPOCHS = 2
TRAIN_STEPS_PER_EPOCH = 8
TRAIN_STEPS = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
# Flash vs einsum step parity (f32, TF32 off, dropout off): the two
# attentions differ by summation order only. On the H100 the losses came
# out bit-equal and the worst gradient tensor differed by 2.3e-6 of its
# max |g| (PERF.md); the limits sit about ten times above that: 1e-5 is
# ~10 f32 ulps of a loss near 11. Rounding P or dS to bf16 inside the f32
# backward (~4e-3 per element) would break them.
PARITY_LOSS_ATOL = 1e-5
PARITY_GRAD_RTOL = 2e-5  # of each gradient tensor's max |value|
# (K, N) of the four Dense layers of a GPT-2 124M block, and the head.
DENSE_KN = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
VOCAB = 50257
# The flash wrappers whose wide-head variants (D > 256) are counted apart
# (``flash_attention.wide_launches``, by wrapper and dtype).
WIDE_KERNELS = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv",
                "flash_bwd_dq_split", "flash_bwd_dkv_split")
# The launch counters chip_smoke reads (``_counters``), one per kernel and
# variant; "<kernel>[_bf16]_wide" are the wide-head launches.
LAUNCH_COUNTERS = (
    "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_split",
    "flash_bwd_dkv_split", "flash_fwd", "int8_matmul", "flash_fwd_lse_bf16",
    "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16",
    *(f"{k}{dt}_wide" for k in WIDE_KERNELS for dt in ("", "_bf16")))
# Rounds of each part of the checkpoint IO phase (1 since phase 16 came,
# 2 before: the time limit), the widths its disk ceiling writes at and
# the threads it reads and checksums with.
CKPT_IO_REPS = 1
CKPT_WRITE_WIDTHS = (1, 4, 8)
CKPT_READ_THREADS = (1, 8)
# torch.profiler traces taken before one that lacks the measured
# function's kernels is given up on, and the calls a Timer trace runs
# before the ones it keeps.
TRACE_ATTEMPTS = 3
TRACE_LEAD = 3
# Head dims the kernels are not instantiated at (96, run zero-padded at
# 128), the widest instantiation (256) and a wide head (512, the wide-head
# kernels that contract over D in chunks), at one prefill layer's shape.
HEAD_DIM_SHAPES = ((1, 1024, 12, 96), (1, 1024, 12, 256), (1, 1024, 12, 512))
# The head dim whose rows enter the kernels JSON line; each kernel's
# outputs in the head-dim phase's errors (the split pair's equal the fused
# pair's bit for bit).
WIDE_D = 512
WIDE_ERR_KEYS = {
    "flash_fwd": ("out_no_lse",), "flash_fwd_lse": ("out", "lse"),
    "flash_bwd_dq": ("delta", "dq"),
    "flash_bwd_dkv": ("dk", "dv"), "flash_bwd_dq_split": ("dq",),
    "flash_bwd_dkv_split": ("dk", "dv"),
}
# The README main path as flows/train_flow.py:45-48 runs it: 3 epochs at
# global batch 32 and lr 1e-3, on the full-size synthetic FashionMNIST
# (60,000 rows: 1875 steps an epoch); the eval at flows/eval_flow.py:61's
# batch of 512 over the 10,000 test rows.
MLP_EPOCHS, MLP_BATCH, MLP_LR = 3, 32, 1e-3
EVAL_BATCH = 512
# The best epoch's accuracy must reach this. The same call on the CPU
# (scripts of this repo: train_fashion_mnist(device="cpu"), 3 epochs)
# read 1.0000 after every epoch (val_loss 0.0026, 0.0008, ...): the
# synthetic classes are separable. 0.99 leaves room for the card's other
# dropout masks and summation order, and still fails a model that did not
# learn (chance is 0.1).
MLP_ACCURACY_FLOOR = 0.99
# Rows by which the predictor's misclassified count (batch 512) may differ
# from the count the best epoch's accuracy implies (the eval step at batch
# 32): the two products run at different M, so a row whose top two logits
# are within rounding may flip.
EVAL_ROWS_TOL = 5
MLP_TIMED_WARMUP = 20   # steps before the step-time median
MLP_PROFILED_STEPS = 50
MLP_INLINE_STEPS = 300  # steps timed with the batches converted inline
DECODE_M = 8      # the engine's slots
PREFILL_M = 512   # the widest prefill bucket the slice phase uses
GEN_PROMPT = 512
NEW_TOKENS = 32
ENGINE_LENS = (5, 300, 64, 17, 129, 250, 33, 200)
# Phase 4's disaggregated leg: a prefill and a decode engine (8 slots,
# pages of 16) sharing a store under build/. Exact ships of three prompts
# a numeric path, a suffix resume (a shipped base, the suffix prefilled),
# a torn set's fallback (the first fp ship's set, torn after its import),
# and feed admissions through a host tier: each fp ship prompt (full pages
# + 1 token) is evicted by a churn prompt that needs the whole 40-page
# pool, then re-admitted. The fp prompts' solo generate() serves the
# exact import, the fallback and the feed; the int8 ships are the engine
# requests' int8 prompts of DISAGG_INT8_MIN tokens or more (200, 250, 300),
# held to the solo generate() the engine's check ran.
DISAGG_PAGE = 16
DISAGG_LENS = (209, 417, 593)       # fp: 13, 26, 37 full pages + 1 token
DISAGG_INT8_MIN = 200
DISAGG_SUFFIX = (320, 64)   # the shipped base, the suffix it is extended by
# Phase 4's replica leg: the requests that hold every slot of the engine
# when the SIGTERM lands (the fp prompts, repeated), and the loop's bound.
REPLICA_SLOTS = 8
REPLICA_MAX_S = 120.0
FEED_CHURN = 630
FEED_POOL = 41              # pages, the trash page included
FEED_HOST_MB = 128.0
# The generation phase: beam width; speculative prompts repeat a 32-token
# segment to 512 tokens, drafts of 4, 64 new tokens; weight-only decode
# is timed after 128-token prompts. Beam scores against sequence_logprob
# on the flash forward: the decode path and the dense forward sum the
# same f32 products in other orders (~1e-5 at the logits), averaged over
# 32 tokens.
BEAM_K = 4
BEAM_SCORE_ATOL = 1e-4
SPEC_SEGMENT, SPEC_NEW, SPEC_K = 32, 64, 4
WEIGHT_PROMPT = 128
# The flow phase: the GPT-2 train flow at 124M width (2 epochs of 4 steps
# at 8 x 1024 on the flash kernels), then the triggered eval flow sampling
# this many tokens three times.
FLOW_GPT_ARGS = ("--preset", "gpt2", "--seq-len", "1024", "--batch-size",
                 "8", "--epochs", "2", "--steps-per-epoch", "4",
                 "--attn-impl", "flash", "--data-axis", "1", "--fsdp-axis",
                 "1")
FLOW_GPT_BATCH, FLOW_GPT_STEPS = 8, 8
FLOW_SAMPLE_TOKENS = 16
# The image phase. ResNet-18 / CIFAR-10 (BASELINE config 1) through the
# flows at width 64 and the train flow's batch 32 and lr 1e-3, the
# synthetic train split cut from 50,000 to 5,000 rows to fit the time
# limit (10,000 until phase 13 came; the 10,000 test rows whole).
CIFAR_TRAIN_ROWS = 5_000
# ResNet-50 / imagenet_synth (BASELINE config 2 on one card) through
# train_model: 224 x 224 x 3, 1000 classes, global batch 64, 2 epochs of
# 1,024 synthetic rows (16 steps each; the dataset's default 2,000 until
# phase 13 came, cut to fit the time limit), its 200 test rows. Then the
# step timed apart: warm-up steps, timed steps and profiled steps, with
# the batches prefetched as the main path does.
R50_BATCH, R50_EPOCHS, R50_TRAIN_ROWS = 64, 2, 1024
R50_TIMED_WARMUP, R50_TIMED_STEPS, R50_PROFILED_STEPS = 5, 20, 10
# ViT-S/16 on imagenet_synth with attn_impl="flash" (f32, TF32 off): one
# epoch of 4 steps at batch 64, 100 test rows (2 padded validation
# batches, 2 predictor batches). Its attention: (64, 197, 6, 64), not
# causal.
VIT_BATCH, VIT_TRAIN_ROWS, VIT_TEST_ROWS = 64, 256, 100
VIT_SHAPE = (64, 197, 6, 64)
# Phase 11, the training recipes: GPT-2 124M at 8 x 1024, 2 epochs of 4
# steps each leg. Lion at AdamW's learning rate (its first updates are
# the sign of the gradient, as Adam's are); Adafactor at 1e-2, its
# updates scaled by each leaf's RMS (the embeddings' ~0.02: ~2e-4 an
# element, AdamW's size). Switch-Base-8 (Fedus et al. 2021): 8 experts,
# capacity 1.25, aux weight 1e-2. A 32-byte sample from "The ".
RECIPE_EPOCHS, RECIPE_STEPS, RECIPE_SEQ = 2, 4, 1024
LION_LR, ADAFACTOR_LR = 3e-4, 1e-2
MOE_EXPERTS = 8
# The MoE leg at 6 of 124M's 12 layers (cut for the time limit when phase
# 16 came; the width and the 8 experts unchanged).
MOE_LAYERS = 6
RECIPE_SAMPLE = 32
# The flash crossovers: (B, H, D), the sequence lengths and the
# interleaved runs whose median each time is (single calls of ~0.2-2 ms
# at the short lengths, whose walls move by tens of percent).
CROSSOVER_BHD = (8, 12, 64)
CROSSOVER_TS = (128, 256, 512, 1024, 2048, 4096)
CROSSOVER_REPS = 11
# Phase 12: GPT-2-medium (BASELINE config 5) trained by FSDP_WORLD ranks,
# its state sharded over them, 2 epochs of 2 steps at 8 x 1024 (4 until
# phase 13 came, cut to fit the time limit), f32, flash, full remat,
# AdamW. The mode was fixed by a probe
# (``--gloo-probe``, ``gloo_probe_rank``; PERF.md §6): gloo carries
# all_gather_into_tensor and reduce_scatter_tensor on CUDA tensors
# between two processes on one card (64 MB bit-equal to the host's) and
# FSDP2 trains over it, while NCCL refuses two ranks of a communicator on
# one device. So the ranks share card FSDP_CARD over gloo;
# tests/test_torch_cuda.py runs the same leg over NCCL at one rank a card
# where there are two cards.
FSDP_WORLD, FSDP_BACKEND, FSDP_CARD = 2, "gloo", 0
FSDP_EPOCHS, FSDP_STEPS_PER_EPOCH = 2, 2
# Depth cut for the time limit: 6 of medium's 24 layers when phase 14
# came, 3 when phase 16 came (the width, 1024 and 16 heads, unchanged).
FSDP_LAYERS = 3
FSDP_STEPS = FSDP_EPOCHS * FSDP_STEPS_PER_EPOCH
# One rank's attention: 8 / 2 rows of medium's 16 heads of 64 at 1024.
FSDP_SHAPE = (4, 1024, 16, 64)
FSDP_RESUME_RTOL = 1e-4  # K' = 1 against K = 2: other reduction orders
FSDP_COLLECTIVE_REPS = 2
# (e): the flows at 124M width as a two-member gang on the one card.
FLOW_FSDP_ARGS = ("--preset", "gpt2", "--seq-len", "1024", "--batch-size",
                  "8", "--epochs", "2", "--steps-per-epoch", "2",
                  "--attn-impl", "flash", "--data-axis", "1", "--fsdp-axis",
                  str(FSDP_WORLD), "--device", f"cuda:{FSDP_CARD}",
                  "--dist-backend", FSDP_BACKEND)
# Phase 13: GPT-2 124M at full width and depth on the tensor and expert
# axes, TP_WORLD ranks sharing card TP_CARD over gloo (the mode the probe
# fixed for phase 12; ``--gloo-probe`` also holds the all-reduce the
# tensor and expert groups run to the host's sums), each a process of its
# own: leg (a) data 1 x fsdp 2 x tensor 2 with AdamW, leg (b) data 1 x
# fsdp 2 x expert 2, Switch MoE with MOE_EXPERTS experts and Adafactor.
# 2 epochs of 2 steps at 8 x 1024, f32, flash, full remat (steps cut for
# time), a checkpoint each epoch.
TP_WORLD, TP_CARD = 4, 0
TP_EPOCHS, TP_STEPS_PER_EPOCH = 2, 2
# Depth cut for the time limit when phase 14 came: 3 of 124M's 12 layers
# (the width, 768 and 12 heads, unchanged).
TP_LAYERS = 3
TP_STEPS = TP_EPOCHS * TP_STEPS_PER_EPOCH
TP_LEGS = {
    "a": dict(data_axis=1, fsdp_axis=2, tensor_axis=2),
    "b": dict(data_axis=1, fsdp_axis=2, expert_axis=2, experts=MOE_EXPERTS,
              optimizer_name="adafactor"),
}
TP_AXIS = {"a": "tensor", "b": "expert"}
# A rank's attention: 8 / 2 rows; (a) 12 / 2 heads of 64, (b) all 12.
TP_SHAPES = {"a": (4, 1024, 6, 64), "b": (4, 1024, 12, 64)}
# The all-reduces of one step on a leg's model group, each of one rank's
# (4, 1024, 768) f32 activations: (a) the two row-parallel sums of a
# block's forward, again in its remat recompute, and the two column
# inputs' gradients in its backward; (b) the expert sum forward and
# recomputed, and the expert input's gradient (the combine weights'
# gradient, (4, 1024, 8, 160), adds 1.67 of these a block).
TP_ALL_REDUCES = {"a": 6 * TP_LAYERS, "b": 3 * TP_LAYERS}
TP_COLLECTIVE_REPS = 2
# Phase 14: sequence and pipeline parallelism on GPT-2 124M at full width,
# SP_LAYERS of its 12 layers (cut for the time limit when phase 16 came),
# SP_WORLD ranks sharing card SP_CARD over gloo (the probe's
# mode; ``--p2p-probe`` holds the shift and the all-to-all), each a
# process of its own, 2 epochs of 2 steps at 8 x 1024, f32, a checkpoint
# each epoch: (a) data 1 x seq 2 with ring attention, (b) the gathered
# flash path on the same mesh (one step), (c) data 1 x stage 2 with 4
# microbatches on the flash kernels.
SP_WORLD, SP_CARD = 2, 0
SP_LAYERS = 6
SP_EPOCHS, SP_STEPS_PER_EPOCH = 2, 2
SP_STEPS = SP_EPOCHS * SP_STEPS_PER_EPOCH
SP_LEGS = {
    "a": dict(data_axis=1, fsdp_axis=1, seq_axis=2, attn_impl="ring"),
    "b": dict(data_axis=1, fsdp_axis=1, seq_axis=2, attn_impl="flash"),
    "c": dict(data_axis=1, fsdp_axis=1, stage_axis=2, microbatches=4,
              attn_impl="flash"),
}
# The flash kernels' other shapes in phase 14: a rank's 12 / 2 heads over
# the whole 1024 tokens after Ulysses's all-to-all, and one pipeline
# microbatch of 8 / 4 rows (the gathered path runs TRAIN_SHAPE).
SP_SHAPES = {"ulysses": (8, 1024, 6, 64), "pipeline": (2, 1024, 12, 64)}
ULYSSES_SHAPE = (8, 1024, 12, 64)
SHIFT_REPS = 3


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def _trace_once(torch, run) -> list[dict]:
    """Every CUDA kernel ``run()`` launches, as chrome-trace events (name,
    ts and dur in us) from one ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


def kernel_trace(torch, run, keep=lambda e: True,
                 min_events: int = 1) -> list[dict]:
    """The CUDA kernels ``run()`` launches that ``keep`` accepts. A trace
    that holds fewer than ``min_events`` such kernels (the profiler drops
    some: none, seen once on the H100 for a short run) is taken again, up
    to ``TRACE_ATTEMPTS`` times in all; then this raises."""
    for attempt in range(TRACE_ATTEMPTS):
        every = _trace_once(torch, run)
        kernels = [e for e in every if keep(e)]
        if len(kernels) >= min_events:
            return kernels
        print(f"torch.profiler trace {attempt + 1} of {TRACE_ATTEMPTS} holds "
              f"{len(every)} CUDA kernels, {len(kernels)} of the measured "
              f"function's (want {min_events} or more); tracing again")
    raise RuntimeError("torch.profiler recorded too few CUDA kernels of the "
                       "measured function: the device times cannot be read")


def _is_flush(e: dict) -> bool:
    return "bitwise_not" in e["name"]


def call_device_ms(kernels: list[dict]) -> list[float]:
    """The device ms of each call of a traced ``Timer`` loop that the
    trace holds whole. A flush kernel opens every call and one closes the
    loop, so the kernels between two recorded flushes are one call's. The
    profiler drops events (whole calls at a short trace's start, seen on
    the H100): a call that lost a kernel, and two calls that lost the
    flush between them, differ in their kernel count from the most common
    one, and are left out."""
    calls, current = [], None
    for e in sorted(kernels, key=lambda e: e["ts"]):
        if _is_flush(e):
            if current:
                calls.append(current)
            current = []
        elif current is not None:
            current.append(e["dur"])
    if not calls:
        return []
    sizes = [len(c) for c in calls]
    size = max(set(sizes), key=lambda n: (sizes.count(n), n))
    return [sum(c) / 1e3 for c in calls if len(c) == size]


class Timer:
    """Times of ``fn`` over ``iters`` calls, each after an L2 flush (the
    serving path meets its weights cold: a decode step streams ~124 MB
    between two visits of one layer). Returns ``(device_ms, call_ms)``:
    the mean over the traced calls of the summed duration of the kernels
    one call launches (profiler trace, ``call_device_ms``; the flush kernel
    excluded), and the CUDA-event time of one call, which also holds the
    wrapper's host work while the device waits for it. Where no trace of
    ``TRACE_ATTEMPTS`` holds half the calls whole, the device ms is the
    CUDA-event time, and ``event_timed`` counts such times."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
        self.event_timed = 0

    def _calls(self, fn, iters):
        for _ in range(iters):
            self.flush.bitwise_not_()
            fn()
        self.flush.bitwise_not_()

    def __call__(self, fn, iters: int = 20, warmup: int = 3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        call = 0.0
        for _ in range(iters):
            self.flush.bitwise_not_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            call += a.elapsed_time(b)
        call_ms = call / iters
        # TRACE_LEAD calls more than are kept: a trace loses its first.
        need = max(1, iters // 2)
        for attempt in range(TRACE_ATTEMPTS):
            ms = call_device_ms(_trace_once(
                torch, lambda: self._calls(fn, TRACE_LEAD + iters)))
            if len(ms) >= need:
                return float(np.mean(ms[-iters:])), call_ms
            print(f"torch.profiler trace {attempt + 1} of {TRACE_ATTEMPTS} "
                  f"holds {len(ms)} whole calls of {TRACE_LEAD + iters} "
                  f"(want {need} or more); tracing again")
        self.event_timed += 1
        print(f"torch.profiler held too few whole calls in {TRACE_ATTEMPTS} "
              f"traces: the device ms is the CUDA-event time {call_ms:.4f}")
        return call_ms, call_ms


def _bound_ms(nbytes: float, ops: float, op_type: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[op_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _measure(timer, kernel, plain, library) -> dict:
    """The kernel's, its plain version's and the library call's times."""
    ms, call_ms = timer(kernel)
    plain_ms, plain_call_ms = timer(plain, iters=5)
    library_ms, library_call_ms = timer(library)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                plain_call_ms=plain_call_ms, library_ms=library_ms,
                library_call_ms=library_call_ms)


def _report(head: str, r: dict) -> None:
    r["bound_share"] = r["bound_ms"] / r["ms"]
    print(f"{head}; device ms: kernel {r['ms']:.4f}, plain "
          f"{r['plain_ms']:.4f}, {r['library']} {r['library_ms']:.4f}, "
          f"bound {r['bound_ms']:.4f} ({r['bound_by']}; the kernel at "
          f"{r['bound_share']:.1%} of it); call ms: kernel "
          f"{r['call_ms']:.4f}, plain {r['plain_call_ms']:.4f}, library "
          f"{r['library_call_ms']:.4f}")


def flash_phase(torch, timer, shapes=FLASH_SHAPES, causal=True,
                dtypes=("float32", "bfloat16")):
    """The no-lse flash forward at ``shapes`` against its plain version
    and SDPA, in ``dtypes``."""
    from tpuflow_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dt in (getattr(torch, name) for name in dtypes):
        name = str(dt).split(".")[-1]
        atol, rtol = FLASH_TOL[name]
        for B, T, H, D in shapes:
            q, k, v = (
                torch.randn(B, T, H, D, device="cuda", generator=g).to(dt)
                for _ in range(3)
            )
            out = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            ref = fa.blockwise_attention(q, k, v, causal=causal)
            err = (out.float() - ref.float()).abs()
            # The largest error as a share of its limit (<= 1 passes).
            share = float((err / (atol + rtol * ref.float().abs())).max())
            max_err = float(err.max())
            if not share <= 1.0:
                raise AssertionError(
                    f"flash {name} {(B, T, H, D)}: max |err| {max_err} "
                    f"exceeds atol {atol} + rtol {rtol} * |ref|"
                )
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            times = _measure(
                timer,
                lambda: fa.flash_attention(q, k, v, causal=causal),
                lambda: fa.blockwise_attention(q, k, v, causal=causal),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=causal
                ),
            )
            esize = q.element_size()
            nbytes = 4 * B * T * H * D * esize  # q, k, v read; o written
            # Two products over the causal half (or the whole T x T).
            ops = 4 * B * H * D * (T * (T + 1) / 2 if causal else T * T)
            bound, by = _bound_ms(nbytes, ops, name)
            rows.append(dict(
                shape=[B, T, H, D], dtype=name, causal=causal,
                max_abs_err=max_err,
                share_of_limit=share, bound_ms=bound, bound_by=by,
                library="sdpa", **times,
            ))
            _report(f"flash {name} {(B, T, H, D)}: max|err| {max_err:.3g} "
                    f"({share:.3f} of the limit)", rows[-1])
    return rows


def _within(got, want, atol: float, rtol: float, what: str):
    """Max |err| and its share of the limit atol + rtol * |want|; raises
    when the share exceeds 1."""
    err = (got.float() - want.float()).abs()
    share = float((err / (atol + rtol * want.float().abs())).max())
    if not share <= 1.0:
        raise AssertionError(
            f"{what}: max |err| {float(err.max())} exceeds atol {atol} + "
            f"rtol {rtol} * |ref|"
        )
    return float(err.max()), share


def _flash_work(B, T, H, D, esize, causal=True) -> dict:
    """(bytes, operations) the function of each flash kernel needs at a
    (B, T, H, D) shape: each input read once, each output written once,
    and the causal half (or, non-causal, the whole) of each T x T x D
    product."""
    x = B * T * H * D * esize  # one (B, T, H, D) array
    r = B * H * T * 4          # one (B*H, T) f32 row array
    # One T x T x D product: its causal half, or all of it.
    prod = 2 * B * H * D * (T * (T + 1) / 2 if causal else T * T)
    # The row delta D = rowsum(dO o O), 2 D operations a row. The function
    # needs it once per row; the split kernels' recomputation on every
    # block visit is their own redundancy, not counted.
    rowsums = 2 * B * T * H * D
    return {
        # q, k, v in; o out; S and P.V.
        "flash_fwd": (4 * x, 2 * prod),
        # q, k, v in; o, lse out; S and P.V.
        "flash_fwd_lse": (4 * x + r, 2 * prod),
        # q, k, v, o, dO, lse in; dq, delta out; S, dP, dQ products plus
        # the row delta once per row.
        "flash_bwd_dq": (6 * x + 2 * r, 3 * prod + rowsums),
        # q, k, v, dO, lse, delta in; dk, dv out; S, dP, dV, dK.
        "flash_bwd_dkv": (6 * x + 2 * r, 4 * prod),
        # q, k, v, o, dO, lse in; dq out; S, dP, dQ and the row delta.
        "flash_bwd_dq_split": (6 * x + r, 3 * prod + rowsums),
        # q, k, v, o (the O stream), dO, lse in; dk, dv out; S, dP, dV, dK
        # and the row delta.
        "flash_bwd_dkv_split": (7 * x + r, 4 * prod + rowsums),
    }


def flash_bwd_phase(torch, timer, shapes=FLASH_SHAPES + (TRAIN_SHAPE,),
                    causal=True, dtypes=("float32", "bfloat16")):
    """The forward with lse, the fused and the split backward pairs against
    their plain versions at ``shapes``, in ``dtypes``, bit-equal over two
    runs (the split pair also to the fused one), with their times."""
    from tpuflow_torch.ops import flash_attention as fa

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(dt, shp) for dt in dtypes for shp in shapes]
    rows = []
    for name, (B, T, H, D) in cases:
        dt = getattr(torch, name)
        q, k, v, do = (
            torch.randn(B, T, H, D, device="cuda", generator=g).to(dt)
            for _ in range(4)
        )
        o, lse = fa.flash_fwd_lse(q, k, v, causal=causal)
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal=causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
        torch.cuda.synchronize()
        tag = f"{name} {(B, T, H, D)}"
        again = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
        split = fa.flash_bwd_split(q, k, v, o, lse, do, causal=causal)
        split_again = fa.flash_bwd_split(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        for what, got in (("fused, second run", again),
                          ("split", split), ("split, second run",
                                             split_again)):
            for key, a, b in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"flash backward {tag}: {what} {key} differs from "
                        "the fused kernels' first run")
        ro, rlse = fa.blockwise_attention_lse(q, k, v, causal=causal)
        rdq, rdelta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
        rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, rdelta,
                                          causal=causal)
        errs = {
            "out": _within(o, ro, *FLASH_TOL[name], f"flash lse fwd {tag}"),
            "lse": _within(lse, rlse, *LSE_TOL, f"lse {tag}"),
            "delta": _within(delta, rdelta, *DELTA_TOL, f"delta {tag}"),
        }
        for key, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            errs[key] = _within(got, want, *BWD_TOL[name], f"{key} {tag}")
        del ro, rlse, rdq, rdelta, rdk, rdv, again, split_again
        sdq = fa.flash_bwd_dq_split_plain(q, k, v, o, lse, do, causal=causal)
        sdk, sdv = fa.flash_bwd_dkv_split_plain(q, k, v, o, lse, do,
                                                causal=causal)
        for key, got, want in zip(("split dq", "split dk", "split dv"),
                                  split, (sdq, sdk, sdv)):
            errs[key] = _within(got, want, *BWD_TOL[name], f"{key} {tag}")
        del sdq, sdk, sdv, split

        # Library yardstick: SDPA (B, H, T, D), forward with grad (its
        # lse kept for the backward), and its backward (dq, dk, dv at once).
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        doh = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

        out_h = sdpa()

        def sdpa_bwd():
            return torch.autograd.grad(out_h, (qh, kh, vh), doh,
                                       retain_graph=True)

        fwd = _measure(
            timer,
            lambda: fa.flash_fwd_lse(q, k, v, causal=causal),
            lambda: fa.blockwise_attention_lse(q, k, v, causal=causal),
            sdpa,
        )
        bwd_dq = _measure(
            timer,
            lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, causal=causal),
            lambda: fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=causal),
            sdpa_bwd,
        )
        bwd_dkv = _measure(
            timer,
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                           causal=causal),
            sdpa_bwd,
        )
        split_dq = _measure(
            timer,
            lambda: fa.flash_bwd_dq_split(q, k, v, o, lse, do, causal=causal),
            lambda: fa.flash_bwd_dq_split_plain(q, k, v, o, lse, do,
                                                causal=causal),
            sdpa_bwd,
        )
        split_dkv = _measure(
            timer,
            lambda: fa.flash_bwd_dkv_split(q, k, v, o, lse, do, causal=causal),
            lambda: fa.flash_bwd_dkv_split_plain(q, k, v, o, lse, do,
                                                 causal=causal),
            sdpa_bwd,
        )
        del out_h, qh, kh, vh
        shape = [B, T, H, D]
        lib = "sdpa backward (dq, dk, dv)"
        work = _flash_work(B, T, H, D, q.element_size(), causal)
        x = B * T * H * D * q.element_size()
        r = B * H * T * 4
        prod = 2 * B * H * D * (T * (T + 1) / 2 if causal else T * T)
        for kern, times, err_keys, libname in (
            ("flash_fwd_lse", fwd, ("out", "lse"), "sdpa forward"),
            ("flash_bwd_dq", bwd_dq, ("delta", "dq"), lib),
            ("flash_bwd_dkv", bwd_dkv, ("dk", "dv"), lib),
            ("flash_bwd_dq_split", split_dq, ("split dq",), lib),
            ("flash_bwd_dkv_split", split_dkv, ("split dk", "split dv"),
             lib),
        ):
            bound, by = _bound_ms(*work[kern], name)
            rows.append(dict(
                kernel=kern, shape=shape, dtype=name, causal=causal,
                max_abs_err=max(errs[k][0] for k in err_keys),
                share_of_limit=max(errs[k][1] for k in err_keys),
                errors={k: errs[k] for k in err_keys},
                bound_ms=bound, bound_by=by, library=libname, **times,
            ))
            _report(f"{kern} {tag}: max|err| "
                    + ", ".join(f"{k} {errs[k][0]:.3g} ({errs[k][1]:.3f})"
                                for k in err_keys), rows[-1])
        # The pair as one function: q, k, v, o, dO, lse in, dq, dk, dv
        # out; five products (S, dP, dQ, dK, dV).
        pair_bound, pair_by = _bound_ms(9 * x + r, 5 * prod, name)
        for row in rows[-4:]:
            row["pair_bound_ms"] = pair_bound
        print(f"backward pairs {tag}: fused "
              f"{bwd_dq['ms'] + bwd_dkv['ms']:.4f} ms, split "
              f"{split_dq['ms'] + split_dkv['ms']:.4f} ms, sdpa backward "
              f"{bwd_dq['library_ms']:.4f} ms, bound {pair_bound:.4f} ms "
              f"({pair_by}, 5 {'causal ' if causal else ''}products); both "
              "bit-equal over two runs, split bit-equal to fused")
    return rows


def int8_phase(torch, timer):
    from tpuflow_torch.ops import int8_matmul as im

    g = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(m, k, n, False) for m in (DECODE_M, PREFILL_M)
              for k, n in DENSE_KN]
    shapes += [(m, 768, VOCAB, True) for m in (DECODE_M, PREFILL_M)]
    rows = []
    for M, K, N, cl in shapes:
        x = torch.randn(M, K, device="cuda", generator=g)
        wshape = (N, K) if cl else (K, N)
        w = torch.randint(-127, 128, wshape, device="cuda", generator=g,
                          dtype=torch.int32).to(torch.int8)
        ws = torch.rand(N, device="cuda", generator=g) * 1e-2
        out = im.int8_matmul(x, w, ws, w_contract_last=cl)
        torch.cuda.synchronize()
        ref = im._plain_int8_matmul(
            x, w, ws, w_contract_last=cl, out_dtype=torch.float32
        )
        if not torch.equal(out, ref):
            raise AssertionError(
                f"int8 {(M, K, N, cl)}: kernel differs from the plain "
                f"version (max |err| {float((out - ref).abs().max())})"
            )
        w_kn = w.t() if cl else w
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            def lib():
                xq, s = im.quantize_rows(x)
                return torch._int_mm(xq, w_kn).float() * s * ws
            lib_kind = "_int_mm + epilogue"
        else:
            wf = w_kn.float() * ws  # dequantized outside the timing
            def lib():
                return x @ wf
            lib_kind = "f32 matmul"
        times = _measure(
            timer,
            lambda: im.int8_matmul(x, w, ws, w_contract_last=cl),
            lambda: im._plain_int8_matmul(
                x, w, ws, w_contract_last=cl, out_dtype=torch.float32
            ),
            lib,
        )
        nbytes = M * K * 4 + K * N + N * 4 + M * N * 4
        bound, by = _bound_ms(nbytes, 2 * M * K * N, "int8")
        rows.append(dict(
            shape=[M, K, N], w_contract_last=cl, max_abs_err=0.0,
            library=lib_kind, bound_ms=bound, bound_by=by, nbytes=nbytes,
            **times,
        ))
        _report(f"int8 {(M, K, N)} contract_last={cl}: bit-equal", rows[-1])
        if M == DECODE_M and (K, N) == DENSE_KN[0]:
            # Kernels one call launches (scale pass, product; a memset of
            # the split-K scratch would show here).
            names = [e["name"] for e in kernel_trace(
                torch, lambda: im.int8_matmul(x, w, ws, w_contract_last=cl))]
            rows[-1]["kernels_per_call"] = names
            print(f"int8 kernels per call at M = {M} ({K} x {N}): "
                  f"{len(names)}: {', '.join(n[:40] for n in names)}")
            if len(names) > 2:
                raise AssertionError(f"an int8 call launched {names}")
    return rows


def slice_phase(torch, smi):
    from tpuflow_torch.infer.generate import chunked_prefill, generate
    from tpuflow_torch.infer.serve import ServeEngine
    from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im

    cfg = GPT2Config.from_preset("gpt2")  # 124M, attn_impl 'auto'
    model = GPT2(cfg, seed=0)  # the default device: cuda
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    res = {"params": n_params}

    # --- main path 1: generate() on a dense 512-token prompt.
    prompt = rng.integers(0, cfg.vocab_size, size=(1, GEN_PROMPT))
    _zero_counters(fa, im)
    t0 = time.monotonic()
    out = generate(model, prompt, max_new_tokens=NEW_TOKENS, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    gen_n = _counters(fa, im)
    flash_launches = fa.launches
    if flash_launches != cfg.n_layer:
        raise AssertionError(
            f"generate() prefill launched flash {flash_launches} times, "
            f"want {cfg.n_layer} (once per layer)"
        )
    toks = out.cpu().numpy()
    if toks.shape != (1, NEW_TOKENS) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size:
        raise AssertionError(f"generate() returned bad tokens {toks}")
    # Reference: the same weights with the plain einsum attention.
    ref_model = GPT2(dataclasses.replace(cfg, attn_impl="xla"), seed=0)
    p_t = torch.as_tensor(prompt, device="cuda")
    with torch.no_grad():
        lf, _ = chunked_prefill(model, p_t, None)
        lx, _ = chunked_prefill(ref_model, p_t, None)
    logit_err = float((lf - lx).abs().max())
    if not (torch.isfinite(lf).all() and logit_err <= 1e-3):
        # f32 through 12 layers: the kernel and the einsum path differ by
        # summation order only, ~1e-5 at the logits.
        raise AssertionError(f"flash prefill logits off by {logit_err}")
    ref_toks = generate(ref_model, prompt, max_new_tokens=NEW_TOKENS,
                        temperature=0.0).cpu().numpy()
    del ref_model
    res["generate"] = dict(
        prompt_len=GEN_PROMPT, new_tokens=NEW_TOKENS, wall_s=gen_s,
        flash_launches=flash_launches, launches=gen_n,
        prefill_logit_max_abs_err_vs_xla=logit_err,
        tokens_equal_xla=bool((ref_toks == toks).all()),
    )
    print(f"generate: 124M, prompt {GEN_PROMPT}, {NEW_TOKENS} new tokens in "
          f"{gen_s:.3f} s, flash launches {flash_launches}, prefill logits "
          f"vs xla max|err| {logit_err:.3g}, tokens equal xla "
          f"{res['generate']['tokens_equal_xla']}")

    # --- main path 2: a paged engine answering fp and int8 requests.
    eng = ServeEngine(model, max_slots=8, quant="fused_native")
    prompts = [rng.integers(0, cfg.vocab_size, size=L) for L in ENGINE_LENS]
    flags = [i % 2 == 1 for i in range(len(prompts))]
    _zero_counters(fa, im)
    t0 = time.monotonic()
    reqs = [
        eng.submit(p, max_new_tokens=NEW_TOKENS, quantize=q)
        for p, q in zip(prompts, flags)
    ]
    eng.run_until_idle()
    torch.cuda.synchronize()
    eng_s = time.monotonic() - t0
    int8_launches, eng_flash = dict(im.tile_launches), fa.launches
    eng_n = _counters(fa, im)
    if im.launches != sum(int8_launches.values()) or \
            0 in int8_launches.values():
        raise AssertionError(f"the engine's int8 requests launched the int8 "
                             f"kernel {int8_launches} times by tile (total "
                             f"{im.launches}): each tile must run")
    n_tok = sum(len(r.tokens) for r in reqs)
    reqs_out = []
    int8_solos = []  # the disaggregated leg's int8 ships and their tokens
    fp_solos = []  # the replica leg's prompts and their tokens
    for p, q, r in zip(prompts, flags, reqs):
        solo_model = eng._qmodel if q else model
        solo = generate(solo_model, p[None, :], max_new_tokens=NEW_TOKENS,
                        temperature=0.0)[0].cpu().numpy()
        if q and p.size >= DISAGG_INT8_MIN:
            int8_solos.append((p, solo))
        if not q:
            fp_solos.append((p, solo))
        if not (r.done and np.array_equal(r.result(), solo)):
            raise AssertionError(
                f"engine request (len {p.size}, int8={q}) differs from solo "
                f"generate(): {r.result()} vs {solo}"
            )
        reqs_out.append(dict(prompt_len=int(p.size), int8=q,
                             ttft_s=r.ttft_s, tokens=len(r.tokens)))
        print(f"  request len {p.size:4d} int8={q!s:5}: ttft "
              f"{r.ttft_s * 1e3:.1f} ms, equal to solo generate()")
    res["engine"] = dict(
        requests=reqs_out, wall_s=eng_s, tokens=n_tok,
        tokens_per_s=n_tok / eng_s, int8_launches=int8_launches,
        flash_launches=eng_flash, launches=eng_n, gpu=smi,
    )
    print(f"engine: {len(reqs)} requests ({sum(flags)} int8), {n_tok} tokens "
          f"in {eng_s:.3f} s = {n_tok / eng_s:.1f} tokens/s, int8 launches by "
          f"tile "
          f"{int8_launches} [{smi}]")
    res["engine_profile"] = engine_profile(torch, model, prompts, flags,
                                           eng_s)
    del eng
    res["disagg"] = disagg_leg(torch, model, rng, smi, int8_solos)
    res["replica"] = replica_leg(torch, model, smi, fp_solos)
    return res, flash_launches, int8_launches


def disagg_leg(torch, model, rng, smi, int8_solos) -> dict:
    """Disaggregated serving on ``model``: a prefill-role engine ships page
    sets, a decode-role engine imports them, every request's tokens equal
    to a solo ``generate()`` on its numeric path. ``int8_solos``: the int8
    prompts to ship, each with its solo ``generate()`` tokens on the
    quantized model. Each part's launches are
    read from zero and, on the card, held to the counts the code implies:
    a ship is one prefill (flash once a layer; an int8 ship also one
    prefill-tile call a product), an exact import none, a feed admission
    none. Off the card (the model on the CPU) the wrappers launch nothing
    and only the tokens are held."""
    from tpuflow_torch.infer import kv_store
    from tpuflow_torch.infer.generate import generate
    from tpuflow_torch.infer.serve import ServeEngine
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im

    t_leg = time.monotonic()
    cfg = model.config
    on_card = model.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    per_prefill = 4 * cfg.n_layer + 1  # int8 products a forward: + LM head
    store = os.path.join(REPO, "build", "disagg_kv")
    shutil.rmtree(store, ignore_errors=True)
    kw = dict(max_slots=8, page_size=DISAGG_PAGE, quant="fused_native",
              kv_store_dir=store)
    pf = ServeEngine(model, role="prefill", **kw)
    dc = ServeEngine(model, role="decode", **kw)
    totals: dict = {}
    walls: dict = {}

    def window(what, want, fn):
        """Run ``fn`` with every counter from 0; on the card, the flash
        forward's and each int8 tile's launches must be ``want``."""
        _zero_counters(fa, im)
        t0 = time.monotonic()
        out = fn()
        sync()
        walls[what] = walls.get(what, 0.0) + time.monotonic() - t0
        got = dict(flash_fwd=fa.launches, **{
            "int8_matmul" + ("" if t == "decode" else "_" + t): n
            for t, n in im.tile_launches.items()})
        if _counters(fa, im) != _launches(flash_fwd=fa.launches,
                                          int8_matmul=im.launches):
            raise AssertionError(f"disagg {what}: a kernel off this path "
                                 f"launched: {_counters(fa, im)}")
        if on_card and got != want:
            raise AssertionError(f"disagg {what}: launches {got}, want "
                                 f"{want}")
        for k, n in got.items():
            totals[k] = totals.get(k, 0) + n
        return out

    def want(flash=0, decode=0, prefill=0):
        return dict(flash_fwd=flash, int8_matmul=decode,
                    int8_matmul_prefill=prefill)

    refs = {(True, p.tobytes()): solo for p, solo in int8_solos}

    def held(what, r, quant, p):
        """``r``'s tokens against the solo ``generate()`` of ``p`` on its
        numeric path, run once a prompt and path."""
        key = (quant, p.tobytes())
        if key not in refs:
            t0 = time.monotonic()
            m = dc._qmodel if quant else model
            refs[key] = generate(m, p[None, :], max_new_tokens=NEW_TOKENS,
                                 temperature=0.0)[0].cpu().numpy()
            walls["solo"] = walls.get("solo", 0.0) + time.monotonic() - t0
        if not (r.done and np.array_equal(r.result(), refs[key])):
            raise AssertionError(f"disagg {what} (len {p.size}) differs "
                                 f"from solo generate(): {r.result()} vs "
                                 f"{refs[key]}")

    def admitted(r):
        return next(t for t in r.trace if t["phase"] == "admitted")

    # --- ships: three prompts a numeric path and a suffix's base.
    vocab = cfg.vocab_size
    ships = ([(rng.integers(0, vocab, size=L), False) for L in DISAGG_LENS]
             + [(p, True) for p, _ in int8_solos])
    base = rng.integers(0, vocab, size=DISAGG_SUFFIX[0])
    rows = []

    def ship_all():
        for p, q in ships + [(base, False)]:
            t0 = time.monotonic()
            key = pf.ship(p, quantize=q)
            ship_s = time.monotonic() - t0
            blob = os.path.getsize(pf.kv_store._blob(key))
            t0 = time.monotonic()
            pset = pf.kv_store.load(key)
            load_s = time.monotonic() - t0
            rows.append(dict(prompt_len=int(p.size), int8=q, key=key,
                             pages=pset.n_pages, blob_mb=blob / 1e6,
                             ship_s=ship_s, load_s=load_s,
                             ship_mb_s=blob / 1e6 / ship_s,
                             load_mb_s=blob / 1e6 / load_s))

    window("ships", want(flash=(len(ships) + 1) * cfg.n_layer,
                         prefill=per_prefill * len(int8_solos)),
           ship_all)
    for r in rows[:len(ships)]:
        print(f"  ship len {r['prompt_len']:4d} int8={r['int8']!s:5}: "
              f"{r['pages']} pages, {r['blob_mb']:.2f} MB, ship "
              f"{r['ship_s'] * 1e3:.1f} ms ({r['ship_mb_s']:.0f} MB/s), "
              f"load {r['load_s'] * 1e3:.1f} ms ({r['load_mb_s']:.0f} "
              f"MB/s) [{smi}]")

    # --- exact imports: no prefill, no flash launch on the decode engine.
    reqs = []

    def imports():
        (p0, q0), r0 = ships[0], rows[0]
        t0 = time.monotonic()
        reqs.append(dc.submit(p0, max_new_tokens=NEW_TOKENS, kv_key=r0["key"],
                              quantize=q0))
        r0["import_s"] = time.monotonic() - t0
        dc.step()  # the shipped admission alone: its TTFT
        for (p, q), r in zip(ships[1:], rows[1:]):
            t0 = time.monotonic()
            reqs.append(dc.submit(p, max_new_tokens=NEW_TOKENS,
                                  kv_key=r["key"], quantize=q))
            r["import_s"] = time.monotonic() - t0
        dc.run_until_idle()

    blocks = -(-(NEW_TOKENS - 1) // dc.decode_block)
    window("imports", want(decode=per_prefill * dc.decode_block * blocks),
           imports)
    if dc._prefill_calls:
        raise AssertionError(f"exact imports ran {dc._prefill_calls} "
                             "prefills on the decode engine")
    for (p, q), r, h in zip(ships, rows, reqs):
        if h.kv_import is None or admitted(h).get("prefilled") != "ship":
            raise AssertionError(f"the ship of len {p.size} int8={q} was "
                                 f"not admitted as shipped: {h.trace}")
        held("exact import", h, q, p)
        r["ttft_s"] = h.ttft_s

    # --- the first fp set torn, and a suffix resume: one prefill each,
    # decoded together.
    blob = pf.kv_store._blob(rows[0]["key"])
    with open(blob, "r+b") as fh:  # one byte flipped
        fh.seek(os.path.getsize(blob) // 2)
        b = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([b[0] ^ 0xFF]))
    torn = ships[0][0]
    ext = np.concatenate([base, rng.integers(0, vocab,
                                             size=DISAGG_SUFFIX[1])])
    fall = {}

    def fallbacks():
        fall["torn"] = dc.submit(torn, max_new_tokens=NEW_TOKENS,
                                 kv_key=rows[0]["key"])
        fall["suffix"] = dc.submit(ext, max_new_tokens=NEW_TOKENS,
                                   kv_key=rows[-1]["key"])
        dc.run_until_idle()

    window("fallbacks", want(flash=2 * cfg.n_layer), fallbacks)
    hs, ht = fall["suffix"], fall["torn"]
    if hs.kv_import is None or admitted(hs).get("shipped_pages") != \
            DISAGG_SUFFIX[0] // DISAGG_PAGE:
        raise AssertionError(f"the suffix resume imported no base pages: "
                             f"{hs.trace}")
    if ht.kv_import is not None or "kv_fallback" not in [
            t["phase"] for t in ht.trace]:
        raise AssertionError(f"the torn set did not fall back: {ht.trace}")
    held("suffix resume", hs, False, ext)
    held("torn fallback", ht, False, torn)
    if dc._prefill_calls != 2:
        raise AssertionError(f"suffix and torn ran {dc._prefill_calls} "
                             "prefills, want 2")

    # --- feed admissions through the host tier, under pool pressure: the
    # fp ship prompts again, each evicted by a churn prompt, re-admitted.
    fe = ServeEngine(model, max_slots=1, page_size=DISAGG_PAGE,
                     n_pages=FEED_POOL, kv_host_mb=FEED_HOST_MB)
    feeds = []
    for hot, _ in ships[:len(DISAGG_LENS)]:
        churn = rng.integers(0, vocab, size=FEED_CHURN)

        def evict():
            for p in (hot, churn):  # each ends at its admission
                fe.submit(p, max_new_tokens=1)
                fe.run_until_idle()

        window("feed evictions", want(flash=2 * cfg.n_layer), evict)
        if not all(fe.pool.tier.locate(d) == "host" for d in
                   kv_store.chain_digests(hot, DISAGG_PAGE)):
            raise AssertionError("the churn prompt left hot pages outside "
                                 "the host tier")
        calls = fe._prefill_calls

        def readmit():
            feeds.append(fe.submit(hot, max_new_tokens=NEW_TOKENS))
            fe.run_until_idle()

        window("feeds", want(), readmit)
        h, adm = feeds[-1], admitted(feeds[-1])
        if fe._prefill_calls != calls or (
                adm.get("prefilled"), adm.get("promoted_pages")) != (
                "feed", hot.size // DISAGG_PAGE):
            raise AssertionError(f"the hot prompt was not fed: {h.trace}")
        held("feed admission", h, False, hot)
    shutil.rmtree(store, ignore_errors=True)
    local_ttft = ht.ttft_s
    wall_s = time.monotonic() - t_leg
    parts = ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
    print(f"disagg: {wall_s:.1f} s ({parts}), {len(ships)} exact ships "
          f"({len(int8_solos)} int8), imports {walls['imports']:.3f} "
          f"s with 0 prefills; TTFT shipped {rows[0]['ttft_s'] * 1e3:.2f} "
          f"ms (+ import {rows[0]['import_s'] * 1e3:.2f} ms) vs local "
          f"{local_ttft * 1e3:.2f} ms, one prompt of {DISAGG_LENS[0]}; "
          f"suffix resume and torn fallback exact; {len(feeds)} feed "
          f"admissions exact, "
          f"{[h.prompt.size // DISAGG_PAGE for h in feeds]} pages promoted; "
          f"launches {totals} [{smi}]")
    return dict(ships=rows, import_wall_s=walls["imports"],
                ttft_shipped_s=rows[0]["ttft_s"],
                import_s=rows[0]["import_s"], ttft_local_s=local_ttft,
                feed_ttft_s=[h.ttft_s for h in feeds],
                host_spills=fe.pool.tier.spills_host, launches=totals,
                walls_s=walls, wall_s=wall_s, gpu=smi)


def _metrics_lines(text: str) -> dict:
    """A Prometheus text exposition parsed: sample name (labels kept) ->
    value. Fails on a line that is neither a comment nor a sample."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def replica_leg(torch, model, smi, fp_solos) -> dict:
    """The serving replica on ``model``: ``serve_forever(http_port=0)`` on
    the main thread, driven over HTTP by client threads, drained by a real
    SIGTERM. ``fp_solos``: the engine check's fp prompts with their solo
    ``generate()`` tokens, which every 200 answer must equal (no new solo
    run). The flash launches are read from 0 around the loop and, on the
    card, held to 12 per prefill whose prompt takes the flash path
    (``resolve_attention_impl`` on its real length, as the model's padded
    prefill dispatches), the ship hop's included; the import and the
    drained request prefill nothing. Afterwards the SIGTERM handler and
    the preemption flag are put back, the export stopped."""
    import signal
    import threading
    import urllib.request

    from tpuflow_torch import obs
    from tpuflow_torch.infer import frontdoor
    from tpuflow_torch.infer.serve import ServeEngine, serve_forever
    from tpuflow_torch.obs import export, fleet
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.ops.attention import resolve_attention_impl
    from tpuflow_torch.utils import heartbeat, preempt

    cfg = model.config
    on_card = model.device.type == "cuda"
    root = os.path.join(REPO, "build", "replica")
    shutil.rmtree(root, ignore_errors=True)
    reg = os.path.join(root, "fleet")
    os.makedirs(reg)
    eng = ServeEngine(model, max_slots=REPLICA_SLOTS, page_size=DISAGG_PAGE,
                      kv_store_dir=os.path.join(root, "kv"))
    solo = {p.tobytes(): s.tolist() for p, s in fp_solos}
    prompts = [p for p, _ in fp_solos]
    ship_p = max(prompts, key=len)
    answers: dict = {}
    prefilled: list = []  # prompt lengths whose admission prefills
    notes: dict = {}
    errors: list = []

    def send(row, rid, body, key=None):
        try:
            answers[key or rid] = (200, frontdoor.http_forward(
                row, {"id": rid, **body}, 120.0))
        except RuntimeError as e:
            answers[key or rid] = (503 if "answered 503" in str(e) else 0,
                                   str(e))

    def wave(row, bodies):
        threads = [threading.Thread(target=send, args=(row, rid, body))
                   for rid, body in bodies.items()]
        for t in threads:
            t.start()
        return threads

    def until(cond, what, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"replica leg: {what} timed out")
            time.sleep(0.002)

    def client():
        try:
            observatory = fleet.FleetObservatory(reg, stale_s=30.0,
                                                 poll_interval_s=0.05)
            rows = []

            def has_url():
                rows[:] = [r for r in observatory.poll()["replicas"]
                           if r.get("generate_url")]
                return bool(rows)

            until(has_url, "generate_url in /status")
            row = rows[0]
            notes["generate_url"] = row["generate_url"]
            notes["status_url"] = row["url"]  # the export's
            # Wave 1: the fp prompts at once; a replay; the ship hop and
            # the forward of its key.
            body = {p.tobytes(): {"prompt": p.tolist(),
                                  "max_new_tokens": NEW_TOKENS}
                    for p in prompts}
            for t in wave(row, {f"fp-{i}": body[p.tobytes()]
                                for i, p in enumerate(prompts)}):
                t.join()
            prefilled.extend(len(p) for p in prompts)
            n_req = eng._next_id
            send(row, "fp-0", {"prompt": [1]}, key="replay-fp-0")
            notes["replay_resubmitted"] = eng._next_id != n_req
            send(row, "ship-0", {"phase": "prefill",
                                 "prompt": ship_p.tolist()})
            prefilled.append(len(ship_p))
            calls = eng._prefill_calls
            key = answers["ship-0"][1]["kv_key"]
            send(row, "import-0", {**body[ship_p.tobytes()], "kv_key": key})
            notes["import_prefills"] = eng._prefill_calls - calls
            # Wave 2: every slot held, one request queued, then SIGTERM.
            held = [prompts[i % len(prompts)] for i in range(REPLICA_SLOTS)]
            threads = wave(row, {f"drain-{i}": body[p.tobytes()]
                                 for i, p in enumerate(held)})
            until(lambda: eng.live_slots == REPLICA_SLOTS,
                  "the slots filling")
            prefilled.extend(len(p) for p in held)
            threads += wave(row, {"queued-0": body[prompts[0].tobytes()]})
            until(lambda: eng.queue_depth == 1, "the ninth request queueing")
            notes["sigterm_live"] = eng.live_slots
            os.kill(os.getpid(), signal.SIGTERM)
            for t in threads:
                t.join()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    old_handler = signal.getsignal(signal.SIGTERM)
    preempt.clear_preemption()
    heartbeat.configure(os.path.join(root, "heartbeat"))
    export.stop()
    obs.goodput_live().reset()
    th = threading.Thread(target=client, name="replica-client")
    _zero_counters(fa, im)
    try:
        th.start()
        t0 = time.monotonic()
        eng.ledger.reset()
        serve_forever(eng, max_s=REPLICA_MAX_S, http_port=0,
                      registration_dir=reg,
                      should_stop=lambda: bool(errors))
        loop_s = time.monotonic() - t0
        ledger = eng.ledger.snapshot()
        th.join(timeout=60.0)
        # The export outlives the loop: its last scrape, the drained
        # request still queued for the requeue.
        with urllib.request.urlopen(notes["status_url"] + "/metrics",
                                    timeout=10) as r:
            metrics = _metrics_lines(r.read().decode())
        if on_card:
            torch.cuda.synchronize()
        launches = _counters(fa, im)
        drained_at = preempt.preemption_requested()
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        preempt.clear_preemption()
        heartbeat.configure(None)
        export.stop()
        obs.goodput_live().reset()
    if errors:
        raise AssertionError(f"replica leg client failed: {errors[0]!r}")
    if th.is_alive() or not drained_at:
        raise AssertionError("replica leg: the loop ended without a drain")
    if not os.path.exists(os.path.join(root, "heartbeat")):
        raise AssertionError("replica leg: no heartbeat was stamped")
    # The answers: 200 with the solo tokens, the replay from the cache,
    # the queued request drained.
    for rid, (code, payload) in sorted(answers.items()):
        if rid == "ship-0":
            if code != 200 or not payload.get("kv_key"):
                raise AssertionError(f"ship hop answered {code} {payload}")
            continue
        if rid == "replay-fp-0":
            continue  # held to fp-0's answer below
        if rid == "queued-0":
            if code != 503 or '"drained"' not in payload:
                raise AssertionError(f"the queued request answered {code} "
                                     f"{payload}, want 503 drained")
            continue
        if code != 200:
            raise AssertionError(f"{rid} answered {code} {payload}")
    fp_ids = [f"fp-{i}" for i in range(len(prompts))]
    drain_ids = [f"drain-{i}" for i in range(REPLICA_SLOTS)]
    for rid, p in [*zip(fp_ids, prompts),
                   *zip(drain_ids, [prompts[i % len(prompts)]
                                    for i in range(REPLICA_SLOTS)]),
                   ("import-0", ship_p)]:
        if answers[rid][1]["tokens"] != solo[p.tobytes()]:
            raise AssertionError(f"{rid} (len {p.size}) differs from solo "
                                 f"generate(): {answers[rid][1]['tokens']}")
    if answers["replay-fp-0"] != answers["fp-0"] or notes[
            "replay_resubmitted"]:
        raise AssertionError("the replay of fp-0 was not the cached answer: "
                             f"{answers['replay-fp-0']}")
    if notes["import_prefills"]:
        raise AssertionError(f"the kv_key forward ran "
                             f"{notes['import_prefills']} prefills")
    if notes["sigterm_live"] != REPLICA_SLOTS:
        raise AssertionError("the SIGTERM landed with free slots")
    for name in ("tpuflow_serve_requests_total", "tpuflow_serve_queue_depth",
                 "tpuflow_serve_slot_occupancy",
                 "tpuflow_serve_ttft_p50_seconds",
                 "tpuflow_serve_itl_p99_seconds",
                 "tpuflow_serve_idle_fraction",
                 "tpuflow_serve_decode_fraction",
                 "tpuflow_serve_prefill_fraction",
                 "tpuflow_serve_pages_free",
                 'tpuflow_serve_ttft_seconds_bucket{le="+Inf"}'):
        if name not in metrics:
            raise AssertionError(f"/metrics lacks {name}")
    served = len(prompts) + 1 + REPLICA_SLOTS  # the import's included
    got = (metrics["tpuflow_serve_queue_depth"],
           metrics["tpuflow_serve_slot_occupancy"],
           metrics["tpuflow_serve_requests_total"])
    if got != (1, 0, served):
        raise AssertionError(f"/metrics after the drain: (queue, occupancy, "
                             f"requests) {got}, want (1, 0, {served})")
    buckets = ledger["buckets"]
    total = sum(buckets.values())
    if abs(total - loop_s) > 0.01 * loop_s:
        raise AssertionError(f"ledger buckets sum to {total:.4f} s, the "
                             f"loop took {loop_s:.4f} s")
    n_flash = sum(resolve_attention_impl(
        cfg.attn_impl, n, needs_bwd=False,
        backend=model.device.type) == "flash" for n in prefilled)
    want = _launches(flash_fwd=cfg.n_layer * n_flash)
    if on_card and launches != want:
        raise AssertionError(f"replica leg launches {launches}, want {want}")
    if eng._prefill_calls != len(prefilled):
        raise AssertionError(f"the engine ran {eng._prefill_calls} "
                             f"prefills, want {len(prefilled)}")
    shutil.rmtree(root, ignore_errors=True)
    parts = ", ".join(f"{b} {v:.3f}" for b, v in buckets.items())
    print(f"replica: serve_forever {loop_s:.2f} s over HTTP "
          f"({len(answers)} answers: {len(prompts)} fp, a replay, a ship "
          f"hop and its import, {REPLICA_SLOTS} drained out, 1 queued -> "
          f"503 drained); ledger {parts} (sum {total:.3f} s); TTFT p50 "
          f"{metrics['tpuflow_serve_ttft_p50_seconds'] * 1e3:.1f} ms; flash "
          f"launches {launches['flash_fwd']} = {cfg.n_layer} x {n_flash} "
          f"prefills on the flash path [{smi}]")
    return dict(loop_s=loop_s, ledger=ledger, answers=len(answers),
                prefills=len(prefilled), flash_prefills=n_flash,
                launches=launches, generate_url=notes["generate_url"],
                metrics=metrics, gpu=smi)


def _decode_ms(torch, model, prompt, steps: int = 16) -> float:
    """Device-synchronized wall of one greedy decode step of ``model``
    after a prefill of ``prompt``, averaged over ``steps`` steps (one
    warm-up step first)."""
    from tpuflow_torch.infer.generate import chunked_prefill

    with torch.no_grad():
        logits, cache = chunked_prefill(model, prompt, None)
        for i in range(steps + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            logits, cache = model(tok[:, None], decode=True, cache=cache)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _chunk_cost(torch, model, prompt, width: int, reps: int = 8) -> dict:
    """One decode call over a (B, ``width``) chunk after a prefill of
    ``prompt``: its device-synchronized wall (the cache index reset before
    each of ``reps`` calls) and the CUDA kernels it launches (profiler)."""
    from tpuflow_torch.infer.generate import chunked_prefill

    with torch.no_grad():
        _, cache = chunked_prefill(model, prompt, None)
        T = cache.index
        chunk = prompt[:, :width]

        def call():
            cache.index = T
            model(chunk, decode=True, cache=cache)

        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        return dict(ms=ms, kernels=len(kernel_trace(torch, call)))


def _split_cost(torch, model, prompt, width: int) -> dict:
    """What running a multi-token decode chunk one (row, position) at a
    time costs (``models/gpt2.py::_tokenwise``): the chunk split as the
    model runs it, the same chunk split by rows only (the products at
    M = width; timing only, its rounding is not decode's), and one
    single-token step."""
    from tpuflow_torch.models import gpt2

    split = _chunk_cost(torch, model, prompt, width)
    tokenwise, decode_attention = gpt2._tokenwise, gpt2._decode_attention
    gpt2._tokenwise = gpt2._rowwise
    gpt2._decode_attention = (
        lambda q, k, v, valid: gpt2._rowwise(gpt2._masked_attention, q, k,
                                             v, valid))
    try:
        rows_only = _chunk_cost(torch, model, prompt, width)
    finally:
        gpt2._tokenwise, gpt2._decode_attention = tokenwise, decode_attention
    step = _chunk_cost(torch, model, prompt, 1)
    return dict(batch=prompt.shape[0], width=width, split=split,
                rows_only=rows_only, single_step=step)


def _timed(torch, fn):
    """``(fn(), device-synchronized wall seconds)``."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def generation_phase(torch, smi) -> dict:
    """The generation surface on GPT-2 124M (``from_preset("gpt2")``,
    weights from seed 0, ``attn_impl`` auto, f32), each leg's launch
    counts read from zero:

    1. Beam search on a (2, 512) prompt, 32 new tokens: K = 1 equals
       greedy ``generate()``; K = 4 prefills once at width 2 (12 flash
       launches) and each row's best score is within ``BEAM_SCORE_ATOL``
       of ``sequence_logprob(per_token=True)`` of its tokens (scored on
       the flash forward); K = 4 on the fused-native model runs both int8
       tiles.
    2. ``speculative_generate(draft_len=4, ngram=3)`` on 512-token prompts
       repeating a 32-token segment, batch 1 and 4, 64 new tokens, fp and
       fused-native: tokens equal ``generate(temperature=0)``;
       committed tokens per forward and the wall against generate()'s.
    3. ``ServeEngine(speculative=4, quant="fused_native")`` on the
       ``ENGINE_LENS`` traffic, half the requests speculative, fp and int8
       mixed: each equals its solo ``generate()``; tokens/s with and
       without speculation, the acceptance rate.
    4. Weight-only int8: greedy tokens equal an fp GPT2 loaded with
       ``dequantize_params`` of the same leaves; int8 bytes against fp;
       ``teacher_forced_agreement`` against fp; decode ms per token at
       batch 8 of fp, weight-only and fused-native (the card's numbers
       behind ``quant_decision``).
    5. ``GenerationPredictor`` through ``map_batches`` on 16 ragged prompts
       (5-300 tokens) at batch 8: every row equals a per-row
       ``generate()``, the second batch through the engine route; then
       ``quantize="int8-native", speculative=True`` on a dense batch."""
    from tpuflow_torch.infer import beam as beam_mod
    from tpuflow_torch.infer.beam import beam_search
    from tpuflow_torch.infer.engine import GenerationPredictor, map_batches
    from tpuflow_torch.infer.generate import generate
    from tpuflow_torch.infer.quant import (
        dequantize_params,
        quant_decision,
        quantize_model,
        quantized_nbytes,
        teacher_forced_agreement,
    )
    from tpuflow_torch.infer.score import sequence_logprob
    from tpuflow_torch.infer.serve import ServeEngine
    from tpuflow_torch.infer.speculative import speculative_generate
    from tpuflow_torch.models.convert import params_from_jax
    from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im

    cfg = GPT2Config.from_preset("gpt2")
    model = GPT2(cfg, seed=0)
    qmodel = quantize_model(model, mode="fused_native")
    rng = np.random.default_rng(10)
    res, launches, tiles = {"gpu": smi}, {}, {}

    def counted(name, fn):
        """``fn()`` with every counter read from zero; its wall."""
        _zero_counters(fa, im)
        out, wall = _timed(torch, fn)
        launches[name] = _counters(fa, im)
        tiles[name] = dict(im.tile_launches)
        return out, wall

    def solo(m, p, n, **kw):
        return generate(m, np.asarray(p)[None], max_new_tokens=n,
                        temperature=0.0, **kw)[0].cpu().numpy()

    # --- 1. beam search.
    prompt = rng.integers(0, cfg.vocab_size, size=(2, GEN_PROMPT))
    greedy = generate(model, prompt, max_new_tokens=NEW_TOKENS,
                      temperature=0.0).cpu().numpy()
    best1, _ = beam_search(model, prompt, beam_size=1,
                           max_new_tokens=NEW_TOKENS)
    if not np.array_equal(best1.cpu().numpy(), greedy):
        raise AssertionError("beam_search(K=1) differs from greedy "
                             "generate()")
    widths = []
    prefill = beam_mod.chunked_prefill

    def recording_prefill(m, p, *a, **kw):
        widths.append(tuple(p.shape))
        return prefill(m, p, *a, **kw)

    beam_mod.chunked_prefill = recording_prefill
    try:
        (best, scores), beam_s = counted("beam", lambda: beam_search(
            model, prompt, beam_size=BEAM_K, max_new_tokens=NEW_TOKENS))
    finally:
        beam_mod.chunked_prefill = prefill
    if launches["beam"] != _launches(flash_fwd=cfg.n_layer):
        raise AssertionError(f"beam K={BEAM_K} launched {launches['beam']}, "
                             f"want {cfg.n_layer} flash forwards")
    if widths != [(2, GEN_PROMPT)]:
        raise AssertionError(f"beam prefill widths {widths}, want one at "
                             f"width 2")
    scorer = GPT2(dataclasses.replace(cfg, attn_impl="flash"), seed=None)
    scorer.load_state_dict(model.state_dict())
    full = np.concatenate([prompt, best.cpu().numpy()], axis=1)
    mask = np.zeros(full.shape, np.float32)
    mask[:, GEN_PROMPT:] = 1.0
    lp, _ = counted("score", lambda: sequence_logprob(
        scorer, full, mask=mask, per_token=True))
    del scorer
    if launches["score"] != _launches(flash_fwd=cfg.n_layer):
        raise AssertionError(f"sequence_logprob launched "
                             f"{launches['score']}")
    score_err = float((lp - scores).abs().max())
    if not score_err <= BEAM_SCORE_ATOL:
        raise AssertionError(f"beam scores {scores} vs sequence_logprob "
                             f"{lp}: {score_err}")
    _, qbeam_s = counted("beam_int8", lambda: beam_search(
        qmodel, prompt, beam_size=BEAM_K, max_new_tokens=NEW_TOKENS))
    if not (tiles["beam_int8"]["decode"] and tiles["beam_int8"]["prefill"]):
        raise AssertionError(f"fused-native beam int8 tiles "
                             f"{tiles['beam_int8']}")
    res["beam"] = dict(
        k=BEAM_K, prompt=[2, GEN_PROMPT], new_tokens=NEW_TOKENS,
        wall_s=beam_s, int8_wall_s=qbeam_s, scores=scores.tolist(),
        score_max_abs_err_vs_sequence_logprob=score_err,
        launches=launches["beam"], int8_tiles=tiles["beam_int8"],
        score_launches=launches["score"])
    print(f"beam K={BEAM_K}: 2 x {GEN_PROMPT}, {NEW_TOKENS} new tokens in "
          f"{beam_s:.3f} s (fused-native {qbeam_s:.3f} s), K=1 equal to "
          f"greedy, scores {[round(x, 5) for x in scores.tolist()]} within "
          f"{score_err:.2g} of sequence_logprob, flash launches "
          f"{launches['beam']['flash_fwd']} (prefill once at width 2), int8 "
          f"tiles {tiles['beam_int8']} [{smi}]")

    # --- 2. speculative decoding, solo.
    res["speculative"] = []
    for B in (1, 4):
        segs = rng.integers(0, cfg.vocab_size, size=(B, SPEC_SEGMENT))
        sp_prompt = np.tile(segs, (1, GEN_PROMPT // SPEC_SEGMENT))
        for name, m in (("fp", model), ("fused_native", qmodel)):
            want, gen_s = _timed(torch, lambda: generate(
                m, sp_prompt, max_new_tokens=SPEC_NEW, temperature=0.0))
            leg = f"spec_{name}_b{B}"
            (got, stats), spec_s = counted(leg, lambda: speculative_generate(
                m, sp_prompt, max_new_tokens=SPEC_NEW, draft_len=SPEC_K,
                ngram=3, return_stats=True))
            if not torch.equal(got, want):
                raise AssertionError(f"speculative {name} batch {B} differs "
                                     "from generate()")
            rate = stats["n_committed"] / stats["n_forwards"]
            res["speculative"].append(dict(
                batch=B, model=name, wall_s=spec_s, generate_wall_s=gen_s,
                launches=launches[leg], **stats))
            print(f"speculative {name} batch {B}: {SPEC_NEW} tokens equal to "
                  f"generate(); {stats['n_committed']} / "
                  f"{stats['n_forwards']} forwards = {rate:.2f} tokens a "
                  f"forward; {spec_s:.3f} s vs generate() {gen_s:.3f} s "
                  f"[{smi}]")

    # What the verify chunk's split costs at (4, K + 1).
    sp_prompt = torch.as_tensor(sp_prompt, device=model.device)
    cost = _split_cost(torch, model, sp_prompt, SPEC_K + 1)
    res["verify_split_cost"] = cost
    print(f"verify chunk (4, {SPEC_K + 1}), fp: split by (row, position) "
          f"{cost['split']['ms']:.2f} ms, {cost['split']['kernels']} kernels; "
          f"by rows only {cost['rows_only']['ms']:.2f} ms, "
          f"{cost['rows_only']['kernels']} kernels; one single-token step "
          f"{cost['single_step']['ms']:.2f} ms, "
          f"{cost['single_step']['kernels']} kernels [{smi}]")

    # --- 3. the engine with speculative verify, fp and int8 mixed.
    prompts = [rng.integers(0, cfg.vocab_size, size=L) for L in ENGINE_LENS]
    flags = [(i % 2 == 1, i % 4 < 2) for i in range(len(prompts))]
    eng = ServeEngine(model, max_slots=8, speculative=SPEC_K,
                      quant="fused_native")

    def serve(spec_on):
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS, quantize=q,
                           speculative=sp and spec_on)
                for p, (q, sp) in zip(prompts, flags)]
        eng.run_until_idle()
        return reqs

    reqs, eng_s = counted("engine_spec", lambda: serve(True))
    for p, (q, sp), r in zip(prompts, flags, reqs):
        want = solo(eng._qmodel if q else model, p, NEW_TOKENS)
        if not (r.done and np.array_equal(r.result(), want)):
            raise AssertionError(f"engine request (len {p.size}, int8={q}, "
                                 f"speculative={sp}) differs from solo "
                                 "generate()")
    n_tok = sum(len(r.tokens) for r in reqs)
    plain, plain_s = counted("engine_plain", lambda: serve(False))
    n_plain = sum(len(r.tokens) for r in plain)
    res["engine"] = dict(
        requests=len(reqs), speculative=sum(sp for _, sp in flags),
        int8=sum(q for q, _ in flags), tokens=n_tok, wall_s=eng_s,
        tokens_per_s=n_tok / eng_s, plain_wall_s=plain_s,
        plain_tokens_per_s=n_plain / plain_s,
        spec_accept_rate=eng.spec_accept_rate,
        launches=launches["engine_spec"])
    print(f"engine, speculative={SPEC_K} + fused_native: {len(reqs)} requests "
          f"(half speculative, half int8) equal to solo generate(); "
          f"{n_tok / eng_s:.1f} tokens/s ({eng_s:.3f} s), without "
          f"speculation {n_plain / plain_s:.1f} tokens/s ({plain_s:.3f} s); "
          f"accept rate {eng.spec_accept_rate:.3f} tokens a verify [{smi}]")

    # --- 4. weight-only int8.
    wmodel = quantize_model(model, mode="weight")
    deq = GPT2(cfg, seed=None)
    deq.load_state_dict(params_from_jax(dequantize_params(wmodel.leaves),
                                        device=model.device))
    wp = prompt[:1]
    got, w_s = counted("weight_only", lambda: generate(
        wmodel, wp, max_new_tokens=NEW_TOKENS, temperature=0.0))
    want = generate(deq, wp, max_new_tokens=NEW_TOKENS, temperature=0.0)
    if not torch.equal(got, want):
        raise AssertionError("weight-only tokens differ from the fp model "
                             "loaded with the dequantized leaves")
    del deq
    fp_bytes = sum(p.nbytes for p in model.parameters())
    q_bytes = quantized_nbytes(wmodel.leaves)
    ref = generate(model, wp, max_new_tokens=NEW_TOKENS, temperature=0.0)
    toks = np.concatenate([wp, ref.cpu().numpy()], axis=1)
    agree = teacher_forced_agreement(model, wmodel, toks, GEN_PROMPT)
    dp = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                      size=(DECODE_M, WEIGHT_PROMPT)),
                         device=model.device)
    # Host-bound steps whose wall drifts within a call: two rounds, the
    # second in reverse order, each model's mean of the two.
    order = (("fp", model), ("weight_only", wmodel), ("fused_native", qmodel))
    rounds = [{name: _decode_ms(torch, m, dp) for name, m in seq}
              for seq in (order, order[::-1])]
    ms = {name: (rounds[0][name] + rounds[1][name]) / 2 for name, _ in order}
    decision = quant_decision(model)
    res["weight_only"] = dict(
        wall_s=w_s, fp_bytes=fp_bytes, int8_bytes=q_bytes,
        teacher_forced_agreement=agree, decode_ms_per_token_b8=ms,
        decode_ms_rounds=rounds,
        decision=dataclasses.asdict(decision),
        launches=launches["weight_only"])
    print(f"weight-only int8: tokens equal the dequantized fp model's; "
          f"{q_bytes / 2**20:.1f} MiB vs fp {fp_bytes / 2**20:.1f} MiB; "
          f"teacher-forced agreement with fp {agree:.4f}; decode ms a token "
          f"at batch {DECODE_M}, the mean of two rounds: "
          + ", ".join(f"{name} {ms[name]:.2f} ({rounds[0][name]:.2f}, "
                      f"{rounds[1][name]:.2f})" for name, _ in order)
          + "; "
          f"quant_decision apply={decision.apply} [{smi}]")

    # --- 5. GenerationPredictor.
    rows = [{"tokens": rng.integers(0, cfg.vocab_size, size=L)}
            for L in rng.integers(5, 301, size=16)]
    pred = GenerationPredictor(model, max_new_tokens=NEW_TOKENS)
    out, pred_s = counted("predictor", lambda: map_batches(
        rows, pred, batch_size=DECODE_M))
    for r, o in zip(rows, out):
        if not np.array_equal(o["generated"],
                              solo(model, r["tokens"], NEW_TOKENS)):
            raise AssertionError("GenerationPredictor row differs from its "
                                 "per-row generate()")
    if (pred.stats["generate_batches"], pred.stats["serve_batches"]) != (1, 1):
        raise AssertionError(f"predictor routes {pred.stats}: want the "
                             "second batch on the engine")
    segs = rng.integers(0, cfg.vocab_size, size=(DECODE_M, SPEC_SEGMENT))
    dense = np.tile(segs, (1, 4))
    spred = GenerationPredictor(model, max_new_tokens=NEW_TOKENS,
                                quantize="int8-native", speculative=True,
                                draft_len=SPEC_K)
    sout, spred_s = counted("predictor_spec", lambda: spred(
        {"tokens": dense}))
    want = generate(spred.model, dense, max_new_tokens=NEW_TOKENS,
                    temperature=0.0).cpu().numpy()
    if not (np.array_equal(sout["generated"], want)
            and spred.stats["spec_batches"] == 1):
        raise AssertionError(f"speculative int8 predictor {spred.stats} "
                             "differs from generate()")
    res["predictor"] = dict(
        rows=len(rows), wall_s=pred_s, stats=pred.stats,
        spec_int8_wall_s=spred_s, spec_int8_stats=spred.stats,
        launches=launches["predictor"])
    print(f"GenerationPredictor: 16 ragged rows at batch {DECODE_M} in "
          f"{pred_s:.3f} s, routes {pred.stats}; int8-native speculative "
          f"dense batch in {spred_s:.3f} s, {spred.stats}; every row equal "
          f"to its generate() [{smi}]")
    res["launches"], res["int8_tiles"] = launches, tiles
    return res


def _busy(kernels) -> float:
    """Union of the kernels' [ts, ts + dur] intervals, in us."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _top(kernels, n: int = 8):
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e["name"][:80]] = by_name.get(e["name"][:80], 0.0) + e["dur"]
    return [(k, d / 1e3) for k, d in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def _train_cfg():
    """The training slice's ``train_gpt`` call: GPT-2 124M at full width
    and depth, TRAIN_EPOCHS x TRAIN_STEPS_PER_EPOCH steps of 8 x 1024,
    flash (the preset's full remat, dropout 0.1, AdamW, f32)."""
    from tpuflow_torch.train.gpt import GptTrainConfig

    return GptTrainConfig(
        preset="gpt2", seq_len=1024, batch_size=8, epochs=TRAIN_EPOCHS,
        steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="flash",
        data_axis=1, fsdp_axis=1,
    )


def train_phase(torch, smi):
    """The training main path through train_gpt, then two profiled steps
    and the flash-vs-einsum step parity."""
    from tpuflow_torch.data.lm import make_lm_loaders
    from tpuflow_torch.device import f32_matmul_precision
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train.gpt import train_gpt

    cfg = _train_cfg()
    model_cfg = cfg.model_config()
    L = model_cfg.n_layer
    n_val = len(make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                cfg.seq_len, model_cfg.vocab_size)[1])
    # Full remat: each step runs every block's forward (lse) once in the
    # forward pass and once more when the backward recomputes it, and the
    # fused pair once; validation runs the no-lse forward per layer.
    want = _launches(flash_fwd_lse=2 * L * TRAIN_STEPS,
                     flash_bwd_dq=L * TRAIN_STEPS,
                     flash_bwd_dkv=L * TRAIN_STEPS,
                     flash_fwd=L * n_val * TRAIN_EPOCHS)
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(fa, im)
    t0 = time.monotonic()
    res = train_gpt(cfg, log=lambda m: print(f"  {m}"))
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    got = _counters(fa, im)
    peak = torch.cuda.max_memory_allocated()
    print(f"train_gpt launches {got} (want {want})")
    if got != want:
        raise AssertionError(f"train_gpt launches {got}, want {want}")
    losses = res.step_losses
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train_gpt losses {losses}")
    hist = res.loss_history
    if not (losses[-1] < losses[0] and hist[-1] < hist[0]):
        raise AssertionError(f"train_gpt loss did not fall: steps {losses}, "
                             f"epoch means {hist}")
    step_ms = float(np.median(res.step_s[1:])) * 1e3
    tok_s = res.metrics_history[-1]["tokens_per_s"]
    out = dict(
        config=dataclasses.asdict(cfg), wall_s=wall_s,
        step_losses=losses, step_s=res.step_s, step_ms_median=step_ms,
        epochs=res.metrics_history, tokens_per_s=tok_s,
        peak_memory_bytes=peak, launches=got, gpu=smi,
    )
    print(f"train_gpt: GPT-2 124M, {TRAIN_EPOCHS} x {TRAIN_STEPS_PER_EPOCH} "
          f"steps of 8 x 1024, full remat, f32, flash: step losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; epoch means "
          f"{', '.join(f'{x:.4f}' for x in hist)}; step {step_ms:.1f} ms "
          f"(median after the cold step), {tok_s} tokens/s (last epoch), "
          f"peak memory {peak / 2**30:.2f} GiB, wall {wall_s:.2f} s [{smi}]")
    # The monitor's cost: the same call without it (after the default
    # one, so on a warm allocator), the same numerics.
    off = train_gpt(cfg, health=False, log=lambda m: None)
    torch.cuda.synchronize()
    if off.step_losses != losses:
        raise AssertionError(f"train_gpt(health=False) losses "
                             f"{off.step_losses}, want {losses}")
    off_ms = float(np.median(off.step_s[1:])) * 1e3
    out["step_ms_median_health_off"] = off_ms
    print(f"train_gpt step with the health monitor {step_ms:.2f} ms, "
          f"without it (health=False, the next call) {off_ms:.2f} ms; "
          f"losses bit-equal [{smi}]")
    out["profile"] = train_profile(torch, cfg, step_ms, smi)
    with f32_matmul_precision():
        out["parity"] = step_parity(torch, cfg)
    out["bf16"] = bf16_phase(torch, smi, cfg)
    out["split_ckpt"], out["split_launches"] = split_ckpt_phase(
        torch, smi, cfg, losses)
    out["ckpt_io"] = ckpt_io_phase(torch, smi, cfg)
    return out, got


def bf16_phase(torch, smi, cfg) -> dict:
    """The bf16 recipe's leg: the same ``train_gpt`` call with
    ``dtype="bfloat16"`` for one epoch of 8 steps, so the flash forward
    with lse and the backward pair run their tensor-core (bf16) variants
    on the main path. Every loss finite, every launch count exact."""
    from tpuflow_torch.data.lm import make_lm_loaders
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train.gpt import train_gpt

    bcfg = dataclasses.replace(cfg, dtype="bfloat16", epochs=1)
    L = cfg.model_config().n_layer
    spe = bcfg.steps_per_epoch
    n_val = len(make_lm_loaders(cfg.batch_size, spe, cfg.seq_len,
                                cfg.model_config().vocab_size)[1])
    # Full remat: two forwards with lse a layer and step, one fused pair;
    # all of them bf16.
    want = _launches(flash_fwd_lse=2 * L * spe, flash_bwd_dq=L * spe,
                     flash_bwd_dkv=L * spe, flash_fwd=L * n_val,
                     flash_fwd_lse_bf16=2 * L * spe,
                     flash_bwd_dq_bf16=L * spe, flash_bwd_dkv_bf16=L * spe)
    _zero_counters(fa, im)
    t0 = time.monotonic()
    res = train_gpt(bcfg, log=lambda m: print(f"  {m}"))
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    got = _counters(fa, im)
    print(f"bf16 leg launches {got} (want {want})")
    if got != want:
        raise AssertionError(f"bf16 leg launches {got}, want {want}")
    losses = res.step_losses
    if len(losses) != spe or not all(np.isfinite(losses)):
        raise AssertionError(f"bf16 leg losses {losses}")
    step_ms = float(np.median(res.step_s[1:])) * 1e3
    tok_s = res.metrics_history[-1]["tokens_per_s"]
    print(f"bf16 leg: GPT-2 124M, {spe} steps of 8 x 1024, full remat, "
          f"dtype bfloat16, flash: step losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step {step_ms:.1f} ms "
          f"(median after the cold step), {tok_s} tokens/s, wall "
          f"{wall_s:.2f} s [{smi}]")
    return dict(wall_s=wall_s, step_losses=losses, step_s=res.step_s,
                step_ms_median=step_ms, tokens_per_s=tok_s, launches=got,
                gpu=smi)


def _launches(**counts) -> dict:
    """The launch counts a leg must read from ``_counters``: ``counts``,
    and 0 for every other counter."""
    return {k: counts.pop(k, 0) for k in LAUNCH_COUNTERS} | counts


def _zero_counters(fa, im) -> None:
    fa.launches = fa.launches_lse = fa.launches_lse_bf16 = 0
    fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    fa.launches_bwd_dq_split = fa.launches_bwd_dkv_split = 0
    fa.launches_bwd_dq_bf16 = fa.launches_bwd_dkv_bf16 = 0
    fa.wide_launches.update(dict.fromkeys(fa.wide_launches, 0))
    im.launches = 0
    im.tile_launches.update(decode=0, prefill=0)


def _counters(fa, im) -> dict:
    return {"flash_fwd_lse": fa.launches_lse,
            "flash_bwd_dq": fa.launches_bwd_dq,
            "flash_bwd_dkv": fa.launches_bwd_dkv,
            "flash_bwd_dq_split": fa.launches_bwd_dq_split,
            "flash_bwd_dkv_split": fa.launches_bwd_dkv_split,
            "flash_fwd": fa.launches, "int8_matmul": im.launches,
            "flash_fwd_lse_bf16": fa.launches_lse_bf16,
            "flash_bwd_dq_bf16": fa.launches_bwd_dq_bf16,
            "flash_bwd_dkv_bf16": fa.launches_bwd_dkv_bf16} | {
                f"{k}_wide": n for k, n in fa.wide_launches.items()}


def _shards(step_dir: str) -> list:
    """(path, shape, dtype, file, crc32) of every shard of a step."""
    with open(os.path.join(step_dir, "state", "manifest.json")) as fh:
        leaves = json.load(fh)["leaves"]
    return [(e["path"], e["shape"], e["dtype"], s["file"], s["crc32"])
            for e in leaves for s in e["shards"]]


def _io_line(what: str, recs: list) -> str:
    return "; ".join(
        f"{what} step {r['step']}: {r['bytes'] / 1e9:.3f} GB in "
        f"{r['seconds']:.3f} s = {r['gbps']:.2f} GB/s"
        + (f" (host copy {r['host_copy_s']:.3f} s)" if "host_copy_s" in r
           else "") for r in recs)


def _pool_rule(ckpt_dir: str, step_dir: str) -> tuple[int, bool]:
    """The step's shards of 64 KiB or more, and whether the manager
    prewarms its pool on ``ckpt_dir``'s storage (memory-backed only)."""
    from tpuflow_torch.ckpt import raw

    n_big = sum(raw._nbytes(shape, raw.torch_dtype(dtype))
                >= raw._POOL_MIN_BYTES
                for _, shape, dtype, _, _ in _shards(step_dir))
    return n_big, raw._fs_is_memory_backed(ckpt_dir)


def _check_recycled(leg: str, saves: list, n_big: int, warm: bool) -> None:
    """A leg's saves drew every shard of 64 KiB or more from a prewarmed
    pool (the first may race the background prewarm), or, on a disk (no
    warm files, nothing retired yet), none."""
    got = [r["recycled"] for r in saves]
    ok = (all(n <= n_big for n in got) and got[1:] == [n_big] * len(got[1:])
          if warm else got == [0] * len(got))
    if not ok:
        raise AssertionError(f"{leg}: its saves drew {got} files from the "
                             f"pool, want {n_big if warm else 0} each")


def _recycled_line(saves: list, n_big: int, warm: bool) -> str:
    return (f"files drawn from the pool {[r['recycled'] for r in saves]} "
            + (f"of {n_big} of 64 KiB or more" if warm else
               "(a disk: no warm files)"))


def split_ckpt_phase(torch, smi, cfg, fused_losses) -> tuple[dict, dict]:
    """The split backward with per-epoch checkpoints, then an in-run resume
    from a copy of its directory without the last step."""
    from tpuflow_torch.data.lm import make_lm_loaders
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train.gpt import train_gpt

    L = cfg.model_config().n_layer
    n_val = len(make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                cfg.seq_len, cfg.model_config().vocab_size)[1])
    spe = TRAIN_STEPS_PER_EPOCH
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                            dir=os.path.join(REPO, "build"))
    try:
        # --- the split leg: 2 epochs, saves at steps 8 and 16.
        split_dir = os.path.join(root, "split")
        _zero_counters(fa, im)
        t0 = time.monotonic()
        res = train_gpt(cfg, ckpt_dir=split_dir, flash_bwd="split",
                        log=lambda m: print(f"  {m}"))
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        got = _counters(fa, im)
        want = _launches(flash_fwd_lse=2 * L * TRAIN_STEPS,
                         flash_bwd_dq_split=L * TRAIN_STEPS,
                         flash_bwd_dkv_split=L * TRAIN_STEPS,
                         flash_fwd=L * n_val * TRAIN_EPOCHS)
        print(f"split leg launches {got} (want {want})")
        if got != want:
            raise AssertionError(f"split leg launches {got}, want {want}")
        if res.step_losses != fused_losses:
            raise AssertionError(
                f"split leg losses {res.step_losses} differ from the fused "
                f"leg's {fused_losses}")
        # Beside the steps, .recycle: the pool, where there is one.
        steps = set(os.listdir(split_dir)) - {".recycle"}
        if steps != {f"step_{spe}", f"step_{TRAIN_STEPS}"}:
            raise AssertionError(f"split leg left {steps}")
        last = os.path.join(split_dir, f"step_{TRAIN_STEPS}")
        if res.checkpoint is None or res.checkpoint.path != last:
            raise AssertionError(f"split leg handle {res.checkpoint}")
        split_shards = _shards(last)
        saves = res.checkpoint_io["saves"]
        n_big, warm = _pool_rule(split_dir, last)
        _check_recycled("split leg", saves, n_big, warm)
        pool_dir = os.path.join(split_dir, ".recycle")
        if not warm and os.path.isdir(pool_dir) and os.listdir(pool_dir):
            raise AssertionError(f"the manager wrote warm files on a disk: "
                                 f"{os.listdir(pool_dir)}")
        print(f"split leg: {TRAIN_STEPS} losses bit-equal to the fused "
              f"leg's; {_io_line('save', saves)}; "
              f"{_recycled_line(saves, n_big, warm)} [{smi}]")

        # --- the resume leg: the directory without its last step.
        resume_dir = os.path.join(root, "resume")
        shutil.copytree(split_dir, resume_dir,
                        ignore=shutil.ignore_patterns(f"step_{TRAIN_STEPS}",
                                                      ".recycle"))
        shutil.rmtree(split_dir)
        logs = []
        _zero_counters(fa, im)
        t0 = time.monotonic()
        res2 = train_gpt(cfg, ckpt_dir=resume_dir, flash_bwd="split",
                         log=lambda m: (logs.append(m), print(f"  {m}")))
        torch.cuda.synchronize()
        resume_wall_s = time.monotonic() - t0
        got2 = _counters(fa, im)
        want2 = dict(want, flash_fwd_lse=2 * L * spe,
                     flash_bwd_dq_split=L * spe, flash_bwd_dkv_split=L * spe,
                     flash_fwd=L * n_val)
        print(f"resume leg launches {got2} (want {want2})")
        if got2 != want2:
            raise AssertionError(f"resume leg launches {got2}, want {want2}")
        if not any(f"in-run resume from step {spe} → epoch 1" in m
                   for m in logs):
            raise AssertionError(f"no in-run resume from step {spe}, epoch "
                                 f"1 in the log: {logs}")
        if res2.step_losses != res.step_losses[spe:]:
            raise AssertionError(
                f"resume leg losses {res2.step_losses} differ from the "
                f"split leg's last {spe} {res.step_losses[spe:]}")
        resumed = _shards(os.path.join(resume_dir, f"step_{TRAIN_STEPS}"))
        if resumed != split_shards:
            bad = [a for a, b in zip(resumed, split_shards) if a != b][:3]
            raise AssertionError(f"resume leg step_{TRAIN_STEPS} differs "
                                 f"from the split leg's: {bad}")
        io2 = res2.checkpoint_io
        _check_recycled("resume leg", io2["saves"], n_big, warm)
        (rec,) = io2["restores"]
        n_leaves = len(resumed)  # one shard a leaf
        if rec["arena_buffers"] != n_leaves or rec["pinned"] != n_leaves:
            raise AssertionError(
                f"the resume's restore took {rec['arena_buffers']} "
                f"prewarmed buffers and handed out {rec['pinned']} pinned "
                f"leaves, want {n_leaves} and {n_leaves}")
        held = torch.cuda.host_memory_stats()["allocated_bytes.current"]
        if held >= rec["bytes"]:
            raise AssertionError(
                f"the host allocator holds {held} pinned bytes after the "
                f"resume, not fewer than the {rec['bytes']} restored")
        print(f"resume leg: resumed at step {spe}, {spe} losses bit-equal "
              f"to the split leg's last {spe}, step_{TRAIN_STEPS}: "
              f"{len(resumed)} shard crc32s equal; "
              f"{_io_line('restore', io2['restores'])} ({n_leaves} "
              f"prewarmed buffers taken, {n_leaves} leaves pinned; "
              f"{held / 1e6:.1f} MB pinned held after it); "
              f"{_io_line('save', io2['saves'])}; "
              f"{_recycled_line(io2['saves'], n_big, warm)} (this "
              f"machine's host disk) [{smi}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = dict(split=dict(wall_s=wall_s, launches=got,
                          step_losses=res.step_losses, saves=saves,
                          shards=len(split_shards),
                          step_shards=split_shards),
               resume=dict(wall_s=resume_wall_s, launches=got2,
                           step_losses=res2.step_losses,
                           restores=io2["restores"], saves=io2["saves"]),
               gpu=smi)
    return out, got


def _fadvise_out(paths) -> None:
    """Drop the files' clean pages from the page cache (no root needed:
    every file here was fsynced), so the next read comes from the disk."""
    for p in paths:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def _bin_paths(d: str) -> list:
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".bin"))


def _timed_reps(fn, before=None) -> list:
    """``CKPT_IO_REPS`` wall times of ``fn()``, ``before()`` untimed ahead
    of each."""
    out = []
    for _ in range(CKPT_IO_REPS):
        if before is not None:
            before()
        t0 = time.monotonic()
        fn()
        out.append(time.monotonic() - t0)
    return out


def _fmt(nbytes: int, times: list) -> str:
    """'min s (GB/s at the min)' of a list of wall times."""
    return (", ".join(f"{t:.3f}" for t in times)
            + f" s = {nbytes / min(times) / 1e9:.2f} GB/s")


def _disk_ceiling(root: str, bufs: list, nbytes: int) -> dict:
    """(a) The storage's own rates for the state's files: writes with fsync
    at each width of ``CKPT_WRITE_WIDTHS``, cold (fadvise) and warm reads
    into backed buffers and crc32 at each of ``CKPT_READ_THREADS``."""
    from concurrent.futures import ThreadPoolExecutor

    from tpuflow_torch.ckpt import raw

    d = os.path.join(root, "ceiling")
    paths = [os.path.join(d, f"f{i:05d}.bin") for i in range(len(bufs))]

    def write(width):
        os.makedirs(d)
        with ThreadPoolExecutor(width) as ex:
            list(ex.map(raw.write_file, paths, bufs))

    out = {"write_s": {}, "read_cold_s": {}, "read_warm_s": {},
           "crc32_s": {}}
    for w in CKPT_WRITE_WIDTHS:
        out["write_s"][w] = _timed_reps(
            lambda: write(w), before=lambda: shutil.rmtree(d, True))
    dst = [raw.aligned_empty(b.nbytes) for b in bufs]
    for b in dst:
        b.fill(0)  # backed: the reads measure the storage, not page faults

    def read(threads):
        with ThreadPoolExecutor(threads) as ex:
            list(ex.map(lambda p, b: raw.read_file(p, b.nbytes, out=b),
                        paths, dst))

    for t in CKPT_READ_THREADS:
        out["read_cold_s"][t] = _timed_reps(
            lambda: read(t), before=lambda: _fadvise_out(paths))
        out["read_warm_s"][t] = _timed_reps(lambda: read(t))
        with ThreadPoolExecutor(t) as ex:
            out["crc32_s"][t] = _timed_reps(
                lambda: list(ex.map(raw._crc32, bufs)))
    shutil.rmtree(d)
    for k, v in out.items():
        print(f"  (a) {k[:-2]}: " + "; ".join(
            f"{n} {'wide' if k == 'write_s' else 'threads'} "
            + _fmt(nbytes, ts) for n, ts in v.items()))
    return out


def _save_legs(root: str, host: list, nbytes: int, crcs: list) -> dict:
    """(b) Saves of ``host`` through ``_write_entries``: to fresh files;
    onto a pool one ``prewarm`` filled; and three steady-state saves, each
    drawing the files retention adopted from the one before. Every save's
    manifest is the same bytes, its crc32s the serial ones, and every
    shard of 64 KiB or more of a pooled save came from the pool."""
    from tpuflow_torch.ckpt import raw

    policy = raw.RetryPolicy()
    sizes = [t.numel() * t.element_size() for _, t in host]
    n_big = sum(s >= raw._POOL_MIN_BYTES for s in sizes)
    manifests = set()

    entries = [(p, t.shape, t.dtype, [([0] * t.dim(), t)]) for p, t in host]

    def save(d, pool=None):
        os.makedirs(d)
        taken = pool.taken if pool is not None else 0
        t0 = time.monotonic()
        raw._write_entries(d, entries, policy, pool=pool)
        dt = time.monotonic() - t0
        if pool is not None and pool.taken - taken != n_big:
            raise AssertionError(
                f"a pooled save drew {pool.taken - taken} files from the "
                f"pool, want all {n_big} shards of 64 KiB or more")
        with open(os.path.join(d, "manifest.json"), "rb") as fh:
            manifests.add(fh.read())
        return dt

    out = {"fresh_s": [], "prewarm_s": [], "prewarmed_s": [],
           "steady_s": []}
    for rep in range(CKPT_IO_REPS):
        d = os.path.join(root, f"fresh{rep}")
        out["fresh_s"].append(save(d))
        shutil.rmtree(d)
        pool = raw.RecyclePool(os.path.join(root, f"pool{rep}"))
        t0 = time.monotonic()
        pool.prewarm(sizes)
        pool.prewarm_wait()
        out["prewarm_s"].append(time.monotonic() - t0)
        out["prewarmed_s"].append(save(d, pool))
        shutil.rmtree(d)
        pool.clear()
    pool = raw.RecyclePool(os.path.join(root, "pool"))
    prev = os.path.join(root, "steady0")
    save(prev)
    for i in range(1, 4):
        pool.adopt_dir(prev)  # retention
        prev = os.path.join(root, f"steady{i}")
        out["steady_s"].append(save(prev, pool))
    pool.clear()
    got = [s["crc32"] for e in json.loads(manifests.pop())["leaves"]
           for s in e["shards"]]
    if manifests or got != crcs:
        raise AssertionError("the saves' manifests differ, or their crc32s "
                             "are not the serial ones")
    for k in ("fresh_s", "prewarmed_s", "steady_s"):
        print(f"  (b) save, {k[:-2]} files: {_fmt(nbytes, out[k])}")
    print(f"  (b) pool prewarm (zero-filled files, no fsync): "
          f"{_fmt(nbytes, out['prewarm_s'])}; {n_big} of {len(sizes)} "
          f"shards drawn from the pool in every pooled save; manifests "
          f"and crc32s equal across all {2 * CKPT_IO_REPS + 4} saves")
    out["save_dir"] = prev
    return out


def _equal_to(torch, tree, host, what: str) -> list:
    """The restored tree's tensors, each bit-equal to the saved one."""
    from tpuflow_torch.ckpt import raw

    got = raw.flatten(tree)
    if [p for p, _ in got] != [p for p, _ in host] or not all(
            torch.equal(a, b) for (_, a), (_, b) in zip(got, host)):
        raise AssertionError(f"{what}: restored tensors differ from the "
                             "saved state")
    return [t for _, t in got]


def _restore_legs(torch, d: str, host: list, nbytes: int,
                  disk: bool) -> dict:
    """(c) Restores of the save in ``d``, each bit-equal to ``host``: the
    parent's order (one thread, leaf after leaf), threaded (cold from the
    disk and warm), threaded into a prewarmed arena (pageable and pinned),
    and zero-copy; (d) the copy of the restored tensors onto the card from
    pageable, pinned-arena and mapped buffers."""
    from tpuflow_torch.ckpt import raw

    paths = _bin_paths(d)
    n_leaves = len(host)
    out, kept = {}, {}
    to_card = ("threaded_warm", "pinned_arena", "zero_copy")
    # The pinned buffers a restore freed stay cached by PyTorch's host
    # allocator: each pinned prewarm starts from an empty cache, as a
    # process's first does.
    empty_host_cache = getattr(torch._C, "_host_emptyCache", lambda: None)

    def restore(key, fn, prewarm=None, cold=False, check=None):
        times, warm_s = [], []
        for rep in range(CKPT_IO_REPS):
            if cold:
                _fadvise_out(paths)
            if key == "pinned_arena":
                empty_host_cache()
            if prewarm is not None:
                t0 = time.monotonic()
                prewarm()
                warm_s.append(time.monotonic() - t0)
            taken = raw._ARENA.taken
            t0 = time.monotonic()
            tree = fn()
            times.append(time.monotonic() - t0)
            tensors = _equal_to(torch, tree, host, key)
            if check is not None:
                check(tensors, raw._ARENA.taken - taken)
            if key in to_card and rep == CKPT_IO_REPS - 1:
                kept[key] = tensors
            del tree, tensors
        out[key + "_s"] = times
        if warm_s:
            out[key + "_prewarm_s"] = warm_s

    def arena_check(pinned):
        def check(tensors, taken):
            if taken != n_leaves:
                raise AssertionError(f"the prewarmed restore took {taken} "
                                     f"arena buffers, want {n_leaves}")
            if pinned and not all(t.is_pinned() for t in tensors):
                raise AssertionError("a pinned-arena restore handed out "
                                     "pageable tensors")
        return check

    sizes = raw.manifest_shard_sizes(d)
    legs = [("serial", lambda: raw.restore_raw(d, io_threads=1), {}),
            ("threaded_cold", lambda: raw.restore_raw(d), {"cold": True}),
            ("threaded_warm", lambda: raw.restore_raw(d), {}),
            ("arena", lambda: raw.restore_raw(d), {
                "prewarm": lambda: raw._ARENA.prewarm(sizes,
                                                      background=False),
                "check": arena_check(False)}),
            ("pinned_arena", lambda: raw.restore_raw(d), {
                "prewarm": lambda: raw._ARENA.prewarm(
                    sizes, background=False, pinned=True),
                "check": arena_check(True)}),
            ("zero_copy", lambda: raw.restore_raw(d, zero_copy=True), {})]
    if not disk:  # memory-backed: nothing is cold
        legs = [leg for leg in legs if leg[0] != "threaded_cold"]
    for key, fn, kw in legs:
        restore(key, fn, **kw)
        line = f"  (c) restore, {key}: {_fmt(nbytes, out[key + '_s'])}"
        if key + "_prewarm_s" in out:
            line += (f" (its prewarm, foreground: "
                     f"{_fmt(nbytes, out[key + '_prewarm_s'])})")
        print(line)
    print(f"  (c) every restore bit-equal to the saved state; the arena "
          f"restores took {n_leaves} buffers each, the pinned ones pinned")
    for key in to_card:
        tensors = kept.pop(key)

        def copy():
            torch.cuda.synchronize()
            on_card = [t.to("cuda", non_blocking=True) for t in tensors]
            torch.cuda.synchronize()
            del on_card

        out[key + "_to_card_s"] = _timed_reps(copy)
        print(f"  (d) copy onto the card from {key} buffers: "
              f"{_fmt(nbytes, out[key + '_to_card_s'])}")
        del tensors
    for key, prewarm in (("threaded_warm", None),
                         ("arena", "arena_prewarm_s"),
                         ("pinned_arena", "pinned_arena_prewarm_s")):
        card = out.get(key + "_to_card_s", out["threaded_warm_to_card_s"])
        total = min(out[key + "_s"]) + min(card)
        fg = total + (min(out[prewarm]) if prewarm else 0.0)
        out[key + "_restore_and_copy_s"] = total
        print(f"  (d) {key}: restore + copy onto the card {total:.3f} s; "
              f"with its prewarm in the foreground {fg:.3f} s")
    empty_host_cache()
    return out


def ckpt_io_phase(torch, smi, cfg) -> dict:
    """The checkpoint of the state the split leg saves (GPT-2 124M params
    and AdamW moments), outside training, ``CKPT_IO_REPS`` rounds of each:
    (a) the disk's own write, read and crc32 rates; (b) saves through
    ``_write_entries`` to fresh, prewarmed-pool and steady-state recycled
    files; (c) restores in the parent's serial order, threaded cold and
    warm, into a prewarmed arena (pageable and pinned) and zero-copy; (d)
    the copy of restored state onto the card; (e) (b) and (c) again on
    tmpfs where ``/dev/shm`` holds four copies of the state, else one line
    saying why not. Everything on this machine's host disk under
    ``build/``; every restore bit-equal to the saved state."""
    import zlib

    from tpuflow_torch.ckpt import raw
    from tpuflow_torch.ckpt.tree import checkpoint_tree
    from tpuflow_torch.train.gpt import init_state

    state = init_state(cfg)
    # (path, host copy) of each leaf (one process writes each leaf whole).
    host = [(names, shards[0][1]) for names, _, _, shards in
            raw._gather_host(checkpoint_tree(
                state, scan_layers=cfg.model_config().scan_layers))]
    del state
    torch.cuda.empty_cache()
    bufs = [raw._bytes(t) for _, t in host]
    nbytes = sum(b.nbytes for b in bufs)
    crcs = [zlib.crc32(b) for b in bufs]
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    free = os.statvfs(build).f_bavail * os.statvfs(build).f_frsize
    print(f"checkpoint IO, {nbytes / 1e9:.3f} GB in {len(bufs)} leaves, "
          f"this machine's host disk ({free / 1e9:.0f} GB free under "
          f"build/) [{smi}]")
    out = dict(bytes=nbytes, leaves=len(bufs), gpu=smi)
    root = tempfile.mkdtemp(prefix="chip_smoke_io_", dir=build)
    try:
        out["ceiling"] = _disk_ceiling(root, bufs, nbytes)
        out["save"] = _save_legs(root, host, nbytes, crcs)
        out["restore"] = _restore_legs(torch, out["save"].pop("save_dir"),
                                       host, nbytes, disk=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    shm = "/dev/shm"
    room = (os.statvfs(shm).f_bavail * os.statvfs(shm).f_frsize
            if os.path.isdir(shm) else 0)
    if room < 4 * nbytes:
        out["tmpfs"] = None
        print(f"  (e) tmpfs leg not run: {shm} has {room / 1e9:.2f} GB "
              f"free, under 4 x the state's {nbytes / 1e9:.3f} GB [{smi}]")
    else:
        print(f"  (e) tmpfs ({shm}, {room / 1e9:.0f} GB free) [{smi}]:")
        root = tempfile.mkdtemp(prefix="chip_smoke_io_", dir=shm)
        try:
            save = _save_legs(root, host, nbytes, crcs)
            out["tmpfs"] = dict(save=save, restore=_restore_legs(
                torch, save.pop("save_dir"), host, nbytes, disk=False))
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return out


def train_profile(torch, cfg, step_ms: float, smi: str) -> dict:
    """Two train steps under torch.profiler after one warm step: the
    device's busy time, its share of two unprofiled steps, and the
    kernels that take the most device time."""
    from tpuflow_torch.data.lm import make_lm_loaders
    from tpuflow_torch.train.gpt import init_state
    from tpuflow_torch.train.step import make_train_step

    state = init_state(cfg)
    step = make_train_step()
    loader, _ = make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                cfg.seq_len, state.model.config.vocab_size)
    batches = list(loader)[:3]
    state, m = step(state, batches[0], 1)
    float(m["loss"])

    def run():
        nonlocal state
        for b in batches[1:]:
            state, m = step(state, b, 1)
            float(m["loss"])

    t0 = time.monotonic()
    kernels = kernel_trace(torch, run)
    wall_s = time.monotonic() - t0
    busy_s = _busy(kernels) / 1e6
    out = dict(
        profiled_wall_s=wall_s, kernel_launches=len(kernels),
        device_busy_s=busy_s,
        device_busy_share_of_two_steps=busy_s / (2 * step_ms / 1e3),
        top_kernels_ms=_top(kernels),
    )
    print(f"two train steps under the profiler: {len(kernels)} kernels, "
          f"device busy {busy_s:.3f} s = "
          f"{out['device_busy_share_of_two_steps']:.1%} of two unprofiled "
          f"steps; top: " + "; ".join(f"{n[:40]} {ms:.1f} ms"
                                      for n, ms in out["top_kernels_ms"][:5])
          + f" [{smi}]")
    return out


def step_parity(torch, cfg) -> dict:
    """One forward+backward of GPT-2 124M from the same seed and batch
    with the flash kernels and with the einsum attention (dropout off,
    TF32 off): the loss and every gradient."""
    from tpuflow_torch.data.lm import make_lm_loaders
    from tpuflow_torch.models.gpt2 import GPT2
    from tpuflow_torch.models.losses import cross_entropy_loss

    base = dataclasses.replace(cfg.model_config(), dropout=0.0)
    loader, _ = make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                cfg.seq_len, base.vocab_size)
    b = next(iter(loader))
    x = torch.as_tensor(b["x"], device="cuda")
    y = torch.as_tensor(b["y"], device="cuda")
    res = {}
    for impl in ("flash", "xla"):
        model = GPT2(dataclasses.replace(base, attn_impl=impl), seed=0)
        loss = cross_entropy_loss(model(x, train=True, rng=1), y)
        loss.backward()
        res[impl] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()})
        del model
    loss_err = abs(res["flash"][0] - res["xla"][0])
    worst, worst_name = 0.0, None
    for n, gx in res["xla"][1].items():
        gf = res["flash"][1][n]
        ratio = float((gf - gx).abs().max() / gx.abs().max().clamp_min(1e-30))
        if ratio > worst:
            worst, worst_name = ratio, n
    print(f"step parity flash vs einsum: loss {res['flash'][0]:.6f} vs "
          f"{res['xla'][0]:.6f} (|diff| {loss_err:.3g}, limit "
          f"{PARITY_LOSS_ATOL}); worst gradient {worst_name} max|diff| = "
          f"{worst:.3g} of its max|g| (limit {PARITY_GRAD_RTOL})")
    if not (loss_err <= PARITY_LOSS_ATOL and worst <= PARITY_GRAD_RTOL):
        raise AssertionError("flash and einsum train steps disagree")
    return dict(loss_flash=res["flash"][0], loss_xla=res["xla"][0],
                loss_abs_diff=loss_err, worst_grad=worst_name,
                worst_grad_rel_diff=worst)


def engine_profile(torch, model, prompts, flags, wall_s: float) -> dict:
    """The same traffic through a fresh engine under torch.profiler: the
    device's busy time (union of kernel intervals), its share of the
    unprofiled engine wall ``wall_s`` (the profiler slows the host, not
    the kernels), and the kernels that take the most device time."""
    from tpuflow_torch.infer.serve import ServeEngine

    eng = ServeEngine(model, max_slots=8, quant="fused_native")

    def run():
        for p, q in zip(prompts, flags):
            eng.submit(p, max_new_tokens=NEW_TOKENS, quantize=q)
        eng.run_until_idle()

    t0 = time.monotonic()
    kernels = kernel_trace(torch, run)
    wall_us = (time.monotonic() - t0) * 1e6
    busy = _busy(kernels)
    out = dict(
        profiled_wall_s=wall_us / 1e6, kernel_launches=len(kernels),
        device_busy_s=busy / 1e6,
        device_busy_share_of_engine_wall=busy / 1e6 / wall_s,
        top_kernels_ms=_top(kernels),
    )
    print(f"engine under the profiler: {len(kernels)} kernels, device busy "
          f"{busy / 1e6:.3f} s = "
          f"{out['device_busy_share_of_engine_wall']:.1%} of the unprofiled "
          f"engine wall {wall_s:.3f} s")
    return out


def head_dim_phase(torch, timer, bwd_rows):
    """The flash forward without and with lse and both backward pairs at a
    padded head dim (96, run at the 128 instantiation), at 256 and at 512
    (the wide-head kernels), f32 and bf16, causal: against their plain
    versions at the true D with the backward phase's tolerances, the split pair
    bit-equal to the fused one, and their device ms (the wrappers' padding
    copies included) beside their bound, their share of it, the D = 64
    kernels' at (1, 1024, 12, 64), the plain versions' and SDPA's."""
    from tpuflow_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        d64 = {r["kernel"]: r["ms"] for r in bwd_rows
               if r["dtype"] == name and r["shape"] == [1, 1024, 12, 64]}
        for B, T, H, D in HEAD_DIM_SHAPES:
            q, k, v, do = (
                torch.randn(B, T, H, D, device="cuda", generator=g).to(dt)
                for _ in range(4)
            )
            tag = f"{name} {(B, T, H, D)}"
            o_no_lse = fa.flash_attention(q, k, v, causal=True)
            o, lse = fa.flash_fwd_lse(q, k, v, causal=True)
            dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal=True)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)
            split = fa.flash_bwd_split(q, k, v, o, lse, do, causal=True)
            torch.cuda.synchronize()
            for key, a, b in zip(("dq", "dk", "dv"), split, (dq, dk, dv)):
                if not torch.equal(a, b):
                    raise AssertionError(f"head dim {tag}: split {key} "
                                         "differs from the fused pair's")
            ro, rlse = fa.blockwise_attention_lse(q, k, v, causal=True)
            rdq, rdelta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do,
                                                causal=True)
            rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, rdelta,
                                              causal=True)
            errs = {
                "out_no_lse": _within(o_no_lse, ro, *FLASH_TOL[name],
                                      f"out without lse {tag}"),
                "out": _within(o, ro, *FLASH_TOL[name], f"out {tag}"),
                "lse": _within(lse, rlse, *LSE_TOL, f"lse {tag}"),
                "delta": _within(delta, rdelta, *DELTA_TOL, f"delta {tag}"),
            }
            for key, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                                   ("dv", dv, rdv)):
                errs[key] = _within(got, want, *BWD_TOL[name],
                                    f"{key} {tag}")
            del ro, rlse, rdq, rdelta, rdk, rdv, split, o_no_lse
            calls = {
                "flash_fwd": (
                    lambda: fa.flash_attention(q, k, v, causal=True),
                    lambda: fa.blockwise_attention(q, k, v, causal=True)),
                "flash_fwd_lse": (
                    lambda: fa.flash_fwd_lse(q, k, v, causal=True),
                    lambda: fa.blockwise_attention_lse(q, k, v, causal=True)),
                "flash_bwd_dq": (
                    lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, causal=True),
                    lambda: fa.flash_bwd_dq_plain(q, k, v, o, lse, do,
                                                  causal=True)),
                "flash_bwd_dkv": (
                    lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                             causal=True),
                    lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   causal=True)),
                "flash_bwd_dq_split": (
                    lambda: fa.flash_bwd_dq_split(q, k, v, o, lse, do,
                                                  causal=True),
                    lambda: fa.flash_bwd_dq_split_plain(q, k, v, o, lse, do,
                                                        causal=True)),
                "flash_bwd_dkv_split": (
                    lambda: fa.flash_bwd_dkv_split(q, k, v, o, lse, do,
                                                   causal=True),
                    lambda: fa.flash_bwd_dkv_split_plain(q, k, v, o, lse, do,
                                                         causal=True)),
            }
            work = _flash_work(B, T, H, D, q.element_size())
            ms = {kern: timer(fn)[0] for kern, (fn, _) in calls.items()}
            bound = {kern: _bound_ms(*work[kern], name) for kern in calls}
            row = dict(shape=[B, T, H, D], dtype=name,
                       kernel_dim=fa._kernel_dim(D), errors=errs, ms=ms,
                       bound_ms={k: b[0] for k, b in bound.items()},
                       bound_by={k: b[1] for k, b in bound.items()},
                       d64_ms=d64)
            # One SDPA call of the same function: the forward, and the
            # backward of all three gradients at once.
            qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            out_h = sdpa(qh, kh, vh, is_causal=True)
            do_h = do.transpose(1, 2)
            fwd_lib = timer(lambda: sdpa(qh, kh, vh, is_causal=True))[0]
            bwd_lib = timer(lambda: torch.autograd.grad(
                out_h, (qh, kh, vh), do_h, retain_graph=True))[0]
            row["plain_ms"] = {kern: timer(plain, iters=3)[0]
                               for kern, (_, plain) in calls.items()}
            row["library_ms"] = {kern: fwd_lib if kern.startswith(
                "flash_fwd") else bwd_lib for kern in calls}
            row["bound_share"] = {k: row["bound_ms"][k] / ms[k] for k in ms}
            del qh, kh, vh, out_h
            rows.append(row)
            print(f"head dim {D} (kernel {fa._kernel_dim(D)}) {tag}: "
                  "max|err| " + ", ".join(f"{k} {e[0]:.3g} ({e[1]:.3f})"
                                          for k, e in errs.items())
                  + "; device ms (bound, the kernel's share of it, D = 64 "
                  "beside): " + ", ".join(
                      f"{k} {ms[k]:.4f} ({bound[k][0]:.4f} {bound[k][1]}, "
                      f"{row['bound_share'][k]:.1%}"
                      + (f", {d64[k]:.4f})" if k in d64 else ")")
                      for k in ms))
            print(f"head dim {D} {tag}: plain ms " + ", ".join(
                f"{k} {row['plain_ms'][k]:.4f}" for k in ms)
                + f"; sdpa forward {row['library_ms']['flash_fwd_lse']:.4f}"
                f", sdpa backward {row['library_ms']['flash_bwd_dq']:.4f}")
    return rows


WIDE_SHAPE = (1, 1024, 12, 512)


def wide_times(torch) -> dict:
    """Device ms of the wide-head kernels' 12 entries (six wrappers, f32
    and bf16) at WIDE_SHAPE causal, with whichever ``tpuflow_torch`` is
    first on sys.path."""
    from tpuflow_torch.ops import _build
    from tpuflow_torch.ops import flash_attention as fa

    _build.build_all(("flash_fwd", "flash_bwd"))
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        q, k, v, do = (torch.randn(*WIDE_SHAPE, device="cuda", generator=g)
                       .to(dt) for _ in range(4))
        o, lse = fa.flash_fwd_lse(q, k, v, causal=True)
        _, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal=True)
        calls = {
            "flash_fwd": lambda: fa.flash_attention(q, k, v, causal=True),
            "flash_fwd_lse": lambda: fa.flash_fwd_lse(q, k, v, causal=True),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, o, lse, do,
                                                    causal=True),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                      delta, causal=True),
            "flash_bwd_dq_split": lambda: fa.flash_bwd_dq_split(
                q, k, v, o, lse, do, causal=True),
            "flash_bwd_dkv_split": lambda: fa.flash_bwd_dkv_split(
                q, k, v, o, lse, do, causal=True),
        }
        for kern, fn in calls.items():
            out[kern + ("_bf16" if name == "bfloat16" else "")] = timer(fn)[0]
    return out


def wide_compare(other: str) -> int:
    """The 12 wide-head entries with the kernels of checkout ``other`` and
    of this one, in turns (other, this, this, other), one process each."""
    smi = _smi_line()
    print(f"gpu: {smi}")
    runs = []
    for label, root in (("other", other), ("this", REPO), ("this", REPO),
                        ("other", other)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--wide-times",
             root], capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        times = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append(dict(label=label, root=root, ms=times))
        print(f"{label} ({root}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    for kern in runs[0]["ms"]:
        o = [r["ms"][kern] for r in runs if r["label"] == "other"]
        t = [r["ms"][kern] for r in runs if r["label"] == "this"]
        print(f"{kern}: other {o[0]:.4f} / {o[1]:.4f} ms, this {t[0]:.4f} / "
              f"{t[1]:.4f} ms, {min(o) / max(t):.1f}x faster at least")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "wide_compare.json"),
              "w") as fh:
        json.dump(dict(gpu=smi, shape=WIDE_SHAPE, runs=runs), fh, indent=1)
    print(smi)
    return 0


def ckpt_ab(torch, order: str = "ABCCBA") -> int:
    """The split and resume legs' checkpoint wiring taken apart, one run
    for each letter of ``order``: A as this checkout runs it; B with the
    pool prewarmed on any storage, as the JAX package does (A prewarms it
    only on memory-backed storage); C without the restore side (no
    ``prewarm_restore``, the restored tree laid out on the host), as the
    parent did after its serial read. Each run: the split leg's saves and
    the files they drew from the pool, the resume leg's restore, the
    layout of the restored tree onto the card and its save, the resumed
    losses bit-equal to the split leg's."""
    from tpuflow_torch.ckpt import manager as mgr_mod
    from tpuflow_torch.ckpt import raw
    from tpuflow_torch.ckpt import tree as tree_mod
    from tpuflow_torch.ops import _build
    from tpuflow_torch.train import gpt as gpt_mod

    smi = _smi_line()
    print(f"gpu: {smi}")
    print(f"built in {_build.build_all():.2f} s")
    cfg = gpt_mod.GptTrainConfig(
        preset="gpt2", seq_len=1024, batch_size=8, epochs=TRAIN_EPOCHS,
        steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="flash",
        data_axis=1, fsdp_axis=1)
    def prewarm_anywhere(self, state):
        sizes = [mgr_mod._saved_nbytes(leaf, self.save_dtype)
                 for _, leaf in raw.flatten(state)]
        self._pool.prewarm(sizes * ((self.max_to_keep or 1)
                                    + (2 if self.best_metric else 1)))

    real = dict(prewarm=mgr_mod.CheckpointManager.prewarm,
                prewarm_restore=mgr_mod.CheckpointManager.prewarm_restore,
                from_jax=tree_mod._from_jax,
                load=gpt_mod.load_checkpoint_tree)
    load_s = []

    def timed_load(state, tree):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        real["load"](state, tree)
        torch.cuda.synchronize()
        load_s.append(time.monotonic() - t0)

    gpt_mod.load_checkpoint_tree = timed_load
    root = tempfile.mkdtemp(prefix="chip_smoke_ab_",
                            dir=os.path.join(REPO, "build"))
    runs = []
    try:
        for name in order:
            mgr_mod.CheckpointManager.prewarm = (
                prewarm_anywhere if name == "B" else real["prewarm"])
            mgr_mod.CheckpointManager.prewarm_restore = (
                (lambda self, *a, **k: None) if name == "C"
                else real["prewarm_restore"])
            tree_mod._from_jax = (
                (lambda m, t, d: real["from_jax"](m, t, "cpu"))
                if name == "C" else real["from_jax"])
            split = os.path.join(root, "split")
            resume = os.path.join(root, "resume")
            res = gpt_mod.train_gpt(cfg, ckpt_dir=split, flash_bwd="split",
                                    log=lambda m: None)
            shutil.copytree(split, resume, ignore=shutil.ignore_patterns(
                f"step_{TRAIN_STEPS}", ".recycle"))
            shutil.rmtree(split)
            t0 = time.monotonic()
            again = gpt_mod.train_gpt(cfg, ckpt_dir=resume,
                                      flash_bwd="split", log=lambda m: None)
            resume_s = time.monotonic() - t0
            shutil.rmtree(resume)
            if again.step_losses != res.step_losses[TRAIN_STEPS_PER_EPOCH:]:
                raise AssertionError(f"{name}: resumed losses differ")
            io, io2 = res.checkpoint_io, again.checkpoint_io
            run = dict(variant=name, split_saves_s=[
                           r["seconds"] for r in io["saves"]],
                       recycled=[r["recycled"] for r in io["saves"]],
                       host_copy_s=[r["host_copy_s"] for r in io["saves"]],
                       restore_s=io2["restores"][0]["seconds"],
                       load_s=load_s[-1],
                       resume_save_s=io2["saves"][0]["seconds"],
                       resume_wall_s=resume_s)
            runs.append(run)
            print(f"{name}: split leg saves " + ", ".join(
                f"{t:.3f}" for t in run["split_saves_s"]) + " s (files "
                f"from the pool {run['recycled']}); resume "
                f"leg restore {run['restore_s']:.3f} s, layout onto the "
                f"card {run['load_s']:.3f} s, save "
                f"{run['resume_save_s']:.3f} s, wall {resume_s:.3f} s; "
                f"losses bit-equal", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"ckpt_ab_{order}.json"),
              "w") as fh:
        json.dump(dict(gpu=smi, runs=runs), fh, indent=1)
    print(smi)
    return 0


def mlp_timing(torch, smi) -> dict:
    """The MLP's training loop as ``train_func_per_worker`` runs it (the
    train step, a dispatch window of 2) with a host stamp per step: one
    epoch with the batches prefetched to the card on a background thread
    (depth 2, as the main path runs), then ``MLP_INLINE_STEPS`` steps with
    the batches converted inline (depth 0) to show what the thread costs.
    Each gives the step ms (median after ``MLP_TIMED_WARMUP`` steps) and
    samples/s; the epoch its training wall. Then ``MLP_PROFILED_STEPS``
    prefetched steps under torch.profiler: the device's busy share of
    their wall, the kernels a step launches, and the host ops that take
    the most CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from tpuflow_torch.data.loader import get_dataloaders, prefetch_to_device
    from tpuflow_torch.models import NeuralNetwork
    from tpuflow_torch.train.step import (
        DispatchWindow,
        create_train_state,
        make_train_step,
    )

    train, _ = get_dataloaders(MLP_BATCH)
    state = create_train_state(NeuralNetwork().cuda(), MLP_LR)
    step = make_train_step()

    def run(n: int, depth: int = 2) -> list[float]:
        window = DispatchWindow(2)
        stamps = [time.monotonic()]
        for _, placed in zip(range(n), prefetch_to_device(
                train, "cuda", depth=depth, keys=("x", "y"))):
            _, metrics = step(state, placed, 1)
            for matured in window.push(metrics["loss"]):
                float(matured)
            stamps.append(time.monotonic())
        for matured in window.drain():
            float(matured)
        torch.cuda.synchronize()
        stamps.append(time.monotonic())
        return stamps

    def median_ms(stamps):
        return float(np.median(np.diff(stamps[1 + MLP_TIMED_WARMUP:-1]))) * 1e3

    stamps = run(len(train))
    step_ms = median_ms(stamps)
    epoch_s = stamps[-1] - stamps[0]
    inline_ms = median_ms(run(MLP_INLINE_STEPS, depth=0))
    walls = []
    kernels = kernel_trace(torch, lambda: walls.append(
        run(MLP_PROFILED_STEPS)))
    prof_wall = walls[-1][-1] - walls[-1][0]
    busy = _busy(kernels) / 1e6
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(MLP_PROFILED_STEPS)
    host_ops = [(e.key, e.self_cpu_time_total / 1e3 / MLP_PROFILED_STEPS,
                 e.count / MLP_PROFILED_STEPS)
                for e in sorted(prof.key_averages(),
                                key=lambda e: -e.self_cpu_time_total)[:10]]
    out = dict(step_ms_median=step_ms, samples_per_s=MLP_BATCH / step_ms * 1e3,
               epoch_train_s=epoch_s, steps=len(train),
               inline_step_ms_median=inline_ms,
               inline_samples_per_s=MLP_BATCH / inline_ms * 1e3,
               profiled_steps=MLP_PROFILED_STEPS,
               kernels_per_step=len(kernels) / MLP_PROFILED_STEPS,
               device_busy_s=busy, profiled_wall_s=prof_wall,
               device_busy_share=busy / prof_wall,
               top_kernels_ms=_top(kernels),
               top_host_ops_ms_per_step=host_ops, gpu=smi)
    print(f"MLP step: {step_ms:.4f} ms (median after {MLP_TIMED_WARMUP} "
          f"steps), {out['samples_per_s']:.0f} samples/s, epoch of "
          f"{len(train)} steps {epoch_s:.2f} s (training only); batches "
          f"converted inline instead: {inline_ms:.4f} ms, "
          f"{out['inline_samples_per_s']:.0f} samples/s; under the "
          f"profiler {MLP_PROFILED_STEPS} steps: "
          f"{out['kernels_per_step']:.1f} kernels a step, device busy "
          f"{busy:.4f} s = {out['device_busy_share']:.1%} of "
          f"{prof_wall:.3f} s; host ms a step by op: " + ", ".join(
              f"{k} {ms:.3f} (x{n:.0f})" for k, ms, n in host_ops[:6])
          + f" [{smi}]")
    return out


def main_path_phase(torch, smi) -> dict:
    """The README main path on the card through the port's entry points:
    ``train_fashion_mnist`` (3 epochs, per-epoch checkpoints), a warm
    start from its checkpoint, an in-run resume from a copy of its storage
    without the newest step, and ``TorchPredictor`` + ``map_batches`` over
    the 10,000 test rows; then its numbers (``mlp_timing``, the
    checkpoint's save and restore seconds, eval rows/s). The MLP's three
    dense layers are torch.matmul products, as the JAX package leaves them
    to XLA: the path launches no kernel of the port, and the counters must
    read 0. Its directories live under ``build/`` and are deleted."""
    from tpuflow_torch.ckpt import CheckpointManager
    from tpuflow_torch.flows import my_torch_module as m
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im

    call = dict(epochs=MLP_EPOCHS, global_batch_size=MLP_BATCH, lr=MLP_LR)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_mlp_",
                            dir=os.path.join(REPO, "build"))
    try:
        run = os.path.join(root, "run")
        _zero_counters(fa, im)
        t0 = time.monotonic()
        res = m.train_fashion_mnist(checkpoint_storage_path=run, **call)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        got = _counters(fa, im)
        if got != _launches():
            raise AssertionError(f"the MLP path launched {got}: it runs no "
                                 "kernel of the port")
        hist = res.metrics_history
        val = [h["val_loss"] for h in hist]
        if len(hist) != MLP_EPOCHS or not all(np.isfinite(val)):
            raise AssertionError(f"main path history {hist}")
        if not val[2] < val[0]:
            raise AssertionError(f"main path val_loss did not fall: {val}")
        best = res.best_checkpoint.metadata["metrics"]
        if not best["accuracy"] >= MLP_ACCURACY_FLOOR:
            raise AssertionError(f"best accuracy {best['accuracy']} below "
                                 f"the floor {MLP_ACCURACY_FLOOR}")
        ckdir = os.path.join(run, "checkpoints")
        best_step = int(res.best_checkpoint.path.rsplit("_", 1)[1])
        kept = sorted(int(d.split("_")[1]) for d in os.listdir(ckdir)
                      if d.startswith("step_"))  # not .recycle
        want_kept = sorted({MLP_EPOCHS - 1, MLP_EPOCHS, best_step})
        if kept != want_kept:
            raise AssertionError(f"retained steps {kept}, want {want_kept} "
                                 "(num_to_keep=2 plus the best)")
        print(f"main path: train_fashion_mnist {MLP_EPOCHS} epochs at batch "
              f"{MLP_BATCH}, lr {MLP_LR}: val_loss "
              f"{', '.join(f'{x:.6f}' for x in val)}; accuracy "
              f"{', '.join(str(h['accuracy']) for h in hist)}; retained "
              f"steps {kept} (best {best_step}); wall {wall_s:.2f} s; "
              f"launches {got} [{smi}]")

        # --- warm start: weights only, one epoch.
        warm = m.train_fashion_mnist(
            checkpoint=res.checkpoint, **dict(call, epochs=1),
            checkpoint_storage_path=os.path.join(root, "warm"))
        warm_val = warm.metrics_history[0]["val_loss"]
        if not warm_val < val[0]:
            raise AssertionError(f"warm start val_loss {warm_val} not below "
                                 f"the cold run's first {val[0]}")
        print(f"warm start from step {MLP_EPOCHS}: first val_loss "
              f"{warm_val:.6f} < the cold run's first {val[0]:.6f}")

        # --- in-run resume: the storage without its newest step.
        resume = os.path.join(root, "resume")
        shutil.copytree(run, resume, ignore=shutil.ignore_patterns(
            f"step_{MLP_EPOCHS}", ".recycle"))
        with open(os.path.join(resume, "metrics.jsonl")) as fh:
            n_lines = len(fh.readlines())
        again = m.train_fashion_mnist(checkpoint_storage_path=resume, **call)
        with open(os.path.join(resume, "metrics.jsonl")) as fh:
            new_steps = [json.loads(x)["step"]
                         for x in fh.readlines()[n_lines:]]
        if new_steps != [MLP_EPOCHS]:
            raise AssertionError(f"the resumed run reported steps "
                                 f"{new_steps}, want [{MLP_EPOCHS}] only")
        if again.metrics != res.metrics:
            raise AssertionError(f"resumed epoch {MLP_EPOCHS} metrics "
                                 f"{again.metrics} != {res.metrics}")
        a = _shards(os.path.join(ckdir, f"step_{MLP_EPOCHS}"))
        b = _shards(os.path.join(resume, "checkpoints", f"step_{MLP_EPOCHS}"))
        if a != b:
            raise AssertionError(f"resumed step_{MLP_EPOCHS} shards differ: "
                                 f"{[x for x, y in zip(a, b) if x != y][:3]}")
        print(f"in-run resume from step {MLP_EPOCHS - 1}: epoch {MLP_EPOCHS} "
              f"only, its metrics bit-equal, step_{MLP_EPOCHS}: {len(a)} "
              "shard crc32s equal")

        # --- the checkpoint's save and restore seconds.
        mgr = CheckpointManager(ckdir)
        state = mgr.restore(MLP_EPOCHS)
        io = CheckpointManager(os.path.join(root, "io"), async_save=False)
        io.save(MLP_EPOCHS, state)
        restore, save = mgr.restores[-1], io.saves[-1]
        print(f"checkpoint of the MLP state: {_io_line('save', [save])}; "
              f"{_io_line('restore', [restore])} (this machine's host disk) "
              f"[{smi}]")

        # --- batch eval over the test rows.
        rows = m.get_dataloaders(EVAL_BATCH, as_rows=True)
        predictor = m.TorchPredictor(res.best_checkpoint)
        t0 = time.monotonic()
        outs = m.map_batches(rows, predictor, batch_size=EVAL_BATCH)
        eval_s = time.monotonic() - t0
        mis = sum(int(o["predicted_values"]) != r["labels"]
                  for o, r in zip(outs, rows))
        implied = round((1.0 - best["accuracy"]) * len(rows))
        if len(outs) != len(rows) or abs(mis - implied) > EVAL_ROWS_TOL:
            raise AssertionError(
                f"{mis}/{len(rows)} misclassified; the best epoch's accuracy "
                f"{best['accuracy']} implies {implied} (+-{EVAL_ROWS_TOL})")
        print(f"eval: {mis}/{len(rows)} misclassified at batch {EVAL_BATCH} "
              f"(the best epoch's accuracy {best['accuracy']} implies "
              f"{implied}; allowed +-{EVAL_ROWS_TOL}); "
              f"{len(rows) / eval_s:.0f} rows/s [{smi}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(wall_s=wall_s, metrics_history=hist, launches=got,
                retained=kept, best_step=best_step, warm_val_loss=warm_val,
                resume_steps=new_steps, resume_shards=len(a), save=save,
                restore=restore, misclassified=mis, implied=implied,
                eval_rows_per_s=len(rows) / eval_s,
                timing=mlp_timing(torch, smi), gpu=smi)


class _Timed:
    """While installed, every call of ``module.<attr>`` is timed (host
    clock, ending in a synchronize): the wrapped call's wall inside a
    flow, which the flow layer's own overhead is measured against."""

    def __init__(self, torch, module, attr: str):
        self.torch, self.module, self.attr = torch, module, attr
        self.orig = getattr(module, attr)
        self.seconds = 0.0

    def __enter__(self):
        def timed(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return self.orig(*args, **kwargs)
            finally:
                self.torch.cuda.synchronize()
                self.seconds += time.monotonic() - t0

        setattr(self.module, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def flow_phase(torch, smi) -> dict:
    """The flow layer on the card through the flow CLIs' ``main(argv)``,
    into a home under ``build/`` (deleted at the end):

    1. ``TorchTrain run --epochs 2`` (batch 32, lr 1e-3) on the full-size
       synthetic FashionMNIST;
    2. ``TorchTrain run --epochs 1 --from-run <1>``: its first val_loss
       below run 1's first;
    3. ``TorchEval run --triggered`` at batch 512: triggered by run 2, the
       misclassified count within ``EVAL_ROWS_TOL`` of what run 2's best
       accuracy implies, its card holding "Error analysis";
    4. ``TorchEval run --checkpoint-run-pathspec <1>``;
    5. ``TorchEval run`` without a source: the "no checkpoint source"
       error. The MLP legs launch no kernel of the port.
    6. ``TorchGptTrain`` at GPT-2 124M width (``FLOW_GPT_ARGS``): every
       flash launch count what its steps imply, the last epoch's loss
       finite;
    7. ``TorchGptEval run --triggered --attn-impl flash --beam-size 4``:
       a finite test loss, the beam sample on its card, and the no-lse
       forward launched once a layer for every validation batch and every
       sample's prefill, the beam's included.

    Each flow's wall, the wrapped call's wall (``train_model``,
    ``map_batches``, ``train_gpt``, ``run_validation`` + ``generate`` +
    ``beam_search``)
    and the difference, the flow layer's own overhead; the GPT step ms
    inside the flow; the train step's ``profile.json`` (device kind, peak
    bytes). Counters are zeroed before leg 6 and before leg 7 and read
    after each."""
    from tpuflow_torch.data.lm import lm_test_loader
    from tpuflow_torch.flow import Run, store
    from tpuflow_torch.flows import eval_flow, gpt_eval_flow, gpt_flow
    from tpuflow_torch.flows import my_torch_module as m
    from tpuflow_torch.flows import train_flow
    from tpuflow_torch.infer import beam as beam_mod
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train import gpt as gpt_mod
    from tpuflow_torch.train import step as step_mod

    # The package exports the function under the module's name.
    gen_mod = importlib.import_module("tpuflow_torch.infer.generate")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    home = tempfile.mkdtemp(prefix="chip_smoke_flows_",
                            dir=os.path.join(REPO, "build"))
    legs = {}

    def leg(name, entry, argv, wrapped):
        with contextlib.ExitStack() as stack:
            timers = [stack.enter_context(_Timed(torch, mod, attr))
                      for mod, attr in wrapped]
            t0 = time.monotonic()
            pathspec = entry([*argv, "--home", home])
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        inner = sum(t.seconds for t in timers)
        what = " + ".join(attr for _, attr in wrapped)
        print(f"flow {name} ({pathspec}): wall {wall:.2f} s, {what} "
              f"{inner:.2f} s, flow layer {wall - inner:.2f} s [{smi}]")
        legs[name] = dict(pathspec=pathspec, wall_s=wall, wrapped=what,
                          wrapped_s=inner, overhead_s=wall - inner)
        return Run(pathspec)

    try:
        _zero_counters(fa, im)
        r1 = leg("TorchTrain", train_flow.main, ["run", "--epochs", "2"],
                 [(m, "train_model")])
        r2 = leg("TorchTrain --from-run", train_flow.main,
                 ["run", "--epochs", "1", "--from-run", r1.pathspec],
                 [(m, "train_model")])
        first1 = r1.data.result.metrics_history[0]["val_loss"]
        first2 = r2.data.result.metrics_history[0]["val_loss"]
        if not (r2.data.warm_started and first2 < first1):
            raise AssertionError(f"warm-started first val_loss {first2} not "
                                 f"below the cold run's {first1}")
        e1 = leg("TorchEval --triggered", eval_flow.main,
                 ["run", "--triggered", "--batch-size", str(EVAL_BATCH)],
                 [(m, "map_batches")])
        if e1.meta.get("triggered_by") != r2.pathspec:
            raise AssertionError(f"eval triggered by "
                                 f"{e1.meta.get('triggered_by')}, want "
                                 f"{r2.pathspec}")
        best = r2.data.result.best_checkpoint.metadata["metrics"]["accuracy"]
        implied = round((1.0 - best) * e1.data.n_rows)
        mis = e1.data.n_misclassified
        if e1.data.n_rows != 10_000 or abs(mis - implied) > EVAL_ROWS_TOL:
            raise AssertionError(
                f"eval: {mis}/{e1.data.n_rows} misclassified; the best "
                f"accuracy {best} implies {implied} (+-{EVAL_ROWS_TOL})")
        card = os.path.join(store.task_dir("TorchEval", e1.run_id, "start",
                                           0), "card.html")
        with open(card) as fh:
            if "Error analysis" not in fh.read():
                raise AssertionError(f"{card} lacks 'Error analysis'")
        e2 = leg("TorchEval --checkpoint-run-pathspec", eval_flow.main,
                 ["run", "--checkpoint-run-pathspec", r1.pathspec],
                 [(m, "map_batches")])
        try:
            eval_flow.main(["run", "--home", home])
        except ValueError as err:
            if "no checkpoint source" not in str(err):
                raise
        else:
            raise AssertionError("an eval without a source did not raise")
        mlp_n = _counters(fa, im)
        if mlp_n != _launches():
            raise AssertionError(f"the MLP flows launched {mlp_n}: they run "
                                 "no kernel of the port")
        print(f"flows, README contract: run 1 val_loss "
              f"{', '.join(str(h['val_loss']) for h in r1.data.result.metrics_history)}"
              f"; warm start first val_loss {first2} < {first1}; triggered "
              f"eval {mis}/{e1.data.n_rows} misclassified (best accuracy "
              f"{best} implies {implied}); pathspec eval "
              f"{e2.data.n_misclassified}/{e2.data.n_rows}; no-source error "
              "raised; kernel launches 0")

        # --- the GPT-2 flows on the flash kernels.
        _zero_counters(fa, im)
        g1 = leg("TorchGptTrain", gpt_flow.main, ["run", *FLOW_GPT_ARGS],
                 [(gpt_mod, "train_gpt")])
        train_n = _counters(fa, im)
        mc = g1.data.model_config
        L, seq = mc["n_layer"], g1.data.seq_len_used
        n_val = len(lm_test_loader(FLOW_GPT_BATCH,
                                   g1.data.synthetic_size_used, seq,
                                   mc["vocab_size"]))
        # Full remat: two lse forwards a layer and step, one fused pair;
        # the no-lse forward a layer and validation batch, each epoch.
        want = _launches(flash_fwd_lse=2 * L * FLOW_GPT_STEPS,
                         flash_bwd_dq=L * FLOW_GPT_STEPS,
                         flash_bwd_dkv=L * FLOW_GPT_STEPS,
                         flash_fwd=L * n_val * 2)
        if train_n != want:
            raise AssertionError(f"TorchGptTrain launched {train_n}, want "
                                 f"{want}")
        hist = g1.data.metrics_history
        if not np.isfinite(g1.data.loss_history[-1]):
            raise AssertionError(f"TorchGptTrain losses "
                                 f"{g1.data.loss_history}")
        tok_s = hist[-1]["tokens_per_s"]
        step_ms = FLOW_GPT_BATCH * seq / tok_s * 1e3
        with open(os.path.join(store.task_dir("TorchGptTrain", g1.run_id,
                                              "train", 1),
                               "profile.json")) as fh:
            prof = json.load(fh)
        peak = max((d["peak_bytes_in_use"] for smp in prof["samples"]
                    for d in smp["devices"]), default=0)
        kind = ", ".join(prof["device_kinds"]) or "no card"
        print(f"flow TorchGptTrain: loss history {g1.data.loss_history}; "
              f"step {step_ms:.1f} ms inside the flow ({tok_s} tokens/s, "
              f"last epoch); launches {train_n}; profile.json: platform "
              f"{prof['platform']}, {kind}, peak "
              f"{peak / 2**30:.2f} GiB allocated [{smi}]")

        _zero_counters(fa, im)
        ge = leg("TorchGptEval --triggered", gpt_eval_flow.main,
                 ["run", "--triggered", "--sample-tokens",
                  str(FLOW_SAMPLE_TOKENS), "--attn-impl", "flash",
                  "--beam-size", str(BEAM_K)],
                 [(step_mod, "run_validation"), (gen_mod, "generate"),
                  (beam_mod, "beam_search")])
        eval_n = _counters(fa, im)
        if ge.meta.get("triggered_by") != g1.pathspec:
            raise AssertionError(f"GPT eval triggered by "
                                 f"{ge.meta.get('triggered_by')}")
        # A prefill a layer for each of the three samples and the beam.
        want = _launches(flash_fwd=L * (n_val + 4))
        if eval_n != want:
            raise AssertionError(f"TorchGptEval launched {eval_n}, want "
                                 f"{want}")
        beam_name, beam_text = ge.data.samples[-1]
        with open(os.path.join(store.task_dir("TorchGptEval", ge.run_id,
                                              "start", 0), "card.html")) as fh:
            if not (beam_name.startswith(f"beam K={BEAM_K} (")
                    and beam_name in fh.read()):
                raise AssertionError(f"TorchGptEval's card lacks the beam "
                                     f"sample ({ge.data.samples})")
        test_loss = ge.data.test_loss
        if not np.isfinite(test_loss):
            raise AssertionError(f"TorchGptEval test loss {test_loss}")
        print(f"flow TorchGptEval: test loss {test_loss:.4f}, ppl "
              f"{ge.data.test_ppl:.2f}; greedy {ge.data.samples[0][1]!r}; "
              f"{beam_name} {beam_text!r}; launches {eval_n} [{smi}]")
    finally:
        shutil.rmtree(home, ignore_errors=True)
    return dict(legs=legs, mlp_launches=mlp_n, gpt_train_launches=train_n,
                gpt_eval_launches=eval_n, gpt_step_ms=step_ms,
                gpt_tokens_per_s=tok_s, gpt_metrics=hist,
                gpt_eval_test_loss=test_loss,
                profile_device=kind,
                profile_platform=prof["platform"], profile_peak_bytes=peak,
                mlp_misclassified=mis, mlp_implied=implied, gpu=smi)


def resnet18_flow_leg(torch, smi) -> dict:
    """ResNet-18 / CIFAR-10 through the flow CLIs' ``main(argv)``, into a
    home under ``build/`` (deleted at the end): ``TorchTrain --model
    resnet18 --dataset cifar10`` for 2 epochs on ``CIFAR_TRAIN_ROWS``
    rows, a ``--from-run`` warm start of 1 epoch whose first val_loss is
    below run 1's, and the triggered ``TorchEval`` at batch 512 over the
    10,000 test rows: triggered by run 2, its count within
    ``EVAL_ROWS_TOL`` of what run 2's best accuracy implies, its card
    holding "Error analysis". No kernel of the port runs."""
    from tpuflow_torch.flow import Run, store
    from tpuflow_torch.flows import eval_flow, train_flow
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    home = tempfile.mkdtemp(prefix="chip_smoke_resnet18_",
                            dir=os.path.join(REPO, "build"))
    args = ["--model", "resnet18", "--dataset", "cifar10", "--n-train",
            str(CIFAR_TRAIN_ROWS), "--home", home]
    walls = {}

    def timed(name, entry, argv):
        t0 = time.monotonic()
        pathspec = entry(argv)
        torch.cuda.synchronize()
        walls[name] = time.monotonic() - t0
        return Run(pathspec)

    try:
        _zero_counters(fa, im)
        r1 = timed("train", train_flow.main, ["run", "--epochs", "2", *args])
        r2 = timed("warm", train_flow.main, ["run", "--epochs", "1",
                                             "--from-run", r1.pathspec,
                                             *args])
        e = timed("eval", eval_flow.main, ["run", "--triggered",
                                           "--batch-size", str(EVAL_BATCH),
                                           "--home", home])
        got = _counters(fa, im)
        if got != _launches():
            raise AssertionError(f"the ResNet-18 flows launched {got}: they "
                                 "run no kernel of the port")
        h1 = [h["val_loss"] for h in r1.data.result.metrics_history]
        first2 = r2.data.result.metrics_history[0]["val_loss"]
        if not (len(h1) == 2 and all(np.isfinite(h1))):
            raise AssertionError(f"ResNet-18 run 1 val_loss {h1}")
        if not (r2.data.warm_started and first2 < h1[0]):
            raise AssertionError(f"warm-started first val_loss {first2} not "
                                 f"below the cold run's {h1[0]}")
        if e.meta.get("triggered_by") != r2.pathspec:
            raise AssertionError(f"eval triggered by "
                                 f"{e.meta.get('triggered_by')}")
        best = r2.data.result.best_checkpoint.metadata["metrics"]["accuracy"]
        implied = round((1.0 - best) * e.data.n_rows)
        mis = e.data.n_misclassified
        if e.data.n_rows != 10_000 or abs(mis - implied) > EVAL_ROWS_TOL:
            raise AssertionError(
                f"ResNet-18 eval: {mis}/{e.data.n_rows} misclassified; the "
                f"best accuracy {best} implies {implied} (+-{EVAL_ROWS_TOL})")
        card = os.path.join(store.task_dir("TorchEval", e.run_id, "start",
                                           0), "card.html")
        with open(card) as fh:
            if "Error analysis" not in fh.read():
                raise AssertionError(f"{card} lacks 'Error analysis'")
        steps = CIFAR_TRAIN_ROWS // 32
        print(f"image: ResNet-18 / CIFAR-10 flows ({CIFAR_TRAIN_ROWS} "
              f"synthetic train rows, batch 32): run 1 val_loss "
              f"{', '.join(f'{x:.4f}' for x in h1)}, accuracy "
              f"{r1.data.result.metrics_history[-1]['accuracy']}; warm start "
              f"first val_loss {first2:.4f}; triggered eval {mis}/"
              f"{e.data.n_rows} misclassified (best accuracy {best} implies "
              f"{implied}); walls: train {walls['train']:.2f} s "
              f"({2 * steps} steps), warm {walls['warm']:.2f} s, eval "
              f"{walls['eval']:.2f} s; launches 0 [{smi}]")
    finally:
        shutil.rmtree(home, ignore_errors=True)
    return dict(walls=walls, val_loss=h1, warm_first_val_loss=first2,
                best_accuracy=best, misclassified=mis, implied=implied,
                launches=got, train_rows=CIFAR_TRAIN_ROWS, gpu=smi)


def _leaves(tree) -> list:
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def resnet50_leg(torch, smi) -> dict:
    """ResNet-50 / imagenet_synth through ``train_model`` (``R50_EPOCHS``
    epochs of ``R50_TRAIN_ROWS`` rows at global batch ``R50_BATCH``,
    cuDNN restricted to its
    deterministic algorithms for this leg), then an in-run resume from a
    copy of its storage without the newest step: every val_loss finite,
    the checkpoint's ``batch_stats`` finite for each of its 53
    BatchNorms, the resumed run training the last epoch only with
    bit-equal metrics and shard crc32s. No kernel of the port runs. Then
    ``resnet50_timing``."""
    from tpuflow_torch.ckpt import restore_from_handle
    from tpuflow_torch.flows import my_torch_module as m
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im

    call = dict(model="resnet50", dataset="imagenet_synth",
                global_batch_size=R50_BATCH, epochs=R50_EPOCHS,
                n_train=R50_TRAIN_ROWS)
    root = tempfile.mkdtemp(prefix="chip_smoke_resnet50_",
                            dir=os.path.join(REPO, "build"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        run = os.path.join(root, "run")
        _zero_counters(fa, im)
        t0 = time.monotonic()
        res = m.train_model(checkpoint_storage_path=run, **call)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        got = _counters(fa, im)
        if got != _launches():
            raise AssertionError(f"the ResNet-50 path launched {got}")
        val = [h["val_loss"] for h in res.metrics_history]
        if len(val) != R50_EPOCHS or not all(np.isfinite(val)):
            raise AssertionError(f"ResNet-50 history {res.metrics_history}")
        leaves = _leaves(restore_from_handle(res.checkpoint,
                                             subtree=("batch_stats",)))
        if len(leaves) != 2 * 53 or not all(
                bool(torch.isfinite(t).all()) for t in leaves):
            raise AssertionError(f"ResNet-50 batch_stats: {len(leaves)} "
                                 "leaves, want 106 finite")
        print(f"image: ResNet-50 / imagenet_synth train_model {R50_EPOCHS} "
              f"epochs at batch {R50_BATCH} (224 x 224, 1000 classes): "
              f"val_loss {', '.join(f'{x:.4f}' for x in val)}; batch_stats "
              f"{len(leaves)} finite leaves in the checkpoint; wall "
              f"{wall_s:.2f} s; launches 0 [{smi}]")

        resume = os.path.join(root, "resume")
        shutil.copytree(run, resume, ignore=shutil.ignore_patterns(
            f"step_{R50_EPOCHS}", ".recycle"))
        with open(os.path.join(resume, "metrics.jsonl")) as fh:
            n_lines = len(fh.readlines())
        t0 = time.monotonic()
        again = m.train_model(checkpoint_storage_path=resume, **call)
        torch.cuda.synchronize()
        resume_s = time.monotonic() - t0
        with open(os.path.join(resume, "metrics.jsonl")) as fh:
            new_steps = [json.loads(x)["step"]
                         for x in fh.readlines()[n_lines:]]
        if new_steps != [R50_EPOCHS]:
            raise AssertionError(f"the resumed ResNet-50 run reported steps "
                                 f"{new_steps}, want [{R50_EPOCHS}]")
        if again.metrics != res.metrics:
            raise AssertionError(f"resumed ResNet-50 metrics {again.metrics}"
                                 f" != {res.metrics}")
        step = f"step_{R50_EPOCHS}"
        a = _shards(os.path.join(run, "checkpoints", step))
        b = _shards(os.path.join(resume, "checkpoints", step))
        if a != b:
            raise AssertionError(f"resumed ResNet-50 {step} shards differ: "
                                 f"{[x for x, y in zip(a, b) if x != y][:3]}")
        print(f"image: ResNet-50 in-run resume from step {R50_EPOCHS - 1}: "
              f"epoch {R50_EPOCHS} only, metrics bit-equal, {step}: "
              f"{len(a)} shard crc32s equal; wall {resume_s:.2f} s [{smi}]")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
    return dict(wall_s=wall_s, metrics_history=res.metrics_history,
                launches=got, batch_stats_leaves=len(leaves),
                resume_steps=new_steps, resume_shards=len(a),
                resume_wall_s=resume_s, timing=resnet50_timing(torch, smi),
                gpu=smi)


def resnet50_timing(torch, smi) -> dict:
    """The ResNet-50 train step (batch ``R50_BATCH``, 224 x 224) as
    ``train_func_per_worker`` runs it, batches prefetched to the card,
    cuDNN free to pick any algorithm: steps/s and images/s over the whole
    window of ``R50_TIMED_STEPS`` steps after ``R50_TIMED_WARMUP``
    (synchronized at both ends), the median step ms beside them, the peak
    memory, and the device's busy share of ``R50_PROFILED_STEPS`` steps
    under the profiler; with cuDNN's TF32 off and again on (PyTorch's
    default for convolutions)."""
    from tpuflow_torch.data.loader import get_dataloaders, prefetch_to_device
    from tpuflow_torch.flows import my_torch_module as m
    from tpuflow_torch.train.step import (
        DispatchWindow,
        create_train_state,
        make_train_step,
    )

    n = R50_TIMED_WARMUP + R50_TIMED_STEPS
    train, _ = get_dataloaders(R50_BATCH, dataset="imagenet_synth",
                               n_train=R50_BATCH * n, n_test=0)
    model = m.build_model("resnet50", dataset="imagenet_synth",
                          num_classes=1000).cuda()
    state = create_train_state(model, 1e-3)
    step = make_train_step()

    def run(warmup: int, steps: int) -> list[float]:
        """``warmup`` steps, then ``steps`` timed ones: the stamps at the
        synchronized start of the timed steps, after each of them, and at
        the synchronized end."""
        window = DispatchWindow(2)
        stamps = []
        for i, placed in zip(range(warmup + steps), prefetch_to_device(
                train, "cuda", keys=("x", "y"))):
            if i == warmup:
                for matured in window.drain():
                    float(matured)
                torch.cuda.synchronize()
                stamps.append(time.monotonic())
            _, metrics = step(state, placed, 1)
            for matured in window.push(metrics["loss"]):
                float(matured)
            if i >= warmup:
                stamps.append(time.monotonic())
        for matured in window.drain():
            float(matured)
        torch.cuda.synchronize()
        stamps.append(time.monotonic())
        if len(stamps) != steps + 2:
            raise AssertionError(f"{len(stamps) - 2} ResNet-50 steps timed,"
                                 f" want {steps}")
        return stamps

    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        for key, allow in (("tf32_off", False), ("tf32_on", True)):
            torch.backends.cudnn.allow_tf32 = allow
            torch.cuda.reset_peak_memory_stats()
            stamps = run(R50_TIMED_WARMUP, R50_TIMED_STEPS)
            timed_s = stamps[-1] - stamps[0]
            ms = float(np.median(np.diff(stamps[:-1]))) * 1e3
            walls = []
            kernels = kernel_trace(torch, lambda: walls.append(
                run(0, R50_PROFILED_STEPS)))
            wall = walls[-1][-1] - walls[-1][0]
            busy = _busy(kernels) / 1e6
            out[key] = dict(
                timed_wall_s=timed_s,
                steps_per_s=R50_TIMED_STEPS / timed_s,
                images_per_s=R50_BATCH * R50_TIMED_STEPS / timed_s,
                step_ms_median=ms,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                kernels_per_step=len(kernels) / R50_PROFILED_STEPS,
                device_busy_share=busy / wall, profiled_wall_s=wall,
                top_kernels_ms=_top(kernels))
            r = out[key]
            print(f"image: ResNet-50 step, cuDNN TF32 "
                  f"{'on' if allow else 'off'}: {R50_TIMED_STEPS} steps "
                  f"after {R50_TIMED_WARMUP} in {timed_s:.4f} s: "
                  f"{r['steps_per_s']:.3f} steps/s, "
                  f"{r['images_per_s']:.1f} images/s (median step "
                  f"{ms:.2f} ms), peak memory "
                  f"{r['peak_memory_bytes'] / 2**30:.2f} GiB; under the "
                  f"profiler {R50_PROFILED_STEPS} steps: "
                  f"{r['kernels_per_step']:.0f} kernels a step, device busy "
                  f"{r['device_busy_share']:.1%} of {wall:.3f} s; top "
                  + ", ".join(f"{k[:40]} {v:.1f} ms" for k, v in
                              r["top_kernels_ms"][:4]) + f" [{smi}]")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def vit_leg(torch, smi) -> dict:
    """ViT-S/16 on imagenet_synth with ``attn_impl="flash"`` (f32, TF32
    off) through ``train_model`` (1 epoch of ``VIT_TRAIN_ROWS`` rows at
    batch ``VIT_BATCH``) and ``TorchPredictor`` + ``map_batches`` over the
    ``VIT_TEST_ROWS`` test rows: each flash kernel launched exactly as
    often as the steps imply (no remat: the forward with lse, dq and
    dk/dv once a layer and step; the no-lse forward once a layer and
    validation or predictor batch), finite val_loss and logits. Then one
    step's loss and gradients against the same model on
    ``attn_impl="xla"``."""
    from tpuflow_torch.flows import my_torch_module as m
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im

    L = 12
    steps = VIT_TRAIN_ROWS // VIT_BATCH
    n_val = -(-VIT_TEST_ROWS // VIT_BATCH)
    kw = {"attn_impl": "flash"}
    root = tempfile.mkdtemp(prefix="chip_smoke_vit_",
                            dir=os.path.join(REPO, "build"))
    try:
        _zero_counters(fa, im)
        t0 = time.monotonic()
        res = m.train_model(model="vit_small", dataset="imagenet_synth",
                            model_kwargs=kw, global_batch_size=VIT_BATCH,
                            epochs=1, n_train=VIT_TRAIN_ROWS,
                            n_test=VIT_TEST_ROWS,
                            checkpoint_storage_path=os.path.join(root, "run"))
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        train_n = _counters(fa, im)
        want = _launches(flash_fwd_lse=L * steps, flash_bwd_dq=L * steps,
                         flash_bwd_dkv=L * steps, flash_fwd=L * n_val)
        print(f"ViT-S/16 train_model launches {train_n} (want {want})")
        if train_n != want:
            raise AssertionError(f"ViT train_model launched {train_n}, want "
                                 f"{want}")
        val = res.metrics["val_loss"]
        if not np.isfinite(val):
            raise AssertionError(f"ViT val_loss {val}")
        rows = m.get_dataloaders(VIT_BATCH, dataset="imagenet_synth",
                                 as_rows=True, n_train=0,
                                 n_test=VIT_TEST_ROWS)
        predictor = m.TorchPredictor(res.best_checkpoint, model=m.build_model(
            "vit_small", dataset="imagenet_synth", num_classes=1000, **kw))
        _zero_counters(fa, im)
        outs = m.map_batches(rows, predictor, batch_size=VIT_BATCH)
        torch.cuda.synchronize()
        eval_n = _counters(fa, im)
        want = _launches(flash_fwd=L * n_val)
        if eval_n != want:
            raise AssertionError(f"ViT predictor launched {eval_n}, want "
                                 f"{want}")
        logits = np.stack([o["logits"] for o in outs])
        if logits.shape != (VIT_TEST_ROWS, 1000) or not np.isfinite(
                logits).all():
            raise AssertionError(f"ViT logits {logits.shape}")
        print(f"image: ViT-S/16 / imagenet_synth, flash: {steps} steps at "
              f"batch {VIT_BATCH} (T = 197, 6 heads of 64, not causal), "
              f"val_loss {val:.4f}, wall {wall_s:.2f} s; predictor over "
              f"{len(rows)} rows: {eval_n['flash_fwd']} no-lse launches, "
              f"logits finite [{smi}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(wall_s=wall_s, val_loss=val, train_launches=train_n,
                eval_launches=eval_n,
                parity=vit_step_parity(torch, rows[:VIT_BATCH]), gpu=smi)


def vit_step_parity(torch, rows) -> dict:
    """One forward+backward of ViT-S/16 from the same seed and batch with
    the flash kernels and with the einsum attention (dropout off, TF32
    off): the loss within ``PARITY_LOSS_ATOL`` and every gradient within
    ``PARITY_GRAD_RTOL`` of its max |g|."""
    from tpuflow_torch.flows import my_torch_module as m
    from tpuflow_torch.models.losses import cross_entropy_loss

    x = torch.as_tensor(np.stack([r["features"] for r in rows]),
                        device="cuda")
    y = torch.as_tensor([r["labels"] for r in rows], device="cuda")
    res = {}
    for impl in ("flash", "xla"):
        model = m.build_model("vit_small", dataset="imagenet_synth",
                              num_classes=1000, attn_impl=impl).cuda()
        loss = cross_entropy_loss(model(x, train=True, rng=1), y)
        loss.backward()
        res[impl] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()})
        del model
    loss_err = abs(res["flash"][0] - res["xla"][0])
    worst, worst_name = 0.0, None
    for n, gx in res["xla"][1].items():
        gf = res["flash"][1][n]
        ratio = float((gf - gx).abs().max() / gx.abs().max().clamp_min(1e-30))
        if ratio > worst:
            worst, worst_name = ratio, n
    print(f"image: ViT-S/16 step parity flash vs einsum: loss "
          f"{res['flash'][0]:.6f} vs {res['xla'][0]:.6f} (|diff| "
          f"{loss_err:.3g}, limit {PARITY_LOSS_ATOL}); worst gradient "
          f"{worst_name} max|diff| = {worst:.3g} of its max|g| (limit "
          f"{PARITY_GRAD_RTOL})")
    if not (loss_err <= PARITY_LOSS_ATOL and worst <= PARITY_GRAD_RTOL):
        raise AssertionError("ViT flash and einsum steps disagree")
    return dict(loss_flash=res["flash"][0], loss_xla=res["xla"][0],
                loss_abs_diff=loss_err, worst_grad=worst_name,
                worst_grad_rel_diff=worst)


# --------------------------------------------------------------- phase 11
def _recipe_cfg(**kw):
    """The training recipes' GPT-2 124M call: full depth and width, 8 x
    1024 tokens a step, f32, flash attention, full remat, random weights
    from seed 0, ``RECIPE_EPOCHS`` epochs of ``RECIPE_STEPS`` steps."""
    from tpuflow_torch.train.gpt import GptTrainConfig

    return GptTrainConfig(**{
        "preset": "gpt2", "seq_len": RECIPE_SEQ, "batch_size": 8,
        "epochs": RECIPE_EPOCHS, "steps_per_epoch": RECIPE_STEPS,
        "attn_impl": "flash", "data_axis": 1, "fsdp_axis": 1, **kw})


def _recipe_want(cfg, steps: int, epochs: int, samples: int = 0) -> dict:
    """The flash launches ``steps`` training steps of ``cfg`` imply (full
    remat: two forwards with lse a layer and step, one fused pair), with
    ``epochs`` validations over its held-out windows and ``samples``
    prefills (the no-lse forward a layer each)."""
    from tpuflow_torch.data.lm import make_lm_loaders

    mc = cfg.model_config()
    L = mc.n_layer
    n_val = len(make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                cfg.seq_len, mc.vocab_size,
                                dataset=cfg.dataset,
                                text_path=cfg.text_path)[1])
    return _launches(flash_fwd_lse=2 * L * steps, flash_bwd_dq=L * steps,
                     flash_bwd_dkv=L * steps,
                     flash_fwd=L * (n_val * epochs + samples))


def _recipe_train(torch, name, cfg, smi, ckpt_dir=None, samples=0,
                  steps=None, epochs=None):
    """One ``train_gpt`` run of ``cfg``, its launches read from zero and
    held to what its steps imply exactly; every loss finite. Returns the
    result, its wall and peak memory, and prints its step ms, tokens/s
    and wall."""
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train.gpt import train_gpt

    steps = cfg.epochs * cfg.steps_per_epoch if steps is None else steps
    epochs = cfg.epochs if epochs is None else epochs
    want = _recipe_want(cfg, steps, epochs, samples)
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(fa, im)
    t0 = time.monotonic()
    res = train_gpt(cfg, ckpt_dir=ckpt_dir, log=lambda m: print(f"  {m}"))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    got = _counters(fa, im)
    if got != want:
        raise AssertionError(f"{name}: launches {got}, want {want}")
    losses = res.step_losses
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: step losses {losses}")
    step_ms = float(np.median(res.step_s[1:])) * 1e3
    tok_s = cfg.batch_size * cfg.seq_len / step_ms * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"{name}: step losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"launches exact ({got['flash_fwd_lse']} lse forwards, "
          f"{got['flash_bwd_dq']} fused pairs, {got['flash_fwd']} no-lse "
          f"forwards)")
    print(f"{name}: step {step_ms:.1f} ms (median after the cold step)")
    print(f"{name}: {tok_s:.0f} tokens/s")
    print(f"{name}: wall {wall:.2f} s, peak memory {peak / 2**30:.2f} GiB "
          f"[{smi}]")
    return res, dict(wall_s=wall, step_ms=step_ms, tokens_per_s=tok_s,
                     peak_memory_bytes=peak, step_losses=losses,
                     launches=got, epochs=res.metrics_history)


def _learned(name, res) -> None:
    """The last epoch's mean loss below the first step's."""
    if not res.loss_history[-1] < res.step_losses[0]:
        raise AssertionError(
            f"{name} did not learn: last epoch's mean "
            f"{res.loss_history[-1]} not below the first step's "
            f"{res.step_losses[0]}")


def _recipe_leg(torch, name, cfg, smi, root) -> tuple:
    """Train ``cfg`` with a checkpoint at each epoch's end; learning; then
    an in-run resume from a copy of the directory without its last step,
    whose losses must be the run's last epoch's bit for bit."""
    d = os.path.join(root, name)
    res, out = _recipe_train(torch, name, cfg, smi, ckpt_dir=d)
    _learned(name, res)
    last = f"step_{RECIPE_EPOCHS * RECIPE_STEPS}"
    resume = d + "_resume"
    shutil.copytree(d, resume,
                    ignore=shutil.ignore_patterns(last, ".recycle"))
    res2, out2 = _recipe_train(torch, f"{name} resume", cfg, smi,
                               ckpt_dir=resume, steps=RECIPE_STEPS,
                               epochs=1)
    if res2.step_losses != res.step_losses[RECIPE_STEPS:]:
        raise AssertionError(
            f"{name}: the resume's losses {res2.step_losses} differ from the "
            f"last epoch's {res.step_losses[RECIPE_STEPS:]}")
    if _shards(os.path.join(resume, last)) != _shards(os.path.join(d, last)):
        raise AssertionError(f"{name}: the resume's {last} differs from the "
                             "run's")
    io = dict(saves=res.checkpoint_io["saves"],
              restores=res2.checkpoint_io["restores"])
    print(f"{name}: resume from step {RECIPE_STEPS} reproduces the last "
          f"epoch's {RECIPE_STEPS} losses bit for bit and its {last} shard "
          f"crc32s; {_io_line('save', io['saves'])}; "
          f"{_io_line('restore', io['restores'])} (this machine's host "
          f"disk) [{smi}]")
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(resume, ignore_errors=True)
    out.update(resume=out2, checkpoint_io=io)
    return res, out


def _state_bytes(torch, cfg) -> dict:
    """The optimizer state of ``cfg``'s model on the card: the bytes of
    its tensors and what the allocator took for them."""
    from tpuflow_torch.train.gpt import JaxLeaves, _init_model

    mc = cfg.model_config()
    model = _init_model(mc, torch.device("cuda"))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tx = cfg.optimizer(model.parameters(), JaxLeaves(model, mc.scan_layers))
    torch.cuda.synchronize()
    took = torch.cuda.memory_allocated() - before
    tensors = [t for ts in (*tx.slots().values(), *tx.leaf_slots().values())
               for t in ts]
    out = dict(bytes=sum(t.nbytes for t in tensors), allocated=took,
               param_bytes=sum(p.nbytes for p in model.parameters()))
    del tx, model
    torch.cuda.empty_cache()
    return out


def _crossover(ts, flash_ms, xla_ms):
    """The smallest T from which flash is faster at every measured T
    (None: flash does not win at the largest)."""
    best = None
    for T in reversed(ts):
        if flash_ms[T] < xla_ms[T]:
            best = T
        else:
            break
    return best


def crossover_leg(torch, smi, root) -> dict:
    """The flash kernels against ``xla_attention`` at (8, T, 12, 64),
    causal, f32 and bf16, at every T of ``CROSSOVER_TS``: the forward,
    the forward+backward, and the backward alone (``autograd.grad`` over a
    retained graph), each the median of ``CROSSOVER_REPS`` interleaved
    runs (flash, xla, xla, flash ...; CUDA events around one call). The
    crossovers (the smallest T from which flash wins at every larger T,
    the larger of the two dtypes') go to a tuning file in ``root``, and
    ``resolve_attention_impl(tuning=that file)`` must pick flash exactly
    from them."""
    from tpuflow_torch.ops.attention import (
        flash_min_seq,
        resolve_attention_impl,
        xla_attention,
    )
    from tpuflow_torch.ops.flash_attention import flash_attention

    impls = {"flash": lambda q, k, v: flash_attention(q, k, v, causal=True),
             "xla": lambda q, k, v: xla_attention(q, k, v, causal=True)}
    B, H, D = CROSSOVER_BHD
    g = torch.Generator(device="cuda").manual_seed(0)
    table = {}

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for T in CROSSOVER_TS:
            q, k, v = (torch.randn((B, T, H, D), generator=g, device="cuda")
                       .to(dtype).requires_grad_() for _ in range(3))
            do = torch.randn((B, T, H, D), generator=g,
                             device="cuda").to(dtype)

            def fwd(name):
                with torch.no_grad():
                    impls[name](q, k, v)

            def fwd_bwd(name):
                torch.autograd.grad(impls[name](q, k, v), (q, k, v), do)

            # The backward alone, over one graph an implementation.
            graphs = {name: f(q, k, v) for name, f in impls.items()}

            def bwd(name):
                torch.autograd.grad(graphs[name], (q, k, v), do,
                                    retain_graph=True)

            row = {}
            for path, run in (("fwd", fwd), ("fwd_bwd", fwd_bwd),
                              ("bwd", bwd)):
                for name in impls:  # warm-up
                    run(name)
                ms = {name: [] for name in impls}
                for r in range(CROSSOVER_REPS):
                    order = list(impls) if r % 2 == 0 else list(impls)[::-1]
                    for name in order:
                        ms[name].append(timed(lambda: run(name)))
                row[path] = {name: float(np.median(v)) for name, v in
                             ms.items()}
            table[(dt, T)] = row
            del q, k, v, do, graphs
            print(f"crossover {dt} T={T}: fwd flash "
                  f"{row['fwd']['flash']:.4f} ms, xla "
                  f"{row['fwd']['xla']:.4f}; fwd+bwd flash "
                  f"{row['fwd_bwd']['flash']:.4f}, xla "
                  f"{row['fwd_bwd']['xla']:.4f}; bwd flash "
                  f"{row['bwd']['flash']:.4f}, xla {row['bwd']['xla']:.4f} "
                  f"(medians of {CROSSOVER_REPS}) [{smi}]")
        torch.cuda.empty_cache()
    found = {}
    for path in ("fwd", "fwd_bwd", "bwd"):
        per_dtype = {}
        for dt in ("float32", "bfloat16"):
            per_dtype[dt] = _crossover(
                CROSSOVER_TS,
                {T: table[(dt, T)][path]["flash"] for T in CROSSOVER_TS},
                {T: table[(dt, T)][path]["xla"] for T in CROSSOVER_TS})
        found[path] = per_dtype
    # Flash from a T where it wins in both dtypes (None: in neither,
    # within the grid).
    both = {path: (None if None in v.values() else max(v.values()))
            for path, v in found.items()}
    tuning = {key: both[path] for key, path in (
        ("flash_min_seq", "fwd_bwd"), ("flash_min_seq_fwd", "fwd"),
        ("flash_min_seq_bwd", "bwd")) if both[path] is not None}
    path = os.path.join(root, "flash_tuning.json")
    with open(path, "w") as fh:
        json.dump(tuning, fh)
    for needs_bwd in (True, False):
        start = flash_min_seq(needs_bwd=needs_bwd, tuning=path)
        for T in CROSSOVER_TS:
            got = resolve_attention_impl("auto", T, needs_bwd=needs_bwd,
                                         backend="cuda", tuning=path)
            if (got == "flash") != (T >= start):
                raise AssertionError(
                    f"resolve_attention_impl(tuning={tuning}) picks {got} at "
                    f"T={T} (needs_bwd={needs_bwd}), want flash from {start}")
    print(f"crossovers (flash wins from): {json.dumps(found)}; tuning file "
          f"{json.dumps(tuning)}; resolve_attention_impl picks flash from "
          f"{flash_min_seq(tuning=path)} (fwd+bwd) and "
          f"{flash_min_seq(needs_bwd=False, tuning=path)} (fwd) [{smi}]")
    return dict(shape=[B, "T", H, D], ts=list(CROSSOVER_TS),
                reps=CROSSOVER_REPS,
                table={f"{dt}/{T}": row for (dt, T), row in table.items()},
                crossovers=found, tuning=tuning, gpu=smi)


def recipes_phase(torch, smi) -> dict:
    """Phase 11, the training recipes on GPT-2 124M at full depth and
    width (``_recipe_cfg``), each leg's flash launches exact:

    (a) Lion, (b) Adafactor, (c) Switch MoE (8 experts, capacity 1.25,
        aux weight 1e-2, AdamW; MOE_LAYERS of the 12 layers): learning,
        and an in-run resume from the first epoch's checkpoint bit-equal
        to the second epoch; (b) also the optimizer state's bytes against
        AdamW's, (c) the summed aux finite and above 0, the checkpoint's
        size and its save and restore rates;
    (d) ``lm_text`` on this checkout's README.md: learning, the recorded
        ``text_source`` hash, a greedy byte-level sample from "The ";
    (e) ``TorchGptTrain --optimizer adafactor --experts 8 --dataset
        lm_text --text-path README.md`` 2 x 2 steps, then the triggered
        ``TorchGptEval``: the MoE model rebuilt, the corpus checked, a
        finite perplexity;
    (f) the 124M weights through ``params_to_hf_state_dict`` and
        ``hf_gpt2_to_params``: bit-equal, equal logits;
    (g) the flash crossovers (``crossover_leg``)."""
    import hashlib

    from tpuflow_torch.data.lm import text_source_record
    from tpuflow_torch.flow import Run
    from tpuflow_torch.flows import gpt_eval_flow, gpt_flow
    from tpuflow_torch.infer.generate import render_tokens
    from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
    from tpuflow_torch.models.import_hf import (
        hf_gpt2_to_params,
        params_to_hf_state_dict,
    )
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train import step as step_mod

    t_phase = time.monotonic()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_recipes_",
                            dir=os.path.join(REPO, "build"))
    out = {"gpu": smi}
    try:
        # --- (a) Lion, (b) Adafactor.
        for name, lr in (("lion", LION_LR), ("adafactor", ADAFACTOR_LR)):
            _, out[name] = _recipe_leg(
                torch, name, _recipe_cfg(optimizer_name=name,
                                         learning_rate=lr), smi, root)
        mine = _state_bytes(torch, _recipe_cfg(optimizer_name="adafactor"))
        adamw = _state_bytes(torch, _recipe_cfg())
        out["adafactor"]["state_bytes"] = mine
        out["adafactor"]["adamw_state_bytes"] = adamw
        print(f"adafactor state: {mine['bytes'] / 2**20:.2f} MiB "
              f"({mine['allocated'] / 2**20:.2f} MiB allocated) against "
              f"AdamW's {adamw['bytes'] / 2**20:.2f} MiB "
              f"({adamw['allocated'] / 2**20:.2f} allocated) for "
              f"{mine['param_bytes'] / 2**20:.1f} MiB of f32 parameters "
              f"[{smi}]")

        # --- (c) Switch MoE.
        seen = []
        real = step_mod.sum_sown_losses
        step_mod.sum_sown_losses = lambda v: seen.append(real(v)) or seen[-1]
        try:
            cfg = _depth_cut(_recipe_cfg(experts=MOE_EXPERTS), MOE_LAYERS)
            res, out["moe"] = _recipe_leg(torch, "moe", cfg, smi, root)
        finally:
            step_mod.sum_sown_losses = real
        aux = [float(a.detach()) for a in seen]
        n_steps = RECIPE_EPOCHS * RECIPE_STEPS + RECIPE_STEPS
        if len(aux) != n_steps or not all(np.isfinite(a) and a > 0
                                          for a in aux):
            raise AssertionError(f"moe: summed aux {aux} (want {n_steps} "
                                 "finite values above 0)")
        mc = cfg.model_config()
        n_params = sum(p.numel() for p in GPT2(mc, seed=None,
                                               device="meta").parameters())
        saved = out["moe"]["checkpoint_io"]["saves"][-1]["bytes"]
        out["moe"].update(aux=aux, params=n_params, checkpoint_bytes=saved)
        print(f"moe: {n_params / 1e6:.1f}M parameters, the summed aux "
              f"{', '.join(f'{a:.5f}' for a in aux)} (finite, above 0); "
              f"checkpoint {saved / 1e9:.2f} GB [{smi}]")

        # --- (d) lm_text on README.md.
        text = os.path.join(REPO, "README.md")
        cfg = _recipe_cfg(dataset="lm_text", text_path=text,
                          sample_tokens=RECIPE_SAMPLE)
        res, out["lm_text"] = _recipe_train(torch, "lm_text", cfg, smi,
                                            samples=1)
        _learned("lm_text", res)
        rec = text_source_record(text)
        with open(text, "rb") as fh:
            sha = hashlib.sha256(fh.read()).hexdigest()
        if rec["sha256"] != sha or rec["bytes"] != os.path.getsize(text):
            raise AssertionError(f"text_source {rec}, sha256 {sha}")
        if len(res.sample) != RECIPE_SAMPLE:
            raise AssertionError(f"lm_text sample {res.sample}")
        sample = render_tokens(res.sample, byte_level=True)
        out["lm_text"].update(text_source=rec, sample=sample)
        print(f"lm_text: README.md, {rec['bytes']} bytes, sha256 "
              f"{rec['sha256'][:16]}...; greedy sample from 'The ': "
              f"{sample!r} [{smi}]")

        # --- (e) the flows.
        home = os.path.join(root, "home")
        argv = ["run", "--preset", "gpt2", "--seq-len", str(RECIPE_SEQ),
                "--batch-size", "8", "--epochs", "2", "--steps-per-epoch",
                "2", "--attn-impl", "flash", "--data-axis", "1",
                "--fsdp-axis", "1", "--optimizer", "adafactor",
                "--learning-rate", str(ADAFACTOR_LR), "--experts",
                str(MOE_EXPERTS), "--dataset", "lm_text", "--text-path",
                text, "--home", home]
        fcfg = _recipe_cfg(optimizer_name="adafactor", experts=MOE_EXPERTS,
                           dataset="lm_text", text_path=text, epochs=2,
                           steps_per_epoch=2)
        want = _recipe_want(fcfg, 4, 2)
        _zero_counters(fa, im)
        t0 = time.monotonic()
        run = Run(gpt_flow.main(argv))
        torch.cuda.synchronize()
        train_wall = time.monotonic() - t0
        got = _counters(fa, im)
        if got != want:
            raise AssertionError(f"TorchGptTrain launches {got}, want {want}")
        if run.data.model_config["n_experts"] != MOE_EXPERTS or \
                run.data.text_source["sha256"] != sha:
            raise AssertionError(f"TorchGptTrain recorded "
                                 f"{run.data.model_config}, "
                                 f"{run.data.text_source}")
        L = fcfg.model_config().n_layer  # the flow's model, full depth
        n_val = want["flash_fwd"] // (2 * L)
        ewant = _launches(flash_fwd=L * (n_val + 3))
        _zero_counters(fa, im)
        t0 = time.monotonic()
        ev = Run(gpt_eval_flow.main(["run", "--triggered", "--attn-impl",
                                     "flash", "--sample-tokens", "16",
                                     "--home", home]))
        torch.cuda.synchronize()
        eval_wall = time.monotonic() - t0
        egot = _counters(fa, im)
        if egot != ewant:
            raise AssertionError(f"TorchGptEval launches {egot}, want "
                                 f"{ewant}")
        if ev.meta.get("triggered_by") != run.pathspec or \
                not np.isfinite(ev.data.test_ppl):
            raise AssertionError(f"TorchGptEval: {ev.meta}, ppl "
                                 f"{ev.data.test_ppl}")
        out["flows"] = dict(train_wall_s=train_wall, eval_wall_s=eval_wall,
                            loss_history=run.data.loss_history,
                            test_ppl=ev.data.test_ppl, samples=ev.data.samples,
                            train_launches=got, eval_launches=egot)
        print(f"flows: TorchGptTrain (adafactor, {MOE_EXPERTS} experts, "
              f"lm_text) losses {run.data.loss_history}, wall "
              f"{train_wall:.2f} s; TorchGptEval rebuilt the MoE model, "
              f"the corpus hash checked, test ppl {ev.data.test_ppl:.2f}, "
              f"greedy {ev.data.samples[0][1]!r}, wall {eval_wall:.2f} s; "
              f"launches exact [{smi}]")

        # --- (f) HF round trip.
        mc = GPT2Config.from_preset("gpt2")
        model = GPT2(mc, seed=0)
        t0 = time.monotonic()
        back = hf_gpt2_to_params(params_to_hf_state_dict(model, mc), mc)
        hf_s = time.monotonic() - t0
        sd = model.state_dict()
        if back.keys() != sd.keys() or not all(
                torch.equal(back[k], sd[k]) for k in sd):
            raise AssertionError("the HF round trip changed the weights")
        twin = GPT2(mc, seed=None)
        twin.load_state_dict(back)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, mc.vocab_size, (2, 128)), device="cuda")
        with torch.no_grad():
            if not torch.equal(model(toks), twin(toks)):
                raise AssertionError("the HF round trip's logits differ")
        del model, twin, back, sd
        out["hf"] = dict(round_trip_s=hf_s)
        print(f"hf: 124M weights through params_to_hf_state_dict and "
              f"hf_gpt2_to_params bit-equal, logits equal, {hf_s:.2f} s "
              f"[{smi}]")

        # --- (g) the flash crossovers.
        out["crossover"] = crossover_leg(torch, smi, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.monotonic() - t_phase
    print(f"phase 11 (training recipes): wall {out['wall_s']:.1f} s [{smi}]")
    return out


_CUT_CLASSES: dict = {}


def _depth_cut(cfg, n_layer: int):
    """``cfg`` (a ``GptTrainConfig``) whose model has ``n_layer`` blocks,
    the preset's width unchanged: a depth cut for the time limit."""
    from tpuflow_torch.train.gpt import GptTrainConfig

    cls = _CUT_CLASSES.get(n_layer)
    if cls is None:
        def model_config(self):
            return dataclasses.replace(GptTrainConfig.model_config(self),
                                       n_layer=n_layer)

        cls = _CUT_CLASSES[n_layer] = type(
            f"GptTrainConfigL{n_layer}", (GptTrainConfig,),
            {"model_config": model_config})
    return cls(**dataclasses.asdict(cfg))


def _fsdp_cfg(**kw):
    from tpuflow_torch.train.gpt import GptTrainConfig

    return _depth_cut(GptTrainConfig(
        preset="medium", seq_len=1024, batch_size=8, epochs=FSDP_EPOCHS,
        steps_per_epoch=FSDP_STEPS_PER_EPOCH, attn_impl="flash",
        **{"data_axis": 1, "fsdp_axis": FSDP_WORLD, **kw}), FSDP_LAYERS)


def _fsdp_want(cfg, steps: int, epochs: int) -> dict:
    """Each rank's flash launches for ``steps`` steps and ``epochs``
    validations of ``cfg`` under full remat."""
    from tpuflow_torch.data.lm import make_lm_loaders

    mc = cfg.model_config()
    L = mc.n_layer
    n_val = len(make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                cfg.seq_len, mc.vocab_size)[1])
    return _launches(flash_fwd_lse=2 * L * steps, flash_bwd_dq=L * steps,
                     flash_bwd_dkv=L * steps, flash_fwd=L * n_val * epochs)


def _first_grads(torch, cfg, mesh=None):
    """The first batch's loss (with a MoE model's load-balance losses)
    and gradients of ``cfg``'s fresh model, dropout off and TF32 off, with
    no update: on one device (the gradients on the card), or sharded over
    ``mesh`` (the train step's reductions, ``train.step.
    sharded_gradients``; process 0 gets the gathered gradients on the
    host, the others None)."""
    from tpuflow_torch import dist
    from tpuflow_torch.data.lm import make_lm_loaders
    from tpuflow_torch.device import f32_matmul_precision
    from tpuflow_torch.models.losses import cross_entropy_loss, sum_sown_losses
    from tpuflow_torch.train.gpt import init_state
    from tpuflow_torch.train.step import batch_sum, sharded_gradients

    mc = dataclasses.replace(cfg.model_config(), dropout=0.0)
    loader, _ = make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                cfg.seq_len, mc.vocab_size)
    loader.set_epoch(0)
    batch = next(iter(loader))
    state = init_state(cfg, mc, str(mesh.device) if mesh else "cuda",
                       mesh=mesh)
    if mesh is not None:
        batch = dist.shard_batch(batch, mesh)
    x, y = (torch.as_tensor(batch[k], device="cuda") for k in ("x", "y"))
    with f32_matmul_precision():
        if mc.n_experts:  # the train step's loss: with the MoE aux losses
            logits, aux = state.model(x, train=True, rng=1, losses=True)
            loss = cross_entropy_loss(logits, y) + sum_sown_losses(aux)
        else:
            loss = cross_entropy_loss(state.model(x, train=True, rng=1), y)
        loss.backward()
    torch.cuda.synchronize()
    named = list(state.model.named_parameters())
    if mesh is None:
        return float(loss.detach()), {n: p.grad.cpu() for n, p in named}
    # The gradients reduced as the train step reduces them.
    plan = state.plan
    grads = sharded_gradients(state)
    grads = {n: plan.full(n, g, mesh).cpu()
             for n, g in zip(plan.names, grads)}
    loss = float(batch_sum(loss.detach().reshape(1), mesh)[0]) / (
        plan.world * mesh.shape.get("seq", 1))
    del state, named
    torch.cuda.empty_cache()
    return loss, grads if dist.process_index() == 0 else None


def _one_device_parity(torch, cfg, grads_path: str, d_loss: float,
                       what: str) -> dict:
    """The first step of ``cfg`` on one device against the sharded one's
    (its loss ``d_loss``, the gradients its process 0 saved at
    ``grads_path``), compared on the card: the loss within
    PARITY_LOSS_ATOL, every gradient within PARITY_GRAD_RTOL of its max
    |g|. Returns both errors and the check's seconds."""
    t0 = time.monotonic()
    loss1, g1 = _first_grads(torch, cfg)
    gs = torch.load(grads_path, map_location="cpu")
    loss_err = abs(loss1 - d_loss)
    worst = max(float((g1[n] - gs[n].to(g1[n].device)).abs().max()
                      / g1[n].abs().max().clamp_min(1e-30)) for n in g1)
    del g1, gs
    torch.cuda.empty_cache()
    if not (loss_err <= PARITY_LOSS_ATOL and worst <= PARITY_GRAD_RTOL):
        raise AssertionError(f"{what} step against one device: loss "
                             f"{loss_err:.2e}, gradients {worst:.2e}")
    return dict(loss_err=loss_err, grad_rel=worst,
                seconds=time.monotonic() - t0)


def _collective_ms(torch, n: int) -> dict:
    """The gloo collectives of one FSDP step at its volume, timed alone:
    an all-gather of ``n`` f32 elements (a rank's half in, the whole
    state out) and a reduce-scatter back, on the card."""
    import torch.distributed as tdist

    world = tdist.get_world_size()
    full = torch.zeros(n - n % world, device="cuda")
    part = torch.zeros(full.numel() // world, device="cuda")
    out = {}
    for name, fn in (("all_gather", lambda: tdist.all_gather_into_tensor(
            full, part)), ("reduce_scatter",
                           lambda: tdist.reduce_scatter_tensor(part, full))):
        times = []
        for _ in range(FSDP_COLLECTIVE_REPS):
            tdist.barrier()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        out[name + "_ms"] = float(np.median(times))
    out["bytes"] = full.numel() * 4
    return out


def fsdp_rank(torch, rank: int, port: int, work: str) -> None:
    """One rank of phase 12 (a process of its own, ``--fsdp-rank``): (b)
    the FSDP leg, the collectives at its volume, (c) the in-run resume at
    K = 2, (d) the first step's gradients; its records to
    ``work/rank<r>.json``."""
    import faulthandler

    from tpuflow_torch import dist
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.parallel import has_sharded_leaf
    from tpuflow_torch.train import gpt as gpt_mod

    faulthandler.enable()
    dist.initialize("cuda", rank=rank, world_size=FSDP_WORLD,
                    init_method=f"tcp://localhost:{port}",
                    backend=FSDP_BACKEND, device_index=FSDP_CARD)
    _await_go(os.path.join(work, "go"))
    cfg = _fsdp_cfg()
    log = (lambda m: print(f"  {m}", flush=True)) if rank == 0 else (
        lambda m: None)
    states = []
    real_init = gpt_mod.init_state

    def keep(*a, **kw):
        states.append(real_init(*a, **kw))
        return states[-1]

    gpt_mod.init_state = keep
    ckpt = os.path.join(work, "ckpt")
    # --- (b) the FSDP leg.
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(fa, im)
    t0 = time.monotonic()
    res = gpt_mod.train_gpt(cfg, ckpt_dir=ckpt, log=log,
                            device=f"cuda:{FSDP_CARD}")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _counters(fa, im)
    state = states[-1]
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    out = {"b": dict(
        launches=launches, step_losses=res.step_losses,
        loss_history=res.loss_history, epochs=res.metrics_history,
        step_s=res.step_s, wall_s=wall, saves=res.checkpoint_io["saves"],
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        sharded=has_sharded_leaf(state.plan),
        local_param_bytes=nbytes(state.params),
        local_moment_bytes=nbytes(state.tx.mu + state.tx.nu),
        state_param_bytes=sum(p.numel() * 4 for p in
                              state.model.parameters()))}
    n_params = sum(p.numel() for p in state.model.parameters())
    del state, states[:]
    torch.cuda.empty_cache()
    out["collectives"] = _collective_ms(torch, n_params)
    # --- (c) the in-run resume at K = 2: the directory without its last
    # step.
    resume = os.path.join(work, "resume2")
    if rank == 0:
        shutil.copytree(ckpt, resume, ignore=shutil.ignore_patterns(
            ".recycle*", f"step_{FSDP_STEPS}"))
    dist.barrier()
    _zero_counters(fa, im)
    res2 = gpt_mod.train_gpt(cfg, ckpt_dir=resume, log=log,
                             device=f"cuda:{FSDP_CARD}")
    torch.cuda.synchronize()
    out["c"] = dict(launches=_counters(fa, im),
                    step_losses=res2.step_losses,
                    restores=res2.checkpoint_io["restores"])
    states.clear()
    gpt_mod.init_state = real_init
    torch.cuda.empty_cache()
    # --- (d) the first step's gradients, sharded.
    mesh = dist.make_mesh(f"cuda:{FSDP_CARD}",
                          {"data": 1, "fsdp": FSDP_WORLD})
    loss, grads = _first_grads(torch, cfg, mesh)
    out["d_loss"] = loss
    if rank == 0:
        torch.save(grads, os.path.join(work, "fsdp_grads.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh, default=float)
    dist.barrier()
    dist.shutdown()


def gloo_probe_rank(torch, rank: int, port: int) -> None:
    """One rank of the probe that fixed phases 12 and 13's mode
    (``--gloo-probe``): FSDP_WORLD processes on card FSDP_CARD over one
    gloo group move 64 MB CUDA tensors by ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` (FSDP2's) and 128 MB by ``all_reduce`` (the
    tensor and expert groups'), each held bit-equal to the same gather and
    sums on the host, then FSDP2 takes a step of a two-layer model over
    the group; prints one line."""
    import torch.distributed as tdist
    from torch.distributed.fsdp import fully_shard

    from tpuflow_torch import dist

    dist.initialize("cuda", rank=rank, world_size=FSDP_WORLD,
                    init_method=f"tcp://localhost:{port}",
                    backend=FSDP_BACKEND, device_index=FSDP_CARD)
    n = (64 << 20) // 4
    host = [torch.randn(FSDP_WORLD * n,
                        generator=torch.Generator().manual_seed(r))
            for r in range(FSDP_WORLD)]
    full = torch.empty(FSDP_WORLD * n, device="cuda")
    part = torch.empty(n, device="cuda")
    red = host[rank].cuda()
    out = {"rank": rank}
    for name, fn, want in (
            ("all_gather", lambda: tdist.all_gather_into_tensor(
                full, host[rank][:n].cuda()),
             lambda: torch.equal(full.cpu(), torch.cat(
                 [h[:n] for h in host]))),
            ("reduce_scatter", lambda: tdist.reduce_scatter_tensor(
                part, host[rank].cuda()),
             lambda: torch.equal(part.cpu(), sum(host)[rank * n:
                                                       (rank + 1) * n])),
            ("all_reduce", lambda: tdist.all_reduce(red),
             lambda: torch.equal(red.cpu(), sum(host)))):
        torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        out[name + "_s"] = time.monotonic() - t0
        out[name + "_equal"] = bool(want())
    model = torch.nn.Sequential(torch.nn.Linear(256, 512),
                                torch.nn.Linear(512, 256)).cuda()
    for layer in model:
        fully_shard(layer)
    fully_shard(model)
    x = torch.randn(8, 256, device="cuda")
    model(x).square().mean().backward()
    torch.cuda.synchronize()
    out["fsdp2_step"] = True
    print(f"gloo probe {json.dumps(out)}", flush=True)
    dist.shutdown()


def gloo_probe() -> int:
    """``--gloo-probe``: run FSDP_WORLD ``gloo_probe_rank`` processes."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--gloo-probe-rank", str(r), str(port)])
             for r in range(FSDP_WORLD)]
    rcs = [p.wait(timeout=300) for p in procs]
    print(f"gloo probe ranks exited {rcs}")
    return max(rcs)


def _rule_layout(step_dir: str) -> list:
    """The leaves of a checkpoint whose shards are not the JAX rule's at
    FSDP_WORLD (``parallel.leaf_spec``, the rule on the leaf's shape)."""
    from tpuflow_torch.parallel import leaf_spec

    with open(os.path.join(step_dir, "state", "manifest.json")) as fh:
        manifest = json.load(fh)
    bad = []
    for e in manifest["leaves"]:
        shape = e["shape"]
        spec = leaf_spec((), shape, {"fsdp": FSDP_WORLD})
        d = spec.index("fsdp") if "fsdp" in spec else None
        want = {(tuple([0] * len(shape)), tuple(shape))}
        if d is not None:
            n = shape[d] // FSDP_WORLD
            want = {(tuple(i * n if j == d else 0 for j in range(len(shape))),
                     tuple(n if j == d else s for j, s in enumerate(shape)))
                    for i in range(FSDP_WORLD)}
        got = {(tuple(s["start"]), tuple(s["shape"])) for s in e["shards"]}
        if got != want:
            bad.append("/".join(e["path"]))
    return bad


def fsdp_kernel_rows(torch, timer) -> dict:
    """Phase 12 (a): the flash kernels at one rank's attention shape, f32
    (the leg's dtype), against their plain versions, with their times."""
    return dict(kernels_fwd=flash_phase(torch, timer, (FSDP_SHAPE,),
                                        dtypes=("float32",)),
                kernels_bwd=flash_bwd_phase(torch, timer, (FSDP_SHAPE,),
                                            dtypes=("float32",)))


def _fsdp_start() -> tuple:
    """Phase 12's work directory and its ranks, started (they wait for
    the go)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_fsdp_",
                            dir=os.path.join(REPO, "build"))
    return work, _start_ranks(["--fsdp-rank", "{rank}", "{port}", work],
                              FSDP_WORLD)


def fsdp_phase(torch, smi, kernel_rows: dict | None = None,
               started: tuple | None = None, ranks_done=None) -> dict:
    """Phase 12: GPT-2-medium trained by FSDP_WORLD ranks on card
    FSDP_CARD over gloo (see FSDP_BACKEND), each a process of its own:
    (a) the flash kernels at one rank's attention shape against their
    plain versions (``kernel_rows``: measured already); (b)
    ``train_gpt`` for 2 epochs of 2 steps with a checkpoint each epoch:
    it learns, each rank's flash launches are exact, the state is
    sharded (each rank's parameter and moment bytes about half the
    state's), the ranks' metrics are bit-equal; (c) the
    epoch-1 checkpoint's merged manifest is the JAX rule's at the world,
    every shard's crc32 checks, an in-run resume at K = 2 gives (b)'s
    epoch-2 losses and last step's crc32s bit for bit, and at K' = 1 (one
    process) every leaf restores bit-equal to the checkpoint and the
    epoch-2 losses fall within FSDP_RESUME_RTOL of (b)'s; (d) the first
    step's loss and gradients on one device within PARITY_LOSS_ATOL and
    PARITY_GRAD_RTOL of (b)'s sharded step; (e) ``TorchGptTrain`` at 124M
    as a two-member gang on the card, then ``TorchGptEval`` from it at one
    process, its flash launches exact. ``started``: ``_fsdp_start()``'s,
    when the ranks were started ahead; ``ranks_done`` is called once they
    have ended."""
    from tpuflow_torch.ckpt import CheckpointManager, raw
    from tpuflow_torch.ckpt.tree import checkpoint_tree, load_checkpoint_tree
    from tpuflow_torch.flow import Run, store
    from tpuflow_torch.flows import gpt_eval_flow, gpt_flow
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train.gpt import init_state, train_gpt

    t_phase = time.monotonic()
    out = {"mode": f"{FSDP_WORLD} ranks on cuda:{FSDP_CARD} over "
                   f"{FSDP_BACKEND}", "gpu": smi}
    # --- (a) the kernels at one rank's attention shape (the whole run
    # measures them with the other kernel phases, before a long run's
    # profiler traces start dropping events).
    if kernel_rows is None:
        kernel_rows = fsdp_kernel_rows(torch, Timer(torch))
        torch.cuda.empty_cache()
    out.update(kernel_rows)
    cfg = _fsdp_cfg()
    work, procs = started or _fsdp_start()
    try:
        ranks_s = _finish_ranks(procs, os.path.join(work, "go"), "phase 12")
        if ranks_done is not None:
            ranks_done()
        ranks = []
        for r in range(FSDP_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        b = [r["b"] for r in ranks]
        # (b) learning, launches, sharding, agreement.
        want_b = _fsdp_want(cfg, FSDP_STEPS, FSDP_EPOCHS)
        for r, rb in enumerate(b):
            if rb["launches"] != want_b:
                raise AssertionError(f"rank {r} launched {rb['launches']}, "
                                     f"want {want_b}")
            share = (rb["local_param_bytes"] / rb["state_param_bytes"],
                     rb["local_moment_bytes"] / rb["state_param_bytes"] / 2)
            if not rb["sharded"] or not all(0.45 < x < 0.55 for x in share):
                raise AssertionError(f"rank {r} holds {share} of the "
                                     "parameters and moments")
            rb["share"] = share
        def metrics(rb):  # tokens/s is each rank's own host clock
            return rb["step_losses"], [(e["train_loss"], e["val_loss"],
                                        e["ppl"]) for e in rb["epochs"]]

        if any(metrics(rb) != metrics(b[0]) for rb in b[1:]):
            raise AssertionError("the ranks' metrics differ: "
                                 f"{[metrics(rb) for rb in b]}")
        losses, hist = b[0]["step_losses"], b[0]["loss_history"]
        if not (all(np.isfinite(losses)) and hist[-1] < losses[0]):
            raise AssertionError(f"FSDP loss did not fall: steps {losses}")
        step_ms = float(np.median(b[0]["step_s"][1:])) * 1e3
        out.update(ranks=ranks, ranks_wall_s=ranks_s, step_ms=step_ms,
                   tokens_per_s=b[0]["epochs"][-1]["tokens_per_s"])
        coll = ranks[0]["collectives"]
        print(f"fsdp (b): GPT-2 medium ({FSDP_LAYERS} of its 24 layers) "
              f"over {out['mode']}, "
              f"{FSDP_EPOCHS} x {FSDP_STEPS_PER_EPOCH} steps of 8 x 1024, "
              f"full remat, f32, flash, AdamW: step losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; step {step_ms:.1f} "
              f"ms (median after the cold step), {out['tokens_per_s']} "
              f"tokens/s; per rank: parameters and moments "
              f"{b[0]['share'][0]:.3f}/{b[0]['share'][1]:.3f} of the "
              f"state's, peak memory "
              f"{[round(rb['peak_memory_bytes'] / 2**30, 2) for rb in b]} "
              f"GiB, launches {b[0]['launches']}; collectives alone at the "
              f"step's volume ({coll['bytes'] / 1e9:.2f} GB): all-gather "
              f"{coll['all_gather_ms']:.0f} ms, reduce-scatter "
              f"{coll['reduce_scatter_ms']:.0f} ms [{smi}]")
        for r, rb in enumerate(b):
            print(f"fsdp (b) rank {r}: {_io_line('saves', rb['saves'])}")
        # (c) the checkpoint, the resumes.
        ckpt = os.path.join(work, "ckpt")
        step_dir = os.path.join(ckpt, f"step_{FSDP_STEPS_PER_EPOCH}")
        bad = _rule_layout(step_dir)
        checked, corrupt = raw.verify_dir(os.path.join(step_dir, "state"))
        if bad or corrupt or not checked:
            raise AssertionError(f"epoch-1 checkpoint: leaves off the rule "
                                 f"{bad[:5]}, corrupt shards {corrupt[:5]}")
        for r, rank in enumerate(ranks):
            c = rank["c"]
            want_c = _fsdp_want(cfg, FSDP_STEPS_PER_EPOCH, 1)
            if c["launches"] != want_c:
                raise AssertionError(f"rank {r} resume launched "
                                     f"{c['launches']}, want {want_c}")
            if c["step_losses"] != losses[FSDP_STEPS_PER_EPOCH:]:
                raise AssertionError(f"rank {r} K=2 resume losses "
                                     f"{c['step_losses']}")
            print(f"fsdp (c) rank {r}: "
                  f"{_io_line('restores', c['restores'])}")
        last = f"step_{FSDP_STEPS}"
        if _shards(os.path.join(work, "resume2", last)) != _shards(
                os.path.join(ckpt, last)):
            raise AssertionError("the K=2 resume's last step differs")
        resume1 = os.path.join(work, "resume1")
        shutil.copytree(ckpt, resume1, ignore=shutil.ignore_patterns(
            ".recycle*", last))
        one = dict(data_axis=1, fsdp_axis=1)
        state = init_state(_fsdp_cfg(**one), device="cuda",
                           materialize=False)
        mgr = CheckpointManager(resume1)
        mc = cfg.model_config()
        tmpl = checkpoint_tree(state, scan_layers=mc.scan_layers,
                               abstract=True)
        load_checkpoint_tree(state, mgr.restore(abstract_state=tmpl))
        mgr.close()
        full = raw.flatten(raw.restore_raw(os.path.join(step_dir, "state")))
        got = raw.flatten(checkpoint_tree(state, scan_layers=mc.scan_layers))
        if [p for p, _ in got] != [p for p, _ in full]:
            raise AssertionError("K'=1 restore: the leaves differ")
        for (path, a), (_, t) in zip(got, full):
            if not torch.equal(a.detach().cpu(), t):
                raise AssertionError(f"K'=1 restore: {'/'.join(path)}")
        n_leaves = len(full)
        del state, full, got
        torch.cuda.empty_cache()
        _zero_counters(fa, im)
        res1 = train_gpt(_fsdp_cfg(**one), ckpt_dir=resume1,
                         log=lambda m: print(f"  {m}"))
        torch.cuda.synchronize()
        k1 = res1.step_losses
        rel = max(abs(a - b_) / abs(b_) for a, b_ in
                  zip(k1, losses[FSDP_STEPS_PER_EPOCH:]))
        if len(k1) != FSDP_STEPS_PER_EPOCH or not rel <= FSDP_RESUME_RTOL:
            raise AssertionError(f"K'=1 resume losses {k1} against "
                                 f"{losses[FSDP_STEPS_PER_EPOCH:]}")
        out["resume1"] = dict(step_losses=k1, max_rel=rel, leaves=n_leaves,
                              restores=res1.checkpoint_io["restores"],
                              launches=_counters(fa, im))
        print(f"fsdp (c): epoch-1 checkpoint on the rule at world "
              f"{FSDP_WORLD}, {checked} shard crc32s checked; K=2 in-run "
              f"resume bit for bit; K'=1: {n_leaves} leaves bit-equal, "
              f"epoch-2 losses {', '.join(f'{x:.6f}' for x in k1)} (worst "
              f"{rel:.2e} relative); "
              f"{_io_line('restores', res1.checkpoint_io['restores'])} "
              f"[{smi}]")
        # (d) one device against the sharded first step.
        out["parity"] = p = _one_device_parity(
            torch, cfg, os.path.join(work, "fsdp_grads.pt"),
            ranks[0]["d_loss"], "FSDP")
        print(f"fsdp (d): first step against one device: loss "
              f"{p['loss_err']:.2e} apart, every gradient within "
              f"{p['grad_rel']:.2e} of its max |g| [{smi}]")
        torch.cuda.empty_cache()
        # (e) the flows.
        home = os.path.join(work, "home")
        run = Run(gpt_flow.main(["run", *FLOW_FSDP_ARGS, "--home", home]))
        meta = run.data.result_checkpoint.metadata
        if meta.get("process_count") != FSDP_WORLD or not all(
                np.isfinite(run.data.loss_history)):
            raise AssertionError(f"TorchGptTrain gang: {meta}, "
                                 f"{run.data.loss_history}")
        # Each member stamped its heartbeat at every step's fence.
        (head,) = [r["head_task"] for r in run.meta["steps"]
                   if r["step"] == "train"]
        tdir = store.task_dir("TorchGptTrain", run.run_id, "train", head)
        beats = []
        for i in range(FSDP_WORLD):
            with open(os.path.join(tdir, f"heartbeat_{i}")) as fh:
                beats.append(int(fh.read()))
        if beats != [meta["step"]] * FSDP_WORLD:
            raise AssertionError(f"TorchGptTrain gang heartbeats {beats}, "
                                 f"want the last step {meta['step']} each")
        _zero_counters(fa, im)
        ge = Run(gpt_eval_flow.main(
            ["run", "--triggered", "--sample-tokens",
             str(FLOW_SAMPLE_TOKENS), "--attn-impl", "flash",
             "--beam-size", str(BEAM_K), "--home", home]))
        eval_n = _counters(fa, im)
        mc2 = run.data.model_config
        from tpuflow_torch.data.lm import lm_test_loader

        n_val = len(lm_test_loader(8, run.data.synthetic_size_used,
                                   run.data.seq_len_used, mc2["vocab_size"]))
        want_e = _launches(flash_fwd=mc2["n_layer"] * (n_val + 4))
        if ge.meta.get("triggered_by") != run.pathspec or eval_n != want_e:
            raise AssertionError(f"TorchGptEval from the gang: launched "
                                 f"{eval_n}, want {want_e}; triggered by "
                                 f"{ge.meta.get('triggered_by')}")
        out["flows"] = dict(train=run.pathspec, loss_history=
                            run.data.loss_history, eval_launches=eval_n,
                            test_loss=ge.data.test_loss, heartbeats=beats)
        print(f"fsdp (e): TorchGptTrain {' '.join(FLOW_FSDP_ARGS)}: loss "
              f"history {run.data.loss_history}, checkpoint of "
              f"{meta['process_count']} processes, the members' heartbeats "
              f"at step {beats}; TorchGptEval at one "
              f"process: test loss {ge.data.test_loss:.4f}, launches "
              f"{eval_n} [{smi}]")
        store.set_home(None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.monotonic() - t_phase
    print(f"phase 12 wall {out['wall_s']:.1f} s [{smi}]")
    return out


def _tp_cfg(leg: str, **kw):
    """Phase 13's ``train_gpt`` call of leg ``leg``: GPT-2 124M at full
    width, TP_LAYERS of its 12 layers, 8 x 1024 tokens a step, f32,
    flash, full remat, TP_EPOCHS epochs of TP_STEPS_PER_EPOCH steps, on
    the leg's mesh."""
    from tpuflow_torch.train.gpt import GptTrainConfig

    return _depth_cut(GptTrainConfig(**{
        "preset": "gpt2", "seq_len": 1024, "batch_size": 8,
        "epochs": TP_EPOCHS, "steps_per_epoch": TP_STEPS_PER_EPOCH,
        "attn_impl": "flash", **TP_LEGS[leg], **kw}), TP_LAYERS)


def _tp_axes(cfg) -> dict:
    return {"data": cfg.data_axis, "fsdp": cfg.fsdp_axis,
            "tensor": cfg.tensor_axis, "expert": cfg.expert_axis}


def _tp_collective_ms(torch, group, calls: int) -> dict:
    """``calls`` gloo all-reduces of one rank's (4, 1024, 768) f32
    activations on ``group``, on the card, timed alone: one step's
    tensor- or expert-parallel volume."""
    import torch.distributed as tdist

    x = torch.ones(4 * 1024 * 768, device="cuda")
    times = []
    for _ in range(TP_COLLECTIVE_REPS):
        tdist.barrier()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(calls):
            tdist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    nbytes = calls * x.numel() * 4
    ms = float(np.median(times))
    return dict(all_reduce_ms=ms, calls=calls, bytes=nbytes,
                gbps=nbytes / ms / 1e6)


def tp_rank(torch, rank: int, port: int, root: str) -> None:
    """One rank of phase 13 (``--tp-rank``): both legs in one process
    group, each into ``root/<leg>`` (``_tp_rank_leg``), and between them
    leg (a)'s epoch-1 step restored and saved again as DCP at the same
    mesh into ``root/a/dcp`` (``_tp_resave``); then ranks 0 and 1 form a
    world of two (a file rendezvous under ``root``) and restore that step
    at fsdp 2 into ``root/a/two``."""
    import faulthandler

    from tpuflow_torch import dist

    faulthandler.enable()
    dist.initialize("cuda", rank=rank, world_size=TP_WORLD,
                    init_method=f"tcp://localhost:{port}",
                    backend=FSDP_BACKEND, device_index=TP_CARD)
    _await_go(os.path.join(root, "go"))
    for leg in ("a", "b"):
        work = os.path.join(root, leg)
        _tp_rank_leg(torch, leg, rank, work)
        if leg == "a":
            _tp_resave(torch, leg, TP_WORLD, rank, os.path.join(
                work, "ckpt", f"step_{TP_STEPS_PER_EPOCH}"),
                os.path.join(work, "dcp"), "dcp")
        torch.cuda.empty_cache()
    dist.barrier()
    dist.shutdown()
    if rank < 2:
        dist.initialize("cuda", rank=rank, world_size=2,
                        init_method=f"file://{os.path.join(root, 'two')}",
                        backend=FSDP_BACKEND, device_index=TP_CARD)
        _tp_resave(torch, "a", 2, rank, os.path.join(
            root, "a", "ckpt", f"step_{TP_STEPS_PER_EPOCH}"),
            os.path.join(root, "a", "two"), "raw")
        dist.barrier()
        dist.shutdown()


def _tp_rank_leg(torch, leg: str, rank: int, work: str) -> None:
    """Leg ``leg`` of a phase 13 rank: the training leg with a checkpoint
    each epoch; the all-reduces of a step alone; the in-run resume at the
    same mesh from the directory without its last step; the first step's
    gradients, sharded. Its records go to ``work/rank<r>.json``."""
    from tpuflow_torch import dist
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.parallel import has_sharded_leaf
    from tpuflow_torch.train import gpt as gpt_mod

    dev = f"cuda:{TP_CARD}"
    cfg = _tp_cfg(leg)
    log = (lambda m: print(f"  {m}", flush=True)) if rank == 0 else (
        lambda m: None)
    states = []
    real_init = gpt_mod.init_state

    def keep(*a, **kw):
        states.append(real_init(*a, **kw))
        return states[-1]

    gpt_mod.init_state = keep
    ckpt = os.path.join(work, "ckpt")
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(fa, im)
    t0 = time.monotonic()
    res = gpt_mod.train_gpt(cfg, ckpt_dir=ckpt, log=log, device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _counters(fa, im)
    state = states[-1]
    plan, mesh = state.plan, state.mesh
    both = [i for i, n in enumerate(plan.names)
            if plan.dims[n] is not None and plan.split[n]]
    size = lambda shape: int(np.prod(shape))  # noqa: E731
    tx = state.tx
    opt = [t for ts in (*tx.slots().values(), *tx.leaf_slots().values())
           for t in ts]
    out = {"train": dict(
        launches=launches, step_losses=res.step_losses,
        loss_history=res.loss_history, epochs=res.metrics_history,
        step_s=res.step_s, wall_s=wall, saves=res.checkpoint_io["saves"],
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        sharded=has_sharded_leaf(plan, axis=TP_AXIS[leg]),
        split_share=(sum(state.params[i].numel() for i in both)
                     / sum(size(plan.shapes[plan.names[i]]) for i in both)),
        param_share=(sum(p.numel() for p in state.params)
                     / sum(size(s) for s in plan.shapes.values())),
        opt_bytes=sum(t.numel() * t.element_size() for t in opt),
        param_bytes=sum(size(s) * 4 for s in plan.shapes.values()))}
    if leg == "b":
        # The summed load-balance loss of the first batch's forward on the
        # trained state (the aux of the FSDP group's whole batch).
        from tpuflow_torch.data.lm import make_lm_loaders

        loader, _ = make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                    cfg.seq_len,
                                    cfg.model_config().vocab_size)
        loader.set_epoch(0)
        x = dist.shard_batch(next(iter(loader)), mesh)["x"]
        with torch.no_grad():
            _, aux = state.model(x, train=True, rng=1, losses=True)
        state.model.reshard()
        out["train"]["aux"] = float(sum(a.float() for a in aux))
    group = mesh.tensor_group if leg == "a" else mesh.expert_group
    del state, states[:], tx, opt
    torch.cuda.empty_cache()
    out["collectives"] = _tp_collective_ms(torch, group, TP_ALL_REDUCES[leg])
    # The in-run resume: the directory without its last step.
    resume = os.path.join(work, "resume")
    if rank == 0:
        shutil.copytree(ckpt, resume, ignore=shutil.ignore_patterns(
            ".recycle*", f"step_{TP_STEPS}"))
    dist.barrier()
    _zero_counters(fa, im)
    res2 = gpt_mod.train_gpt(cfg, ckpt_dir=resume, log=log, device=dev)
    torch.cuda.synchronize()
    out["resume"] = dict(launches=_counters(fa, im),
                         step_losses=res2.step_losses,
                         restores=res2.checkpoint_io["restores"])
    states.clear()
    gpt_mod.init_state = real_init
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    loss, grads = _first_grads(torch, cfg, dist.make_mesh(dev,
                                                          _tp_axes(cfg)))
    out["d_loss"] = loss
    if rank == 0:
        torch.save(grads, os.path.join(work, "tp_grads.pt"))
    del grads
    out["d_s"] = time.monotonic() - t0
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh, default=float)
    dist.barrier()


def _tp_resave(torch, leg: str, world: int, rank: int, src: str, dst: str,
               fmt: str) -> None:
    """Restore phase 13's step directory ``src`` (either format) at
    ``world`` ranks (fsdp ``world``; leg (a)'s mesh at 4) and save it
    again as step 1 in ``fmt`` into ``dst``; this rank's save and restore
    records to ``dst/rank<r>.json``."""
    from tpuflow_torch import dist
    from tpuflow_torch.ckpt import CheckpointManager, dcp, raw
    from tpuflow_torch.ckpt.tree import checkpoint_tree, load_checkpoint_tree
    from tpuflow_torch.train.gpt import init_state

    dev = f"cuda:{TP_CARD}"
    cfg = _tp_cfg(leg) if world == TP_WORLD else _tp_cfg(
        leg, data_axis=1, fsdp_axis=world, tensor_axis=1, expert_axis=1)
    mc = cfg.model_config()
    mesh = dist.make_mesh(dev, _tp_axes(cfg))
    state = init_state(cfg, mc, dev, materialize=False, mesh=mesh)
    tmpl = checkpoint_tree(state, scan_layers=mc.scan_layers, abstract=True)
    state_dir = os.path.join(src, "state")
    t0 = time.monotonic()
    if dcp.is_dcp(state_dir):
        tree, nbytes = dcp.load(state_dir, tmpl)
    else:
        stats = {}
        tree = raw.restore_raw(state_dir, tmpl, stats=stats)
        nbytes = stats["bytes"]
    restore_s = time.monotonic() - t0
    load_checkpoint_tree(state, tree)
    del tree
    mgr = CheckpointManager(dst, max_to_keep=None, multi_process=True,
                            format=fmt)
    mgr.save(1, checkpoint_tree(state, scan_layers=mc.scan_layers))
    mgr.wait_until_finished()
    saves = list(mgr.saves)
    mgr.close()
    with open(os.path.join(dst, f"rank{rank}.json"), "w") as fh:
        json.dump(dict(saves=saves, restore=dict(
            bytes=nbytes, seconds=restore_s,
            gbps=nbytes / restore_s / 1e9)), fh, default=float)


# Processes started ahead of their phase (a phase's ranks while the one
# before it checks its results), stopped at exit if a phase fails first.
_AHEAD: list = []
GO_TIMEOUT_S = 1200.0


def _stop_ahead() -> None:
    for p in _AHEAD:
        if p.poll() is None:
            p.kill()
            p.wait()


def _ahead(proc):
    """Register ``proc``, started ahead of its phase, for ``_stop_ahead``."""
    if not _AHEAD:
        import atexit

        atexit.register(_stop_ahead)
    _AHEAD.append(proc)
    return proc


def _start_ranks(args: list, world: int) -> list:
    """Start ``world`` processes of this script with ``args`` (``{rank}``
    and ``{port}`` filled in). Each joins its world, then waits for its
    work directory's ``go`` file (``_await_go``): their start (imports,
    context, rendezvous) can overlap the work before their phase."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    return [_ahead(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         *(a.format(rank=r, port=port) for a in args)]))
        for r in range(world)]


def _finish_ranks(procs: list, go: str, what: str) -> float:
    """Tell the ranks ``procs`` to go (the file ``go``) and wait for their
    end; raises when one fails. Returns the seconds from the go."""
    open(go, "w").close()
    t0 = time.monotonic()
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError(f"{what}: ranks exited {rcs}")
    return time.monotonic() - t0


def _await_go(go: str) -> None:
    """A rank's wait for its parent's ``go`` file."""
    deadline = time.monotonic() + GO_TIMEOUT_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise AssertionError(f"no {go} within {GO_TIMEOUT_S:.0f} s")
        time.sleep(0.02)


def _tp_rule_layout(step_dir: str, axes: dict) -> list:
    """The leaves of a checkpoint whose shards are not the regions the JAX
    rule (``gpt2_tensor_rules`` on ``axes``; the pipeline rule on a
    ``stage`` mesh) gives the mesh's processes."""
    from tpuflow_torch.dist.mesh import axis_order
    from tpuflow_torch.parallel import gpt2_tensor_rules, leaf_spec
    from tpuflow_torch.parallel.sharding import region

    shape = {a: axes.get(a, 1) for a in axis_order(axes)}
    world = int(np.prod(list(shape.values())))
    with open(os.path.join(step_dir, "state", "manifest.json")) as fh:
        manifest = json.load(fh)
    bad = []
    for e in manifest["leaves"]:
        spec = leaf_spec(e["path"], e["shape"], shape, gpt2_tensor_rules)
        want = set()
        for r in range(world):
            c = dict(zip(shape, (int(i) for i in np.unravel_index(
                r, list(shape.values())))))
            start, extent = region(spec, e["shape"], c,
                                   c["data"] * shape["fsdp"] + c["fsdp"],
                                   shape)
            want.add((tuple(start), tuple(extent)))
        got = {(tuple(s["start"]), tuple(s["shape"])) for s in e["shards"]}
        if got != want:
            bad.append("/".join(e["path"]))
    return bad


def _equal_leaves(torch, got_tree, want_tree, what: str) -> int:
    """Every leaf of ``got_tree`` bit-equal to ``want_tree``'s, the same
    paths (by path: a restored tree's dicts flatten sorted, a state's
    optimizer fields in optax's order); returns the count."""
    from tpuflow_torch.ckpt import raw

    got = {"/".join(p): t for p, t in raw.flatten(got_tree)}
    want = {"/".join(p): t for p, t in raw.flatten(want_tree)}
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: the leaves differ")
    for path, a in got.items():
        if not torch.equal(a.detach().cpu(), want[path].detach().cpu()):
            raise AssertionError(f"{what}: {path}")
    return len(got)


def _restore_one(torch, leg: str, step_dir: str):
    """The state of ``step_dir`` restored at one process on the card, as
    the JAX checkpoint tree of its tensors."""
    from tpuflow_torch.ckpt import Checkpoint, restore_from_handle
    from tpuflow_torch.ckpt.tree import checkpoint_tree, load_checkpoint_tree
    from tpuflow_torch.train.gpt import init_state

    cfg = _tp_cfg(leg, data_axis=1, fsdp_axis=1, tensor_axis=1,
                  expert_axis=1)
    mc = cfg.model_config()
    state = init_state(cfg, mc, "cuda", materialize=False)
    tmpl = checkpoint_tree(state, scan_layers=mc.scan_layers, abstract=True)
    load_checkpoint_tree(state, restore_from_handle(
        Checkpoint.from_directory(step_dir), abstract_state=tmpl))
    return checkpoint_tree(state, scan_layers=mc.scan_layers)


def tp_kernel_rows(torch, timer) -> dict:
    """Phase 13's flash kernels at each leg's attention shape a rank, f32
    (the legs' dtype), against their plain versions, with their times."""
    shapes = tuple(TP_SHAPES.values())
    return dict(kernels_fwd=flash_phase(torch, timer, shapes,
                                        dtypes=("float32",)),
                kernels_bwd=flash_bwd_phase(torch, timer, shapes,
                                            dtypes=("float32",)))


def _tp_start() -> tuple:
    """Phase 13's work directory and its ranks, started (they wait for
    the go)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_",
                            dir=os.path.join(REPO, "build"))
    for leg in ("a", "b"):
        os.makedirs(os.path.join(root, leg))
    return root, _start_ranks(["--tp-rank", "{rank}", "{port}", root],
                              TP_WORLD)


def tp_phase(torch, smi, kernel_rows: dict | None = None,
             started: tuple | None = None, ranks_done=None) -> dict:
    """Phase 13: GPT-2 124M at full depth and width on the tensor and
    expert axes, TP_WORLD ranks on card TP_CARD over gloo, each a process
    of its own that runs both legs in turn (one process group). (a) data 1
    x fsdp 2 x tensor 2, AdamW; (b) data 1 x fsdp 2 x expert 2, Switch MoE
    with MOE_EXPERTS experts, Adafactor. Each leg:
    learning; each rank's flash launches exact at its attention shape; the
    ranks' metrics bit-equal; the state sharded on the leg's axis (a: each
    rank 1/4 of every leaf split over tensor and fsdp); the epoch-1
    checkpoint on the rule's regions with every crc32 checked; the in-run
    resume at the mesh bit for bit; a restore at one process, every leaf
    bit-equal; the first step on one device within the step-parity
    limits. (a) also: a restore at fsdp 2 (two ranks), every leaf
    bit-equal; the step saved as DCP at the mesh and restored at one
    process bit-equal to the raw restore. (b) also: the MoE's summed load-balance
    loss finite, > 0 and bit-equal across ranks; the Adafactor state's
    bytes a rank. Each leg's step ms, tokens/s, peak memory a rank, save
    and restore GB/s a rank and its all-reduces timed alone. ``started``:
    ``_tp_start()``'s, when the ranks were started ahead; ``ranks_done``
    is called once they have ended."""
    t_phase = time.monotonic()
    out = {"mode": f"{TP_WORLD} ranks on cuda:{TP_CARD} over "
                   f"{FSDP_BACKEND}", "gpu": smi}
    if kernel_rows is None:
        kernel_rows = tp_kernel_rows(torch, Timer(torch))
        torch.cuda.empty_cache()
    out.update(kernel_rows)
    root, procs = started or _tp_start()
    try:
        out["ranks_wall_s"] = _finish_ranks(
            procs, os.path.join(root, "go"), "phase 13")
        if ranks_done is not None:
            ranks_done()
        for leg in ("a", "b"):
            out[leg] = _tp_leg(torch, smi, leg, _tp_cfg(leg),
                               os.path.join(root, leg))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.monotonic() - t_phase
    print(f"phase 13 wall {out['wall_s']:.1f} s [{smi}]")
    return out


def _tp_leg(torch, smi, leg: str, cfg, work: str) -> dict:
    """Phase 13's leg ``leg`` and its checks (see ``tp_phase``)."""
    from tpuflow_torch.ckpt import raw

    axes = _tp_axes(cfg)
    desc = " x ".join(f"{k} {v}" for k, v in axes.items())
    ranks = []
    for r in range(TP_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    tr = [r["train"] for r in ranks]
    want = _fsdp_want(cfg, TP_STEPS, TP_EPOCHS)
    for r, t in enumerate(tr):
        if t["launches"] != want:
            raise AssertionError(f"tp ({leg}) rank {r} launched "
                                 f"{t['launches']}, want {want}")
        if not t["sharded"] or (leg == "a" and t["split_share"] != 0.25):
            raise AssertionError(f"tp ({leg}) rank {r}: sharded "
                                 f"{t['sharded']}, {t['split_share']} of "
                                 "the tensor- and fsdp-split leaves")

    def metrics(t):
        return t["step_losses"], [(e["train_loss"], e["val_loss"], e["ppl"])
                                  for e in t["epochs"]], t.get("aux")

    if any(metrics(t) != metrics(tr[0]) for t in tr[1:]):
        raise AssertionError(f"tp ({leg}): the ranks' metrics differ: "
                             f"{[metrics(t) for t in tr]}")
    losses, hist = tr[0]["step_losses"], tr[0]["loss_history"]
    if not (all(np.isfinite(losses)) and hist[-1] < losses[0]):
        raise AssertionError(f"tp ({leg}): the loss did not fall: {losses}")
    if leg == "b" and not (np.isfinite(tr[0]["aux"]) and tr[0]["aux"] > 0):
        raise AssertionError(f"tp (b): load-balance loss {tr[0]['aux']}")
    step_ms = float(np.median(tr[0]["step_s"][1:])) * 1e3
    rec = dict(ranks=ranks, step_ms=step_ms,
               tokens_per_s=cfg.batch_size * cfg.seq_len / step_ms * 1e3)
    coll = ranks[0]["collectives"]
    print(f"tp ({leg}): GPT-2 124M ({TP_LAYERS} of its 12 layers) on "
          f"{desc} ({TP_WORLD} ranks on "
          f"cuda:{TP_CARD} over {FSDP_BACKEND}), {cfg.optimizer_name}"
          f"{', %d experts' % cfg.experts if cfg.experts else ''}, "
          f"{TP_EPOCHS} x {TP_STEPS_PER_EPOCH} steps of 8 x 1024, f32, "
          f"flash, full remat: step losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}"
          + (f", summed aux {tr[0]['aux']:.6f}" if leg == "b" else "")
          + f"; step {step_ms:.1f} ms (median after the cold step), "
          f"{rec['tokens_per_s']:.0f} tokens/s; per rank: parameters "
          f"{tr[0]['param_share']:.4f} of the model's, split leaves "
          f"{tr[0]['split_share']:.4f}, optimizer state "
          f"{tr[0]['opt_bytes'] / 2**20:.1f} MiB, peak memory "
          f"{[round(t['peak_memory_bytes'] / 2**30, 2) for t in tr]} GiB, "
          f"launches {tr[0]['launches']}; {coll['calls']} all-reduces of "
          f"a step alone ({coll['bytes'] / 1e9:.3f} GB): "
          f"{coll['all_reduce_ms']:.0f} ms, {coll['gbps']:.2f} GB/s "
          f"[{smi}]")
    for r, t in enumerate(tr):
        print(f"tp ({leg}) rank {r}: {_io_line('saves', t['saves'])}")
    # The epoch-1 checkpoint: the rule's regions, every crc32.
    ckpt = os.path.join(work, "ckpt")
    step_dir = os.path.join(ckpt, f"step_{TP_STEPS_PER_EPOCH}")
    bad = _tp_rule_layout(step_dir, axes)
    checked, corrupt = raw.verify_dir(os.path.join(step_dir, "state"))
    if bad or corrupt or not checked:
        raise AssertionError(f"tp ({leg}) epoch-1 checkpoint: leaves off "
                             f"the rule {bad[:5]}, corrupt {corrupt[:5]}")
    # The in-run resume at the mesh.
    want_r = _fsdp_want(cfg, TP_STEPS_PER_EPOCH, 1)
    for r, rank in enumerate(ranks):
        res = rank["resume"]
        if res["launches"] != want_r:
            raise AssertionError(f"tp ({leg}) rank {r} resume launched "
                                 f"{res['launches']}, want {want_r}")
        if res["step_losses"] != losses[TP_STEPS_PER_EPOCH:]:
            raise AssertionError(f"tp ({leg}) rank {r} resume losses "
                                 f"{res['step_losses']}")
    last = f"step_{TP_STEPS}"
    if _shards(os.path.join(work, "resume", last)) != _shards(
            os.path.join(ckpt, last)):
        raise AssertionError(f"tp ({leg}): the resume's last step differs")
    for r, rank in enumerate(ranks):
        print(f"tp ({leg}) rank {r}: "
              f"{_io_line('restores', rank['resume']['restores'])}")
    # One process, every leaf.
    whole = raw.restore_raw(os.path.join(step_dir, "state"))
    t0 = time.monotonic()
    n = _equal_leaves(torch, _restore_one(torch, leg, step_dir), whole,
                      f"tp ({leg}) restore at one process")
    rec["restore_one_s"] = time.monotonic() - t0
    print(f"tp ({leg}): epoch-1 checkpoint on the rule's regions of "
          f"{desc}, {checked} shard crc32s checked; in-run resume at "
          f"{TP_WORLD} ranks bit for bit (losses, the last step's "
          f"crc32s); at one process {n} leaves bit-equal [{smi}]")
    if leg == "a":
        # Two ranks at fsdp 2, every leaf; the step as DCP at the mesh,
        # restored at one process, against the raw restore (both ran in
        # the ranks' processes, after leg (a)).
        two = os.path.join(work, "two")
        n2 = _equal_leaves(torch, raw.restore_raw(os.path.join(
            two, "step_1", "state")), whole, "tp (a) restore at fsdp 2")
        rec["restore_two"] = [json.load(open(os.path.join(
            two, f"rank{r}.json"))) for r in range(2)]
        dcp_dir = os.path.join(work, "dcp")
        rec["dcp"] = [json.load(open(os.path.join(
            dcp_dir, f"rank{r}.json"))) for r in range(TP_WORLD)]
        n3 = _equal_leaves(torch, _restore_one(torch, leg, os.path.join(
            dcp_dir, "step_1")), whole, "tp (a) DCP restore at one process")
        print(f"tp (a): restored at fsdp 2 (two ranks), {n2} leaves "
              f"bit-equal ({_io_line('restore', [dict(step=1, **rec['restore_two'][0]['restore'])])}"
              f"); saved as DCP by {TP_WORLD} ranks "
              f"({_io_line('save', rec['dcp'][0]['saves'])} a rank) and "
              f"restored at one process: {n3} leaves bit-equal to the raw "
              f"restore [{smi}]")
    del whole
    # One device against the sharded first step (the loss with the MoE's
    # load-balance losses; the gradients reduced by the train step's own
    # ``sharded_gradients``).
    rec["parity"] = p = _one_device_parity(
        torch, cfg, os.path.join(work, "tp_grads.pt"), ranks[0]["d_loss"],
        f"tp ({leg})")
    print(f"tp ({leg}): first step against one device: loss "
          f"{p['loss_err']:.2e} apart, every gradient within "
          f"{p['grad_rel']:.2e} of its max |g| (the check {p['seconds']:.1f}"
          f" s here, {ranks[0]['d_s']:.1f} s in the ranks) [{smi}]")
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------- phase 14
def _sp_cfg(leg: str, **kw):
    """Phase 14's ``train_gpt`` call of leg ``leg``: GPT-2 124M at full
    width, SP_LAYERS of its layers, 8 x 1024 tokens a step, f32,
    SP_EPOCHS epochs of SP_STEPS_PER_EPOCH steps, on the leg's mesh."""
    from tpuflow_torch.train.gpt import GptTrainConfig

    return _depth_cut(GptTrainConfig(**{
        "preset": "gpt2", "seq_len": 1024, "batch_size": 8,
        "epochs": SP_EPOCHS, "steps_per_epoch": SP_STEPS_PER_EPOCH,
        **SP_LEGS[leg], **kw}), SP_LAYERS)


def _sp_init(torch, rank: int, port: int) -> str:
    """Join phase 14's world of SP_WORLD ranks on card SP_CARD over gloo;
    returns the device."""
    from tpuflow_torch import dist

    dist.initialize("cuda", rank=rank, world_size=SP_WORLD,
                    init_method=f"tcp://localhost:{port}",
                    backend=FSDP_BACKEND, device_index=SP_CARD)
    return f"cuda:{SP_CARD}"


def _sp_train(torch, gpt_mod, cfg, ckpt: str, dev: str, log) -> dict:
    """One training run of ``cfg`` with a checkpoint each epoch into
    ``ckpt``, its launches read from zero; the state it trained is
    ``_sp_train.state``."""
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im

    states = []
    real_init = gpt_mod.init_state

    def keep(*a, **kw):
        states.append(real_init(*a, **kw))
        return states[-1]

    gpt_mod.init_state = keep
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_counters(fa, im)
        t0 = time.monotonic()
        res = gpt_mod.train_gpt(cfg, ckpt_dir=ckpt, log=log, device=dev)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        gpt_mod.init_state = real_init
    _sp_train.state = states[-1]
    return dict(launches=_counters(fa, im), step_losses=res.step_losses,
                loss_history=res.loss_history, epochs=res.metrics_history,
                step_s=res.step_s, wall_s=wall,
                saves=res.checkpoint_io["saves"],
                restores=res.checkpoint_io["restores"],
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def _sp_resume(torch, gpt_mod, cfg, ckpt: str, work: str, dev: str,
               log) -> dict:
    """The in-run resume: ``ckpt`` copied without its last step, trained
    again to the end."""
    from tpuflow_torch import dist

    resume = os.path.join(work, os.path.basename(ckpt) + "_resume")
    if dist.process_index() == 0:
        shutil.copytree(ckpt, resume, ignore=shutil.ignore_patterns(
            ".recycle*", f"step_{SP_STEPS}"))
    dist.barrier()
    out = _sp_train(torch, gpt_mod, cfg, resume, dev, log)
    del _sp_train.state
    return out


def _shift_gbps(torch, seq) -> dict:
    """The ring's shift alone: ``p2p.ppermute`` of one layer's stacked key
    and value blocks, (2, 8, 512, 12, 64) f32, to the right neighbour on
    the card, SHIFT_REPS times (the first to warm up); received bits equal
    to the sender's."""
    import torch.distributed as tdist

    from tpuflow_torch.parallel.p2p import ppermute, ring_perm

    g = torch.Generator(device="cuda").manual_seed(seq.rank)
    x = torch.randn((2, 8, 512, 12, 64), generator=g, device="cuda")
    want = torch.randn((2, 8, 512, 12, 64), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(
                           (seq.rank - 1) % seq.size))
    times = []
    for _ in range(SHIFT_REPS):
        tdist.barrier()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        y = ppermute(x, seq, ring_perm(seq.size))
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    ms = float(np.median(times[1:]))
    nbytes = x.numel() * 4
    return dict(ms=ms, bytes=nbytes, gbps=nbytes / ms / 1e6,
                equal=bool(torch.equal(y, want)))


def _ulysses_check(torch, seq) -> dict:
    """``ulysses_attention(inner_impl="flash")`` at ULYSSES_SHAPE, f32,
    causal, on this rank's block of seeded q, k, v (the same whole tensors
    on every rank), forward and backward; each rank's output and q, k, v
    gradients gathered and held on rank 0 against the plain flash version
    (``blockwise_attention`` under autograd) on the whole tensors. The
    flash launches of the call are returned."""
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.parallel.p2p import gather
    from tpuflow_torch.parallel.ulysses import ulysses_attention

    B, T, H, D = ULYSSES_SHAPE
    Tl = T // seq.size
    g = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, do = (torch.randn((B, T, H, D), generator=g, device="cuda")
                   for _ in range(4))
    blk = slice(seq.rank * Tl, (seq.rank + 1) * Tl)
    ql, kl, vl = (t[:, blk].clone().requires_grad_() for t in (q, k, v))
    _zero_counters(fa, im)
    out = ulysses_attention(ql, kl, vl, causal=True, seq=seq,
                            inner_impl="flash")
    out.backward(do[:, blk])
    torch.cuda.synchronize()
    launches = _counters(fa, im)
    got = [gather(t.detach(), seq.group, 1)
           for t in (out, ql.grad, kl.grad, vl.grad)]
    rec = dict(launches=launches)
    if seq.rank == 0:
        qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
        ref = fa.blockwise_attention(qp, kp, vp, causal=True)
        ref.backward(do)
        errs = {}
        for name, a, b, (atol, rtol) in zip(
                ("out", "dq", "dk", "dv"), got,
                (ref, qp.grad, kp.grad, vp.grad),
                (FLASH_TOL["float32"], *[BWD_TOL["float32"]] * 3)):
            errs[name] = _within(a, b.detach(), atol, rtol,
                                 f"ulysses (flash) {name}")[0]
        rec["max_abs_err"] = errs
    return rec


def sp_rank(torch, rank: int, port: int, work: str) -> None:
    """One rank of phase 14 (``--sp-rank``), its records to
    ``work/rank<r>.json``: leg (a) (data 1 x seq 2, ring) trained with a
    checkpoint each epoch, the ring's shift alone, the in-run resume, the
    first step's gradients on the seq mesh; leg (b)'s first step on the
    gathered flash path and the Ulysses check; then, in the same process
    group on the pipeline mesh, leg (c) (data 1 x stage 2) trained, its
    stage blocks' share and the in-run resume."""
    import faulthandler

    from tpuflow_torch import dist
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.parallel.p2p import AxisGroup
    from tpuflow_torch.train import gpt as gpt_mod

    faulthandler.enable()
    dev = _sp_init(torch, rank, port)
    _await_go(os.path.join(work, "go"))
    log = (lambda m: print(f"  {m}", flush=True)) if rank == 0 else (
        lambda m: None)
    out = {}
    cfg = _sp_cfg("a")
    ckpt = os.path.join(work, "ckpt_a")
    out["a"] = _sp_train(torch, gpt_mod, cfg, ckpt, dev, log)
    mesh = _sp_train.state.mesh
    del _sp_train.state
    torch.cuda.empty_cache()
    seq = AxisGroup.of(mesh, "seq")
    out["shift"] = _shift_gbps(torch, seq)
    out["a_resume"] = _sp_resume(torch, gpt_mod, cfg, ckpt, work, dev,
                                 log)
    torch.cuda.empty_cache()
    loss, grads = _first_grads(torch, cfg, mesh)
    out["a_d_loss"] = loss
    if rank == 0:
        torch.save(grads, os.path.join(work, "a_grads.pt"))
    del grads
    cfg_b = _sp_cfg("b")
    _zero_counters(fa, im)
    loss, grads = _first_grads(torch, cfg_b, mesh)
    out["b"] = dict(launches=_counters(fa, im), d_loss=loss)
    if rank == 0:
        torch.save(grads, os.path.join(work, "b_grads.pt"))
    del grads
    torch.cuda.empty_cache()
    out["ulysses"] = _ulysses_check(torch, seq)
    # The pipeline mesh, in the same process group.
    cfg = _sp_cfg("c")
    out["c"] = _sp_train(torch, gpt_mod, cfg,
                         os.path.join(work, "ckpt_c"), dev, log)
    plan = _sp_train.state.plan
    held = {"/".join(p): (len(_sp_train.state.model.h), plan.leaves[p][0])
            for p in plan.leaves if p[0] == "h"}
    out["c"]["block_share"] = sorted({n / shape[0]
                                      for n, shape in held.values()})
    out["c"]["stage_layers"] = len(_sp_train.state.model.h)
    del _sp_train.state, plan
    torch.cuda.empty_cache()
    out["c_resume"] = _sp_resume(torch, gpt_mod, cfg,
                                 os.path.join(work, "ckpt_c"), work,
                                 dev, log)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh, default=float)
    dist.barrier()
    dist.shutdown()


def sp_kernel_rows(torch, timer) -> dict:
    """Phase 14's flash kernels at its other attention shapes, f32 (the
    legs' dtype), against their plain versions, with their times: a rank's
    heads after Ulysses's all-to-all and a pipeline microbatch (the
    gathered path runs the training shape, measured in phase 3)."""
    shapes = tuple(SP_SHAPES.values())
    return dict(kernels_fwd=flash_phase(torch, timer, shapes,
                                        dtypes=("float32",)),
                kernels_bwd=flash_bwd_phase(torch, timer, shapes,
                                            dtypes=("float32",)))


def _restore_at_one(torch, cfg, step_dir: str, scan: bool = False):
    """The state of ``step_dir`` restored at one process on the card onto
    ``cfg``'s model (``scan``: in the scan-layers layout, which the
    ``gpt2`` preset has), as the JAX checkpoint tree of its tensors."""
    from tpuflow_torch.ckpt import Checkpoint, restore_from_handle
    from tpuflow_torch.ckpt.tree import checkpoint_tree, load_checkpoint_tree
    from tpuflow_torch.train.gpt import init_state

    mc = cfg.model_config()
    if scan:
        mc = dataclasses.replace(mc, scan_layers=True)
    state = init_state(cfg, mc, "cuda", materialize=False)
    tmpl = checkpoint_tree(state, scan_layers=mc.scan_layers, abstract=True)
    load_checkpoint_tree(state, restore_from_handle(
        Checkpoint.from_directory(step_dir), abstract_state=tmpl))
    return checkpoint_tree(state, scan_layers=mc.scan_layers)


def _one_device_loss(torch, cfg) -> float:
    """The first batch's mean cross-entropy of ``cfg``'s fresh model on one
    device, whole, dropout off (the pipeline's ``train=False`` blocks),
    TF32 off."""
    from tpuflow_torch.data.lm import make_lm_loaders
    from tpuflow_torch.device import f32_matmul_precision
    from tpuflow_torch.models.losses import cross_entropy_loss
    from tpuflow_torch.train.gpt import init_state

    mc = cfg.model_config()
    loader, _ = make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                cfg.seq_len, mc.vocab_size)
    loader.set_epoch(0)
    batch = next(iter(loader))
    state = init_state(cfg, mc, "cuda")
    x, y = (torch.as_tensor(batch[k], device="cuda") for k in ("x", "y"))
    with torch.no_grad(), f32_matmul_precision():
        loss = float(cross_entropy_loss(state.model(x, train=False), y))
    del state
    torch.cuda.empty_cache()
    return loss


def _sp_check_leg(leg: str, cfg, ranks: list, want: dict) -> None:
    """A training leg's common checks: each rank's launches exact, the
    ranks' losses bit-equal, the loss falling."""
    for r, t in enumerate(ranks):
        if t["launches"] != want:
            raise AssertionError(f"sp ({leg}) rank {r} launched "
                                 f"{t['launches']}, want {want}")
    losses = ranks[0]["step_losses"]
    if any(t["step_losses"] != losses or t["loss_history"]
           != ranks[0]["loss_history"] for t in ranks[1:]):
        raise AssertionError(f"sp ({leg}): the ranks' losses differ: "
                             f"{[t['step_losses'] for t in ranks]}")
    hist = ranks[0]["loss_history"]
    if not (all(np.isfinite(losses)) and hist[-1] < losses[0]):
        raise AssertionError(f"sp ({leg}): the loss did not fall: {losses}")


def _sp_resume_check(leg: str, work: str, ckpt: str, train: list,
                     resumes: list, want: dict) -> None:
    """The in-run resume: each rank's launches exact, its losses those of
    the run's last epoch bit for bit, the last step's crc32s equal."""
    for r, res in enumerate(resumes):
        if res["launches"] != want:
            raise AssertionError(f"sp ({leg}) rank {r} resume launched "
                                 f"{res['launches']}, want {want}")
        if res["step_losses"] != train[r]["step_losses"][SP_STEPS_PER_EPOCH:]:
            raise AssertionError(f"sp ({leg}) rank {r} resume losses "
                                 f"{res['step_losses']}")
    last = f"step_{SP_STEPS}"
    if _shards(os.path.join(work, os.path.basename(ckpt) + "_resume",
                            last)) != _shards(os.path.join(ckpt, last)):
        raise AssertionError(f"sp ({leg}): the resume's last step differs")


def _sp_line(leg: str, what: str, cfg, t: dict, smi: str) -> dict:
    step_ms = float(np.median(t["step_s"][1:])) * 1e3
    rec = dict(step_ms=step_ms,
               tokens_per_s=cfg.batch_size * cfg.seq_len / step_ms * 1e3)
    print(f"sp ({leg}): GPT-2 124M on {what} ({SP_WORLD} ranks on "
          f"cuda:{SP_CARD} over {FSDP_BACKEND}), {SP_EPOCHS} x "
          f"{SP_STEPS_PER_EPOCH} steps of 8 x 1024, f32: step losses "
          f"{', '.join(f'{x:.4f}' for x in t['step_losses'])}; step "
          f"{step_ms:.1f} ms (median after the cold step), "
          f"{rec['tokens_per_s']:.0f} tokens/s; flash launches a rank "
          f"{ {k: v for k, v in t['launches'].items() if v} }; peak memory "
          f"{t['peak_memory_bytes'] / 2**30:.2f} GiB [{smi}]")
    return rec


def _sp_start() -> tuple:
    """Phase 14's work directory and its ranks, started (they wait for
    the go)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_sp_",
                            dir=os.path.join(REPO, "build"))
    return work, _start_ranks(["--sp-rank", "{rank}", "{port}", work],
                              SP_WORLD)


def seq_pipeline_phase(torch, smi, kernel_rows: dict | None = None,
                       started: tuple | None = None,
                       ranks_done=None) -> dict:
    """Phase 14: sequence and pipeline parallelism on GPT-2 124M at full
    width and depth, SP_WORLD ranks sharing card SP_CARD over gloo, each a
    process of its own. (a) data 1 x seq 2, ring attention, AdamW, a
    checkpoint each epoch: learning; the ranks' losses bit-equal; no flash
    launch (the ring is plain products); the epoch-1 checkpoint on the
    rule's regions (every leaf whole, written once) with every crc32
    checked; the in-run resume bit for bit; a restore at one process every
    leaf bit-equal; the first step on one device within the step-parity
    limits; the ring's shift alone (GB/s, bits equal). (b) data 1 x seq 2,
    ``attn_impl="flash"`` (the gathered path): one step within step parity
    of one device, its flash launches a rank exact; ``ulysses_attention
    (inner_impl="flash")`` at ULYSSES_SHAPE against the plain version,
    forward and backward. (c) data 1 x stage 2, 4 microbatches, flash,
    AdamW: learning, the ranks' losses bit-equal, each rank's flash
    launches exact, each rank holding half of every ``h/block`` leaf, the
    epoch-1 checkpoint on the stage rule with every crc32 checked, the
    in-run resume bit for bit, a restore at one process onto the scan
    model every leaf bit-equal, the first step's loss within
    PARITY_LOSS_ATOL of the one-device model's. ``started``:
    ``_sp_start()``'s, when the ranks were started ahead; ``ranks_done``
    is called once they have ended."""
    from tpuflow_torch.ckpt import raw
    from tpuflow_torch.train.gpt import mesh_axes

    t_phase = time.monotonic()
    out = {"mode": f"{SP_WORLD} ranks on cuda:{SP_CARD} over "
                   f"{FSDP_BACKEND}", "gpu": smi}
    if kernel_rows is None:
        kernel_rows = sp_kernel_rows(torch, Timer(torch))
        torch.cuda.empty_cache()
    out.update(kernel_rows)
    work, procs = started or _sp_start()
    try:
        procs_s = _finish_ranks(procs, os.path.join(work, "go"),
                                "phase 14")
        if ranks_done is not None:
            ranks_done()
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
                 for r in range(SP_WORLD)]
        out["ranks"], out["ranks_wall_s"] = ranks, procs_s
        ab = c = ranks
        L = _sp_cfg("a").model_config().n_layer
        # (a): the ring runs no kernel of the port.
        cfg_a = _sp_cfg("a")
        _sp_check_leg("a", cfg_a, [r["a"] for r in ab], _launches())
        out["a"] = _sp_line("a", "data 1 x seq 2, ring", cfg_a, ab[0]["a"],
                            smi)
        shift = ab[0]["shift"]
        if not all(r["shift"]["equal"] for r in ab):
            raise AssertionError("sp (a): the shift's bits differ")
        out["shift"] = shift
        print(f"sp (a): the ring's shift alone, (2, 8, 512, 12, 64) f32 "
              f"({shift['bytes'] / 2**20:.0f} MiB) to the right neighbour "
              f"staged through pinned host buffers over gloo: "
              f"{shift['ms']:.2f} ms, {shift['gbps']:.2f} GB/s (the host's "
              f"path, not NVLink's) [{smi}]")
        ckpt_a = os.path.join(work, "ckpt_a")
        step_dir = os.path.join(ckpt_a, f"step_{SP_STEPS_PER_EPOCH}")
        bad = _tp_rule_layout(step_dir, mesh_axes(cfg_a))
        checked, corrupt = raw.verify_dir(os.path.join(step_dir, "state"))
        if bad or corrupt or not checked:
            raise AssertionError(f"sp (a) epoch-1 checkpoint: leaves off "
                                 f"the rule {bad[:5]}, corrupt {corrupt[:5]}")
        _sp_resume_check("a", work, ckpt_a, [r["a"] for r in ab],
                         [r["a_resume"] for r in ab], _launches())
        whole = raw.restore_raw(os.path.join(step_dir, "state"))
        n = _equal_leaves(torch, _restore_at_one(
            torch, _sp_cfg("a", seq_axis=1), step_dir), whole,
            "sp (a) restore at one process")
        del whole
        p = out["a"]["parity"] = _one_device_parity(
            torch, cfg_a, os.path.join(work, "a_grads.pt"),
            ab[0]["a_d_loss"], "sp (a)")
        print(f"sp (a): epoch-1 checkpoint on the rule's regions, {checked} "
              f"shard crc32s checked; in-run resume at {SP_WORLD} ranks bit "
              f"for bit; at one process {n} leaves bit-equal; first step "
              f"against one device: loss {p['loss_err']:.2e} apart, every "
              f"gradient within {p['grad_rel']:.2e} of its max |g| [{smi}]")
        # (b): the gathered flash path, one step; Ulysses.
        cfg_b = _sp_cfg("b")
        want_b = _launches(flash_fwd_lse=2 * L, flash_bwd_dq=L,
                           flash_bwd_dkv=L)
        for r, rank in enumerate(ab):
            if rank["b"]["launches"] != want_b:
                raise AssertionError(f"sp (b) rank {r} launched "
                                     f"{rank['b']['launches']}, want "
                                     f"{want_b}")
        p = _one_device_parity(torch, cfg_b, os.path.join(work, "b_grads.pt"),
                               ab[0]["b"]["d_loss"], "sp (b)")
        uly = ab[0]["ulysses"]
        want_u = _launches(flash_fwd_lse=1, flash_bwd_dq=1, flash_bwd_dkv=1)
        for r, rank in enumerate(ab):
            if rank["ulysses"]["launches"] != want_u:
                raise AssertionError(f"sp (b) rank {r} ulysses launched "
                                     f"{rank['ulysses']['launches']}")
        out["b"] = dict(parity=p, launches=ab[0]["b"]["launches"],
                        ulysses=uly)
        print(f"sp (b): data 1 x seq 2 on the gathered flash path: one step "
              f"against one device: loss {p['loss_err']:.2e} apart, every "
              f"gradient within {p['grad_rel']:.2e} of its max |g|; flash "
              f"launches a rank {ab[0]['b']['launches']['flash_fwd_lse']} "
              f"lse forwards, {ab[0]['b']['launches']['flash_bwd_dq']} dq, "
              f"{ab[0]['b']['launches']['flash_bwd_dkv']} dk/dv (exact); "
              f"ulysses_attention(inner_impl='flash') at {ULYSSES_SHAPE} "
              f"against the plain version: max |err| "
              f"{ {k: f'{v:.2e}' for k, v in uly['max_abs_err'].items()} } "
              f"[{smi}]")
        # (c): the pipeline.
        cfg_c = _sp_cfg("c")
        M = cfg_c.microbatches
        per = L // 2 * M * SP_STEPS
        want_c = _launches(flash_fwd_lse=per, flash_bwd_dq=per,
                           flash_bwd_dkv=per)
        _sp_check_leg("c", cfg_c, [r["c"] for r in c], want_c)
        for r, rank in enumerate(c):
            if rank["c"]["block_share"] != [0.5]:
                raise AssertionError(f"sp (c) rank {r} holds "
                                     f"{rank['c']['block_share']} of the "
                                     "h/block leaves")
        out["c"] = _sp_line("c", f"data 1 x stage 2, {M} microbatches, "
                            "flash", cfg_c, c[0]["c"], smi)
        ckpt_c = os.path.join(work, "ckpt_c")
        step_dir = os.path.join(ckpt_c, f"step_{SP_STEPS_PER_EPOCH}")
        bad = _tp_rule_layout(step_dir, mesh_axes(cfg_c))
        checked, corrupt = raw.verify_dir(os.path.join(step_dir, "state"))
        if bad or corrupt or not checked:
            raise AssertionError(f"sp (c) epoch-1 checkpoint: leaves off "
                                 f"the rule {bad[:5]}, corrupt {corrupt[:5]}")
        per_r = L // 2 * M * SP_STEPS_PER_EPOCH
        _sp_resume_check("c", work, ckpt_c, [r["c"] for r in c],
                         [r["c_resume"] for r in c],
                         _launches(flash_fwd_lse=per_r, flash_bwd_dq=per_r,
                                   flash_bwd_dkv=per_r))
        whole = raw.restore_raw(os.path.join(step_dir, "state"))
        one = _sp_cfg("c", stage_axis=1, microbatches=2)
        n = _equal_leaves(torch, _restore_at_one(torch, one, step_dir,
                                                 scan=True),
                          whole, "sp (c) restore at one process")
        del whole
        loss1 = _one_device_loss(torch, one)
        err = abs(loss1 - c[0]["c"]["step_losses"][0])
        if not err <= PARITY_LOSS_ATOL:
            raise AssertionError(f"sp (c): first step's loss {err:.2e} off "
                                 "the one-device model's")
        out["c"]["loss_err"] = err
        print(f"sp (c): each rank holds {c[0]['c']['stage_layers']} of {L} "
              f"blocks (half of every h/block leaf); epoch-1 checkpoint on "
              f"the stage rule, {checked} shard crc32s checked; in-run "
              f"resume at {SP_WORLD} ranks bit for bit; at one process onto "
              f"the scan model {n} leaves bit-equal; first step's loss "
              f"{err:.2e} off the one-device model's [{smi}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    out["wall_s"] = time.monotonic() - t_phase
    print(f"phase 14 wall {out['wall_s']:.1f} s [{smi}]")
    return out


# --------------------------------------------------------------- phase 15
PREEMPT_STEP = 5           # leg (a): the fault plan's preempt
PREEMPT_SIGNAL_STEP = 3    # leg (b): SIGTERM once the child reports it
PREEMPT_GRACE_S = 30.0     # leg (a)'s budget: the full save (leg (b): 0)
PREEMPT_CHILD_TIMEOUT_S = 300.0
# Leg (a)'s requeued call: a NaN poisoned before step NAN_STEP, which the
# health monitor flags and rolls back to the epoch-0 save at step
# ROLLBACK_STEP; the replayed step PROFILE_STEP is traced.
NAN_STEP = 11
ROLLBACK_STEP = TRAIN_STEPS_PER_EPOCH
PROFILE_STEP = 13
# The kernels the profiled training step must show (f32, D = 64): the
# forward with lse and the fused backward pair.
PROFILE_KERNELS = ("flash_fwd_fma<64, 64>", "bwd_dq_fma<64, false>",
                   "bwd_dkv_fma<64, false>")


def _recorded_losses(gpt_mod, echo: float | None = None):
    """Patch ``train_gpt``'s train-step maker so that each step's loss is
    kept (and with ``echo``, a monotonic time, printed as ``step <n> loss
    <repr> (<s> s)``, the seconds since ``echo``), the steps of a call
    that ends in ``Preempted`` included; returns the list and the
    undo."""
    real = gpt_mod.make_train_step
    losses = []

    def maker(*a, **kw):
        step = real(*a, **kw)

        def run(*args):
            state, metrics = step(*args)
            losses.append(float(metrics["loss"]))
            if echo is not None:
                print(f"step {state.step} loss {losses[-1]!r} "
                      f"({time.monotonic() - echo:.2f} s)", flush=True)
            return state, metrics

        return run

    gpt_mod.make_train_step = maker
    return losses, lambda: setattr(gpt_mod, "make_train_step", real)


def _tracked_managers(gpt_mod):
    """Patch ``train_gpt``'s ``CheckpointManager`` with a subclass that
    keeps each instance, so its save and restore records outlive a call
    that raises; returns the list and the undo."""
    real = gpt_mod.CheckpointManager
    made = []

    class Tracked(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    gpt_mod.CheckpointManager = Tracked
    return made, lambda: setattr(gpt_mod, "CheckpointManager", real)


def _preempt_want(cfg, replayed: int = 0) -> dict:
    """The flash launches of TRAIN_STEPS steps of ``cfg`` (full remat) and
    ``replayed`` discarded ones, and its TRAIN_EPOCHS validations."""
    from tpuflow_torch.data.lm import make_lm_loaders

    mc = cfg.model_config()
    L = mc.n_layer
    n_val = len(make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                cfg.seq_len, mc.vocab_size)[1])
    steps = TRAIN_STEPS + replayed
    return _launches(flash_fwd_lse=2 * L * steps, flash_bwd_dq=L * steps,
                     flash_bwd_dkv=L * steps,
                     flash_fwd=L * n_val * TRAIN_EPOCHS)


def _preempt_reference(torch, cfg, work: str, smi: str) -> tuple:
    """``--preempt`` alone: the uninterrupted run phases 6 and 7 give the
    whole script (its losses and its ``step_16``'s shards; split = fused
    bit for bit, which phase 7 holds)."""
    from tpuflow_torch.train.gpt import train_gpt

    t0 = time.monotonic()
    ref = os.path.join(work, "reference")
    res = train_gpt(cfg, ckpt_dir=ref, log=lambda m: None)
    shards = _shards(os.path.join(ref, f"step_{TRAIN_STEPS}"))
    shutil.rmtree(ref)
    print(f"preempt: the uninterrupted reference run, {TRAIN_STEPS} steps "
          f"with its checkpoints: {time.monotonic() - t0:.1f} s [{smi}]")
    return res.step_losses, shards


def _preempt_leg_a(torch, cfg, work: str, fused: list, shards: list,
                   smi: str) -> dict:
    """Leg (a): ``train_gpt`` drained in this process by the fault plan at
    PREEMPT_STEP with a PREEMPT_GRACE_S budget (the full save, on the
    persistent tier), then called again with the obs recorder configured,
    the fault plan's NaN before step NAN_STEP and the profile window on
    step PROFILE_STEP: the health monitor flags NAN_STEP and rolls back
    to ROLLBACK_STEP, and the run replays from there."""
    from tpuflow_torch import obs
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train import gpt as gpt_mod
    from tpuflow_torch.utils import preempt

    ck = os.path.join(work, "a")
    obs_dir = os.path.join(work, "a_obs")
    losses, undo_losses = _recorded_losses(gpt_mod)
    mgrs, undo_mgrs = _tracked_managers(gpt_mod)
    _zero_counters(fa, im)
    t0 = time.monotonic()
    try:
        try:
            gpt_mod.train_gpt(cfg, ckpt_dir=ck, log=lambda m: None,
                              faults=f"preempt:0@step{PREEMPT_STEP}",
                              preempt_grace_s=PREEMPT_GRACE_S)
            raise AssertionError("preempt (a): train_gpt was not preempted")
        except preempt.Preempted:
            drain_s = time.monotonic() - preempt._REQUESTED_AT
        preempt.clear_preemption()
        drained = losses[:]
        save = mgrs[0].saves[-1]
        meta = json.load(open(os.path.join(ck, f"step_{PREEMPT_STEP}",
                                           "metadata.json")))
        obs.configure(obs_dir, proc=0)
        try:
            res = gpt_mod.train_gpt(cfg, ckpt_dir=ck, log=lambda m: None,
                                    faults=f"nan_grad:0@step{NAN_STEP}",
                                    profile=(PROFILE_STEP, PROFILE_STEP))
        finally:
            obs.configure(None)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        got = _counters(fa, im)
    finally:
        undo_losses()
        undo_mgrs()
    cursor = {"epoch": 0, "batch_index": PREEMPT_STEP, "seed": 0}
    if meta["data_state"] != cursor or meta["metrics"]:
        raise AssertionError(f"preempt (a): step_{PREEMPT_STEP} holds "
                             f"{meta['data_state']}, {meta['metrics']}")
    # Steps 1-10, the NaN step, then 9-16 replayed from the rollback.
    want_raw = (fused[:NAN_STEP - 1] + [float("nan")]
                + fused[ROLLBACK_STEP:])
    nan_at = NAN_STEP - 1
    if (len(drained) != PREEMPT_STEP or len(losses) != len(want_raw)
            or not np.isnan(losses[nan_at])
            or losses[:nan_at] + losses[nan_at + 1:]
            != want_raw[:nan_at] + want_raw[nan_at + 1:]):
        raise AssertionError(f"preempt (a): losses {drained} then "
                             f"{losses[PREEMPT_STEP:]}, want {want_raw} "
                             f"(phase 6's {fused} around the NaN)")
    if res.step_losses != fused[PREEMPT_STEP:]:
        raise AssertionError(f"preempt (a): the result's step losses "
                             f"{res.step_losses}, want phase 6's "
                             f"{fused[PREEMPT_STEP:]}")
    if _shards(os.path.join(ck, f"step_{TRAIN_STEPS}")) != shards:
        raise AssertionError(f"preempt (a): step_{TRAIN_STEPS} differs "
                             "from phase 7's")
    want = _preempt_want(cfg, replayed=NAN_STEP - ROLLBACK_STEP)
    if got != want:
        raise AssertionError(f"preempt (a) launches {got}, want {want}")
    restores = res.checkpoint_io["restores"]
    if [(r["step"], r["tier"]) for r in restores] != [
            (PREEMPT_STEP, "persistent"), (ROLLBACK_STEP, "persistent")]:
        raise AssertionError(f"preempt (a) restored {restores}")
    events = [e for p in sorted(os.listdir(obs_dir))
              if p.startswith("events.p")
              for e in obs.read_events(os.path.join(obs_dir, p))]
    health = obs.health_summary(events)
    an, rb = health["anomalies"], health["rollbacks"]
    if ([(a["detector"], a["step"]) for a in an] != [("nonfinite", NAN_STEP)]
            or [(r["step"], r["from_step"]) for r in rb]
            != [(ROLLBACK_STEP, NAN_STEP)]
            or health["nonfinite_steps"] != 1):
        raise AssertionError(f"preempt (a): health events {health}")
    (prof,) = health["profiles"]
    traces = [os.path.join(prof["dir"], n) for n in os.listdir(prof["dir"])
              if n.endswith(".json")]
    if len(traces) != 1:
        raise AssertionError(f"preempt (a): profile traces {traces}")
    with open(traces[0]) as fh:
        names = [e.get("name", "") for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "kernel"]
    seen = {k: sum(k.replace(" ", "") in n.replace(" ", "") for n in names)
            for k in PROFILE_KERNELS}
    if not all(seen.values()):
        raise AssertionError(f"preempt (a): the profile of step "
                             f"{PROFILE_STEP} holds {len(names)} kernels, "
                             f"the flash ones {seen}")
    ev_ts = {e["name"]: e["ts"] for e in events
             if e["name"] in ("health.anomaly", "health.rollback")}
    rollback_s = ev_ts["health.rollback"] - ev_ts["health.anomaly"]
    print(f"preempt (a): drained at step {PREEMPT_STEP} by the fault plan "
          f"(grace {PREEMPT_GRACE_S:.0f} s: the full save) in "
          f"{drain_s:.3f} s from the flag to Preempted "
          f"({_io_line('save', [save])}), requeued: "
          f"{_io_line('restore', restores[:1])} (persistent tier, warm page "
          f"cache); the requeued call's NaN at step {NAN_STEP} flagged "
          f"(nonfinite) and rolled back to step {ROLLBACK_STEP} in "
          f"{rollback_s:.3f} s (crc32 verify + "
          f"{_io_line('restore', restores[1:])}); {PREEMPT_STEP} + "
          f"{NAN_STEP - PREEMPT_STEP} + {TRAIN_STEPS - ROLLBACK_STEP} "
          f"losses bit-equal to phase 6's around the NaN, step_"
          f"{TRAIN_STEPS}'s {len(shards)} shard crc32s equal to phase 7's, "
          f"launches { {n: v for n, v in got.items() if v} } (exact); step "
          f"{PROFILE_STEP} profiled: {len(names)} kernels, flash "
          f"{list(seen.values())}; wall {wall_s:.1f} s [{smi}]")
    shutil.rmtree(ck)
    shutil.rmtree(obs_dir)
    return dict(drain_s=drain_s, save=save, restore=restores[0],
                rollback_restore=restores[1], rollback_s=rollback_s,
                launches=got, step_losses=losses, wall_s=wall_s,
                profile_kernels=seen)


class _Child:
    """A ``--preempt-child`` process of this script (attempt ``attempt``
    in ``work``), started ahead; its output lines read on a thread as they
    come."""

    def __init__(self, work: str, attempt: int):
        import queue
        import threading

        self.name = f"child {attempt}"
        self.proc = _ahead(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--preempt-child",
             work, str(attempt)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            bufsize=1))
        self._lines = queue.Queue()

        def read():
            for line in self.proc.stdout:
                self._lines.put(line)
            self._lines.put(None)

        threading.Thread(target=read, daemon=True).start()

    def lines(self, deadline: float):
        """Its lines, each printed, until it ends; raises past
        ``deadline``."""
        import queue

        while True:
            try:
                line = self._lines.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise AssertionError(f"preempt: {self.name} ran past its "
                                     f"deadline") from None
            if line is None:
                return
            print(f"  [{self.name}] {line.rstrip()}")
            yield line

    def until(self, prefix: str, deadline: float) -> None:
        """Read its lines up to one that starts with ``prefix``."""
        for line in self.lines(deadline):
            if line.startswith(prefix):
                return
        raise AssertionError(f"preempt: {self.name} ended (rc "
                             f"{self.proc.wait()}) before {prefix!r}")


def _preempt_start() -> tuple:
    """Phase 15's work directory and leg (b)'s two children, started
    (each makes its imports and context and warms up, then waits for its
    go)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_preempt_",
                            dir=os.path.join(REPO, "build"))
    wb = os.path.join(work, "b")
    os.makedirs(wb)
    return work, _Child(wb, 0), _Child(wb, 1)


def _preempt_leg_b(torch, cfg, wb: str, children: tuple, fused: list,
                   shards: list, smi: str) -> dict:
    """Leg (b) in ``wb`` with ``children``, two ``--preempt-child``
    processes started ahead and ready: the first, told to go, trains with
    the local tier and no grace left; a real SIGTERM once it reports step
    PREEMPT_SIGNAL_STEP drains it (``emergency_save``, exit 75); the
    second, the requeue, told to go once the first has ended, resumes
    from the local tier and finishes."""
    import glob
    import signal

    child0, child1 = children
    t0 = time.monotonic()
    deadline = t0 + PREEMPT_CHILD_TIMEOUT_S
    open(os.path.join(wb, "go0"), "w").close()
    child0.until(f"step {PREEMPT_SIGNAL_STEP} ", deadline)
    child0.proc.send_signal(signal.SIGTERM)
    t_sig = time.monotonic()
    for _ in child0.lines(deadline):
        pass
    rc0 = child0.proc.wait(timeout=30)
    if rc0 != 75:
        raise AssertionError(f"preempt (b): child 0 exited {rc0}, want 75")
    try:
        c0 = json.load(open(os.path.join(wb, "child0.json")))
        k = c0["step"]
        local = glob.glob(os.path.join(wb, "local", "*", f"step_{k}",
                                       "metadata.json"))
        if (k < PREEMPT_SIGNAL_STEP or len(local) != 1 or os.path.exists(
                os.path.join(wb, "ck", f"step_{k}", "metadata.json"))):
            raise AssertionError(f"preempt (b): drained at step {k}, local "
                                 f"copies {local}, a persistent step_{k}: "
                                 "want a local-only step")
        open(os.path.join(wb, "go1"), "w").close()
        for _ in child1.lines(deadline):
            pass
        rc1 = child1.proc.wait(timeout=30)
        if rc1 != 0:
            raise AssertionError(f"preempt (b): the requeue exited {rc1}")
    finally:
        if child1.proc.poll() is None:
            child1.proc.kill()
            child1.proc.wait()
    wall_s = time.monotonic() - t0
    c1 = json.load(open(os.path.join(wb, "child1.json")))
    from tpuflow_torch.obs import read_events

    events = [e for p in glob.glob(os.path.join(wb, "obs", "events.p*.jsonl"))
              for e in read_events(p)]
    served = [(e["tier"], e["step"]) for e in events
              if e["name"] == "ckpt.restore_tier" and e.get("launch") == 1]
    (em,) = [e for e in events if e["name"] == "ckpt.emergency_save"]
    (restore,) = c1["restores"]
    if served != [("local", k)] or (restore["tier"], restore["step"]) != (
            "local", k) or (em["step"], em["tier"], em["ok"]) != (
            k, "local", True):
        raise AssertionError(f"preempt (b): the requeue restored {served}, "
                             f"{restore}; emergency save {em}")
    if c0["losses"] + c1["losses"] != fused:
        raise AssertionError(f"preempt (b): losses {c0['losses']} then "
                             f"{c1['losses']}, want phase 6's {fused}")
    if c1["step"] != TRAIN_STEPS or _shards(os.path.join(
            wb, "ck", f"step_{TRAIN_STEPS}")) != shards:
        raise AssertionError(f"preempt (b): step_{TRAIN_STEPS} differs "
                             "from phase 7's")
    got = {n: c0["launches"][n] + c1["launches"][n] for n in c0["launches"]}
    want = _preempt_want(cfg)
    if got != want:
        raise AssertionError(f"preempt (b) launches {got}, want {want}")
    save = c0["save"]
    print(f"preempt (b): SIGTERM {t_sig - t0:.1f} s into child 0 (after "
          f"its step {PREEMPT_SIGNAL_STEP}), drained at step {k} with no "
          f"grace left: emergency_save on the local tier in "
          f"{c0['drain_s']:.3f} s from the flag to Preempted "
          f"({_io_line('save', [save])}), exit 75, no persistent step_{k}; "
          f"the requeue {_io_line('restore', [restore])} (local tier, warm "
          f"page cache); {k} + {TRAIN_STEPS - k} losses bit-equal to phase "
          f"6's, step_{TRAIN_STEPS}'s {len(shards)} shard crc32s equal to "
          f"phase 7's, launches {({n: v for n, v in got.items() if v})} "
          f"(exact); wall {wall_s:.1f} s [{smi}]")
    return dict(step=k, signal_s=t_sig - t0, drain_s=c0["drain_s"],
                save=save, restore=restore, launches=got,
                child_launches=[c0["launches"], c1["launches"]],
                step_losses=c0["losses"] + c1["losses"], wall_s=wall_s)


def _warm_up(torch, gpt_mod) -> None:
    """Pay a fresh process's first-use costs of the training slice's call
    ahead of a child's go (unwarmed, a child's first step came 11.7 s
    after its go on the card): one state of ``_train_cfg()`` and one step
    on it, then dropped (the launch counters are zeroed after the go)."""
    from tpuflow_torch.data.lm import make_lm_loaders

    cfg = _train_cfg()
    state = gpt_mod.init_state(cfg)
    loader, _ = make_lm_loaders(cfg.batch_size, cfg.steps_per_epoch,
                                cfg.seq_len, cfg.model_config().vocab_size)
    loader.set_epoch(0)
    gpt_mod.make_train_step()(state, next(iter(loader)), 1)
    torch.cuda.synchronize()
    del state


def preempt_child(torch, work: str, attempt: int) -> int:
    """One attempt of leg (b) (``--preempt-child``): the training slice's
    ``train_gpt`` with the local tier under ``work`` and a grace budget of
    0 s, its SIGTERM handler installed, each step's loss printed; the
    requeue is ``attempt`` 1. Writes
    ``work/child<attempt>.json``; exits 75 when drained. Each attempt
    makes its imports and its context and warms up (``_warm_up``), then
    waits for the parent's go (``work/go<attempt>``) before it trains."""
    from tpuflow_torch import obs
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train import gpt as gpt_mod
    from tpuflow_torch.utils import preempt

    preempt.install_sigterm_handler()
    preempt.configure(attempt=attempt)
    _warm_up(torch, gpt_mod)
    print(f"ready {time.monotonic() - T_START:.2f} s after the start",
          flush=True)
    go = os.path.join(work, f"go{attempt}")
    deadline = time.monotonic() + PREEMPT_CHILD_TIMEOUT_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise AssertionError("no go from the parent")
        time.sleep(0.02)
    t_go = time.monotonic()
    obs.configure(os.path.join(work, "obs"), attempt=attempt)
    losses, _ = _recorded_losses(gpt_mod, echo=t_go)
    mgrs, _ = _tracked_managers(gpt_mod)
    _zero_counters(fa, im)
    out = {"attempt": attempt}
    try:
        res = gpt_mod.train_gpt(
            _train_cfg(), ckpt_dir=os.path.join(work, "ck"),
            log=lambda m: print(f"  {m} ({time.monotonic() - t_go:.2f} s)",
                                flush=True), preempt_grace_s=0.0,
            ckpt_local_dir=os.path.join(work, "local"))
        out.update(preempted=False, step=res.checkpoint.metadata["step"],
                   restores=res.checkpoint_io["restores"],
                   saves=res.checkpoint_io["saves"])
    except preempt.Preempted:
        out.update(preempted=True, step=len(losses),
                   drain_s=time.monotonic() - preempt._REQUESTED_AT,
                   save=mgrs[0].saves[-1])
    torch.cuda.synchronize()
    out.update(losses=losses, launches=_counters(fa, im))
    with open(os.path.join(work, f"child{attempt}.json"), "w") as fh:
        json.dump(out, fh, default=float)
    obs.configure(None)  # flush and close the event file
    sys.stdout.flush()
    return preempt.REQUEUE_EXIT_CODE if out["preempted"] else 0


def preempt_phase(torch, smi, fused: list | None = None,
                  shards: list | None = None,
                  started: tuple | None = None) -> dict:
    """Phase 15: preemption on the training slice's call (GPT-2 124M at
    full width and depth, 2 x 8 steps of 8 x 1024, f32, full remat,
    dropout 0.1, AdamW, flash, the fused backward). (a) Drained in this
    process by the fault plan ``preempt:0@step5`` with a 30 s grace (the
    full save, persistent tier), then requeued with a NaN before step 11,
    which the health monitor rolls back to step 8 (``_preempt_leg_a``):
    the losses around the NaN bit-equal to phase 6's (``fused``),
    ``step_16``'s crc32s equal to phase 7's split leg's (``shards``), the
    flash launches exact, step 13 profiled. (b) A
    real SIGTERM to a child process of this script once it reports step 3,
    with the local tier and no grace: exit 75 and a local-only committed
    step k (``emergency_save``); the requeued child restores step k from
    the local tier (its ``ckpt.restore_tier`` event) and finishes with the
    same checks. Records the drain times, the emergency save's and the
    restores' seconds and GB/s and the phase's wall. Without ``fused`` and
    ``shards`` (``--preempt``) an uninterrupted run gives them first.
    ``started``: ``_preempt_start()``'s, when leg (b)'s children were
    started ahead; else they start now. Leg (a) runs once both are ready
    (their warm-ups done)."""
    t_phase = time.monotonic()
    cfg = _train_cfg()
    work, *children = started or _preempt_start()
    wb = os.path.join(work, "b")
    try:
        out = {"gpu": smi}
        if fused is None:
            fused, shards = _preempt_reference(torch, cfg, work, smi)
        ready = time.monotonic() + PREEMPT_CHILD_TIMEOUT_S
        for child in children:
            child.until("ready ", ready)
        out["a"] = _preempt_leg_a(torch, cfg, work, fused, shards, smi)
        torch.cuda.empty_cache()
        out["b"] = _preempt_leg_b(torch, cfg, wb, children, fused, shards,
                                  smi)
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = {n: out["a"]["launches"][n] + out["b"]["launches"][n]
                       for n in out["a"]["launches"]}
    out["wall_s"] = time.monotonic() - t_phase
    print(f"phase 15 wall {out['wall_s']:.1f} s [{smi}]")
    return out


def p2p_probe_rank(torch, mode: str, rank: int, port: int) -> None:
    """One rank of the probe of the collectives phase 14 needs
    (``--p2p-probe``): 2 processes on card SP_CARD over one gloo group.
    ``direct``: ``send``/``recv`` of a 64 MB CUDA tensor as it is;
    ``all_to_all``: ``all_to_all_single`` of 64 MB CUDA tensors; ``staged``:
    the port's shift (``p2p.ppermute``, through pinned host buffers) and
    all-to-all (``p2p.all_to_all``). Each result held bit-equal to the
    host's copy of what was sent; prints one line."""
    import torch.distributed as tdist

    from tpuflow_torch import dist
    from tpuflow_torch.parallel.p2p import (
        AxisGroup,
        all_to_all,
        ppermute,
        ring_perm,
    )

    dist.initialize("cuda", rank=rank, world_size=2,
                    init_method=f"tcp://localhost:{port}",
                    backend=FSDP_BACKEND, device_index=SP_CARD)
    n = (64 << 20) // 4
    host = [torch.randn(n, generator=torch.Generator().manual_seed(r))
            for r in range(2)]
    x = host[rank].cuda()
    out = {"mode": mode, "rank": rank}
    torch.cuda.synchronize()
    tdist.barrier()
    t0 = time.monotonic()
    if mode == "direct":
        if rank == 0:
            tdist.send(x, 1)
            got, want = x, host[0]
        else:
            got = torch.empty_like(x)
            tdist.recv(got, 0)
            want = host[0]
    elif mode == "all_to_all":
        got = torch.empty_like(x)
        tdist.all_to_all_single(got, x)
        half = n // 2
        want = torch.cat([host[0][rank * half:(rank + 1) * half],
                          host[1][rank * half:(rank + 1) * half]])
    else:
        peers = AxisGroup(tdist.group.WORLD, rank, 2)
        got = ppermute(x, peers, ring_perm(2))
        want = host[1 - rank]
        torch.cuda.synchronize()
        out["shift_s"] = time.monotonic() - t0
        out["shift_equal"] = bool(torch.equal(got.cpu(), want))
        t0 = time.monotonic()
        got = all_to_all(x.view(2, -1), peers, 0, 1)
        half = n // 2
        want = torch.cat([host[0][rank * half:(rank + 1) * half],
                          host[1][rank * half:(rank + 1) * half]])
        got = got.reshape(-1)
    torch.cuda.synchronize()
    out["s"] = time.monotonic() - t0
    out["equal"] = bool(torch.equal(got.cpu(), want))
    print(f"p2p probe {json.dumps(out)}", flush=True)
    dist.shutdown()


def p2p_probe() -> int:
    """``--p2p-probe``: each mode of ``p2p_probe_rank`` in a pair of
    processes of its own (a mode that crashes takes only its pair)."""
    import socket

    rcs = {}
    for mode in ("direct", "all_to_all", "staged"):
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--p2p-probe-rank", mode, str(r),
                                   str(port)]) for r in range(2)]
        try:
            rcs[mode] = [p.wait(timeout=120) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    print(f"p2p probe ranks exited {rcs}")
    return 0 if all(not any(v) for k, v in rcs.items()
                    if k != "direct") else 1

# Phase 16: the elastic gang. ``TorchGptTrain`` at GPT-2 124M width (768
# wide, 12 heads of 64, vocab 50257) cut to ELASTIC_LAYERS of its 12
# layers (phase 13's depth cut, for the time limit), a gang of
# ELASTIC_WORLD members sharing card ELASTIC_CARD over gloo, data axis 3,
# the global batch ELASTIC_BATCH x 1024 (divides by 3 and by 2), f32,
# flash, the fused backward, AdamW, dropout 0, a checkpoint each epoch.
# Member 1 dies after step ELASTIC_FAULT_STEP (the second of epoch 1), the
# survivors shrink to 2, resume from epoch 0's checkpoint and replay two
# steps; the supervisor
# relaunches it (after a 1 s rejoin delay) and the gang grows back to 3.
ELASTIC_WORLD, ELASTIC_CARD, ELASTIC_LAYERS = 3, 0, 3
ELASTIC_BATCH = 12
ELASTIC_EPOCHS, ELASTIC_STEPS_PER_EPOCH = 4, 10
ELASTIC_FAULT_STEP = ELASTIC_STEPS_PER_EPOCH + 2
ELASTIC_REPLAY_RTOL = 1e-4  # world 2 against world 3: reduction orders
# One rank's attention shape in each world the phase forms: the global
# batch over ELASTIC_WORLD members, and over the survivors of one loss.
ELASTIC_SHAPES = tuple((ELASTIC_BATCH // w, 1024, 12, 64)
                       for w in (ELASTIC_WORLD, ELASTIC_WORLD - 1))


def elastic_kernel_rows(torch, timer) -> dict:
    """Phase 16's flash kernels at one rank's attention shape in each of
    its worlds (ELASTIC_SHAPES), f32 (the phase's dtype), against their
    plain versions, with their times."""
    return dict(kernels_fwd=flash_phase(torch, timer, ELASTIC_SHAPES,
                                        dtypes=("float32",)),
                kernels_bwd=flash_bwd_phase(torch, timer, ELASTIC_SHAPES,
                                            dtypes=("float32",)))


def _elastic_args(layers: int = ELASTIC_LAYERS, device: str | None = None,
                  **kw) -> dict:
    """The elastic flow's parameters: ``TorchGptTrain``'s defaults, the
    phase's config, ``kw`` over them."""
    flow = _elastic_flow()
    args = {a: p.default for a, p in flow.parameters().items()}
    args.update(preset="gpt2", seq_len=1024, batch_size=ELASTIC_BATCH,
                epochs=ELASTIC_EPOCHS, steps_per_epoch=ELASTIC_STEPS_PER_EPOCH,
                attn_impl="flash", data_axis=ELASTIC_WORLD, fsdp_axis=1,
                device=device or f"cuda:{ELASTIC_CARD}", dist_backend="gloo",
                layers=layers)
    args.update(kw)
    return args


def _elastic_member(flow) -> None:
    """Instrument this gang member's ``train_gpt`` (the elastic flow's
    step body, before ``TorchGptTrain.train``): the model cut to
    ``flow.layers`` blocks (0: the preset's) with dropout off; the
    member's record (``tpuflow_torch/testing/elastic_record.py``: its
    steps, validations, restores with every region's crc32s, re-forms
    and result) in ``elastic.p<member>.jsonl`` in the step's storage,
    each line with the launch counters so far; and with ``flow.go``, a
    wait for that file once the training step is made (each generation
    of the call, the first one's setup done ahead of the phase)."""
    from tpuflow_torch.dist import membership
    from tpuflow_torch.flow import current
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.testing.elastic_record import record_elastic
    from tpuflow_torch.train import gpt as gpt_mod

    layers = int(flow.layers)
    real_cfg = gpt_mod.GptTrainConfig.model_config
    gpt_mod.GptTrainConfig.model_config = lambda self: dataclasses.replace(
        real_cfg(self), dropout=0.0, **({"n_layer": layers} if layers else {}))
    record_elastic(
        os.path.join(current.tpu_storage_path,
                     f"elastic.p{membership.member_id()}.jsonl"),
        os.path.join(current.tpu_storage_path, "checkpoints"),
        extra=lambda: {"c": _counters(fa, im)})
    if flow.go:
        real_make = gpt_mod.make_train_step

        def make(*a, **kw):
            step = real_make(*a, **kw)
            _await_go(flow.go)
            return step

        gpt_mod.make_train_step = make


_ELASTIC_FLOW = []


def _elastic_flow():
    """The elastic phase's flow: ``TorchGptTrain`` as an elastic gang
    (floor 2, no retries) whose members run ``_elastic_member`` first.
    Defined on first use (this script imports the port only after its
    CUDA check); a gang member, which loads this file by path, reaches it
    through the module's ``__getattr__``."""
    if not _ELASTIC_FLOW:
        from tpuflow_torch.flow import Parameter, gpu, retry, step
        from tpuflow_torch.flows.gpt_flow import TorchGptTrain

        class ElasticGptTrain(TorchGptTrain):
            layers = Parameter("layers", default=0,
                               help="cut the model to this many blocks "
                               "(0: the preset's)")
            go = Parameter("go", default="",
                           help="a file to wait for before the first "
                           "step, the world formed and the state built")

            @retry(times=0)
            @gpu(all_hosts_started_timeout=300, min_members=2)
            @step
            def train(self):
                _elastic_member(self)
                TorchGptTrain.train(self)

        ElasticGptTrain.__module__ = __name__
        _ELASTIC_FLOW.append(ElasticGptTrain)
    return _ELASTIC_FLOW[0]


def __getattr__(name):
    if name == "ElasticGptTrain":
        return _elastic_flow()
    raise AttributeError(name)


def _elastic_lines(storage: str) -> dict:
    out = {}
    for m in range(ELASTIC_WORLD):
        with open(os.path.join(storage, f"elastic.p{m}.jsonl")) as fh:
            out[m] = [json.loads(x) for x in fh]
    return out


def _elastic_checks(lines: dict, want_of, epochs: int, spe: int) -> dict:
    """Phase 16's per-member checks (see ``elastic_phase``); returns the
    launches per member and generation and the replayed steps."""
    gens: dict = {}
    for m, recs in lines.items():
        for r in recs:
            gens.setdefault((m, r["gen"]), []).append(r)
    launches, by_world, prev = {}, {}, {}
    for (m, g) in sorted(gens):
        recs = gens[(m, g)]
        # A process's counters start at its start line (a relaunched
        # member's too), else where its previous generation ended.
        c0 = recs[0]["c"] if "start" in recs[0] else prev.get(m)
        if c0 is None:
            raise AssertionError(f"member {m}: no start line")
        got = {k: recs[-1]["c"][k] - c0[k] for k in c0}
        prev[m] = recs[-1]["c"]
        steps = sum("loss" in r for r in recs)
        vals = sum("validation" in r for r in recs)
        want = want_of(steps, vals)
        if got != want:
            raise AssertionError(f"member {m} generation {g}: launched "
                                 f"{got}, want {want} ({steps} steps, "
                                 f"{vals} validations)")
        launches[f"{m}/{g}"] = {k: v for k, v in got.items() if v}
        at = by_world.setdefault(str(recs[-1]["world"]), {})
        for k, v in got.items():
            at[k] = at.get(k, 0) + v
    # The ranks' losses bit-equal within each generation.
    by_gen: dict = {}
    for (m, g), recs in gens.items():
        by_gen.setdefault(g, {})[m] = [(r["step"], r["loss"]) for r in recs
                                       if "loss" in r]
    for g, members in by_gen.items():
        ref = next(iter(members.values()))
        for m, got in members.items():
            n = min(len(got), len(ref))  # a member dies mid-generation
            if got[:n] != ref[:n]:
                raise AssertionError(f"generation {g}: member {m}'s losses "
                                     f"{got} differ from {ref}")
    # Every restore across a world change bit-equal to the committed step.
    regions = 0
    for m, recs in lines.items():
        for r in recs:
            for p, start, shape, got, committed in r.get("regions", ()):
                if got != committed:
                    raise AssertionError(
                        f"member {m} restored {p} at {start} {shape} with "
                        f"crc32 {got}, the committed step holds {committed}")
                regions += 1
    # The steps the shrunk gang replays against their first run at 3.
    first = dict(by_gen[0][0])
    replay = [(s, loss, first[s]) for s, loss in by_gen[1][0] if s in first]
    if not replay:
        raise AssertionError("the shrunk gang replayed no step")
    worst = max(abs(a - b) / abs(b) for _, a, b in replay)
    if worst > ELASTIC_REPLAY_RTOL:
        raise AssertionError(f"replayed steps {replay}: {worst:.2e} relative"
                             f" > {ELASTIC_REPLAY_RTOL}")
    # The head's result: every optimizer step once, every epoch once.
    (res,) = [r for r in lines[0] if "result_steps" in r]
    if (res["result_steps"], res["epochs"]) != (epochs * spe,
                                                list(range(epochs))):
        raise AssertionError(f"the head's result: {res}")
    return dict(launches=launches, launches_by_world=by_world,
                replay=replay, replay_rel=worst, regions=regions)


def _median(xs):
    return float(np.median(xs)) if xs else None


def _elastic_start() -> tuple:
    """Phase 16's work directory and its ``--elastic-child`` process,
    started: it launches the gang, whose members form generation 0 and
    build their state, then wait for the go before their first step."""
    work = tempfile.mkdtemp(prefix="chip_smoke_elastic_",
                            dir=os.path.join(REPO, "build"))
    return work, _ahead(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--elastic-child", work]))


def elastic_child(torch, work: str) -> int:
    """``--elastic-child``: phase 16 with the gang waiting for
    ``<work>/go``, its record into ``<work>/elastic.json``."""
    out = elastic_phase(torch, _smi_line(),
                        _elastic_args(go=os.path.join(work, "go")),
                        work=work)
    with open(os.path.join(work, "elastic.json"), "w") as fh:
        json.dump(out, fh, default=float)
    return 0


def elastic_run(torch, smi, started: tuple) -> dict:
    """Phase 16 from its started child (``_elastic_start``): the go, the
    child's end, its record; the wall from the go."""
    work, proc = started
    try:
        wall = _finish_ranks([proc], os.path.join(work, "go"), "elastic")
        with open(os.path.join(work, "elastic.json")) as fh:
            out = json.load(fh)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = wall
    print(f"phase 16 wall {wall:.1f} s from the go [{smi}]")
    return out


def elastic_phase(torch, smi, args: dict | None = None,
                  want_launches=None, work: str | None = None) -> dict:
    """Phase 16: ``TorchGptTrain`` as an elastic gang (``FlowRunner(
    elastic=True)``, floor 2) of ELASTIC_WORLD members sharing the card
    over gloo, under the fault plan ``member_exit:1@step<k>,
    rejoin_delay:1.0@1`` (k = ELASTIC_FAULT_STEP, in epoch 1). Checks,
    each fatal: the step succeeds in one launch; exactly one
    ``flow.member_lost`` (member 1, 2 survivors); ``flow.gang_resize``
    spans shrink 3 -> 2, then grow 2 -> 3; no ``flow.member_failed`` or
    ``flow.heartbeat_stall``; the head's result holds every optimizer step
    and epoch once; every restore bit-equal to the committed step (each
    leaf's crc32 over the region a rank restored); the ranks' losses
    bit-equal within each generation; the steps the shrunk gang replays
    within ELASTIC_REPLAY_RTOL relative of their first run at world 3;
    each member's flash launches exact in each generation; learning.
    Records the re-form's seconds (the member's exit to the plan, the plan
    to the formed generation, each member's teardown and rendezvous, the
    restores' GB/s, the relaunch to the join), step ms in each generation
    and the phase's wall. ``args``/``want_launches``: the flow's
    parameters and the launch counts of (steps, validations) (a CPU
    rehearsal passes its own)."""
    from tpuflow_torch.data.lm import make_lm_loaders
    from tpuflow_torch.flow import Run, store
    from tpuflow_torch.flow import runner as runner_mod
    from tpuflow_torch.flow.runner import FlowRunner
    from tpuflow_torch.obs import read_events
    from tpuflow_torch.train.gpt import GptTrainConfig

    t_phase = time.monotonic()
    args = args or _elastic_args()
    L = int(args["layers"]) or 12
    n_val = len(make_lm_loaders(args["batch_size"], args["steps_per_epoch"],
                                args["seq_len"], GptTrainConfig(
                                    preset=args["preset"]).model_config()
                                .vocab_size)[1])
    want_launches = want_launches or (lambda steps, vals: _launches(
        flash_fwd_lse=2 * L * steps, flash_bwd_dq=L * steps,
        flash_bwd_dkv=L * steps, flash_fwd=L * n_val * vals))
    epochs, spe = int(args["epochs"]), int(args["steps_per_epoch"])
    k = ELASTIC_FAULT_STEP - ELASTIC_STEPS_PER_EPOCH + spe
    own = work is None
    work = work or tempfile.mkdtemp(prefix="chip_smoke_elastic_",
                                    dir=os.path.join(REPO, "build"))
    popens = []
    real_popen = subprocess.Popen

    class _Recorded(real_popen):
        def __init__(self, cmd, *a, **kw):
            popens.append((time.time(), list(cmd)))
            super().__init__(cmd, *a, **kw)

    launches_of_gang = []
    real_exec = FlowRunner._exec_gang

    def exec_gang(self, *a, **kw):
        launches_of_gang.append(kw.get("attempt"))
        return real_exec(self, *a, **kw)

    out = {"gpu": smi, "fault_step": k}
    try:
        store.set_home(os.path.join(work, "home"))
        runner_mod.subprocess.Popen = _Recorded
        FlowRunner._exec_gang = exec_gang
        flow = _elastic_flow()
        t_run = time.time()
        run = Run(FlowRunner(flow, faults=f"member_exit:1@step{k},"
                             "rejoin_delay:1.0@1", elastic=True).run(args))
        t_end = time.time()
        if args.get("go"):
            t_run = os.path.getmtime(args["go"])  # the members' start
        if not run.successful or launches_of_gang != [0]:
            raise AssertionError(f"elastic gang: successful "
                                 f"{run.successful}, launches "
                                 f"{launches_of_gang}")
        events = read_events(os.path.join(store.run_dir(
            flow.__name__, run.run_id), "events.jsonl"))
        named = lambda n: [e for e in events if e["name"] == n]  # noqa: E731
        lost = named("flow.member_lost")
        if [(e["member"], e["survivors"]) for e in lost] != [(1, 2)]:
            raise AssertionError(f"flow.member_lost events {lost}")
        resizes = sorted(named("flow.gang_resize"),
                         key=lambda e: e["generation"])
        kinds = [(e["reason"], e["from_members"], e["to_members"])
                 for e in resizes]
        if kinds != [("shrink", 3, 2), ("grow", 2, 3)]:
            raise AssertionError(f"flow.gang_resize spans {kinds}")
        bad = named("flow.member_failed") + named("flow.heartbeat_stall")
        if bad:
            raise AssertionError(f"failure events {bad}")
        storage = store.storage_dir(flow.__name__, run.run_id, "train")
        lines = _elastic_lines(storage)
        checked = _elastic_checks(lines, want_launches, epochs, spe)
        hist = run.data.loss_history
        if not all(np.isfinite(hist)) or hist[-1] >= hist[0]:
            raise AssertionError(f"no learning: epoch losses {hist}")
        # The re-form's seconds.
        exit_t = max(r["t"] for r in lines[1] if r["gen"] == 0)
        relaunch = [t for t, cmd in popens if cmd[-1] == "rejoin"]
        steps_ms = {}
        for g in (0, 1, 2):
            ts = [r["t"] for r in lines[0] if r["gen"] == g and "loss" in r]
            steps_ms[g] = _median([1e3 * (b - a) for a, b in zip(ts, ts[1:])])
        restores = [dict(member=m, gen=r["gen"], **r["restore"])
                    for m, recs in lines.items() for r in recs
                    if "restore" in r]
        reforms = [dict(member=m, gen=r["reformed"], s=r["reform_s"])
                   for m, recs in lines.items() for r in recs
                   if "reformed" in r]
        grow = resizes[1]
        steps0 = [r["t"] for r in lines[0] if "loss" in r]
        back = [r for r in lines[1] if r["gen"] == 2]
        # Seconds from the run's start: where the phase's wall goes, and
        # the slack the grow landed with.
        out["timeline"] = {name: t - t_run for name, t in dict(
            first_step=steps0[0], exit=exit_t,
            shrink_formed=resizes[0]["ts"] + resizes[0]["dur_s"],
            relaunch=relaunch[0] if relaunch else t_end,
            rejoined_start=back[0]["t"] if back else t_end,
            grow_plan=grow["ts"], grow_formed=grow["ts"] + grow["dur_s"],
            rejoined_restored=next((r["t"] for r in back
                                    if "restored" in r), t_end),
            first_step_after_grow=min(r["t"] for r in lines[0]
                                      if r["gen"] == 2 and "loss" in r),
            last_step=steps0[-1], end=t_end).items()}
        out.update(
            loss_history=hist, launches=checked["launches"],
            launches_by_world=checked["launches_by_world"],
            replay=checked["replay"], replay_rel=checked["replay_rel"],
            regions=checked["regions"], step_ms=steps_ms,
            exit_to_plan_s=resizes[0]["ts"] - exit_t,
            resize_s=[e["dur_s"] for e in resizes],
            reform_s=reforms, restores=restores,
            relaunch_to_join_s=(grow["ts"] + grow["dur_s"] - relaunch[0]
                                if relaunch else None),
            relaunch_to_request_s=(grow["ts"] - relaunch[0] if relaunch
                                   else None),
            grow_step=min(r["step"] for r in lines[0]
                          if r["gen"] == 2 and "loss" in r))
        totals = {}
        for per in checked["launches"].values():
            for name, n in per.items():
                totals[name] = totals.get(name, 0) + n
        out["launch_totals"] = totals
        print(f"elastic: shrink 3 -> 2 after member 1's exit at step {k}: "
              f"exit to plan {out['exit_to_plan_s']:.3f} s, plan to formed "
              f"{out['resize_s'][0]:.3f} s; grow 2 -> 3 at step "
              f"{out['grow_step']}: relaunch to join "
              f"{out['relaunch_to_join_s']:.3f} s, plan to formed "
              f"{out['resize_s'][1]:.3f} s; teardown and rendezvous "
              + ", ".join(f"m{r['member']}/g{r['gen']} {r['s']:.3f}"
                          for r in reforms) + " s; restores "
              + ", ".join(f"m{r['member']}/g{r['gen']} step {r['step']} "
                          f"{r['gbps']:.2f} GB/s" for r in restores)
              + f"; step ms by generation {steps_ms}; timeline (s) "
              + ", ".join(f"{n} {t:.1f}" for n, t in out["timeline"].items())
              + f"; {checked['regions']} "
              f"restored regions bit-equal; replayed steps within "
              f"{checked['replay_rel']:.2e} relative; epoch losses {hist} "
              f"[{smi}]")
    finally:
        runner_mod.subprocess.Popen = real_popen
        FlowRunner._exec_gang = real_exec
        store.set_home(None)
        if own:
            shutil.rmtree(work, ignore_errors=True)
        else:
            shutil.rmtree(os.path.join(work, "home"), ignore_errors=True)
    out["wall_s"] = time.monotonic() - t_phase
    print(f"phase 16 wall {out['wall_s']:.1f} s [{smi}]")
    return out


def main() -> int:
    import torch

    t_start = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--wide-compare"]:
        return wide_compare(os.path.abspath(sys.argv[2]))
    if sys.argv[1:2] == ["--wide-times"]:
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(wide_times(torch)))
        return 0
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--ckpt-ab"]:
        return ckpt_ab(torch, *sys.argv[2:3])
    if sys.argv[1:2] == ["--fsdp-rank"]:
        fsdp_rank(torch, int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--gloo-probe-rank"]:
        gloo_probe_rank(torch, int(sys.argv[2]), int(sys.argv[3]))
        return 0
    if sys.argv[1:2] == ["--gloo-probe"]:
        return gloo_probe()
    if sys.argv[1:2] == ["--tp-rank"]:
        tp_rank(torch, int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--sp-rank"]:
        sp_rank(torch, int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--p2p-probe-rank"]:
        p2p_probe_rank(torch, sys.argv[2], int(sys.argv[3]),
                       int(sys.argv[4]))
        return 0
    if sys.argv[1:2] == ["--p2p-probe"]:
        return p2p_probe()
    if sys.argv[1:2] == ["--preempt-child"]:
        return preempt_child(torch, sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--elastic-child"]:
        return elastic_child(torch, sys.argv[2])
    from tpuflow_torch.device import f32_matmul_precision
    from tpuflow_torch.ops import _build

    smi = _smi_line()
    print(f"gpu: {smi}")
    build_s = _build.build_all()
    print(f"built {', '.join(_build.KERNELS)} in {build_s:.2f} s")
    if sys.argv[1:2] == ["--recipes"]:
        recipes = recipes_phase(torch, smi)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "recipes.json"),
                  "w") as fh:
            json.dump(recipes, fh, indent=1, default=float)
        return 0
    if sys.argv[1:2] == ["--fsdp"]:
        fsdp = fsdp_phase(torch, smi)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "fsdp.json"), "w") as fh:
            json.dump(fsdp, fh, indent=1, default=float)
        return 0
    if sys.argv[1:2] == ["--tp"]:
        tp = tp_phase(torch, smi)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "tp.json"), "w") as fh:
            json.dump(tp, fh, indent=1, default=float)
        return 0
    if sys.argv[1:2] == ["--sp"]:
        sp = seq_pipeline_phase(torch, smi)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "sp.json"), "w") as fh:
            json.dump(sp, fh, indent=1, default=float)
        return 0
    if sys.argv[1:2] == ["--elastic"]:
        el = elastic_phase(torch, smi)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "elastic.json"),
                  "w") as fh:
            json.dump(el, fh, indent=1, default=float)
        return 0
    if sys.argv[1:2] == ["--slice"]:
        sl = slice_phase(torch, smi)[0]
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "slice.json"),
                  "w") as fh:
            json.dump(sl, fh, indent=1, default=float)
        return 0
    if sys.argv[1:2] == ["--preempt"]:
        pre = preempt_phase(torch, smi)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "preempt.json"),
                  "w") as fh:
            json.dump(pre, fh, indent=1, default=float)
        return 0

    walls = {}
    lap = [time.monotonic()]

    def wall(name):
        now = time.monotonic()
        walls[name] = now - lap[0]
        lap[0] = now
        print(f"{name} wall {walls[name]:.1f} s")

    timer = Timer(torch)
    flash_rows = flash_phase(torch, timer)
    int8_rows = int8_phase(torch, timer)
    bwd_rows = flash_bwd_phase(torch, timer)
    head_rows = head_dim_phase(torch, timer, bwd_rows)
    vit_rows = flash_phase(torch, timer, (VIT_SHAPE,), causal=False)
    vit_bwd_rows = flash_bwd_phase(torch, timer, (VIT_SHAPE,), causal=False)
    fsdp_rows = fsdp_kernel_rows(torch, timer)
    tp_rows = tp_kernel_rows(torch, timer)
    sp_rows = sp_kernel_rows(torch, timer)
    elastic_rows = elastic_kernel_rows(torch, timer)
    event_timed = timer.event_timed
    print(f"kernel times read from CUDA events, the profiler having held "
          f"too few whole calls: {event_timed}")
    del timer
    wall("kernel phases")
    sl, flash_n, int8_n = slice_phase(torch, smi)
    wall("slice phase")
    gen = generation_phase(torch, smi)
    wall("generation phase")
    tr, train_n = train_phase(torch, smi)
    wall("train phase")
    main_path = main_path_phase(torch, smi)
    wall("main path phase")
    flows = flow_phase(torch, smi)
    wall("flow phase")
    image = dict(resnet18=resnet18_flow_leg(torch, smi),
                 resnet50=resnet50_leg(torch, smi))
    with f32_matmul_precision():
        image["vit"] = vit_leg(torch, smi)
    wall("image phase")
    # Phases 12-15 start their processes ahead: phase 12's before phase
    # 11, each later one's while the phase before it checks its results
    # (a phase's processes wait for its go; they idle until then).
    ahead = {"fsdp": _fsdp_start()}
    recipes = recipes_phase(torch, smi)
    wall("recipes phase")
    fsdp = fsdp_phase(torch, smi, fsdp_rows, started=ahead.pop("fsdp"),
                      ranks_done=lambda: ahead.update(tp=_tp_start()))
    wall("fsdp phase")
    tp = tp_phase(torch, smi, tp_rows, started=ahead.pop("tp"),
                  ranks_done=lambda: ahead.update(sp=_sp_start()))
    wall("tp phase")
    sp = seq_pipeline_phase(
        torch, smi, sp_rows, started=ahead.pop("sp"),
        ranks_done=lambda: ahead.update(pre=_preempt_start()))
    wall("seq and pipeline phase")
    # Phase 16's gang starts while phase 15 runs (its members wait for
    # their go once their world is formed and their state built).
    ahead["elastic"] = _elastic_start()
    pre = preempt_phase(torch, smi, tr["step_losses"],
                        tr["split_ckpt"]["split"]["step_shards"],
                        started=ahead.pop("pre"))
    wall("preempt phase")
    elastic = elastic_run(torch, smi, ahead.pop("elastic"))
    elastic.update(elastic_rows)
    wall("elastic phase")

    # One JSON entry per kernel. flash: one launch at the generate() leg's
    # shape (f32, 1 x 512 x 12 x 64). int8: the 49 launches of one int8
    # decode step (4 Dense layers x 12 blocks at M = 8, plus the LM head),
    # and the same 49 at M = 512 on the prefill tile; their launches are
    # the engine run's, by tile.
    f = next(r for r in flash_rows
             if r["dtype"] == "float32" and r["shape"][1] == GEN_PROMPT)
    per_step = {(k, n): 12 for k, n in DENSE_KN}
    per_step[(768, VOCAB)] = 1
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="tpuflow_torch/csrc/flash_fwd.cu",
             replaces="tpuflow/ops/flash_attention.py:180",
             shape="one prefill layer, f32 (1, 512, 12, 64), causal",
             launches=flash_n, max_abs_err=f["max_abs_err"], ms=f["ms"],
             plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
             bound_by=f["bound_by"], library_ms=f["library_ms"],
             call_ms=f["call_ms"]),
    ]
    # The training kernels at the training leg's shape (8 x 1024 x 12 x
    # 64), with their launches in the train_gpt runs: f32 from the fused
    # leg (the split pair from the split leg), bf16 from the bf16 leg,
    # which runs the fused pair (its split variants' count there is 0).
    replaces = {
        "flash_fwd_lse": "tpuflow/ops/flash_attention.py:180",
        "flash_bwd_dq": "tpuflow/ops/flash_attention.py:499",
        "flash_bwd_dkv": "tpuflow/ops/flash_attention.py:499",
        "flash_bwd_dq_split": "tpuflow/ops/flash_attention.py:578",
        "flash_bwd_dkv_split": "tpuflow/ops/flash_attention.py:578",
    }
    launched = dict(train_n)
    for kern in ("flash_bwd_dq_split", "flash_bwd_dkv_split"):
        launched[kern] = tr["split_launches"][kern]
    bf16_n = tr["bf16"]["launches"]
    for kern in replaces:
        launched[kern + "_bf16"] = bf16_n[kern]
    for r in bwd_rows:
        if r["shape"] != list(TRAIN_SHAPE):
            continue
        bf16 = r["dtype"] == "bfloat16"
        src = ("tpuflow_torch/csrc/flash_fwd.cu" if r["kernel"] ==
               "flash_fwd_lse" else "tpuflow_torch/csrc/flash_bwd.cu")
        name = r["kernel"] + ("_bf16" if bf16 else "")
        entry = dict(
            name=name, route="cuda", source=src,
            replaces=replaces[r["kernel"]],
            shape=f"one training layer, {r['dtype']} (8, 1024, 12, 64), "
                  "causal" + ("; launches from the bf16 leg" if bf16
                              else ""),
            launches=launched[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            library=r["library"], call_ms=r["call_ms"],
        )
        kernels.append(entry)

    def int8_entry(name, m_rows, launches, shape):
        rows = [r for r in int8_rows if r["shape"][0] == m_rows]

        def step_sum(key):
            return sum(per_step[tuple(r["shape"][1:])] * r[key]
                       for r in rows)

        nbytes = sum(per_step[tuple(r["shape"][1:])] * r["nbytes"]
                     for r in rows)
        ops = sum(per_step[tuple(r["shape"][1:])] * 2 * np.prod(r["shape"])
                  for r in rows)
        bound, by = _bound_ms(nbytes, ops, "int8")
        return dict(name=name, route="cuda",
                    source="tpuflow_torch/csrc/int8_matmul.cu",
                    replaces="tpuflow/ops/int8_matmul.py:229", shape=shape,
                    launches=launches, max_abs_err=0.0, ms=step_sum("ms"),
                    plain_ms=step_sum("plain_ms"), bound_ms=bound,
                    bound_by=by, library_ms=step_sum("library_ms"),
                    library=", ".join(sorted({r["library"] for r in rows})),
                    call_ms=step_sum("call_ms"))

    # The flash kernels' launches on this slice's path, the GPT-2 flows
    # (f32; the train flow's, plus the eval flow's no-lse forwards).
    flow_n = {k: flows["gpt_train_launches"][k]
              + flows["gpt_eval_launches"][k]
              for k in flows["gpt_train_launches"]}
    # The wide-head kernels (D > 256) at D = 512, with their launches
    # summed over every main path run above (the counters' "_wide" keys).
    main_runs = [sl["generate"]["launches"], sl["engine"]["launches"],
                 _launches(flash_fwd=sl["disagg"]["launches"]["flash_fwd"]),
                 sl["replica"]["launches"],
                 *gen["launches"].values(),
                 train_n, tr["bf16"]["launches"], tr["split_launches"],
                 tr["split_ckpt"]["resume"]["launches"],
                 main_path["launches"], flows["mlp_launches"],
                 flows["gpt_train_launches"], flows["gpt_eval_launches"],
                 image["resnet18"]["launches"], image["resnet50"]["launches"],
                 image["vit"]["train_launches"], image["vit"]["eval_launches"]]
    replaces_wide = {"flash_fwd": replaces["flash_fwd_lse"], **replaces}
    for r in head_rows:
        if r["shape"][3] != WIDE_D:
            continue
        bf16 = r["dtype"] == "bfloat16"
        for kern in WIDE_KERNELS:
            errs = [r["errors"][k][0] for k in WIDE_ERR_KEYS[kern]]
            counter = kern + ("_bf16" if bf16 else "") + "_wide"
            kernels.append(dict(
                name=f"{kern}_d{WIDE_D}" + ("_bf16" if bf16 else ""),
                route="cuda",
                source=("tpuflow_torch/csrc/flash_fwd.cu"
                        if kern.startswith("flash_fwd")
                        else "tpuflow_torch/csrc/flash_bwd.cu"),
                replaces=replaces_wide[kern],
                shape=f"wide head, {r['dtype']} {tuple(r['shape'])}, "
                      "causal; launches: the main paths' wide-head runs",
                launches=sum(run[counter] for run in main_runs),
                flow_launches=flow_n[counter], max_abs_err=max(errs),
                ms=r["ms"][kern],
                plain_ms=r["plain_ms"][kern], bound_ms=r["bound_ms"][kern],
                bound_by=r["bound_by"][kern],
                library_ms=r["library_ms"][kern],
                library=("sdpa forward" if kern.startswith("flash_fwd")
                         else "sdpa backward (dq, dk, dv)")))
    for entry in kernels:
        if entry["name"] in flow_n:
            entry["flow_launches"] = flow_n[entry["name"]]
    # The generation phase's launches (its legs summed; int8 by tile).
    gen_n = {"flash_fwd": sum(n["flash_fwd"]
                              for n in gen["launches"].values()),
             "int8_matmul": sum(t["decode"]
                                for t in gen["int8_tiles"].values()),
             "int8_matmul_prefill": sum(t["prefill"]
                                        for t in gen["int8_tiles"].values())}
    # The flash kernels at the ViT leg's attention shape, not causal, f32
    # (the leg's dtype), with the leg's launches: train_model's, plus the
    # predictor's no-lse forwards.
    vit_n = {k: image["vit"]["train_launches"][k]
             + image["vit"]["eval_launches"][k] for k in LAUNCH_COUNTERS}
    shape = f"ViT-S/16 attention, float32 {VIT_SHAPE}, not causal"
    for r in [*vit_rows, *vit_bwd_rows]:
        kern = r.get("kernel", "flash_fwd")
        if r["dtype"] != "float32" or kern.endswith("_split"):
            continue
        kernels.append(dict(
            name=f"{kern}_vit", route="cuda",
            source=("tpuflow_torch/csrc/flash_fwd.cu"
                    if kern.startswith("flash_fwd")
                    else "tpuflow_torch/csrc/flash_bwd.cu"),
            replaces=replaces_wide[kern], shape=shape, launches=vit_n[kern],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            library=r["library"], call_ms=r["call_ms"]))
    # The flash kernels at phase 16's attention shape a rank in each of
    # its worlds, f32, with the launches its members made at that world.
    for r in [*elastic_rows["kernels_fwd"], *elastic_rows["kernels_bwd"]]:
        kern = r.get("kernel", "flash_fwd")
        if kern.endswith("_split"):
            continue
        B = r["shape"][0]
        world = ELASTIC_BATCH // B
        kernels.append(dict(
            name=f"{kern}_elastic_w{world}", route="cuda",
            source=("tpuflow_torch/csrc/flash_fwd.cu"
                    if kern.startswith("flash_fwd")
                    else "tpuflow_torch/csrc/flash_bwd.cu"),
            replaces=replaces_wide[kern],
            shape=f"phase 16 at world {world}, float32 {tuple(r['shape'])}"
                  ", causal",
            launches=elastic["launches_by_world"][str(world)].get(kern, 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            library=r["library"], call_ms=r["call_ms"]))
    kernels += [
        int8_entry("int8_matmul", DECODE_M, int8_n["decode"],
                   "one int8 decode step at M=8: 48 Dense + LM head"),
        int8_entry("int8_matmul_prefill", PREFILL_M, int8_n["prefill"],
                   "49 calls at M=512: 48 Dense + LM head (prefill tile)"),
    ]
    for entry in kernels:
        if entry["name"] in gen_n:
            entry["generation_launches"] = gen_n[entry["name"]]
        # Phase 4's disaggregated leg: its ships, imports, fallbacks and
        # feed admissions (the flash forward; the int8 matmul by tile).
        if entry["name"] in sl["disagg"]["launches"]:
            entry["disagg_launches"] = sl["disagg"]["launches"][entry["name"]]
        # Phase 4's replica leg: its requests over HTTP, the ship hop
        # included (the flash forward).
        if entry["name"] == "flash_fwd":
            entry["replica_launches"] = sl["replica"]["launches"]["flash_fwd"]
    # The flash kernels' launches in phase 11, every training recipe's
    # runs summed (its legs, resumes and flows; f32).
    recipe_runs = [recipes[leg]["launches"] for leg in
                   ("lion", "adafactor", "moe", "lm_text")]
    recipe_runs += [recipes[leg]["resume"]["launches"]
                    for leg in ("lion", "adafactor", "moe")]
    recipe_runs += [recipes["flows"]["train_launches"],
                    recipes["flows"]["eval_launches"]]
    for entry in kernels:
        if entry["name"] in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                             "flash_bwd_dkv"):
            entry["recipe_launches"] = sum(run[entry["name"]]
                                           for run in recipe_runs)
            # Phase 12's FSDP leg (b), its ranks' launches summed (each
            # rank's count is checked exactly in the phase).
            entry["fsdp_launches"] = sum(r["b"]["launches"][entry["name"]]
                                         for r in fsdp["ranks"])
            # Phase 13's two training legs, every rank's launches summed
            # (each rank's count is checked exactly in the phase).
            entry["tp_launches"] = sum(
                r["train"]["launches"][entry["name"]]
                for leg in ("a", "b") for r in tp[leg]["ranks"])
            # Phase 14's sequence-parallel legs, every rank's launches
            # summed: (a)'s training and resume (the ring launches none)
            # and (b)'s step on the gathered flash path; and its pipeline
            # leg (c), training and resume.
            entry["seq_launches"] = sum(
                r[k]["launches"][entry["name"]] for r in sp["ranks"]
                for k in ("a", "a_resume", "b"))
            entry["pipeline_launches"] = sum(
                r[k]["launches"][entry["name"]] for r in sp["ranks"]
                for k in ("c", "c_resume"))
            # Phase 15's two legs, drained and requeued (leg (b)'s two
            # child processes summed).
            entry["preempt_launches"] = pre["launches"][entry["name"]]
            # Phase 16's elastic gang, every member's launches in every
            # generation summed (each checked exactly in the phase).
            entry["elastic_launches"] = elastic["launch_totals"].get(
                entry["name"], 0)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(gpu=smi, build_s=build_s, flash=flash_rows,
                       int8=int8_rows, flash_bwd=bwd_rows,
                       head_dims=head_rows, slice=sl, generation=gen,
                       train=tr,
                       main_path=main_path, flows=flows, image=image,
                       recipes=recipes, fsdp=fsdp, tp=tp, sp=sp,
                       preempt=pre, elastic=elastic,
                       vit_flash=vit_rows, vit_flash_bwd=vit_bwd_rows,
                       event_timed=event_timed, walls=walls,
                       kernels=kernels),
                  fh,
                  indent=1, default=float)
    print(f"chip_smoke wall {time.monotonic() - t_start:.1f} s [{smi}]")
    print(json.dumps({"kernels": kernels}, default=float))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
