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
   fp and int8 requests, each held equal to a solo ``generate()``.
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
   of times the code implies. Then two steps under the profiler
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
11. One JSON line with every kernel's numbers (the int8 matmul both as one
   decode step at M = 8 and as the same 49 products at M = 512; the
   training kernels in f32 and bf16, their launches from the f32 legs and
   the bf16 leg, which runs the fused pair, so the bf16 split variants'
   count there is 0; the wide-head kernels at D = 512, their launches the
   wide-head runs the main paths' counters read; ``flow_launches``: the
   flash kernels' launches in the flow phase; ``generation_launches``:
   those of the generation phase; the ``_vit`` entries at the
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
# Rounds of each part of the checkpoint IO phase, the widths its disk
# ceiling writes at and the threads it reads and checksums with.
CKPT_IO_REPS = 2
CKPT_WRITE_WIDTHS = (1, 4, 8)
CKPT_READ_THREADS = (1, 8)
# torch.profiler traces taken before a trace without the measured
# function's kernels is fatal.
TRACE_ATTEMPTS = 3
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
# synthetic train split cut from 50,000 to 10,000 rows to fit the time
# limit (the 10,000 test rows whole).
CIFAR_TRAIN_ROWS = 10_000
# ResNet-50 / imagenet_synth (BASELINE config 2 on one card) through
# train_model: 224 x 224 x 3, 1000 classes, global batch 64, 2 epochs of
# the dataset's default 2,000 synthetic rows (31 steps each), its 200
# test rows. Then the step timed apart: warm-up steps, timed steps and
# profiled steps, with the batches prefetched as the main path does.
R50_BATCH, R50_EPOCHS = 64, 2
R50_TIMED_WARMUP, R50_TIMED_STEPS, R50_PROFILED_STEPS = 5, 20, 10
# ViT-S/16 on imagenet_synth with attn_impl="flash" (f32, TF32 off): one
# epoch of 4 steps at batch 64, 100 test rows (2 padded validation
# batches, 2 predictor batches). Its attention: (64, 197, 6, 64), not
# causal.
VIT_BATCH, VIT_TRAIN_ROWS, VIT_TEST_ROWS = 64, 256, 100
VIT_SHAPE = (64, 197, 6, 64)


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def kernel_trace(torch, run, keep=lambda e: True) -> list[dict]:
    """The CUDA kernels ``run()`` launches that ``keep`` accepts, as
    chrome-trace events (name, ts and dur in us) from ``torch.profiler``.
    A trace that holds no such kernel (seen once on the H100 for a short
    run) is taken again, up to ``TRACE_ATTEMPTS`` times in all; then the
    device times cannot be read and this raises."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    for attempt in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        every = [e for e in events if e.get("cat") == "kernel"]
        kernels = [e for e in every if keep(e)]
        if kernels:
            return kernels
        print(f"torch.profiler trace {attempt + 1} of {TRACE_ATTEMPTS} holds "
              f"{len(every)} CUDA kernels, none of the measured function's; "
              "tracing again")
    raise RuntimeError("torch.profiler recorded no CUDA kernel of the "
                       "measured function: the device times cannot be read")


class Timer:
    """Times of ``fn`` over ``iters`` calls, each after an L2 flush (the
    serving path meets its weights cold: a decode step streams ~124 MB
    between two visits of one layer). Returns ``(device_ms, call_ms)``:
    the summed duration of the kernels one call launches (profiler trace;
    the flush kernel excluded), and the CUDA-event time of one call, which
    also holds the wrapper's host work while the device waits for it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")

    def _calls(self, fn, iters):
        for _ in range(iters):
            self.flush.bitwise_not_()
            fn()

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
        kernels = kernel_trace(torch, lambda: self._calls(fn, iters),
                               keep=lambda e: "bitwise_not" not in e["name"])
        return sum(e["dur"] for e in kernels) / 1e3 / iters, call / iters


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


def flash_phase(torch, timer, shapes=FLASH_SHAPES, causal=True):
    """The no-lse flash forward at ``shapes`` against its plain version
    and SDPA, f32 and bf16."""
    from tpuflow_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
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
                    causal=True):
    """The forward with lse, the fused and the split backward pairs against
    their plain versions at ``shapes``, f32 and bf16, bit-equal over two
    runs (the split pair also to the fused one), with their times."""
    from tpuflow_torch.ops import flash_attention as fa

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(dt, shp) for dt in ("float32", "bfloat16") for shp in shapes]
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
    for p, q, r in zip(prompts, flags, reqs):
        solo_model = eng._qmodel if q else model
        solo = generate(solo_model, p[None, :], max_new_tokens=NEW_TOKENS,
                        temperature=0.0)[0].cpu().numpy()
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
    return res, flash_launches, int8_launches


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


def train_phase(torch, smi):
    """The training main path through train_gpt, then two profiled steps
    and the flash-vs-einsum step parity."""
    from tpuflow_torch.data.lm import make_lm_loaders
    from tpuflow_torch.device import f32_matmul_precision
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train.gpt import GptTrainConfig, train_gpt

    cfg = GptTrainConfig(
        preset="gpt2", seq_len=1024, batch_size=8, epochs=TRAIN_EPOCHS,
        steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="flash",
        data_axis=1, fsdp_axis=1,
    )
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
                          shards=len(split_shards)),
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

    def save(d, pool=None):
        os.makedirs(d)
        taken = pool.taken if pool is not None else 0
        t0 = time.monotonic()
        raw._write_entries(d, host, policy, pool=pool)
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
    host = raw._gather_host(checkpoint_tree(
        state, scan_layers=cfg.model_config().scan_layers))
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
    epochs at global batch ``R50_BATCH``, cuDNN restricted to its
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
                global_batch_size=R50_BATCH, epochs=R50_EPOCHS)
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


def main() -> int:
    import torch

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
    from tpuflow_torch.device import f32_matmul_precision
    from tpuflow_torch.ops import _build

    smi = _smi_line()
    print(f"gpu: {smi}")
    build_s = _build.build_all()
    print(f"built {', '.join(_build.KERNELS)} in {build_s:.2f} s")

    timer = Timer(torch)
    flash_rows = flash_phase(torch, timer)
    int8_rows = int8_phase(torch, timer)
    bwd_rows = flash_bwd_phase(torch, timer)
    head_rows = head_dim_phase(torch, timer, bwd_rows)
    vit_rows = flash_phase(torch, timer, (VIT_SHAPE,), causal=False)
    vit_bwd_rows = flash_bwd_phase(torch, timer, (VIT_SHAPE,), causal=False)
    del timer
    sl, flash_n, int8_n = slice_phase(torch, smi)
    gen = generation_phase(torch, smi)
    tr, train_n = train_phase(torch, smi)
    main_path = main_path_phase(torch, smi)
    flows = flow_phase(torch, smi)
    image = dict(resnet18=resnet18_flow_leg(torch, smi),
                 resnet50=resnet50_leg(torch, smi))
    with f32_matmul_precision():
        image["vit"] = vit_leg(torch, smi)

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
    kernels += [
        int8_entry("int8_matmul", DECODE_M, int8_n["decode"],
                   "one int8 decode step at M=8: 48 Dense + LM head"),
        int8_entry("int8_matmul_prefill", PREFILL_M, int8_n["prefill"],
                   "49 calls at M=512: 48 Dense + LM head (prefill tile)"),
    ]
    for entry in kernels:
        if entry["name"] in gen_n:
            entry["generation_launches"] = gen_n[entry["name"]]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(gpu=smi, build_s=build_s, flash=flash_rows,
                       int8=int8_rows, flash_bwd=bwd_rows,
                       head_dims=head_rows, slice=sl, generation=gen,
                       train=tr,
                       main_path=main_path, flows=flows, image=image,
                       vit_flash=vit_rows, vit_flash_bwd=vit_bwd_rows,
                       kernels=kernels),
                  fh,
                  indent=1, default=float)
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
