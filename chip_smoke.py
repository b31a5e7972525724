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
4. Serving slice on GPT-2 124M at full width, weights random from a seed:
   ``generate()`` on a 512-token dense prompt (its prefill must launch the
   flash kernel once per layer), then a paged ``ServeEngine`` answering
   fp and int8 requests, each held equal to a solo ``generate()``.
5. Training slice: ``train_gpt`` trains GPT-2 124M (full remat, dropout
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
6. Split + checkpoint leg: the same ``train_gpt`` call with the split
   backward and a checkpoint directory (saves at steps 8 and 16): its 16
   losses bit-equal to step 5's, exact launch counts. Resume leg: the same
   call on a copy of that directory without ``step_16``: an in-run resume
   from step 8, its 8 losses bit-equal to the split leg's last 8 and a
   ``step_16`` whose every shard crc32 equals the split leg's. Save and
   restore seconds and GB/s (host disk of this machine). Then the same
   state's save and restore taken apart outside training: crc32, writes
   with fsync, reads. The directories live under ``build/`` and are
   deleted at the end.
7. The README main path: ``train_fashion_mnist`` (the FashionMNIST MLP at
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
8. The flow layer on the card through the flow CLIs' ``main(argv)``
   (``flow_phase``): the README contract (``TorchTrain`` 2 epochs on the
   full-size synthetic set, a ``--from-run`` warm start whose first
   val_loss is below run 1's, a triggered ``TorchEval`` at batch 512 whose
   count matches the best accuracy and whose card holds "Error analysis",
   a pathspec eval, the "no checkpoint source" error; no kernel launches),
   then ``TorchGptTrain`` at GPT-2 124M width on the flash kernels (exact
   launch counts, a finite last loss) and the triggered ``TorchGptEval``
   (a finite test loss, exact no-lse launches). Each flow's wall, the
   wrapped call's wall and the flow layer's overhead, the GPT step ms
   inside the flow, ``profile.json``'s device and peak bytes.
9. One JSON line with every kernel's numbers (the int8 matmul both as one
   decode step at M = 8 and as the same 49 products at M = 512; the
   training kernels in f32 and bf16, their launches from the f32 legs and
   the bf16 leg, which runs the fused pair, so the bf16 split variants'
   count there is 0; the wide-head kernels at D = 512, their launches the
   wide-head runs the main paths' counters read; ``flow_launches``: the
   flash kernels' launches in the flow phase), the ``nvidia-smi`` line,
   and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is absent or the package is not
beside this script. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# Rounds of the checkpoint IO phase (a save, writes, a restore, reads).
CKPT_IO_REPS = 2
# torch.profiler traces taken before a trace without the measured
# function's kernels is fatal.
TRACE_ATTEMPTS = 3
# Head dims the kernels are not instantiated at (96, run zero-padded at
# 128), the widest instantiation (256) and a wide head (512, the wide-head
# kernels that contract over D in chunks), at one prefill layer's shape.
HEAD_DIM_SHAPES = ((1, 1024, 12, 96), (1, 1024, 12, 256), (1, 1024, 12, 512))
# The head dim whose rows also time the plain versions and SDPA, and enter
# the kernels JSON line; each kernel's outputs in the head-dim phase's
# errors (the split pair's equal the fused pair's bit for bit).
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
# The flow phase: the GPT-2 train flow at 124M width (2 epochs of 4 steps
# at 8 x 1024 on the flash kernels), then the triggered eval flow sampling
# this many tokens three times.
FLOW_GPT_ARGS = ("--preset", "gpt2", "--seq-len", "1024", "--batch-size",
                 "8", "--epochs", "2", "--steps-per-epoch", "4",
                 "--attn-impl", "flash", "--data-axis", "1", "--fsdp-axis",
                 "1")
FLOW_GPT_BATCH, FLOW_GPT_STEPS = 8, 8
FLOW_SAMPLE_TOKENS = 16


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


def flash_phase(torch, timer):
    from tpuflow_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        atol, rtol = FLASH_TOL[name]
        for B, T, H, D in FLASH_SHAPES:
            q, k, v = (
                torch.randn(B, T, H, D, device="cuda", generator=g).to(dt)
                for _ in range(3)
            )
            out = fa.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            ref = fa.blockwise_attention(q, k, v, causal=True)
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
                lambda: fa.flash_attention(q, k, v, causal=True),
                lambda: fa.blockwise_attention(q, k, v, causal=True),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True
                ),
            )
            esize = q.element_size()
            nbytes = 4 * B * T * H * D * esize  # q, k, v read; o written
            ops = 4 * B * H * D * T * (T + 1) / 2  # causal half, 2 products
            bound, by = _bound_ms(nbytes, ops, name)
            rows.append(dict(
                shape=[B, T, H, D], dtype=name, max_abs_err=max_err,
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


def _flash_work(B, T, H, D, esize) -> dict:
    """(bytes, operations) the function of each flash kernel needs at a
    causal (B, T, H, D) shape: each input read once, each output written
    once, and the causal half of each T x T x D product."""
    x = B * T * H * D * esize  # one (B, T, H, D) array
    r = B * H * T * 4          # one (B*H, T) f32 row array
    prod = 2 * B * H * D * T * (T + 1) / 2  # one causal T x T x D product
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


def flash_bwd_phase(torch, timer):
    """The forward with lse, the fused and the split backward pairs against
    their plain versions, bit-equal over two runs (the split pair also to
    the fused one), with their times."""
    from tpuflow_torch.ops import flash_attention as fa

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(dt, shp) for dt in ("float32", "bfloat16")
             for shp in FLASH_SHAPES + (TRAIN_SHAPE,)]
    rows = []
    for name, (B, T, H, D) in cases:
        dt = getattr(torch, name)
        q, k, v, do = (
            torch.randn(B, T, H, D, device="cuda", generator=g).to(dt)
            for _ in range(4)
        )
        o, lse = fa.flash_fwd_lse(q, k, v, causal=True)
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal=True)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)
        torch.cuda.synchronize()
        tag = f"{name} {(B, T, H, D)}"
        again = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
        split = fa.flash_bwd_split(q, k, v, o, lse, do, causal=True)
        split_again = fa.flash_bwd_split(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        for what, got in (("fused, second run", again),
                          ("split", split), ("split, second run",
                                             split_again)):
            for key, a, b in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"flash backward {tag}: {what} {key} differs from "
                        "the fused kernels' first run")
        ro, rlse = fa.blockwise_attention_lse(q, k, v, causal=True)
        rdq, rdelta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=True)
        rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, rdelta,
                                          causal=True)
        errs = {
            "out": _within(o, ro, *FLASH_TOL[name], f"flash lse fwd {tag}"),
            "lse": _within(lse, rlse, *LSE_TOL, f"lse {tag}"),
            "delta": _within(delta, rdelta, *DELTA_TOL, f"delta {tag}"),
        }
        for key, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            errs[key] = _within(got, want, *BWD_TOL[name], f"{key} {tag}")
        del ro, rlse, rdq, rdelta, rdk, rdv, again, split_again
        sdq = fa.flash_bwd_dq_split_plain(q, k, v, o, lse, do, causal=True)
        sdk, sdv = fa.flash_bwd_dkv_split_plain(q, k, v, o, lse, do,
                                                causal=True)
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
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

        out_h = sdpa()

        def sdpa_bwd():
            return torch.autograd.grad(out_h, (qh, kh, vh), doh,
                                       retain_graph=True)

        fwd = _measure(
            timer,
            lambda: fa.flash_fwd_lse(q, k, v, causal=True),
            lambda: fa.blockwise_attention_lse(q, k, v, causal=True),
            sdpa,
        )
        bwd_dq = _measure(
            timer,
            lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, causal=True),
            lambda: fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=True),
            sdpa_bwd,
        )
        bwd_dkv = _measure(
            timer,
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                           causal=True),
            sdpa_bwd,
        )
        split_dq = _measure(
            timer,
            lambda: fa.flash_bwd_dq_split(q, k, v, o, lse, do, causal=True),
            lambda: fa.flash_bwd_dq_split_plain(q, k, v, o, lse, do,
                                                causal=True),
            sdpa_bwd,
        )
        split_dkv = _measure(
            timer,
            lambda: fa.flash_bwd_dkv_split(q, k, v, o, lse, do, causal=True),
            lambda: fa.flash_bwd_dkv_split_plain(q, k, v, o, lse, do,
                                                 causal=True),
            sdpa_bwd,
        )
        del out_h, qh, kh, vh
        shape = [B, T, H, D]
        lib = "sdpa backward (dq, dk, dv)"
        work = _flash_work(B, T, H, D, q.element_size())
        x = B * T * H * D * q.element_size()
        r = B * H * T * 4
        prod = 2 * B * H * D * T * (T + 1) / 2
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
                kernel=kern, shape=shape, dtype=name,
                max_abs_err=max(errs[k][0] for k in err_keys),
                share_of_limit=max(errs[k][1] for k in err_keys),
                errors={k: errs[k] for k in err_keys},
                bound_ms=bound, bound_by=by, library=libname, **times,
            ))
            _report(f"{kern} {tag}: max|err| "
                    + ", ".join(f"{k} {errs[k][0]:.3g} ({errs[k][1]:.3f})"
                                for k in err_keys), rows[-1])
        # The pair as one function: q, k, v, o, dO, lse in, dq, dk, dv
        # out; five causal products (S, dP, dQ, dK, dV).
        pair_bound, pair_by = _bound_ms(9 * x + r, 5 * prod, name)
        for row in rows[-4:]:
            row["pair_bound_ms"] = pair_bound
        print(f"backward pairs {tag}: fused "
              f"{bwd_dq['ms'] + bwd_dkv['ms']:.4f} ms, split "
              f"{split_dq['ms'] + split_dkv['ms']:.4f} ms, sdpa backward "
              f"{bwd_dq['library_ms']:.4f} ms, bound {pair_bound:.4f} ms "
              f"({pair_by}, 5 causal products); both bit-equal over two "
              "runs, split bit-equal to fused")
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
        steps = set(os.listdir(split_dir))
        if steps != {f"step_{spe}", f"step_{TRAIN_STEPS}"}:
            raise AssertionError(f"split leg left {steps}")
        last = os.path.join(split_dir, f"step_{TRAIN_STEPS}")
        if res.checkpoint is None or res.checkpoint.path != last:
            raise AssertionError(f"split leg handle {res.checkpoint}")
        split_shards = _shards(last)
        saves = res.checkpoint_io["saves"]
        print(f"split leg: {TRAIN_STEPS} losses bit-equal to the fused "
              f"leg's; {_io_line('save', saves)} [{smi}]")

        # --- the resume leg: the directory without its last step.
        resume_dir = os.path.join(root, "resume")
        shutil.copytree(split_dir, resume_dir,
                        ignore=shutil.ignore_patterns(f"step_{TRAIN_STEPS}"))
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
        print(f"resume leg: resumed at step {spe}, {spe} losses bit-equal "
              f"to the split leg's last {spe}, step_{TRAIN_STEPS}: "
              f"{len(resumed)} shard crc32s equal; "
              f"{_io_line('restore', io2['restores'])}; "
              f"{_io_line('save', io2['saves'])} (this machine's host "
              f"disk) [{smi}]")
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


def ckpt_io_phase(torch, smi, cfg) -> dict:
    """The pieces of a checkpoint save and restore of the state the split
    leg saves, on this machine's host disk, outside training: the crc32 of
    every leaf (the save computes them before the first write), the save's
    file work (crc32, the leaf files written with fsync through its 4-file
    pool, the manifest), the leaf writes alone, a restore (reads and crc32
    checks, leaf after leaf, from the page cache the save left) and its
    reads alone. ``CKPT_IO_REPS`` rounds."""
    from concurrent.futures import ThreadPoolExecutor

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
    t0 = time.monotonic()
    for b in bufs:
        raw._crc32(b)
    crc_s = time.monotonic() - t0
    times = {k: [] for k in ("save_s", "write_s", "restore_s", "read_s")}
    root = tempfile.mkdtemp(prefix="chip_smoke_io_",
                            dir=os.path.join(REPO, "build"))
    try:
        for rep in range(CKPT_IO_REPS):
            d = os.path.join(root, f"save{rep}")
            os.makedirs(d)
            t0 = time.monotonic()
            raw._write_entries(d, host, raw.RetryPolicy())
            times["save_s"].append(time.monotonic() - t0)
            w = os.path.join(root, f"write{rep}")
            os.makedirs(w)
            paths = [os.path.join(w, f"leaf_{i:05d}.bin")
                     for i in range(len(bufs))]
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=4) as ex:
                for fut in [ex.submit(raw.write_file, p, b)
                            for p, b in zip(paths, bufs)]:
                    fut.result()
            times["write_s"].append(time.monotonic() - t0)
            t0 = time.monotonic()
            got = raw.restore_raw(d)  # crc32-verified
            times["restore_s"].append(time.monotonic() - t0)
            del got
            t0 = time.monotonic()
            for p, b in zip(paths, bufs):
                raw.read_file(p, b.nbytes)
            times["read_s"].append(time.monotonic() - t0)
            shutil.rmtree(d)
            shutil.rmtree(w)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = dict(bytes=nbytes, leaves=len(bufs), crc32_s=crc_s, **times, gpu=smi)
    print(f"checkpoint IO, {nbytes / 1e9:.3f} GB in {len(bufs)} leaves "
          f"(this machine's host disk and page cache): crc32 {crc_s:.3f} s; "
          + "; ".join(f"{k[:-2]} " + ", ".join(f"{t:.3f}" for t in v) + " s"
                      for k, v in times.items()) + f" [{smi}]")
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
    from tpuflow_torch.device import pin_f32_matmul_precision
    from tpuflow_torch.models.gpt2 import GPT2
    from tpuflow_torch.models.losses import cross_entropy_loss

    pin_f32_matmul_precision()
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
    copies included) beside their bound and the D = 64 kernels' at
    (1, 1024, 12, 64). At D = 512 also the plain versions' and SDPA's
    device ms."""
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
            if D == WIDE_D:
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
                del qh, kh, vh, out_h
            rows.append(row)
            print(f"head dim {D} (kernel {fa._kernel_dim(D)}) {tag}: "
                  "max|err| " + ", ".join(f"{k} {e[0]:.3g} ({e[1]:.3f})"
                                          for k, e in errs.items())
                  + "; device ms (bound, D = 64 beside): " + ", ".join(
                      f"{k} {ms[k]:.4f} ({bound[k][0]:.4f} {bound[k][1]}"
                      + (f", {d64[k]:.4f})" if k in d64 else ")")
                      for k in ms))
            if D == WIDE_D:
                print(f"head dim {D} {tag}: plain ms " + ", ".join(
                    f"{k} {row['plain_ms'][k]:.3f}" for k in ms)
                    + f"; sdpa forward {row['library_ms']['flash_fwd_lse']:.4f}"
                    f", sdpa backward {row['library_ms']['flash_bwd_dq']:.4f}")
    return rows


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
        kept = sorted(int(d.split("_")[1]) for d in os.listdir(ckdir))
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
            f"step_{MLP_EPOCHS}"))
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
    7. ``TorchGptEval run --triggered --attn-impl flash``: a finite test
       loss, and the no-lse forward launched once a layer for every
       validation batch and every sample's prefill.

    Each flow's wall, the wrapped call's wall (``train_model``,
    ``map_batches``, ``train_gpt``, ``run_validation`` + ``generate``)
    and the difference, the flow layer's own overhead; the GPT step ms
    inside the flow; the train step's ``profile.json`` (device kind, peak
    bytes). Counters are zeroed before leg 6 and before leg 7 and read
    after each."""
    from tpuflow_torch.data.lm import lm_test_loader
    from tpuflow_torch.flow import Run, store
    from tpuflow_torch.flows import eval_flow, gpt_eval_flow, gpt_flow
    from tpuflow_torch.flows import my_torch_module as m
    from tpuflow_torch.flows import train_flow
    from tpuflow_torch.infer import generate as gen_mod
    from tpuflow_torch.ops import flash_attention as fa
    from tpuflow_torch.ops import int8_matmul as im
    from tpuflow_torch.train import gpt as gpt_mod
    from tpuflow_torch.train import step as step_mod

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
                  str(FLOW_SAMPLE_TOKENS), "--attn-impl", "flash"],
                 [(step_mod, "run_validation"), (gen_mod, "generate")])
        eval_n = _counters(fa, im)
        if ge.meta.get("triggered_by") != g1.pathspec:
            raise AssertionError(f"GPT eval triggered by "
                                 f"{ge.meta.get('triggered_by')}")
        want = _launches(flash_fwd=L * (n_val + 3))
        if eval_n != want:
            raise AssertionError(f"TorchGptEval launched {eval_n}, want "
                                 f"{want}")
        test_loss = ge.data.test_loss
        if not np.isfinite(test_loss):
            raise AssertionError(f"TorchGptEval test loss {test_loss}")
        print(f"flow TorchGptEval: test loss {test_loss:.4f}, ppl "
              f"{ge.data.test_ppl:.2f}; greedy {ge.data.samples[0][1]!r}; "
              f"launches {eval_n} [{smi}]")
    finally:
        shutil.rmtree(home, ignore_errors=True)
    return dict(legs=legs, mlp_launches=mlp_n, gpt_train_launches=train_n,
                gpt_eval_launches=eval_n, gpt_step_ms=step_ms,
                gpt_tokens_per_s=tok_s, gpt_metrics=hist,
                gpt_eval_test_loss=test_loss,
                profile_device=kind,
                profile_platform=prof["platform"], profile_peak_bytes=peak,
                mlp_misclassified=mis, mlp_implied=implied, gpu=smi)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
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
    del timer
    sl, flash_n, int8_n = slice_phase(torch, smi)
    tr, train_n = train_phase(torch, smi)
    main_path = main_path_phase(torch, smi)
    flows = flow_phase(torch, smi)

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
                 train_n, tr["bf16"]["launches"], tr["split_launches"],
                 tr["split_ckpt"]["resume"]["launches"],
                 main_path["launches"], flows["mlp_launches"],
                 flows["gpt_train_launches"], flows["gpt_eval_launches"]]
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
    kernels += [
        int8_entry("int8_matmul", DECODE_M, int8_n["decode"],
                   "one int8 decode step at M=8: 48 Dense + LM head"),
        int8_entry("int8_matmul_prefill", PREFILL_M, int8_n["prefill"],
                   "49 calls at M=512: 48 Dense + LM head (prefill tile)"),
    ]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(gpu=smi, build_s=build_s, flash=flash_rows,
                       int8=int8_rows, flash_bwd=bwd_rows,
                       head_dims=head_rows, slice=sl, train=tr,
                       main_path=main_path, flows=flows, kernels=kernels),
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
