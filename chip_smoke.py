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
   and the fused backward pair (dq, dk/dv) within stated tolerances and
   bit-equal over two runs — with the kernel's, the plain version's and
   one PyTorch library call's device times (profiler trace, L2 flushed
   before every launch) and the least time the card could take.
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
   gradient within stated tolerances.
6. One JSON line with every kernel's numbers, the ``nvidia-smi`` line, and
   as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is absent or the package is not
beside this script. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
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
# torch.profiler traces taken before a trace without the measured
# function's kernels is fatal.
TRACE_ATTEMPTS = 3
DECODE_M = 8      # the engine's slots
PREFILL_M = 512   # the widest prefill bucket the slice phase uses
GEN_PROMPT = 512
NEW_TOKENS = 32
ENGINE_LENS = (5, 300, 64, 17, 129, 250, 33, 200)


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
    print(f"{head}; device ms: kernel {r['ms']:.4f}, plain "
          f"{r['plain_ms']:.4f}, {r['library']} {r['library_ms']:.4f}, "
          f"bound {r['bound_ms']:.4f} ({r['bound_by']}); call ms: kernel "
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


def flash_bwd_phase(torch, timer):
    """The forward with lse and the fused backward pair against their
    plain versions, bit-equal over two runs, with their times."""
    from tpuflow_torch.ops import flash_attention as fa

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(dt, shp) for dt in ("float32", "bfloat16")
             for shp in FLASH_SHAPES] + [("float32", TRAIN_SHAPE)]
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
        again = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))):
            raise AssertionError(f"flash backward {name} {(B, T, H, D)}: "
                                 "two runs differ")
        ro, rlse = fa.blockwise_attention_lse(q, k, v, causal=True)
        rdq, rdelta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=True)
        rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, rdelta,
                                          causal=True)
        tag = f"{name} {(B, T, H, D)}"
        errs = {
            "out": _within(o, ro, *FLASH_TOL[name], f"flash lse fwd {tag}"),
            "lse": _within(lse, rlse, *LSE_TOL, f"lse {tag}"),
            "delta": _within(delta, rdelta, *DELTA_TOL, f"delta {tag}"),
        }
        for key, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            errs[key] = _within(got, want, *BWD_TOL[name], f"{key} {tag}")
        del ro, rlse, rdq, rdelta, rdk, rdv, again

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
        del out_h, qh, kh, vh
        e = q.element_size()
        x = B * T * H * D * e       # one (B, T, H, D) array
        r = B * H * T * 4           # one (B*H, T) f32 row array
        prod = 2 * B * H * D * T * (T + 1) / 2  # one causal T x T x D product
        shape = [B, T, H, D]
        for kern, times, nbytes, ops, err_keys, lib in (
            ("flash_fwd_lse", fwd, 4 * x + r, 2 * prod, ("out", "lse"),
             "sdpa forward"),
            # q, k, v, o, dO, lse in; dq, delta out; S, dP, dQ products
            # plus the row delta.
            ("flash_bwd_dq", bwd_dq, 6 * x + 2 * r,
             3 * prod + 2 * B * T * H * D, ("delta", "dq"),
             "sdpa backward (dq, dk, dv)"),
            # q, k, v, dO, lse, delta in; dk, dv out; S, dP, dV, dK.
            ("flash_bwd_dkv", bwd_dkv, 6 * x + 2 * r, 4 * prod,
             ("dk", "dv"), "sdpa backward (dq, dk, dv)"),
        ):
            bound, by = _bound_ms(nbytes, ops, name)
            rows.append(dict(
                kernel=kern, shape=shape, dtype=name,
                max_abs_err=max(errs[k][0] for k in err_keys),
                share_of_limit=max(errs[k][1] for k in err_keys),
                errors={k: errs[k] for k in err_keys},
                bound_ms=bound, bound_by=by, library=lib, **times,
            ))
            _report(f"{kern} {tag}: max|err| "
                    + ", ".join(f"{k} {errs[k][0]:.3g} ({errs[k][1]:.3f})"
                                for k in err_keys), rows[-1])
        # The pair as one function: q, k, v, o, dO, lse in, dq, dk, dv
        # out; five causal products (S, dP, dQ, dK, dV).
        pair_bound, pair_by = _bound_ms(9 * x + r, 5 * prod, name)
        for row in rows[-2:]:
            row["pair_bound_ms"] = pair_bound
        print(f"backward pair {tag}: kernels {bwd_dq['ms'] + bwd_dkv['ms']:.4f}"
              f" ms, sdpa backward {bwd_dq['library_ms']:.4f} ms, bound "
              f"{pair_bound:.4f} ms ({pair_by}, 5 causal products), "
              "bit-equal over two runs")
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
    fa.launches = im.launches = 0
    t0 = time.monotonic()
    out = generate(model, prompt, max_new_tokens=NEW_TOKENS, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
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
        flash_launches=flash_launches,
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
    fa.launches = im.launches = 0
    t0 = time.monotonic()
    reqs = [
        eng.submit(p, max_new_tokens=NEW_TOKENS, quantize=q)
        for p, q in zip(prompts, flags)
    ]
    eng.run_until_idle()
    torch.cuda.synchronize()
    eng_s = time.monotonic() - t0
    int8_launches, eng_flash = im.launches, fa.launches
    if int8_launches == 0:
        raise AssertionError("the engine's int8 requests never launched the "
                             "int8 kernel")
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
        flash_launches=eng_flash, gpu=smi,
    )
    print(f"engine: {len(reqs)} requests ({sum(flags)} int8), {n_tok} tokens "
          f"in {eng_s:.3f} s = {n_tok / eng_s:.1f} tokens/s, int8 launches "
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
    want = {"flash_fwd_lse": 2 * L * TRAIN_STEPS,
            "flash_bwd_dq": L * TRAIN_STEPS,
            "flash_bwd_dkv": L * TRAIN_STEPS,
            "flash_fwd": L * n_val * TRAIN_EPOCHS}
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_lse = 0
    fa.launches_bwd_dq = fa.launches_bwd_dkv = im.launches = 0
    t0 = time.monotonic()
    res = train_gpt(cfg, log=lambda m: print(f"  {m}"))
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    got = {"flash_fwd_lse": fa.launches_lse,
           "flash_bwd_dq": fa.launches_bwd_dq,
           "flash_bwd_dkv": fa.launches_bwd_dkv,
           "flash_fwd": fa.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"train_gpt launches {got} (want {want}), int8 {im.launches}")
    if got != want or im.launches:
        raise AssertionError(f"train_gpt launches {got}, int8 "
                             f"{im.launches}; want {want} and no int8")
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
    return out, got


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
    del timer
    sl, flash_n, int8_n = slice_phase(torch, smi)
    tr, train_n = train_phase(torch, smi)

    # One JSON entry per kernel. flash: one launch at the generate() leg's
    # shape (f32, 1 x 512 x 12 x 64). int8: the 49 launches of one int8
    # decode step (4 Dense layers x 12 blocks at M = 8, plus the LM head).
    f = next(r for r in flash_rows
             if r["dtype"] == "float32" and r["shape"][1] == GEN_PROMPT)
    per_step = {(k, n): 12 for k, n in DENSE_KN}
    per_step[(768, VOCAB)] = 1
    step = [r for r in int8_rows if r["shape"][0] == DECODE_M]

    def step_sum(key):
        return sum(per_step[tuple(r["shape"][1:])] * r[key] for r in step)

    step_bytes = sum(per_step[tuple(r["shape"][1:])] * r["nbytes"]
                     for r in step)
    step_ops = sum(per_step[tuple(r["shape"][1:])] * 2 * np.prod(r["shape"])
                   for r in step)
    step_bound, step_by = _bound_ms(step_bytes, step_ops, "int8")
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
    # The training kernels at the training leg's shape (f32, 8 x 1024 x 12
    # x 64), with their launches in the train_gpt run.
    replaces = {
        "flash_fwd_lse": "tpuflow/ops/flash_attention.py:180",
        "flash_bwd_dq": "tpuflow/ops/flash_attention.py:499",
        "flash_bwd_dkv": "tpuflow/ops/flash_attention.py:499",
    }
    for r in bwd_rows:
        if r["shape"] != list(TRAIN_SHAPE):
            continue
        src = ("tpuflow_torch/csrc/flash_fwd.cu" if r["kernel"] ==
               "flash_fwd_lse" else "tpuflow_torch/csrc/flash_bwd.cu")
        kernels.append(dict(
            name=r["kernel"], route="cuda", source=src,
            replaces=replaces[r["kernel"]],
            shape="one training layer, f32 (8, 1024, 12, 64), causal",
            launches=train_n[r["kernel"]], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            library=r["library"], call_ms=r["call_ms"],
        ))
    kernels += [
        dict(name="int8_matmul", route="cuda",
             source="tpuflow_torch/csrc/int8_matmul.cu",
             replaces="tpuflow/ops/int8_matmul.py:229",
             shape="one int8 decode step at M=8: 48 Dense + LM head",
             launches=int8_n, max_abs_err=0.0, ms=step_sum("ms"),
             plain_ms=step_sum("plain_ms"), bound_ms=step_bound,
             bound_by=step_by, library_ms=step_sum("library_ms"),
             call_ms=step_sum("call_ms")),
    ]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(gpu=smi, build_s=build_s, flash=flash_rows,
                       int8=int8_rows, flash_bwd=bwd_rows, slice=sl,
                       train=tr, kernels=kernels), fh,
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
