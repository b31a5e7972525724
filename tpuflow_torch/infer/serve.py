"""Continuous-batching serving engine over a paged KV cache (or, with
``paged=False``, contiguous slot rows).

Counterpart of the core of ``tpuflow/infer/serve.py``:

- **Paged KV.** One fixed pool of ``(n_pages, page_size)`` pages per layer
  (``PagedKVCache``) plus a per-slot page table. Page 0 is the TRASH page:
  dead slots and out-of-range writes land there, nothing reads it.
  ``PagePool`` does the host-side accounting: free list, refcounted
  shared-prefix pages keyed by a sha1 chain over the prompt, LRU eviction of
  idle prefix pages, and admission backpressure when the pool is full.
- **Admission.** A waiting request is LEFT-padded to a bucket width and
  prefilled on a (1, W) row cache; the page insert strips the padding (roll
  by -pad) and copies the row's pages into the pool slots its table names,
  skipping shared prefix pages.
- **Contiguous slot rows** (``paged=False``, the JAX engine's
  ``TPUFLOW_SERVE_PAGED=0``): one (n_ctx) cache row a slot; the prefill
  row is copied in whole, its bucket pads kept (the slot decodes at
  length W with ``pad_lens`` W - L), so a request admits only when
  ``W + max_new_tokens <= n_ctx``. No page pool, no prefix cache, no KV
  export or import, no speculative decoding (the JAX engine refuses it:
  a verify block's write clamps at the row's n_ctx edge). It is the
  reference the paged engine's residency is measured against
  (``residency_efficiency``).
- **Decode blocks.** ``decode_block`` single-token steps over every slot at
  once, with per-slot eos / budget / capacity freezing, one host sync per
  block. Greedy only: every request's tokens equal a solo
  ``generate(temperature=0)`` of its prompt.
- **Per-request int8.** ``quant='fused_native'`` builds the W8A8 view of
  the same weights (``'weight_only'`` the weight-only one);
  ``submit(quantize=True)`` routes a request to it.
- **MoE models** run every path. Each call routes its own T (a bucket's
  pads, a chunk, a prefix-cache suffix, a verify chunk), as the JAX
  engine's calls do, so a request's tokens equal the JAX engine's for the
  same submissions, and equal solo ``generate()`` only where the call
  structure is the same (``models/moe.py``). A decode step keeps every
  token and its products are per row, so a request's tokens do not depend
  on the other slots.
- **Per-request speculative decode.** ``speculative=K`` arms a verify
  block: each live slot drafts K tokens on the host (``ngram_draft`` over
  its prompt and tokens so far), ONE (S, K+1) forward over the paged cache
  verifies every slot's ``[cur, draft...]``, and each row commits its own
  accepted prefix plus the bonus token, capped by its budget, the cache's
  capacity and its first eos. Rows advance independently: the rejected
  tail's k/v lies past the row's new frontier, masked until the row
  overwrites it. ``submit(speculative=False)`` opts a request out.

The groups — (fp, int8) x (plain, speculative) — share the one pool; each
group's block runs with every other group masked out of its live set (a
masked row only writes its own frozen frontier columns, which its own
group overwrites before reading them).

- **Disaggregated prefill and decode.** A ``prefill``-role engine's
  ``ship`` runs the admission prefill once and commits the request's KV
  pages, their sha1 digest chain and the first greedy token to a
  crash-safe store (``infer/kv_store.py``); a ``decode``-role engine's
  ``submit(kv_key=)`` imports the set and admits the request already
  prefilled. A prompt that extends a shipped one imports the covered pages
  and prefills the rest; a torn, missing or mismatched set rides local
  prefill (the ``kv_fallback`` trace phase), never an error.
- **Tiered prefix cache.** With ``kv_host_mb`` / ``kv_disk_dir``, a prefix
  page evicted from the pool spills to host DRAM, then to node-local disk,
  and a later prompt with that prefix promotes it back instead of
  recomputing it; the disk tier survives an engine restart.

Admission has three modes: ``ship`` (an exact shipped set: its committed
first token, no prefill), ``feed`` (restored and shared pages cover
exactly the first ``L - 1`` prompt tokens: the decode block is fed
``prompt[L - 1]`` at length ``L - 1``, writes it into a fresh private
page and emits the first token) and ``prefill`` (the
classic path, restored pages masked off its page write). Each request
keeps a lifecycle trace (``ServeRequest.trace``), mirrored as
``serve.trace`` events when an ``obs`` recorder is configured.

- **Serving observatory.** ``ServeEngine.ledger`` (``obs/serve_ledger.py``)
  charges every second of the engine's wall to one bucket (``prefill``,
  ``decode``, ``verify``, ``insert``, ``host_sched``, ``idle``), keeps TTFT
  and ITL by traffic group and counts declared-SLO violations
  (``slo_ttft_ms``, ``slo_itl_ms``); each terminal request writes one
  access-log line beside the recorder's event files; every scheduler
  iteration feeds the process's live goodput ledger, which
  ``/metrics`` and ``/status`` serve. A bucket ends at a host sync the path
  already pays (a prefill at its first token's readback, a decode block
  at its tokens' readback); ``insert`` holds the host side of the page
  copies, whose device time lands in the next synced bucket.
- **Device observatory.** The engine polls the card's memory gauges on
  its scheduler fence (``obs/device.py``; the first iteration and every
  64th, throttled by ``hbm_poll_s``), records the first fenced run of
  each signature (``prefill@<W>``, ``decode``, ``verify``, ``insert``,
  ``restore``; ``_q`` the int8 path's) in its program ledger
  (``ServeEngine.programs``, written as ``programs.json`` with the kernel
  libraries and a budget check by ``collect_program_ledger``), and feeds
  an anomaly capturer (``capture=``, ``obs/profcap.py``) its ITL
  observations and SLO breaches.
- **The long-lived loop.** ``serve_forever`` steps the engine under a
  lock it shares with the replica's ``/generate`` gateway
  (``infer/frontdoor.py``), stamps the heartbeat every iteration, starts
  the ``/metrics`` + ``/status`` export, and drains on SIGTERM: no new
  admissions, the live slots finish, queued requests end ``drained``.

- **Request tracing.** A request submitted with a propagated trace context
  (``submit(trace=)``, from the gateway; ``obs/trace.py``) carries its
  trace id on its lifecycle events, escalates the trace on an SLO breach,
  pins it as its TTFT and ITL exemplars, and flushes its lifecycle as
  spans when it completes or drains.

PyTorch runs eagerly, so the JAX engine's jit programs, warmup and
never-recompile accounting have no counterpart here (its AOT program
ledger becomes the first-run ledger above). A fleet of these
engines sits behind ``infer/router.py``'s ``Router`` and
``infer/frontdoor.py``'s ``FrontDoor``. Where the JAX engine reads
``TPUFLOW_SERVE_*`` / ``TPUFLOW_KV_*`` / ``TPUFLOW_ROUTER_GATEWAY`` /
``TPUFLOW_OBS_HTTP_*`` / ``TPUFLOW_TRACE*`` knobs, this one takes
arguments.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from tpuflow_torch import obs
from tpuflow_torch.device import f32_matmul_precision
from tpuflow_torch.infer import kv_store as _kvstore
from tpuflow_torch.infer.generate import (
    chunked_prefill,
    normalize_prefill_chunk,
    prompt_lens_to_pad_lens,
)
from tpuflow_torch.infer.quant import (
    QuantizedModel,
    canonical_mode,
    quantize_model,
)
from tpuflow_torch.infer.speculative import ngram_draft
from tpuflow_torch.obs import device as _obs_device
from tpuflow_torch.obs import profcap as _profcap
from tpuflow_torch.obs import serve_ledger as _ledger
from tpuflow_torch.obs import trace as _reqtrace


def resolve_serve_quant(quant=None) -> str | None:
    """Per-request-int8 mode from the ctor arg: None/False = disabled,
    True = fused-native, else any quantization-mode spelling
    (``fused_native``/``mxu``/``weight_only``/``weight``)."""
    if quant is None or quant is False:
        return None
    if quant is True:
        return "mxu"
    return canonical_mode(quant)


def resolve_spec_draft(speculative=None) -> int:
    """Per-request speculative draft length from the ctor arg: None/False
    = off (0), True = the default draft of 4, an int = the draft length."""
    if speculative is None or speculative is False:
        return 0
    if speculative is True:
        return 4
    k = int(speculative)
    if k < 0:
        raise ValueError(f"speculative draft length must be >= 0, got {k}")
    return k


def resolve_serve_role(role=None) -> str:
    """Serving phase this engine advertises: ``prefill`` takes ship hops,
    ``decode`` takes admissions, ``both`` (None, the default) is classic
    colocated serving. The role never gates the engine's behaviour (a
    decode engine still prefills locally when a shipped set is torn); it
    is placement advice for a router. A bad value raises."""
    if role is None:
        return "both"
    r = str(role).strip().lower()
    if r not in ("prefill", "decode", "both"):
        raise ValueError(f"role must be prefill|decode|both, got {role!r}")
    return r


def resolve_page_size(n_ctx: int, page_size=None) -> int:
    """Page width in tokens (default 16, reduced to the largest divisor of
    ``n_ctx`` at or below it). An explicit value must divide ``n_ctx``."""
    if page_size is not None:
        ps = int(page_size)
        if ps < 1 or n_ctx % ps:
            raise ValueError(
                f"page_size must be >= 1 and divide n_ctx={n_ctx}, got {ps}"
            )
        return ps
    ps = max(min(16, n_ctx), 1)
    while n_ctx % ps:
        ps -= 1
    return ps


def default_buckets(n_ctx: int) -> list[int]:
    """Power-of-two prefill-width ladder from 16, topped by ``n_ctx - 1``
    (the widest admittable width)."""
    top = max(n_ctx - 1, 1)
    out: list[int] = []
    w = min(16, top)
    while w < top:
        out.append(w)
        w *= 2
    out.append(top)
    return out


def resolve_buckets(n_ctx: int, buckets=None) -> list[int]:
    """Bucket widths from the explicit arg or the default ladder —
    deduped, ascending, capped at ``n_ctx - 1``."""
    if buckets is None:
        return default_buckets(n_ctx)
    out = sorted({int(b) for b in buckets if 1 <= int(b) <= n_ctx - 1})
    if not out:
        raise ValueError(
            f"no usable prefill bucket in {buckets!r} (need 1 <= b <= "
            f"n_ctx - 1 = {n_ctx - 1})"
        )
    return out


def _host_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a dtype numpy holds: bfloat16 as its int16 bits."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _device_view(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`_host_view` for a pool of ``dtype``."""
    return t.view(dtype) if dtype == torch.bfloat16 else t


class PagePool:
    """Host-side accounting for the paged KV cache: free-list allocation,
    shared-prefix refcounts, and LRU eviction of idle cached prefix pages.
    Pure Python/numpy; the device only sees the resulting page tables.

    Page 0 is the reserved TRASH page: never allocated, never read.

    Prefix sharing: page j of a prompt is shareable when it is FULLY covered
    by prompt tokens (decode writes start at the prompt length, so shared
    pages are never written) and is keyed by the sha1 of the prompt prefix
    through that page. A matched page's refcount bumps instead of
    allocating; at release, refcount-0 cached pages go IDLE (still
    matchable) and are only reclaimed LRU-first under pool pressure.

    Tiered spill: with ``tier_cache`` (a ``kv_store.TierCache``) and a
    ``page_reader`` (page id -> host bundle), an evicted prefix page's
    content drops to host DRAM / node-local disk instead of being
    forgotten, and ``acquire`` extends the digest-chain walk into the lower
    tiers: matched lower-tier pages are freshly allocated here and reported
    by :meth:`take_promotions`, so the engine restores their bytes instead
    of recomputing them. Without a tier cache every path is the untiered
    pool's."""

    def __init__(self, n_pages: int, page_size: int,
                 prefix_cache: bool = True, tier_cache=None,
                 page_reader=None):
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the reserved trash "
                f"page), got {n_pages}"
            )
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.prefix_cache = bool(prefix_cache)
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self._ref: dict[int, int] = {}
        self._hash_to_page: dict[bytes, int] = {}
        self._page_hash: dict[int, bytes] = {}
        self._idle: collections.OrderedDict[int, None] = (
            collections.OrderedDict()
        )
        self.prefix_hits = 0
        self.prefix_lookups = 0
        self.evictions = 0
        self.tier = tier_cache
        self._page_reader = page_reader
        self._pending_promote: list[tuple[int, bytes, str]] = []
        self.tier_hits = 0

    @property
    def usable_pages(self) -> int:
        """Pages a single request could ever hold (pool minus trash)."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        """Pages allocatable right now: truly free + idle-evictable."""
        return len(self._free) + len(self._idle)

    @property
    def allocated_pages(self) -> int:
        """Pages currently held by at least one live request."""
        return len(self._ref)

    def prefix_digests(self, prompt) -> list[bytes]:
        """Chain keys for every FULLY-prompt-covered page, in order."""
        if not self.prefix_cache:
            return []
        return _kvstore.chain_digests(prompt, self.page_size)

    def match_len(self, digests: list[bytes]) -> int:
        """Longest cached prefix-page chain (no side effects)."""
        m = 0
        for d in digests:
            if d not in self._hash_to_page:
                break
            m += 1
        return m

    def can_fit(self, need: int, matched: int) -> bool:
        return need - matched <= self.free_pages

    def acquire(self, prompt, need: int) -> tuple[list[int], int] | None:
        """Map ``need`` pages for a request whose prompt may share a cached
        prefix. Returns ``(page_ids, matched)`` — the first ``matched`` ids
        are shared prefix pages, the rest freshly allocated — or None when
        the pool cannot fit the request (the caller leaves it queued).
        Fresh full-prompt pages register in the prefix cache."""
        digests = self.prefix_digests(prompt)
        matched = min(self.match_len(digests), need)
        self._pending_promote = []
        if self.tier is not None:
            # The chain walk goes on into the lower tiers, contiguously
            # from where the pool's match broke: each hit gets a fresh
            # page below (registered like any full-prompt page) whose
            # bytes the engine restores from the tier.
            j = matched
            while j < min(len(digests), need):
                tier = self.tier.locate(digests[j])
                if tier is None:
                    break
                self._pending_promote.append((j, digests[j], tier))
                j += 1
        if not self.can_fit(need, matched):
            self._pending_promote = []
            return None
        self.prefix_lookups += len(digests[:need])
        self.prefix_hits += matched
        ids: list[int] = []
        for d in digests[:matched]:
            pid = self._hash_to_page[d]
            if self._ref.get(pid, 0) == 0:
                self._idle.pop(pid, None)
            self._ref[pid] = self._ref.get(pid, 0) + 1
            ids.append(pid)
        for j in range(matched, need):
            pid = self._alloc_one()
            self._ref[pid] = 1
            ids.append(pid)
            if j < len(digests) and digests[j] not in self._hash_to_page:
                self._hash_to_page[digests[j]] = pid
                self._page_hash[pid] = digests[j]
        return ids, matched

    def take_promotions(self) -> list[tuple[int, bytes, str]]:
        """The last ``acquire``'s lower-tier matches as ``(page_index,
        digest, tier)``, consumed by the engine, which fetches each bundle
        and writes it back into the pool."""
        out, self._pending_promote = self._pending_promote, []
        return out

    def _alloc_one(self) -> int:
        if self._free:
            return self._free.pop()
        pid, _ = self._idle.popitem(last=False)  # LRU-first eviction
        d = self._page_hash.pop(pid)
        del self._hash_to_page[d]
        self.evictions += 1
        if self.tier is not None and self._page_reader is not None:
            # Spill instead of forget: the page's bytes drop a tier and
            # stay findable through the tier cache's digest index.
            tier = self.tier.spill(d, self._page_reader(pid))
            if tier is not None:
                obs.event("serve.tier_spill", page=pid, tier=tier)
        obs.event("serve.page_evict", page=pid)
        return pid

    def release(self, page_ids) -> None:
        """Drop one ownership of each page; refcount-0 cached prefix pages
        go idle (matchable until evicted), private pages go free."""
        for pid in dict.fromkeys(int(p) for p in page_ids):
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                del self._ref[pid]
                if pid in self._page_hash:
                    self._idle[pid] = None
                    self._idle.move_to_end(pid)
                else:
                    self._free.append(pid)


@dataclasses.dataclass
class ServeRequest:
    """One request's lifecycle, owned by the engine that created it."""

    id: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int
    eos_id: int | None
    t_submit: float
    quantize: bool = False  # int8 numeric path (engine must be armed)
    speculative: bool = False  # rides the verify block (engine armed)
    bucket: int | None = None
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    state: str = "queued"  # queued | running | done
    finish_reason: str | None = None
    # Lifecycle trace: one {"phase", "t", ...} dict a transition, mirrored
    # as serve.trace events; the last backpressure reason while queued.
    trace: list[dict] = dataclasses.field(default_factory=list)
    queue_reason: str | None = None
    # Serving observatory: the per-block ITL observations (block wall /
    # tokens committed: what the SLO gate and the access log read), the
    # SLO violation count, the drain mark and the last harvest's time.
    itl_s: list[float] = dataclasses.field(default_factory=list)
    slo_violations: int = 0
    drained: bool = False
    t_last_tick: float | None = None
    # A validated KVPageSet loaded at submit (kv_key=): its pages restore
    # at admission instead of being recomputed; None: local prefill.
    kv_import: _kvstore.KVPageSet | None = None
    # The request's trace context (obs/trace.py::TraceContext) when it
    # arrived through a front door, else None: the untraced path stays
    # one ``is not None`` check.
    trace_ctx: object = None

    @property
    def done(self) -> bool:
        return self.state == "done"

    @property
    def group(self) -> str:
        """Traffic-group label: (fp|int8).(plain|spec), the scheduler's
        decode-block partition, the split the SLO histograms report by."""
        return _ledger.group_key(self.quantize, self.speculative)

    @property
    def terminal_phase(self) -> str | None:
        """The trace's terminal phase (complete | drained), or None while
        the request is still in flight."""
        for t in reversed(self.trace):
            if t.get("phase") in ("complete", "drained"):
                return t["phase"]
        return None

    @property
    def ttft_s(self) -> float | None:
        """Submit → first generated token (the prefill logits' argmax)."""
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def decode_tokens_per_s(self) -> float | None:
        """Post-first-token decode rate."""
        if self.t_done is None or self.t_first is None:
            return None
        n = len(self.tokens) - 1
        dur = self.t_done - self.t_first
        if n <= 0 or dur <= 0:
            return None
        return n / dur

    def result(self) -> np.ndarray:
        """Generated tokens so far (complete once ``done``)."""
        return np.asarray(self.tokens, np.int32)


class ServeEngine:
    """Request-level continuous-batching engine over one model, paged
    (``paged=False``: contiguous slot rows, see the module docstring).

    ``model`` is a ``GPT2`` (fp), or a ``QuantizedModel`` with ``quant``
    unset; ``quant='fused_native'`` (or ``'weight_only'``) arms an int8
    path beside the fp one, ``speculative=K`` the verify block with drafts
    of K tokens from ``spec_ngram``-gram lookup. The engine runs on the
    model's device.

    Disaggregated serving: ``role`` (``prefill`` | ``decode`` | ``both``)
    is the phase it advertises, kept in ``self.role`` and carried by the
    replica's ``/status`` row, from which a router places ship hops on
    ``prefill`` replicas and requests elsewhere. ``kv_store_dir`` is the shared
    page-set store ``ship`` commits to and ``submit(kv_key=)`` imports
    from; ``kv_host_mb`` and ``kv_disk_dir`` arm the tiered prefix cache
    (host DRAM budget, node-local disk directory; a ``TierCache`` with its
    default index bound and an unbounded disk). With none of them the
    engine is the classic one.

    Serving observatory: ``slo_ttft_ms`` / ``slo_itl_ms`` declare the TTFT
    and per-block ITL SLOs in milliseconds (None: off; a value that is
    not a positive number raises ``ValueError``), the JAX engine's
    ``TPUFLOW_SERVE_SLO_*_MS``;
    ``access_log=False`` disarms the per-request access log
    (``TPUFLOW_SERVE_ACCESS_LOG=0``), which otherwise writes beside the
    ``obs`` recorder's event files when one is configured.

    Device observatory: ``capture`` arms the anomaly-triggered
    ``torch.profiler`` capture (a ``CaptureConfig``, True for its
    defaults, or a built ``AnomalyCapturer``; the JAX
    ``TPUFLOW_PROF_*``), ``hbm_poll_s`` the memory gauges' cadence
    (``TPUFLOW_DEVICE_POLL_S``; 0 off), ``device_ledger=False`` the
    program ledger (``TPUFLOW_DEVICE_LEDGER=0``).

    The engine's methods set the per-thread state they need themselves
    (``torch.no_grad``, the model's card as the current device, the f32
    matmul precision scope), so ``submit``, ``ship`` and ``step`` may run
    on any thread, such as a gateway's request handlers, serialised by the
    caller's lock.
    """

    def __init__(
        self,
        model,
        *,
        max_slots: int = 8,
        prefill_chunk: int | None = None,
        buckets=None,
        decode_block: int = 8,
        pad_id: int = 0,
        quant: str | bool | None = None,
        paged: bool = True,
        page_size: int | None = None,
        n_pages: int | None = None,
        prefix_cache: bool = True,
        speculative: int | bool | None = None,
        spec_ngram: int = 3,
        role: str | None = None,
        kv_store_dir: str | None = None,
        kv_host_mb: float = 0.0,
        kv_disk_dir: str | None = None,
        slo_ttft_ms: float | None = None,
        slo_itl_ms: float | None = None,
        access_log: bool = True,
        capture=None,
        hbm_poll_s: float = _obs_device.DEFAULT_POLL_S,
        device_ledger: bool = True,
    ):
        self.paged = bool(paged)
        self.model = model
        self.device = model.device
        self.quant_mode = resolve_serve_quant(quant)
        self._qmodel = None
        if self.quant_mode is not None:
            if isinstance(model, QuantizedModel):
                raise ValueError(
                    "ServeEngine(quant=...) wants the raw fp model and owns "
                    "both numeric paths; got an already-quantized model — "
                    "drop the wrapper or drop the quant arg"
                )
            self._qmodel = quantize_model(model, mode=self.quant_mode)
        self.spec_draft = resolve_spec_draft(speculative)
        self.spec_ngram = int(spec_ngram)
        if self.spec_ngram < 2:
            raise ValueError(f"spec_ngram must be >= 2, got {spec_ngram}")
        if self.spec_draft and not self.paged:
            raise ValueError(
                "per-request speculative decode needs the paged cache "
                "(the contiguous slot rows' block write clamps at the "
                "n_ctx edge; paging routes overshoot to the trash page) "
                "— drop paged=False"
            )
        self.n_ctx = int(model.config.n_ctx)
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}"
            )
        self.prefill_chunk = prefill_chunk
        self.buckets = resolve_buckets(self.n_ctx, buckets)
        self.decode_block = int(decode_block)
        if self.decode_block < 1:
            raise ValueError(
                f"decode_block must be >= 1, got {self.decode_block}"
            )
        self.pad_id = int(pad_id)
        # Serving observatory: the engine-time ledger (buckets sum to the
        # serve wall by construction), the declared SLOs and the lazily
        # opened access log.
        self._access_on = bool(access_log)
        self._access: _ledger.AccessLog | None = None
        self.ledger = _ledger.ServeLedger(
            slo_ttft_s=_ledger.resolve_slo_s(slo_ttft_ms),
            slo_itl_s=_ledger.resolve_slo_s(slo_itl_ms),
        )
        self._iters = 0
        self._last_gauges: tuple | None = None
        # Device observatory: the anomaly capturer (None: one ``is not
        # None`` check a decode block), the memory poll's cadence, and the
        # program ledger of the signatures' first fenced runs.
        self._profcap = _profcap.make_capturer(capture)
        self.hbm_poll_s = hbm_poll_s
        self.device_ledger = bool(device_ledger)
        self.programs = _obs_device.ProgramLedger(source="serve")
        self._n_params = sum(p.numel() for p in model.parameters())
        S = self.max_slots
        self.role = resolve_serve_role(role)
        self.kv_store = (
            _kvstore.KVStore(kv_store_dir) if kv_store_dir else None
        )
        self._prefill_calls = 0
        self.pool = None
        if self.paged:
            self._init_pages(page_size, n_pages, prefix_cache, kv_host_mb,
                             kv_disk_dir)
        else:
            # One (n_ctx) row a slot; decode writes each slot's column.
            self._cache = model.init_cache(S)
        self._queue: collections.deque[ServeRequest] = collections.deque()
        self._slots: list[ServeRequest | None] = [None] * S
        self._tok = np.zeros((S,), np.int64)
        self._lengths = np.zeros((S,), np.int64)
        # Bucket pads kept at a contiguous row's head (0 when paged: the
        # page insert strips them).
        self._pads = np.zeros((S,), np.int64)
        self._remaining = np.zeros((S,), np.int64)
        self._live = np.zeros((S,), bool)
        self._quant = np.zeros((S,), bool)  # slot rides the int8 path
        self._spec = np.zeros((S,), bool)  # slot rides the verify block
        self._spec_committed = 0
        self._spec_forwards = 0
        self._eos = np.full((S,), -1, np.int64)
        self._next_id = 0

    def _init_pages(self, page_size, n_pages, prefix_cache: bool,
                    kv_host_mb: float, kv_disk_dir) -> None:
        """The paged engine's pool: geometry, the host accounting (with
        the spill tiers when armed), the page tables and the device pool."""
        S = self.max_slots
        self.page_size = resolve_page_size(self.n_ctx, page_size)
        self.pages_per_slot = self.n_ctx // self.page_size
        self.n_pages = (
            int(n_pages) if n_pages is not None
            else S * self.pages_per_slot + 1
        )
        tier = None
        if prefix_cache and (kv_host_mb > 0 or kv_disk_dir):
            tier = _kvstore.TierCache(
                host_bytes=int(kv_host_mb * 2**20),
                disk_dir=kv_disk_dir or None,
            )
        self.pool = PagePool(
            self.n_pages, self.page_size, prefix_cache=prefix_cache,
            tier_cache=tier,
            page_reader=self._read_page_host if tier is not None else None,
        )
        self._page_table = np.zeros((S, self.pages_per_slot), np.int64)
        self._slot_pages: list[list[int]] = [[] for _ in range(S)]
        self._cache = self.model.init_paged_cache(self.n_pages,
                                                  self.page_size)
        # Page-leaf names, in the order of ``self._cache.k + .v``: the
        # JAX engine's flattened cache paths, which page bundles, shipped
        # sets and the tier store key on.
        n_layer = self.model.config.n_layer
        self._leaf_names = [
            f"['h{i}']['cached_{kv}']"
            for kv in ("key", "value") for i in range(n_layer)
        ]
        pool0 = self._cache.k[0]
        self._page_host = (
            (self.page_size, *pool0.shape[2:]),
            _host_view(pool0[:0]).cpu().numpy().dtype,
        )

    # --------------------------------------------------------- device work
    @contextlib.contextmanager
    def _on_device(self):
        """The per-thread state every engine entry point needs, whatever
        the calling thread's: no autograd, the model's card as the current
        device, and the decode precision scope (true f32 products when the
        model's ``decode_precision`` is ``'highest'``, as ``generate()``)."""
        highest = self.model.config.decode_precision == "highest"
        card = (torch.cuda.device(self.device)
                if self.device.type == "cuda" else contextlib.nullcontext())
        with torch.no_grad(), card, f32_matmul_precision(highest):
            yield

    @contextlib.contextmanager
    def _program(self, name: str, tokens: int = 0):
        """The first fenced run of signature ``name`` (the block this wraps
        ends at a host sync) becomes an entry of ``self.programs``: its
        wall, 2 N FLOPs a token over ``tokens``, and on the card its
        memory marks (``obs/device.py``). Later runs pass straight
        through."""
        if not self.device_ledger or name in self.programs:
            yield
            return
        mark = _obs_device.allocated_bytes(self.device)
        t0 = time.monotonic()
        yield
        self.programs.note_entry(_obs_device.program_entry(
            name, run_s=time.monotonic() - t0,
            flops=2.0 * self._n_params * tokens if tokens else None,
            argument_bytes=mark, device=self.device, source="serve"))

    def _prefill_fn(self, model, prompt, pads, *, chunk):
        """(1, W) admission prefill → (first greedy token, row cache)."""
        logits, cache = chunked_prefill(model, prompt, chunk, pad_lens=pads)
        return int(torch.argmax(logits[0, -1])), cache

    def _prefill_row(self, model, prompt: np.ndarray, W: int):
        """The bucketed admission prefill of ``prompt`` LEFT-padded to
        width ``W`` → (first greedy token, (1, n_ctx) row cache)."""
        L = prompt.size
        padded = np.full((1, W), self.pad_id, np.int64)
        padded[0, W - L:] = prompt
        pads = prompt_lens_to_pad_lens([L], 1, W, device=self.device)
        chunk = normalize_prefill_chunk(self.prefill_chunk, W)
        self._prefill_calls += 1
        return self._prefill_fn(
            model, torch.as_tensor(padded, device=self.device), pads,
            chunk=chunk,
        )

    def _row_pages(self, row, pad: int, pool):
        """One (1, n_ctx, H, D) prefill row leaf with its LEFT padding
        stripped (roll by -pad: the real prompt kv moves to logical columns
        [0, L), so cache content is pad-invariant — the property prefix
        sharing and shipping rest on), as (pages_per_slot, page_size, H, D)
        logical pages in ``pool``'s dtype."""
        shifted = torch.roll(row[0], -pad, dims=0)  # (n_ctx, H, D)
        return shifted.reshape(
            self.pages_per_slot, self.page_size, *row.shape[2:]
        ).to(pool.dtype)

    def _page_insert(self, row_cache, table_row, pad: int, write_mask):
        """Paged admission insert, in place on the pool: copy the prefill
        row's pad-stripped logical pages into the pool pages ``table_row``
        names where ``write_mask`` is set (shared prefix pages, restored
        pages and unneeded tail entries are skipped)."""
        sel = np.nonzero(write_mask)[0]
        if sel.size == 0:
            return
        src = torch.as_tensor(sel, device=self.device)
        dst = torch.as_tensor(table_row[sel], device=self.device)
        for pool, row in zip(
            self._cache.k + self._cache.v, row_cache.k + row_cache.v
        ):
            pages = self._row_pages(row, pad, pool)
            pool.index_copy_(0, dst, pages.index_select(0, src))

    def _insert_row(self, row_cache, slot: int) -> None:
        """Contiguous admission insert, in place: the (1, n_ctx) prefill
        row, its bucket pads kept, copied into ``slot``'s cache row."""
        for big, row in zip(self._cache.k + self._cache.v,
                            row_cache.k + row_cache.v):
            big[slot].copy_(row[0])

    def _read_page_host(self, pid: int) -> dict[str, np.ndarray]:
        """Pool page ``pid`` as a host bundle (leaf name -> (page_size, H,
        D)): the spill unit. One gather of every leaf, one copy."""
        leaves = self._cache.k + self._cache.v
        host = _host_view(torch.stack([leaf[pid] for leaf in leaves]))
        return dict(zip(self._leaf_names, host.cpu().numpy()))

    def _leaves_ok(self, leaves, lead: tuple = ()) -> bool:
        """Page leaves this pool can take: every leaf of the engine's model,
        each ``lead`` + one page of the pool's geometry, in its host dtype
        (a tier bundle: ``lead`` empty; a shipped set: its page count)."""
        shape, dtype = self._page_host
        return set(leaves) == set(self._leaf_names) and all(
            a.shape == (*lead, *shape) and a.dtype == dtype
            for a in leaves.values()
        )

    def _restore_pages(self, table_row, pages: dict[int, dict]) -> None:
        """Scatter restored page bundles (logical page index -> bundle:
        tier promotions, shipped pages) into the pool pages ``table_row``
        names: one copy onto the card, one scatter a leaf."""
        if not pages:
            return
        js = sorted(pages)
        host = np.stack([
            np.stack([pages[j][name] for j in js])
            for name in self._leaf_names
        ])  # (leaves, pages, page_size, H, D)
        leaves = self._cache.k + self._cache.v
        with self.ledger.bucket("insert"), self._program("restore"):
            src = _device_view(
                torch.from_numpy(host).to(self.device), leaves[0].dtype
            )
            dst = torch.as_tensor(table_row[js], device=self.device)
            for pool, block in zip(leaves, src):
                pool.index_copy_(0, dst, block)

    def _decode_fn(self, model, tok, lengths, pads, remaining, live, eos,
                   page_table):
        """``decode_block`` single-token steps over every slot, per-slot
        freezing inside the loop, no host sync until the block ends. Rows
        outside ``live`` keep rewriting their frozen frontier column (their
        own page or row; dead slots: the trash page, or their own row,
        which the next admission overwrites). ``page_table`` None: the
        contiguous rows, ``pads`` their bucket pads. Returns
        (tokens (S, block), tok, lengths, remaining, live)."""
        n_ctx = self.n_ctx
        toks = []
        for _ in range(self.decode_block):
            logits, _ = model(
                tok[:, None], decode=True, cache=self._cache,
                slot_index=lengths, page_table=page_table, pad_lens=pads,
            )
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
            emitted = torch.where(live, nxt, torch.full_like(nxt, self.pad_id))
            lengths = torch.where(live, lengths + 1, lengths)
            remaining = torch.where(live, remaining - 1, remaining)
            # eos itself IS emitted; the slot freezes after it.
            live = live & (nxt != eos) & (remaining > 0) & (lengths < n_ctx)
            toks.append(emitted)
            tok = emitted
        return torch.stack(toks, dim=1), tok, lengths, remaining, live

    def _verify_fn(self, model, tok, draft, lengths, remaining, live, eos,
                   page_table):
        """The speculative verify block: ONE (S, K+1) forward over
        ``[cur, draft...]`` per slot, then a PER-ROW commit — the accepted
        draft prefix plus the model's bonus token at the first
        disagreement, truncated by each row's eos / budget / capacity.
        Returns (emitted (S, K+1), tok, lengths, remaining, live), the
        decode block's layout: tokens per row = the remaining-budget
        delta."""
        K, n_ctx = self.spec_draft, self.n_ctx
        S = tok.shape[0]
        x = torch.cat([tok[:, None], draft], dim=1)  # (S, K+1)
        logits, _ = model(
            x, decode=True, cache=self._cache, slot_index=lengths,
            page_table=page_table,
        )
        am = torch.argmax(logits, dim=-1)  # (S, K+1)
        # am[:, j] = the model's token after (cur, d_0..d_{j-1});
        # acceptance = leading agreement with the draft, per row.
        a = torch.cumprod((am[:, :K] == draft).long(), dim=1).sum(dim=1)
        j = torch.arange(K + 1, device=tok.device)
        rows = torch.arange(S, device=tok.device)
        w = torch.where(
            j[None, :] < a[:, None], torch.nn.functional.pad(draft, (0, 1)),
            am[rows[:, None], torch.minimum(j[None, :], a[:, None])],
        )
        # Commit count: acceptance + bonus, capped by budget and capacity
        # (a live row holds remaining >= 1 and lengths < n_ctx, so c >= 1).
        c = torch.minimum(torch.minimum(a + 1, remaining), n_ctx - lengths)
        # eos: commit up to and INCLUDING the first eos in the window.
        is_eos = w == eos[:, None]  # eos == -1 never matches a token
        first_eos = torch.argmax(is_eos.int(), dim=1)
        has_eos = (is_eos & (j[None, :] < c[:, None])).any(dim=1)
        c = torch.where(has_eos, torch.minimum(c, first_eos + 1), c)
        c = torch.where(live, c, 0)
        emitted = torch.where(j[None, :] < c[:, None], w, self.pad_id)
        new_tok = w[rows, torch.clamp(c - 1, min=0)]
        tok = torch.where(c > 0, new_tok, tok)
        lengths = lengths + c
        remaining = remaining - c
        live = live & ~has_eos & (remaining > 0) & (lengths < n_ctx)
        return emitted, tok, lengths, remaining, live

    # ---------------------------------------------------------- scheduling
    def bucket_for(self, prompt_len: int, max_new_tokens: int) -> int:
        """Smallest bucket width holding the prompt whose capacity check
        passes: paged, the REAL prompt length against n_ctx (the page
        insert strips bucket pads); contiguous rows keep the pads, so the
        padded width."""
        for w in self.buckets:
            used = prompt_len if self.paged else w
            if prompt_len <= w and used + max_new_tokens <= self.n_ctx:
                return w
        raise ValueError(
            f"no prefill bucket fits prompt_len={prompt_len} + "
            f"max_new_tokens={max_new_tokens} within n_ctx={self.n_ctx} "
            f"(buckets: {self.buckets})"
        )

    def _pages_needed(self, req: ServeRequest) -> int:
        """Pages covering every logical column the request can touch: prompt
        + budget, plus the verify block's draft-length overshoot for a
        speculative request (rejected-tail writes land in its own pages;
        columns >= n_ctx route to the trash page)."""
        slack = self.spec_draft if req.speculative else 0
        top = min(self.n_ctx, req.prompt.size + req.max_new_tokens + slack)
        return -(-top // self.page_size)

    def submit(self, prompt, *, max_new_tokens: int,
               eos_id: int | None = None,
               quantize: bool = False,
               speculative: bool | None = None,
               trace=None,
               kv_key: str | None = None) -> ServeRequest:
        """Enqueue one request; returns its live handle. Validation is eager:
        a request that can never fit fails here. ``quantize=True`` routes it
        through the int8 path (needs ``quant=`` at construction);
        ``speculative`` through the verify block (None = the engine's
        default: on when armed; True needs ``speculative=`` at
        construction). ``kv_key`` names a shipped page set in the engine's
        KV store: a loadable matching set admits the request already
        prefilled; a missing, torn or mismatched one rides local prefill
        (the ``kv_fallback`` trace phase), never an error. ``trace`` is the
        request's propagated trace context (``obs/trace.py``): its
        lifecycle events carry the trace id, an SLO breach escalates it,
        and its lifecycle spans flush when the request ends."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if quantize and self.quant_mode is None:
            raise ValueError(
                "submit(quantize=True) needs a quant-armed engine: pass "
                "ServeEngine(quant='fused_native')"
            )
        if speculative and not self.spec_draft:
            raise ValueError(
                "submit(speculative=True) needs a spec-armed engine: pass "
                "ServeEngine(speculative=K)"
            )
        spec = (bool(self.spec_draft) if speculative is None
                else bool(speculative))
        kv_import = None
        if kv_key is not None and self.kv_store is not None and self.paged:
            with obs.span("serve.kv_import", key=kv_key) as sp:
                pset = self.kv_store.load(kv_key)
                if pset is not None and self._import_ok(
                    pset, prompt, quantize
                ):
                    kv_import = pset
                sp.set(ok=kv_import is not None,
                       pages=0 if pset is None else pset.n_pages)
        req = ServeRequest(
            id=self._next_id,
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            eos_id=None if eos_id is None else int(eos_id),
            t_submit=time.monotonic(),
            quantize=bool(quantize),
            speculative=spec,
            bucket=self.bucket_for(prompt.size, max_new_tokens),
            trace_ctx=trace,
        )
        if self.paged and self._pages_needed(req) > self.pool.usable_pages:
            raise ValueError(
                f"request needs {self._pages_needed(req)} pages but the "
                f"pool holds {self.pool.usable_pages} usable pages "
                f"(n_pages={self.n_pages}, page_size={self.page_size}); "
                "it could never admit"
            )
        req.kv_import = kv_import
        self._next_id += 1
        self._queue.append(req)
        self._trace(req, "submitted", prompt_len=int(prompt.size),
                    max_new=req.max_new_tokens, bucket=req.bucket,
                    group=req.group)
        if kv_key is not None and kv_import is None:
            # The shipped set was missing, torn or mismatched: the request
            # proceeds as if it had never been shipped.
            self._trace(req, "kv_fallback", key=kv_key)
        return req

    # ------------------------------------------------ disaggregated serving
    def prefill_export(self, prompt, *,
                       quantize: bool = False) -> _kvstore.KVPageSet:
        """Run the admission prefill of ``prompt`` and extract its KV pages
        as a :class:`~tpuflow_torch.infer.kv_store.KVPageSet`: the
        prefill-role half of a disaggregated pair. The row comes from the
        same bucketed prefill an admission runs, pad-stripped as the page
        insert strips it, so each page's bytes equal the pool page a local
        admission writes. The set holds the partial tail page (private to
        the request: decode writes land there) and the first greedy token,
        so an exact import admits with no prefill. A contiguous engine
        raises ``ValueError``, as the JAX one does."""
        if not self.paged:
            raise ValueError("KV export needs the paged engine (paged=True)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must have at least one token")
        if quantize and self.quant_mode is None:
            raise ValueError(
                "prefill_export(quantize=True) needs a quant-armed engine: "
                "pass ServeEngine(quant='fused_native')"
            )
        L = int(prompt.size)
        W = self.bucket_for(L, 1)
        model = self._qmodel if quantize else self.model
        k_ship = -(-L // self.page_size)
        leaves = self._cache.k + self._cache.v
        with self._on_device():
            with self.ledger.bucket("prefill"), self._program(
                    f"prefill@{W}{'_q' if quantize else ''}", W):
                first, row_cache = self._prefill_row(model, prompt, W)
            rows = torch.stack([
                self._row_pages(row, W - L, pool)[:k_ship]
                for pool, row in zip(leaves, row_cache.k + row_cache.v)
            ])  # (leaves, k_ship, page_size, H, D): one copy to the host
            host = _host_view(rows).cpu().numpy()
        return _kvstore.KVPageSet(
            page_size=self.page_size,
            n_tokens=L,
            prompt=prompt,
            digests=_kvstore.chain_digests(prompt, self.page_size),
            pages=dict(zip(self._leaf_names, host)),
            tok0=first,
            meta={"quant": bool(quantize)},
        )

    def ship(self, prompt, *, quantize: bool = False) -> str:
        """Prefill and commit: the prefill-role request path. Returns the
        committed ``kv_key`` a decode engine's ``submit(kv_key=)`` takes."""
        if self.kv_store is None:
            raise ValueError(
                "ship() needs a KV store: pass "
                "ServeEngine(kv_store_dir=...)"
            )
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with obs.span("serve.kv_ship", prompt_len=int(prompt.size),
                      quant=bool(quantize)) as sp:
            pset = self.prefill_export(prompt, quantize=quantize)
            key = self.kv_store.commit(pset)
            sp.set(key=key, pages=pset.n_pages)
        return key

    def _import_ok(self, pset, prompt, quantize: bool) -> bool:
        """A shipped set is usable when its geometry, leaves and numeric
        path match this engine's and it covers this prompt: exactly (no
        prefill) or as a digest-chain prefix (the covered pages import,
        the rest prefills). Anything else rides local prefill."""
        if pset.page_size != self.page_size or not pset.pages:
            return False
        if bool(pset.meta.get("quant")) != bool(quantize):
            return False
        if not self._leaves_ok(pset.pages, (pset.n_pages,)):
            return False
        if pset.n_tokens == prompt.size and np.array_equal(
            np.asarray(pset.prompt, np.int32), prompt
        ):
            return True
        mine = _kvstore.chain_digests(prompt, self.page_size)
        return _kvstore.chain_match(pset.digests, mine) > 0

    # ------------------------------------------------------ lifecycle trace
    def _trace(self, req: ServeRequest, phase: str, **attrs) -> None:
        """One lifecycle transition: appended to the request's trace and
        mirrored as a serve.trace event; with a propagated context both
        carry its ``trace_id`` (absent, never empty, without one)."""
        if req.trace_ctx is not None:
            attrs["trace_id"] = req.trace_ctx.trace_id
        req.trace.append({"phase": phase, "t": time.monotonic(), **attrs})
        obs.event("serve.trace", request=req.id, phase=phase, **attrs)

    def _tid(self, req: ServeRequest) -> dict:
        """``{"trace_id": ...}`` when a propagated context rides the
        request, else ``{}``: spread into the serve.* lifecycle events so
        the untraced shape is unchanged."""
        ctx = req.trace_ctx
        return {} if ctx is None else {"trace_id": ctx.trace_id}

    def _exemplar(self, req: ServeRequest) -> str | None:
        """The trace id a TTFT / ITL observation pins as its histogram
        bucket's exemplar: only a recorded trace's, so a fleet p99
        exemplar always resolves to spans on disk."""
        ctx = req.trace_ctx
        return ctx.trace_id if ctx is not None and ctx.recorded else None

    def _note_queued(self, req: ServeRequest, reason: str) -> None:
        """Backpressure evidence: the queued phase once per reason change
        (a request waiting many iterations writes one entry)."""
        if req.queue_reason != reason:
            req.queue_reason = reason
            self._trace(req, "queued", reason=reason)

    def _note_first_token(self, req: ServeRequest, now: float) -> None:
        """TTFT bookkeeping, shared by the prefill admission and the
        prefill-free ones (ship, feed): the gauge, the lifecycle trace, the
        ledger's TTFT and SLO gate, and the live ledger's note."""
        req.t_first = now
        obs.gauge("serve.ttft_s", round(req.ttft_s, 6))
        self._trace(req, "first_token", ttft_s=round(req.ttft_s, 6))
        self.ledger.note_ttft(req.group, req.ttft_s)
        if self.ledger.check_ttft(req.ttft_s, group=req.group):
            self._slo_violation(req, "ttft", req.ttft_s,
                                self.ledger.slo_ttft_s)
        obs.goodput_live().note_serve_ttft(req.ttft_s,
                                           trace_id=self._exemplar(req))

    def _slo_violation(self, req: ServeRequest, kind: str, value: float,
                       limit_s: float) -> None:
        req.slo_violations += 1
        if req.trace_ctx is not None:
            # Tail sampling: an SLO breach force-records the trace even
            # when the head sampler skipped it.
            req.trace_ctx.escalate("slo")
        obs.event("serve.slo_violation", request=req.id, slo=kind,
                  value=round(value, 6), limit_s=limit_s, group=req.group,
                  **self._tid(req))
        obs.counter("serve.slo_violations", 1)
        if self._profcap is not None:
            # A declared-SLO breach: a direct capture trigger.
            self._profcap.note_slo_breach(kind)

    def _access_write(self, req: ServeRequest, terminal: str) -> None:
        """One access-log line at the request's terminal transition
        (complete or drained). Lazy: the writer opens beside the event
        files the first time a recorder-enabled process ends a request; no
        recorder, no file."""
        if not self._access_on:
            return
        if self._access is None:
            rec = obs.recorder()
            if rec is None:
                return
            self._access = _ledger.AccessLog(rec.directory, proc=rec.proc)
        ttft = req.ttft_s
        rate = req.decode_tokens_per_s
        self._access.write({
            "request": req.id,
            "ts": req.t_submit,
            "group": req.group,
            "quant": req.quantize,
            "spec": req.speculative,
            "prompt_len": int(req.prompt.size),
            "max_new_tokens": req.max_new_tokens,
            "bucket": req.bucket,
            "tokens": len(req.tokens),
            "terminal": terminal,
            "finish_reason": req.finish_reason or terminal,
            "queue_wait_s": (None if req.t_admit is None
                             else round(req.t_admit - req.t_submit, 6)),
            "ttft_s": None if ttft is None else round(ttft, 6),
            "itl_s": [round(v, 6) for v in req.itl_s],
            "decode_tokens_per_s": None if rate is None else round(rate, 2),
            "slo_violations": req.slo_violations,
            "trace": req.trace,
        })

    def drain_queued(self) -> int:
        """Terminal-trace every still-queued request as ``drained`` (the
        SIGTERM drain: the process is exiting; queued work rides the
        requeue). The queue itself is untouched, so a resumed engine can
        still admit them, but every submitted request's trace now reaches
        exactly one terminal event. Returns the count."""
        n = 0
        for req in self._queue:
            if req.drained:
                continue
            req.drained = True
            self._trace(req, "drained", reason="preempt_drain")
            self._access_write(req, "drained")
            if req.trace_ctx is not None:
                _reqtrace.flush_lifecycle(req.trace_ctx, req.trace,
                                          engine_request=req.id)
            n += 1
        return n

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def live_slots(self) -> int:
        return int(self._live.sum())

    def _free_slot(self) -> int | None:
        for s, req in enumerate(self._slots):
            if req is None:
                return s
        return None

    def _admit_one(self, req: ServeRequest, slot: int) -> bool:
        """Admit ``req`` into ``slot``. Returns False (request untouched,
        left queued) when the page pool cannot fit it — token-budget
        backpressure; pages are acquired before any device work.

        Pages covered by an imported set or by lower-tier promotions are
        RESTORED (their committed bytes scattered into the pool) instead of
        recomputed. An exact shipped set admits on its committed first
        token (``ship``); restored and shared pages covering the first
        ``L - 1`` tokens feed ``prompt[L - 1]`` to the decode block at
        length ``L - 1`` (``feed``) when that column opens a fresh private
        page: the decode step's write (an M = 1 product, whose rounding may
        differ from the prefill's) then never lands in a page that is
        shared from the pool or restored and registered for sharing. Else
        the classic prefill runs with the restored pages masked off its
        write (``prefill``). A contiguous engine always prefills and
        copies the padded row into the slot's row."""
        page_ids, matched, promoted = None, 0, []
        if self.paged:
            got = self.pool.acquire(req.prompt, self._pages_needed(req))
            if got is None:
                self._note_queued(req, "pages")
                return False
            page_ids, matched = got
            promoted = self.pool.take_promotions()
        now = time.monotonic()
        req.t_admit = now
        W, L = req.bucket, req.prompt.size
        ps = self.page_size if self.paged else 0
        pset = req.kv_import  # None on a contiguous engine (submit)
        # Restored pages (logical index -> bundle), contiguous from where
        # the pool's match broke: tier promotions first, shipped pages
        # extend the run. A failed fetch ends the run; every page past it
        # rides the prefill write (never a gap).
        restored: dict[int, dict[str, np.ndarray]] = {}
        restore_src: dict[int, str] = {}
        for j, digest, _tier in promoted:
            if j != matched + len(restored):
                break
            got_b = self.pool.tier.fetch(digest)
            if got_b is None or not self._leaves_ok(got_b[0]):
                break
            restored[j], restore_src[j] = got_b
        exact = (pset is not None and pset.n_tokens == L
                 and np.array_equal(pset.prompt, req.prompt))
        if pset is not None:
            k_full = _kvstore.chain_match(
                pset.digests, self.pool.prefix_digests(req.prompt)
            )
            top = pset.n_pages if exact else min(k_full, pset.n_pages)
            for j in range(matched + len(restored), min(top, len(page_ids))):
                restored[j] = pset.page_bundle(j)
                restore_src[j] = "ship"
        covered = matched + len(restored)
        if exact and pset.tok0 is not None and covered * ps >= L:
            mode = "ship"
        elif ((pset is not None or getattr(self.pool, "tier", None)
               is not None) and covered >= 1 and L - 1 == covered * ps):
            mode = "feed"
        else:
            mode = "prefill"
        table_row = write_mask = None
        if self.paged:
            table_row = np.zeros((self.pages_per_slot,), np.int64)
            table_row[: len(page_ids)] = page_ids
            write_mask = np.zeros((self.pages_per_slot,), bool)
            write_mask[matched: len(page_ids)] = True
            for j in restored:
                write_mask[j] = False  # restored bytes, not the prefill's
        n_tier = sum(1 for src in restore_src.values() if src != "ship")
        if n_tier:
            n_host = sum(1 for src in restore_src.values() if src == "host")
            self.pool.tier_hits += n_tier
            obs.event("serve.tier_hit", request=req.id, host=n_host,
                      disk=n_tier - n_host, **self._tid(req))
        self._restore_pages(table_row, restored)
        if n_tier:
            obs.event("serve.tier_promote", request=req.id, pages=n_tier,
                      prefill_skipped=mode != "prefill", **self._tid(req))
        first: int | None = None
        row_cache = None
        if mode == "ship":
            first = int(pset.tok0)
        elif mode == "prefill":
            model = self._qmodel if req.quantize else self.model
            # The bucket ends at the first token's readback, a host sync.
            with self.ledger.bucket("prefill"), obs.span(
                "serve.prefill", request=req.id, bucket=W, prompt_len=int(L),
                chunk=normalize_prefill_chunk(self.prefill_chunk, W),
                quant=bool(req.quantize),
            ), self._program(f"prefill@{W}{'_q' if req.quantize else ''}",
                             W):
                first, row_cache = self._prefill_row(model, req.prompt, W)
        # feed: the first token comes out of the decode block.
        if first is not None:
            req.t_first = req.t_last_tick = time.monotonic()
        req.state = "running"
        extra = {}
        if mode != "prefill" or restored:
            extra = dict(prefilled=mode, shipped_pages=len(restored) - n_tier,
                         promoted_pages=n_tier)
        n_pages = 0 if page_ids is None else len(page_ids)
        obs.event("serve.admit", request=req.id, slot=slot, bucket=W,
                  prompt_len=int(L), queue_wait_s=round(now - req.t_submit, 6),
                  pages=n_pages, shared_pages=matched, **self._tid(req))
        self._trace(req, "admitted", slot=slot, bucket=W,
                    queue_wait_s=round(now - req.t_submit, 6),
                    pages=n_pages, shared_pages=matched, **extra)
        if mode == "prefill" and self.paged:
            # Written even when the request ends here: its fresh prompt
            # pages are registered in the prefix cache, and a later prompt
            # that matches them reads them.
            with self.ledger.bucket("insert"), self._program("insert"):
                self._page_insert(row_cache, table_row, W - L, write_mask)
        if first is not None:
            req.tokens.append(first)
            self._note_first_token(req, req.t_first)
            obs.goodput_live().note_serve_tokens(1)
            obs.counter("serve.tokens", 1)
            if (req.eos_id is not None and first == req.eos_id) or (
                req.max_new_tokens == 1
            ):
                if page_ids is not None:
                    self.pool.release(page_ids)
                self._finish(req,
                             "eos" if req.max_new_tokens > 1 else "budget")
                return True
        if self.paged:
            self._page_table[slot] = table_row
            self._slot_pages[slot] = list(page_ids)
            # Pads stripped: logical columns [0, L) (feed: [0, L - 1)).
            self._lengths[slot] = L if mode != "feed" else L - 1
            self._pads[slot] = 0
        else:
            with self.ledger.bucket("insert"), self._program("insert"):
                self._insert_row(row_cache, slot)
            # The row keeps its bucket pads: columns [W - L, W) are the
            # prompt's.
            self._lengths[slot] = W
            self._pads[slot] = W - L
        self._slots[slot] = req
        self._tok[slot] = first if first is not None else req.prompt[L - 1]
        self._remaining[slot] = req.max_new_tokens - (first is not None)
        self._live[slot] = True
        self._quant[slot] = req.quantize
        self._spec[slot] = req.speculative
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        return True

    def _finish(self, req: ServeRequest, reason: str) -> None:
        req.t_done = time.monotonic()
        req.state = "done"
        req.finish_reason = reason
        rate = req.decode_tokens_per_s
        obs.event("serve.complete", request=req.id, tokens=len(req.tokens),
                  reason=reason, ttft_s=round(req.ttft_s, 6),
                  decode_tokens_per_s=None if rate is None
                  else round(rate, 2), **self._tid(req))
        obs.counter("serve.requests", 1)
        if req.quantize:
            obs.counter("serve.quant_requests", 1)
        if rate is not None:
            obs.gauge("serve.tokens_per_s", round(rate, 2))
        self._trace(req, "complete", reason=reason, tokens=len(req.tokens),
                    slo_violations=req.slo_violations)
        self._access_write(req, "complete")
        if req.trace_ctx is not None:
            # The replica half of the cross-process timeline: the
            # lifecycle phases as wall-clock spans, flushed under the
            # propagated trace id.
            _reqtrace.flush_lifecycle(req.trace_ctx, req.trace,
                                      engine_request=req.id)
        obs.goodput_live().note_serve_complete(req.group)

    def _emit_state_gauges(self) -> None:
        """Queue-depth, occupancy, page-pool and ledger gauges on change
        (plus a refresh every 64 iterations: a long idle server must not
        flood the event stream), and the live ledger's serving view."""
        pool = self.pool  # None on a contiguous engine: no page keys
        tier = None if pool is None else pool.tier
        state = (
            len(self._queue),
            self.live_slots,
            None if pool is None else pool.free_pages,
            None if pool is None else pool.prefix_hits,
            None if tier is None else tier.pages_host,
            None if tier is None else tier.pages_disk,
        )
        fr = self.ledger.fractions()
        if self._iters % 64 == 1:
            # The card's memory on the fence the loop already pays (read
            # at the first iteration, then every 64th, throttled by
            # hbm_poll_s), and the capture governor's wall deadline.
            _obs_device.maybe_emit_hbm(force=self._iters == 1,
                                       poll_s=self.hbm_poll_s)
            if self._profcap is not None:
                self._profcap.poll()
        if state != self._last_gauges or self._iters % 64 == 0:
            self._last_gauges = state
            obs.gauge("serve.queue_depth", state[0])
            obs.gauge("serve.slot_occupancy",
                      round(state[1] / self.max_slots, 4))
            if pool is not None:
                obs.gauge("serve.pages_free", state[2])
                obs.gauge("serve.prefix_hits", state[3])
            if tier is not None:
                obs.gauge("serve.pages_host", state[4])
                obs.gauge("serve.pages_disk", state[5])
            # The idle / decode / prefill split (verify and decode merge
            # into one "earning tokens" fraction) and the token-efficiency
            # gauges, on the load gauges' cadence.
            obs.gauge("serve.idle_fraction", round(fr["idle"], 4))
            obs.gauge("serve.decode_fraction",
                      round(fr["decode"] + fr["verify"], 4))
            obs.gauge("serve.prefill_fraction", round(fr["prefill"], 4))
            util = self.ledger.decode_utilization
            if util is not None:
                obs.gauge("serve.decode_utilization", round(util, 4))
            waste = self.ledger.masked_row_waste
            if waste is not None:
                obs.gauge("serve.masked_row_waste", round(waste, 4))
        led = obs.goodput_live()
        led.note_serve_state(state[0], state[1], self.max_slots)
        led.note_serve_ledger(
            {
                "idle": fr["idle"],
                "decode": fr["decode"] + fr["verify"],
                "prefill": fr["prefill"],
                "insert": fr["insert"],
                "host_sched": fr["host_sched"],
            },
            utilization=self.ledger.decode_utilization,
            masked_waste=self.ledger.masked_row_waste,
            slo_violations=self.ledger.slo_violations,
            slo_by_group=self.ledger.slo_by_group,
        )
        if pool is not None:
            led.note_serve_pages(pool.free_pages, pool.usable_pages)
            led.note_serve_prefix(pool.prefix_hits, pool.prefix_lookups)
        led.note_serve_role(self.role)
        if tier is not None:
            led.note_serve_tiers(tier.pages_host, tier.pages_disk,
                                 pool.tier_hits)

    def _run_decode_block(self, quant: bool, spec: bool = False) -> int:
        """One decode (or speculative verify) block over ONE group's slots
        — the groups partition the live set by (numeric path, speculative)
        — every other slot masked out of the live set; merge the group's
        state back, harvest tokens, free exited slots. Returns the tokens
        emitted. The whole block (host drafts, dispatch, the tokens'
        readback, the state merge) charges to the decode (or verify)
        bucket."""
        mask = self._live & (self._quant == quant) & (self._spec == spec)
        if not mask.any():
            return 0
        dev = self.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        table = t(self._page_table) if self.paged else None
        pads = None if self.paged else t(self._pads)
        model = self._qmodel if quant else self.model
        old_remaining = self._remaining.copy()
        group_live = int(mask.sum())
        total_live = int(self._live.sum())
        # Two literal span calls (not one with a computed name): the
        # catalog check sees literal emitter names only.
        span = (
            obs.span("serve.quant_decode", slots=group_live, spec=spec)
            if quant
            else obs.span("serve.decode", slots=group_live, spec=spec)
        )
        kind = ("verify" if spec else "decode") + ("_q" if quant else "")
        steps = self.spec_draft + 1 if spec else self.decode_block
        with self.ledger.bucket("verify" if spec else "decode"), span as sp, \
                self._program(kind, group_live * steps):
            if spec:
                # Host-side prompt-lookup drafts per slot (a wrong draft
                # only costs speed; the verify forward arbitrates).
                drafts = np.zeros((self.max_slots, self.spec_draft),
                                  np.int64)
                for s in np.nonzero(mask)[0]:
                    req = self._slots[s]
                    hist = np.concatenate(
                        [req.prompt, np.asarray(req.tokens, np.int32)]
                    )
                    drafts[s] = ngram_draft(hist, self.spec_draft,
                                            ngram=self.spec_ngram)
                toks, tok, lengths, remaining, live = self._verify_fn(
                    model, t(self._tok), t(drafts), t(self._lengths),
                    t(self._remaining), t(mask), t(self._eos), table,
                )
            else:
                toks, tok, lengths, remaining, live = self._decode_fn(
                    model, t(self._tok), t(self._lengths), pads,
                    t(self._remaining), t(mask), t(self._eos), table,
                )
            # The one host sync of the block.
            toks = toks.cpu().numpy()
            self._tok = np.where(mask, tok.cpu().numpy(), self._tok)
            self._lengths = np.where(mask, lengths.cpu().numpy(),
                                     self._lengths)
            self._remaining = np.where(
                mask, remaining.cpu().numpy(), self._remaining
            )
            self._live = np.where(mask, live.cpu().numpy(), self._live)
            emitted = int((old_remaining - self._remaining).sum())
            sp.set(tokens=emitted)
            self.ledger.note_decode_block(
                self.max_slots, group_live, total_live, spec=spec,
                drafted=group_live * self.spec_draft if spec else 0,
                committed=emitted,
            )
            if spec:
                self._spec_committed += emitted
                self._spec_forwards += group_live
                rate = self._spec_committed / max(self._spec_forwards, 1)
                obs.gauge("serve.spec_accept_rate", round(rate, 4))
                obs.goodput_live().note_serve_spec(
                    self._spec_committed, self._spec_forwards
                )
        now = time.monotonic()
        led = obs.goodput_live()
        for s, req in enumerate(self._slots):
            if req is None or not mask[s]:
                continue
            n = int(old_remaining[s] - self._remaining[s])
            if n:
                req.tokens.extend(int(x) for x in toks[s, :n])
                # One ITL observation a block (block wall / tokens
                # committed): the per-token latency the SLO gate, the
                # /metrics percentiles and the access log share.
                anchor = (req.t_last_tick if req.t_last_tick is not None
                          else req.t_first)
                itl = None
                if anchor is not None:
                    itl = max(now - anchor, 0.0) / n
                    req.itl_s.append(itl)
                    self.ledger.note_itl(req.group, itl)
                    led.note_serve_itl(itl, trace_id=self._exemplar(req))
                    if self._profcap is not None:
                        # The ITL spike detector; the same call advances
                        # a live capture's bound.
                        self._profcap.observe_itl(itl)
                if req.t_first is None:
                    # A feed admission: its first token came out of this
                    # block, after the ITL anchor above (which must not
                    # see a zero-width block).
                    self._note_first_token(req, now)
                req.t_last_tick = now
                if spec:
                    self._trace(req, "tick", tokens=n, spec=True,
                                drafted=self.spec_draft, accepted=n - 1)
                else:
                    self._trace(req, "tick", tokens=n, spec=False)
                if itl is not None and self.ledger.check_itl(
                        itl, group=req.group):
                    self._slo_violation(req, "itl", itl,
                                        self.ledger.slo_itl_s)
            if not self._live[s]:
                last = req.tokens[-1] if req.tokens else None
                if req.eos_id is not None and last == req.eos_id:
                    reason = "eos"
                elif len(req.tokens) >= req.max_new_tokens:
                    reason = "budget"
                else:
                    reason = "capacity"  # n_ctx frontier hit
                self._finish(req, reason)
                self._slots[s] = None
                self._quant[s] = False
                self._spec[s] = False
                if self.paged:
                    self.pool.release(self._slot_pages[s])
                    self._slot_pages[s] = []
                    self._page_table[s, :] = 0
        return emitted

    def collect_program_ledger(self, path: str | None = None
                               ) -> _obs_device.ProgramLedger:
        """The engine's device ledger (the JAX engine's
        ``collect_program_ledger``): the signatures run so far and the
        kernel libraries loaded, a static budget check against the card,
        written as ``programs.json`` (default: beside the recorder's event
        files; nothing without one). Returns the ledger."""
        for entry in _obs_device.kernel_entries():
            self.programs.note_entry(entry)
        self.programs.budget_check()
        self.programs.write(path)
        return self.programs

    def residency_efficiency(self) -> float | None:
        """KV residency: tokens resident (the live slots' committed cache
        columns) over tokens allocated (their held pages x page_size; a
        contiguous engine holds a whole n_ctx row a live slot). The
        paged-vs-slot headline: short requests strand most of a
        contiguous row but only their own pages. None when idle."""
        live = np.nonzero(self._live)[0]
        if live.size == 0:
            return None
        resident = int((self._lengths[live] - self._pads[live]).sum())
        if self.paged:
            allocated = sum(len(self._slot_pages[int(s)])
                            for s in live) * self.page_size
        else:
            allocated = int(live.size) * self.n_ctx
        if allocated <= 0:
            return None
        return resident / allocated

    @property
    def spec_accept_rate(self) -> float | None:
        """Cumulative tokens committed per speculative verify, per row
        (1.0 = speculation bought nothing; draft_len + 1 is the most)."""
        if not self._spec_forwards:
            return None
        return self._spec_committed / self._spec_forwards

    def step(self, admit: bool = True) -> bool:
        """One scheduler iteration: admit waiting requests into free slots
        (a blocked head-of-queue request applies backpressure), then run
        one block per live group — (fp, int8) x (plain, speculative) — and
        feed the live ledger. Returns False when there was nothing to do.
        Its prefills, decode and verify blocks run with true f32 products
        when the model's ``decode_precision`` is ``'highest'``, as
        ``generate()`` does."""
        self._iters += 1
        did = False
        with self._on_device():
            while admit and self._queue:
                slot = self._free_slot()
                if slot is None:
                    self._note_queued(self._queue[0], "slots")
                    break
                if not self._admit_one(self._queue[0], slot):
                    break  # page backpressure: stays queued, never dropped
                self._queue.popleft()
                did = True
            if self._live.any():
                did = True
                emitted = 0
                for quant in (False, True) if self.quant_mode else (False,):
                    for spec in ((False, True) if self.spec_draft
                                 else (False,)):
                        emitted += self._run_decode_block(quant, spec)
                obs.goodput_live().note_serve_tokens(emitted)
                if emitted:
                    obs.counter("serve.tokens", emitted)
        self._emit_state_gauges()
        return did

    def run_until_idle(self, max_iters: int | None = None) -> None:
        """Drive the scheduler until queue and slots are empty."""
        iters = 0
        while self._queue or self._live.any():
            self.step()
            iters += 1
            if max_iters is not None and iters >= max_iters:
                raise RuntimeError(
                    f"engine not idle after {max_iters} iterations "
                    f"(queue={len(self._queue)}, live={self.live_slots})"
                )

    def generate_many(self, prompts, *, max_new_tokens: int,
                      eos_id: int | None = None, quantize: bool = False,
                      speculative: bool | None = None) -> list[np.ndarray]:
        """Submit every prompt, run to completion, return each request's
        generated tokens in submit order."""
        reqs = [
            self.submit(p, max_new_tokens=max_new_tokens, eos_id=eos_id,
                        quantize=quantize, speculative=speculative)
            for p in prompts
        ]
        self.run_until_idle()
        return [r.result() for r in reqs]


def serve_forever(
    engine: ServeEngine,
    *,
    idle_sleep_s: float = 0.005,
    max_s: float | None = None,
    should_stop=None,
    gateway: bool = True,
    http_port: int | None = None,
    http_host: str = "127.0.0.1",
    registration_dir: str | None = None,
    replica_id: str | None = None,
    trace: bool = True,
    trace_dir: str | None = None,
    registry_path: str | None = None,
    alert_engine=None,
) -> None:
    """Long-lived serving loop on ``engine``'s card: it steps the engine
    under a lock, stamps the heartbeat every iteration (``utils/
    heartbeat.py``: the gang supervisor's stall detector works on a
    serving gang as on a training gang), and drains on a SIGTERM
    preemption (``utils/preempt.py``): it stops admitting, finishes the
    live slots, marks the still-queued requests ``drained`` and returns,
    instead of killing requests mid-decode. The handler installs only on
    the main thread; elsewhere the loop still honours a preemption that
    something else requested.

    ``http_port`` (None: no export; 0: an ephemeral port) starts the
    ``/metrics`` + ``/status`` + ``/alerts`` export on ``http_host`` and
    registers the replica in ``registration_dir`` under ``replica_id``
    (the JAX package's ``TPUFLOW_OBS_HTTP_PORT``, ``_HOST``,
    ``TPUFLOW_FLEET_REGISTRATION_DIR`` and ``TPUFLOW_FLEET_REPLICA_ID``);
    ``/alerts`` judges ``alert_engine`` (None: the process engine
    ``obs/alerts.py::engine()``).
    ``gateway`` (``TPUFLOW_ROUTER_GATEWAY``) also starts the replica's
    ``/generate`` endpoint (``infer/frontdoor.py::ReplicaGateway``) on
    ``http_host``, sharing the step loop's lock, and advertises its URL as
    ``generate_url`` in ``/status``; the URL is retracted before the
    socket closes. While draining, new ``/generate`` requests answer 503
    "draining" and the drained ones 503 "drained". ``trace`` and
    ``trace_dir`` (``TPUFLOW_TRACE``, ``TPUFLOW_TRACE_DIR``) go to the
    gateway, whose spans take ``replica_id`` as their writer.

    ``max_s`` bounds the loop; ``should_stop`` is an optional callable
    polled each iteration. With a recorder configured and the engine's
    ``device_ledger`` on, the loop writes the engine's device program
    ledger (``collect_program_ledger``: the kernel libraries, the
    signatures run so far and a budget check) as it starts, and again as
    it ends with the signatures serving ran.

    ``registry_path`` (the JAX package's ``TPUFLOW_REGISTRY_PATH``; None:
    no entry): whatever ends the loop (a drain, ``should_stop``, the
    deadline or an exception on its way out), the replica's headline
    (requests, TTFT/ITL percentiles from the mergeable buckets, the SLO
    count) is appended to that run registry as one ``serve`` record
    (``obs/registry.py::maybe_append_live``), after the gateway closed;
    the append never masks an exception in flight.
    """
    from tpuflow_torch.utils import heartbeat, preempt

    if http_port is not None:
        obs.start_export(http_port, host=http_host,
                         registration_dir=registration_dir,
                         replica_id=replica_id, alert_engine=alert_engine)
    step_lock = threading.RLock()
    gw = None
    if gateway:
        from tpuflow_torch.infer.frontdoor import ReplicaGateway

        try:
            gw = ReplicaGateway(engine, lock=step_lock, host=http_host,
                                trace=trace, trace_dir=trace_dir,
                                replica_id=replica_id)
        except OSError as e:
            print(f"[tpuflow] replica gateway failed to bind on {http_host} "
                  f"({e}); serving status-only")
        else:
            url = gw.url
            if http_host == "0.0.0.0":  # noqa: S104 (the caller opted in)
                import socket
                from urllib.parse import urlsplit

                url = (f"http://{socket.gethostname()}:"
                       f"{urlsplit(url).port}/generate")
            obs.goodput_live().note_serve_generate_url(url)
    _serve_ledger(engine)
    preempt.install_sigterm_handler()
    deadline = None if max_s is None else time.monotonic() + max_s
    draining = False
    try:
        while True:
            if preempt.preemption_requested() and not draining:
                # The exported flag flips the iteration admissions stop,
                # so a router sees serve_draining on its next poll.
                draining = True
                obs.goodput_live().note_serve_draining(True)
                if gw is not None:
                    gw.draining = True  # new /generate: 503 "draining"
            with step_lock:
                did = engine.step(admit=not draining)
            heartbeat.beat(step=engine._iters)
            if draining and not engine._live.any():
                # Queued requests ride the requeue; their traces reach the
                # drained terminal, so none vanishes from the access log.
                with step_lock:
                    engine.drain_queued()
                return
            if should_stop is not None and should_stop():
                return
            if deadline is not None and time.monotonic() > deadline:
                return
            if not did:
                with engine.ledger.bucket("idle"):
                    time.sleep(idle_sleep_s)
    finally:
        _serve_ledger(engine)
        if gw is not None:
            # Retract the advertised URL before the socket dies, so a
            # fleet poll racing the shutdown never hands a router an
            # address that can only refuse.
            obs.goodput_live().note_serve_generate_url(None)
            gw.close()
        from tpuflow_torch.obs import registry

        registry.maybe_append_live("serve", path=registry_path)


def _serve_ledger(engine: ServeEngine) -> None:
    """``serve_forever``'s device program ledger, when a recorder is on
    and the engine keeps one; never fails the loop."""
    if obs.recorder() is None or not getattr(engine, "device_ledger",
                                             False):
        return
    try:
        engine.collect_program_ledger()
    except Exception as e:
        print(f"[tpuflow_torch] device program ledger failed (ignored): "
              f"{e!r}")
