"""Continuous-batching serving engine over a paged KV cache.

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
- **Decode blocks.** ``decode_block`` single-token steps over every slot at
  once, with per-slot eos / budget / capacity freezing, one host sync per
  block. Greedy only: every request's tokens equal a solo
  ``generate(temperature=0)`` of its prompt.
- **Per-request int8.** ``quant='fused_native'`` builds the W8A8 view of
  the same weights (``'weight_only'`` the weight-only one);
  ``submit(quantize=True)`` routes a request to it.
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

PyTorch runs eagerly, so the JAX engine's jit programs, warmup and
never-recompile accounting have no counterpart here. Disaggregated roles
and tiers, ``serve_forever`` and the serving observatory are not ported
yet (ROADMAP). Where the JAX engine reads ``TPUFLOW_SERVE_*`` knobs, this
one takes constructor arguments.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time

import numpy as np
import torch

from tpuflow_torch.device import f32_matmul_precision
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
from tpuflow_torch.models.gpt2 import reject_moe


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
    matchable) and are only reclaimed LRU-first under pool pressure."""

    def __init__(self, n_pages: int, page_size: int,
                 prefix_cache: bool = True):
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
        p = np.asarray(prompt, np.int32).reshape(-1)
        ps = self.page_size
        return [
            hashlib.sha1(p[: (j + 1) * ps].tobytes()).digest()
            for j in range(p.size // ps)
        ]

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
        if not self.can_fit(need, matched):
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

    def _alloc_one(self) -> int:
        if self._free:
            return self._free.pop()
        pid, _ = self._idle.popitem(last=False)  # LRU-first eviction
        d = self._page_hash.pop(pid)
        del self._hash_to_page[d]
        self.evictions += 1
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

    @property
    def done(self) -> bool:
        return self.state == "done"

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
    """Request-level continuous-batching engine over one model, paged.

    ``model`` is a ``GPT2`` (fp), or a ``QuantizedModel`` with ``quant``
    unset; ``quant='fused_native'`` (or ``'weight_only'``) arms an int8
    path beside the fp one, ``speculative=K`` the verify block with drafts
    of K tokens from ``spec_ngram``-gram lookup. The engine runs on the
    model's device.
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
    ):
        if not paged:
            raise NotImplementedError(
                "contiguous slot-row caches (the JAX engine's paged=False "
                "regression reference) are not ported; the engine is paged"
            )
        reject_moe(model.config, "the serving engine")
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
        S = self.max_slots
        self.page_size = resolve_page_size(self.n_ctx, page_size)
        self.pages_per_slot = self.n_ctx // self.page_size
        self.n_pages = (
            int(n_pages) if n_pages is not None
            else S * self.pages_per_slot + 1
        )
        self.pool = PagePool(
            self.n_pages, self.page_size, prefix_cache=prefix_cache
        )
        self._page_table = np.zeros((S, self.pages_per_slot), np.int64)
        self._slot_pages: list[list[int]] = [[] for _ in range(S)]
        self._cache = model.init_paged_cache(self.n_pages, self.page_size)
        self._queue: collections.deque[ServeRequest] = collections.deque()
        self._slots: list[ServeRequest | None] = [None] * S
        self._tok = np.zeros((S,), np.int64)
        self._lengths = np.zeros((S,), np.int64)
        self._remaining = np.zeros((S,), np.int64)
        self._live = np.zeros((S,), bool)
        self._quant = np.zeros((S,), bool)  # slot rides the int8 path
        self._spec = np.zeros((S,), bool)  # slot rides the verify block
        self._spec_committed = 0
        self._spec_forwards = 0
        self._eos = np.full((S,), -1, np.int64)
        self._next_id = 0

    # --------------------------------------------------------- device work
    def _prefill_fn(self, model, prompt, pads, *, chunk):
        """(1, W) admission prefill → (first greedy token, row cache)."""
        logits, cache = chunked_prefill(model, prompt, chunk, pad_lens=pads)
        return int(torch.argmax(logits[0, -1])), cache

    def _page_insert(self, row_cache, table_row, pad: int, write_mask):
        """Paged admission insert, in place on the pool: strip the (1, n_ctx)
        prefill row's LEFT padding (roll by -pad: the real prompt kv moves
        to logical columns [0, L), so cache content is pad-invariant — the
        property prefix sharing rests on) and copy its logical pages into
        the pool pages ``table_row`` names where ``write_mask`` is set
        (shared prefix pages and unneeded tail entries are skipped)."""
        sel = np.nonzero(write_mask)[0]
        if sel.size == 0:
            return
        src = torch.as_tensor(sel, device=self.device)
        dst = torch.as_tensor(table_row[sel], device=self.device)
        ps = self.page_size
        for pool, row in zip(
            self._cache.k + self._cache.v, row_cache.k + row_cache.v
        ):
            shifted = torch.roll(row[0], -pad, dims=0)  # (n_ctx, H, D)
            pages = shifted.reshape(self.pages_per_slot, ps, *row.shape[2:])
            pool.index_copy_(0, dst, pages.index_select(0, src).to(pool.dtype))

    def _decode_fn(self, model, tok, lengths, remaining, live, eos,
                   page_table):
        """``decode_block`` single-token steps over every slot, per-slot
        freezing inside the loop, no host sync until the block ends. Rows
        outside ``live`` keep rewriting their frozen frontier column (their
        own page; dead slots: the trash page). Returns
        (tokens (S, block), tok, lengths, remaining, live)."""
        n_ctx = self.n_ctx
        toks = []
        for _ in range(self.decode_block):
            logits, _ = model(
                tok[:, None], decode=True, cache=self._cache,
                slot_index=lengths, page_table=page_table,
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
        """Smallest bucket width holding the prompt, with the REAL prompt
        length checked against n_ctx (the page insert strips bucket pads)."""
        for w in self.buckets:
            if prompt_len <= w and prompt_len + max_new_tokens <= self.n_ctx:
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
               speculative: bool | None = None) -> ServeRequest:
        """Enqueue one request; returns its live handle. Validation is eager:
        a request that can never fit fails here. ``quantize=True`` routes it
        through the int8 path (needs ``quant=`` at construction);
        ``speculative`` through the verify block (None = the engine's
        default: on when armed; True needs ``speculative=`` at
        construction)."""
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
        req = ServeRequest(
            id=self._next_id,
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            eos_id=None if eos_id is None else int(eos_id),
            t_submit=time.monotonic(),
            quantize=bool(quantize),
            speculative=spec,
            bucket=self.bucket_for(prompt.size, max_new_tokens),
        )
        if self._pages_needed(req) > self.pool.usable_pages:
            raise ValueError(
                f"request needs {self._pages_needed(req)} pages but the "
                f"pool holds {self.pool.usable_pages} usable pages "
                f"(n_pages={self.n_pages}, page_size={self.page_size}); "
                "it could never admit"
            )
        self._next_id += 1
        self._queue.append(req)
        return req

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
        backpressure; pages are acquired before any device work."""
        got = self.pool.acquire(req.prompt, self._pages_needed(req))
        if got is None:
            return False
        page_ids, matched = got
        req.t_admit = time.monotonic()
        W, L = req.bucket, req.prompt.size
        padded = np.full((1, W), self.pad_id, np.int64)
        padded[0, W - L:] = req.prompt
        pads = prompt_lens_to_pad_lens([L], 1, W, device=self.device)
        chunk = normalize_prefill_chunk(self.prefill_chunk, W)
        model = self._qmodel if req.quantize else self.model
        first, row_cache = self._prefill_fn(
            model, torch.as_tensor(padded, device=self.device), pads,
            chunk=chunk,
        )
        req.t_first = time.monotonic()
        req.tokens.append(first)
        req.state = "running"
        done = (req.eos_id is not None and first == req.eos_id) or (
            req.max_new_tokens == 1
        )
        if done:
            self.pool.release(page_ids)
            self._finish(req, "eos" if req.max_new_tokens > 1 else "budget")
            return True
        table_row = np.zeros((self.pages_per_slot,), np.int64)
        table_row[: len(page_ids)] = page_ids
        write_mask = np.zeros((self.pages_per_slot,), bool)
        write_mask[matched: len(page_ids)] = True
        self._page_insert(row_cache, table_row, W - L, write_mask)
        self._page_table[slot] = table_row
        self._slot_pages[slot] = list(page_ids)
        self._lengths[slot] = L  # pads stripped: logical columns [0, L)
        self._slots[slot] = req
        self._tok[slot] = first
        self._remaining[slot] = req.max_new_tokens - 1
        self._live[slot] = True
        self._quant[slot] = req.quantize
        self._spec[slot] = req.speculative
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        return True

    def _finish(self, req: ServeRequest, reason: str) -> None:
        req.t_done = time.monotonic()
        req.state = "done"
        req.finish_reason = reason

    def _run_decode_block(self, quant: bool, spec: bool = False) -> None:
        """One decode (or speculative verify) block over ONE group's slots
        — the groups partition the live set by (numeric path, speculative)
        — every other slot masked out of the live set; merge the group's
        state back, harvest tokens, free exited slots."""
        mask = self._live & (self._quant == quant) & (self._spec == spec)
        if not mask.any():
            return
        dev = self.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        model = self._qmodel if quant else self.model
        old_remaining = self._remaining.copy()
        if spec:
            # Host-side prompt-lookup drafts per slot (a wrong draft only
            # costs speed; the verify forward arbitrates).
            drafts = np.zeros((self.max_slots, self.spec_draft), np.int64)
            for s in np.nonzero(mask)[0]:
                req = self._slots[s]
                hist = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int32)]
                )
                drafts[s] = ngram_draft(hist, self.spec_draft,
                                        ngram=self.spec_ngram)
            toks, tok, lengths, remaining, live = self._verify_fn(
                model, t(self._tok), t(drafts), t(self._lengths),
                t(self._remaining), t(mask), t(self._eos),
                t(self._page_table),
            )
        else:
            toks, tok, lengths, remaining, live = self._decode_fn(
                model, t(self._tok), t(self._lengths), t(self._remaining),
                t(mask), t(self._eos), t(self._page_table),
            )
        # The one host sync of the block.
        toks = toks.cpu().numpy()
        self._tok = np.where(mask, tok.cpu().numpy(), self._tok)
        self._lengths = np.where(mask, lengths.cpu().numpy(), self._lengths)
        self._remaining = np.where(
            mask, remaining.cpu().numpy(), self._remaining
        )
        self._live = np.where(mask, live.cpu().numpy(), self._live)
        if spec:
            self._spec_committed += int(
                (old_remaining - self._remaining).sum())
            self._spec_forwards += int(mask.sum())
        for s, req in enumerate(self._slots):
            if req is None or not mask[s]:
                continue
            n = int(old_remaining[s] - self._remaining[s])
            req.tokens.extend(int(x) for x in toks[s, :n])
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
                self.pool.release(self._slot_pages[s])
                self._slot_pages[s] = []
                self._page_table[s, :] = 0

    @property
    def spec_accept_rate(self) -> float | None:
        """Cumulative tokens committed per speculative verify, per row
        (1.0 = speculation bought nothing; draft_len + 1 is the most)."""
        if not self._spec_forwards:
            return None
        return self._spec_committed / self._spec_forwards

    @torch.no_grad()
    def step(self, admit: bool = True) -> bool:
        """One scheduler iteration: admit waiting requests into free slots
        (a blocked head-of-queue request applies backpressure), then run
        one block per live group — (fp, int8) x (plain, speculative).
        Returns False when there was nothing to do. Its prefills, decode
        and verify blocks run with true f32 products when the model's
        ``decode_precision`` is ``'highest'``, as ``generate()`` does."""
        did = False
        highest = self.model.config.decode_precision == "highest"
        with f32_matmul_precision(highest):
            while admit and self._queue:
                slot = self._free_slot()
                if slot is None:
                    break
                if not self._admit_one(self._queue[0], slot):
                    break  # page backpressure: stays queued, never dropped
                self._queue.popleft()
                did = True
            if self._live.any():
                did = True
                for quant in (False, True) if self.quant_mode else (False,):
                    for spec in ((False, True) if self.spec_draft
                                 else (False,)):
                        self._run_decode_block(quant, spec)
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
