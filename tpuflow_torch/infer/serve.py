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
  the same weights; ``submit(quantize=True)`` routes a request to it. The
  fp and int8 groups share the one pool; each group's block runs with the
  other group masked out of its live set (a masked row only writes its own
  frozen frontier column, which its own group overwrites before reading).

PyTorch runs eagerly, so the JAX engine's jit programs, warmup and
never-recompile accounting have no counterpart here. Speculative verify,
disaggregated roles and tiers, and the serving observatory are not ported
yet (ROADMAP).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time

import numpy as np
import torch

from tpuflow_torch.device import pin_f32_matmul_precision
from tpuflow_torch.infer.generate import (
    chunked_prefill,
    normalize_prefill_chunk,
    prompt_lens_to_pad_lens,
)
from tpuflow_torch.infer.quant import canonical_mode, quantize_model


def resolve_serve_quant(quant=None) -> str | None:
    """Per-request-int8 mode from the ctor arg: None/False = disabled,
    True = fused-native, else any quantization-mode spelling."""
    if quant is None or quant is False:
        return None
    if quant is True:
        return "mxu"
    return canonical_mode(quant)


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

    ``model`` is a ``GPT2`` (fp); ``quant='fused_native'`` arms the int8
    path beside it. The engine runs on the model's device.
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
    ):
        if not paged:
            raise NotImplementedError(
                "contiguous slot-row caches (the JAX engine's paged=False "
                "regression reference) are not ported; the engine is paged"
            )
        if model.config.decode_precision == "highest":
            pin_f32_matmul_precision()
        self.model = model
        self.device = model.device
        self.quant_mode = resolve_serve_quant(quant)
        self._qmodel = None
        if self.quant_mode is not None:
            self._qmodel = quantize_model(model, mode=self.quant_mode)
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
        """Pages covering every logical column the request can touch."""
        top = min(self.n_ctx, req.prompt.size + req.max_new_tokens)
        return -(-top // self.page_size)

    def submit(self, prompt, *, max_new_tokens: int,
               eos_id: int | None = None,
               quantize: bool = False) -> ServeRequest:
        """Enqueue one request; returns its live handle. Validation is eager:
        a request that can never fit fails here. ``quantize=True`` routes it
        through the int8 path (needs ``quant=`` at construction)."""
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
        req = ServeRequest(
            id=self._next_id,
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            eos_id=None if eos_id is None else int(eos_id),
            t_submit=time.monotonic(),
            quantize=bool(quantize),
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
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        return True

    def _finish(self, req: ServeRequest, reason: str) -> None:
        req.t_done = time.monotonic()
        req.state = "done"
        req.finish_reason = reason

    def _run_decode_block(self, quant: bool) -> None:
        """One decode block over ONE numeric group's slots, every other
        slot masked out of the live set; merge the group's state back,
        harvest tokens, free exited slots."""
        mask = self._live & (self._quant == quant)
        if not mask.any():
            return
        dev = self.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        old_remaining = self._remaining.copy()
        toks, tok, lengths, remaining, live = self._decode_fn(
            self._qmodel if quant else self.model,
            t(self._tok), t(self._lengths), t(self._remaining), t(mask),
            t(self._eos), t(self._page_table),
        )
        # The one host sync of the block.
        toks = toks.cpu().numpy()
        self._tok = np.where(mask, tok.cpu().numpy(), self._tok)
        self._lengths = np.where(mask, lengths.cpu().numpy(), self._lengths)
        self._remaining = np.where(
            mask, remaining.cpu().numpy(), self._remaining
        )
        self._live = np.where(mask, live.cpu().numpy(), self._live)
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
                self.pool.release(self._slot_pages[s])
                self._slot_pages[s] = []
                self._page_table[s, :] = 0

    @torch.no_grad()
    def step(self, admit: bool = True) -> bool:
        """One scheduler iteration: admit waiting requests into free slots
        (a blocked head-of-queue request applies backpressure), then run
        one decode block per live group (fp, then int8). Returns False when
        there was nothing to do."""
        did = False
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
                self._run_decode_block(quant)
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
                      eos_id: int | None = None,
                      quantize: bool = False) -> list[np.ndarray]:
        """Submit every prompt, run to completion, return each request's
        generated tokens in submit order."""
        reqs = [
            self.submit(p, max_new_tokens=max_new_tokens, eos_id=eos_id,
                        quantize=quantize)
            for p in prompts
        ]
        self.run_until_idle()
        return [r.result() for r in reqs]
