"""Front-door router: fault-tolerant admission over a serving fleet
(counterpart of ``tpuflow/infer/router.py``).

The single client-facing ingress for a fleet. Everything here is
host-side: the router never touches a device; it reads the fleet
observatory's snapshot dicts (``obs/fleet.py``) and forwards requests to
replica ``/generate`` endpoints through an injectable ``forward_fn``.

Four policies compose a request:

- **Admission by fleet token budget.** A request needs
  ``pages_needed(prompt, max_new)`` KV pages somewhere. It dispatches only
  to a replica whose reported ``serve_pages_free`` minus the pages the
  router has already charged to in-flight work covers the need; until one
  exists the request WAITS in the front door's queue (backpressure queues,
  never drops), bounded by ``queue_timeout_s``, after which the client
  gets an explicit 503, counted in ``router.reject``.
- **Balance by health x queue trend.** Among eligible replicas the pick
  maximizes ``route_score = health * decay^queue_trend``: the fleet health
  score damped geometrically by consecutive queue-growth polls, so a
  replica falling behind its arrivals sheds new work before its health
  moves. Ties break toward fewer router-outstanding requests, then toward
  warmer spill tiers.
- **Prefix affinity.** Prompts hash to the page-chain digests the engines'
  prefix caches use (``prefix_digests`` is ``kv_store.chain_digests``), and
  the router remembers which replica last served each chain: a request
  sharing a prefix routes to the replica already holding those pages.
- **Failover.** Each forward carries a per-replica timeout; a failure
  (timeout, refused, non-200) backs the replica off exponentially and
  re-dispatches the request, to a DIFFERENT replica when one is eligible
  (``router.reroute``). Requests are idempotent by id: the client sees
  exactly one answer even when a replica dies mid-decode and a duplicate
  races the original. Retry budget exhausted: 503, never a hang.

Drain awareness rides on the replicas' ``/status``: a draining replica
flips ``serve_draining``, the fleet row carries it, and the router stops
admitting there at the next refresh (``router.drain`` once a flip). Its
queued work comes back as 503s and re-routes through the retry path.
Phase-aware placement rides on the engines' serving roles: a prompt of at least
``ship_min_tokens`` takes a ship hop to a ``prefill``-role replica, whose
``kv_key`` the decode forward carries; any failure falls back to local
prefill.

``AutoscaleController`` is the minimal replacement loop: stale replicas
and sustained occupancy or SLO pressure give deduplicated,
cooldown-limited actions whose launch command builds the replacement's
kernels (``ops/_build.py``) before it takes traffic.

The JAX router reads ``TPUFLOW_ROUTER_*``, ``TPUFLOW_SERVE_PAGE_SIZE``
and ``TPUFLOW_KV_SHIP_MIN_TOKENS``; here each is an argument with the JAX
default (README, "The fleet front on the port").
"""

from __future__ import annotations

import importlib
import pathlib
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Callable

import numpy as np

from tpuflow_torch.infer import kv_store as _kvstore

# The recorder submodule, not the package's ``recorder()`` accessor that
# shadows it once ``tpuflow_torch.obs`` is initialised.
_rec = importlib.import_module("tpuflow_torch.obs.recorder")


class FleetBusy(RuntimeError):
    """Admission-queue timeout or retry-budget exhaustion.

    The router's ONLY loss mode, and it is explicit: the front door
    maps it to HTTP 503 so the client knows to back off and retry.
    Nothing is ever silently dropped.
    """


# --------------------------------------------------------- pure policy
def prefix_digests(prompt: Any, page_size: int) -> list[bytes]:
    """Chain keys for every fully-covered prompt page: the engines'
    prefix-cache keys (``kv_store.chain_digests``, which ``PagePool``
    uses), so the router's affinity map speaks the replicas' prefix-cache
    language without importing the engine. No pages below 1 token."""
    ps = int(page_size)
    if ps <= 0:
        return []
    return _kvstore.chain_digests(prompt, ps)


def pages_needed(prompt_len: int, max_new_tokens: int, page_size: int) -> int:
    """KV pages a request can grow to — the admission charge."""
    total = int(prompt_len) + int(max_new_tokens)
    return max(1, -(-total // max(int(page_size), 1)))


def route_score(
    health: float, queue_trend: int, trend_decay: float
) -> float:
    """Balance score: health damped geometrically per consecutive
    queue-growth poll. health<=0 or huge trend → 0 (never negative)."""
    h = max(float(health), 0.0)
    t = max(int(queue_trend), 0)
    d = min(max(float(trend_decay), 0.0), 1.0)
    return h * (d ** t)


def row_tier_pages(row: dict) -> int:
    """Host + disk spill-tier pages a fleet row reports —
    the warmth signal the decode tie-break prefers. Rows without tier
    counts score 0."""
    total = 0
    for key in ("serve_pages_host", "serve_pages_disk"):
        v = row.get(key)
        if isinstance(v, (int, float)):
            total += int(v)
    return total


# Bounded internal maps: the affinity map holds the most recent chain
# digests (LRU), the done-cache the most recent responses (idempotent
# replay window). Both are memory bounds, not correctness bounds.
AFFINITY_MAP_MAX = 8192
DONE_CACHE_MAX = 2048
_BACKOFF_CAP_S = 2.0


class Router:
    """The front door's brain: admission, pick, forward, retry.

    ``snapshot_fn`` returns the fleet observatory's snapshot dict
    (``{"fleet": {...}, "replicas": [rows]}``) and should be cheap —
    the production wiring (``frontdoor.main``) hands in
    ``FleetPoller.snapshot``, a cached background sweep. Either way
    the router never holds its lock across the call, so even a slow
    snapshot_fn degrades to stale routing, not blocked routing.
    ``forward_fn(row, request, timeout_s)`` performs one
    forward attempt and RAISES on any failure (timeout, refused,
    non-200); its return value is the client's response. Clock and
    sleep are injectable so the retry/backoff state machine unit-tests
    without real waiting.
    """

    def __init__(
        self,
        snapshot_fn: Callable[[], dict],
        forward_fn: Callable[[dict, dict, float], dict],
        *,
        page_size: int = 16,
        timeout_s: float = 30.0,
        retries: int = 3,
        backoff_s: float = 0.05,
        affinity: bool = True,
        hedge: bool = False,
        ship_min_tokens: int = 0,
        min_health: float = 0.25,
        trend_decay: float = 0.5,
        queue_timeout_s: float = 60.0,
        refresh_s: float = 0.05,
        wait_tick_s: float = 0.02,
        autoscale: "AutoscaleController | None" = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self._snapshot_fn = snapshot_fn
        self._forward = forward_fn
        self.page_size = int(page_size)
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.affinity = bool(affinity)
        self.hedge = bool(hedge)
        self.ship_min_tokens = int(ship_min_tokens)
        self.min_health = float(min_health)
        self.trend_decay = float(trend_decay)
        self.queue_timeout_s = float(queue_timeout_s)
        self.refresh_s = float(refresh_s)
        self.wait_tick_s = float(wait_tick_s)
        self._autoscale = autoscale
        self._clock = clock
        self._sleep = sleep
        self._cond = threading.Condition()
        self._rows: dict[str, dict] = {}
        self._refreshing = False
        self._last_refresh = float("-inf")
        self._last_budget = 0
        self._draining: set[str] = set()
        self._backoff_until: dict[str, float] = {}
        self._charged: dict[str, int] = {}
        self._outstanding: dict[str, int] = {}
        self._affinity_map: OrderedDict[bytes, str] = OrderedDict()
        self._done: OrderedDict[str, dict] = OrderedDict()
        self._inflight: dict[str, threading.Event] = {}
        self._waiting = 0
        self._counters = {
            "accepted": 0, "requests": 0, "rejected": 0, "retries": 0,
            "reroutes": 0, "affinity_hits": 0, "drains": 0,
            # Disaggregated serving: prefill hops shipped
            # to a role=="prefill" replica, and ship attempts that
            # fell back to the decode replica's local prefill.
            "ships": 0, "ship_fallbacks": 0,
            # Cumulative router-side admission wait (seconds, successful
            # picks only): /status's router_wait_s, an alert rule's mean
            # wait per request over router_requests.
            "wait_s": 0.0,
        }

    # ------------------------------------------------------- snapshot
    def refresh(self, force: bool = False) -> None:
        """Pull the fleet snapshot (throttled by ``refresh_s``), detect
        drain flips, re-gauge the admission budget, feed the autoscale
        loop, and wake admission waiters."""
        with self._cond:
            self._refresh_locked(force=force)

    def _refresh_locked(self, force: bool = False) -> None:
        """Caller holds ``self._cond`` exactly once. The snapshot fetch
        itself runs with the lock RELEASED: even a cheap cached
        snapshot_fn must never head-of-line-block the admission
        waiters, retries, and completion bookkeeping that all tick this
        condition — and a slow one (an observatory sweep handed in
        directly) would otherwise freeze all routing exactly when the
        fleet is degraded. ``_refreshing`` keeps the fetch
        single-flight; everyone else routes on the cached view."""
        now = self._clock()
        if self._refreshing:
            return  # another thread is mid-fetch; use the cached view
        if not force and now - self._last_refresh < self.refresh_s:
            return
        self._refreshing = True
        self._last_refresh = now
        self._cond.release()
        try:
            snap = self._snapshot_fn() or {}
        except Exception:
            snap = None  # keep routing on the last good snapshot
        finally:
            self._cond.acquire()
            self._refreshing = False
        if snap is None:
            return
        rows = snap.get("replicas") or []
        self._rows = {
            str(r.get("id")): r for r in rows if r.get("id")
        }
        for rid, row in self._rows.items():
            d = bool(row.get("serve_draining"))
            if d and rid not in self._draining:
                self._draining.add(rid)
                self._counters["drains"] += 1
                _rec.event("router.drain", replica=rid)
            elif not d and rid in self._draining:
                self._draining.discard(rid)
        budget = 0
        for rid, row in self._rows.items():
            if self._routable(row, now) is None:
                continue
            # A prefill-role replica takes ship hops, not
            # admissions — its pages are not decode budget.
            if row.get("serve_role") == "prefill":
                continue
            free = row.get("serve_pages_free")
            if isinstance(free, (int, float)):
                budget += max(
                    int(free) - self._charged.get(rid, 0), 0
                )
        self._last_budget = budget
        _rec.gauge("router.budget_pages", budget)
        if self._autoscale is not None:
            self._autoscale.consider(snap)
        self._cond.notify_all()

    def _routable(self, row: dict, now: float) -> float | None:
        """Health score if the replica may take NEW work, else None."""
        rid = str(row.get("id"))
        if row.get("stale") or row.get("serve_draining"):
            return None
        if self._backoff_until.get(rid, float("-inf")) > now:
            return None
        h = row.get("health")
        if not isinstance(h, (int, float)) or h < self.min_health:
            return None
        return float(h)

    def _pick_locked(
        self, need: int, digests: list[bytes], tried: set[str],
        now: float,
    ) -> tuple[str, dict, bool] | None:
        """(replica id, row, affinity-hit) or None when nothing can
        take ``need`` pages right now."""
        elig: list[tuple[str, dict, float]] = []
        for rid, row in self._rows.items():
            h = self._routable(row, now)
            if h is None:
                continue
            # Decode placement skips prefill-role rows:
            # those take the ship hop, never the request itself.
            if row.get("serve_role") == "prefill":
                continue
            free = row.get("serve_pages_free")
            if not isinstance(free, (int, float)):
                continue
            if int(free) - self._charged.get(rid, 0) < need:
                continue
            elig.append((rid, row, h))
        if not elig:
            return None
        # A replica that already failed this request is a last resort.
        pool = [e for e in elig if e[0] not in tried] or elig
        if self.affinity and digests:
            by_id = {e[0]: e for e in pool}
            for dg in reversed(digests):
                owner = self._affinity_map.get(dg)
                if owner in by_id:
                    rid, row, _h = by_id[owner]
                    return rid, row, True
        rid, row, _h = max(
            pool,
            key=lambda e: (
                route_score(
                    e[2], e[1].get("queue_trend", 0), self.trend_decay
                ),
                -self._outstanding.get(e[0], 0),
                # Warmer spill tiers break the remaining tie: more
                # host/disk pages means more promotable
                # prefixes, so equal-score picks land where a lower
                # tier might save a prefill. Tier-less fleets report
                # 0 everywhere — the ordering is unchanged.
                int(row_tier_pages(e[1])),
                e[0],
            ),
        )
        return rid, row, False

    def _pick_prefill_locked(self, now: float) -> dict | None:
        """Healthiest routable prefill-role row, or None. The ship hop
        is best-effort: no candidate simply means local prefill."""
        best: tuple[float, str, dict] | None = None
        for rid, row in self._rows.items():
            if row.get("serve_role") != "prefill":
                continue
            h = self._routable(row, now)
            if h is None:
                continue
            if best is None or (h, rid) > (best[0], best[1]):
                best = (h, rid, row)
        return None if best is None else best[2]

    def _maybe_ship(
        self, rid: str, prompt: Any, request: dict
    ) -> dict:
        """Disaggregated prefill hop. Prompts of at least
        ``ship_min_tokens`` take one best-effort forward to a
        role=="prefill" replica — ``{"phase": "prefill"}`` runs a
        chunked prefill there and commits the KV pages as a tiny
        checkpoint — and the decode forward carries the returned
        ``kv_key`` so the decode replica imports pages instead of
        recomputing them. EVERY failure mode (no prefill capacity, a
        dead replica mid-ship, a gateway without a kv store, a torn
        commit) degrades to the unmodified request: the decode replica
        prefills locally and the answer is unaffected — counted in
        ``router_ship_fallbacks`` so the degradation is observable."""
        if self.ship_min_tokens <= 0 or len(prompt) < self.ship_min_tokens:
            return request
        ctx = request.get("_trace_ctx")
        now = self._clock()
        with self._cond:
            self._refresh_locked()
            prow = self._pick_prefill_locked(now)
        t0 = self._clock()
        wall = time.time()
        key = None
        err = "no_prefill_replica"
        if prow is not None:
            ship_req = {
                "id": f"{rid}#prefill",
                "phase": "prefill",
                "prompt": [int(t) for t in prompt],
            }
            if request.get("quantize") is not None:
                ship_req["quantize"] = bool(request.get("quantize"))
            try:
                resp = self._forward(prow, ship_req, self.timeout_s)
                key = resp.get("kv_key") or None
                if key is None:
                    err = "no kv_key in prefill response"
            except Exception as e:  # noqa: BLE001 — ship is optional
                err = str(e)[:200]
        if ctx is not None:
            ctx.add_span(
                "router.ship",
                ts=wall,
                dur_s=self._clock() - t0,
                parent=ctx.root_id,
                ok=key is not None,
                **(
                    {"replica": str(prow.get("id"))}
                    if prow is not None else {}
                ),
                **({} if key is not None else {"error": err}),
            )
        if key is None:
            with self._cond:
                self._counters["ship_fallbacks"] += 1
            _rec.event(
                "router.ship_fallback",
                request=rid,
                reason=err,
            )
            return request
        with self._cond:
            self._counters["ships"] += 1
        _rec.event(
            "router.ship",
            request=rid,
            replica=str(prow.get("id")),
            key=str(key),
        )
        out = dict(request)
        out["kv_key"] = str(key)
        return out

    # ----------------------------------------------------------- route
    def route(self, request: dict) -> dict:
        """Admit, pick, forward — with bounded retry — one request.

        ``request`` needs ``id`` (idempotency key), ``prompt`` (token
        id list) and ``max_new_tokens``; everything else passes through
        to the replica. Returns the replica's response dict. Raises
        ``FleetBusy`` (503) on admission timeout or retry exhaustion,
        ``ValueError`` on a malformed request.
        """
        rid = str(request.get("id") or "")
        if not rid:
            raise ValueError("request needs a non-empty id")
        # Malformed requests surface as ValueError HERE, before the
        # accepted counter moves — the front door maps it to 400, and
        # nothing else (a TypeError from an int() cast, a numpy refusal
        # on a ragged prompt) can escape route() as a non-contract
        # exception or skew the zero-drop accounting.
        try:
            prompt = np.asarray(
                request.get("prompt"), np.int32
            ).reshape(-1)
        except (TypeError, ValueError, OverflowError) as e:
            raise ValueError(
                f"prompt must be a list of token ids ({e})"
            ) from e
        if prompt.size == 0:
            raise ValueError("request needs a non-empty prompt")
        try:
            max_new = int(request.get("max_new_tokens") or 1)
        except (TypeError, ValueError) as e:
            raise ValueError(
                "max_new_tokens must be an integer, got "
                f"{request.get('max_new_tokens')!r}"
            ) from e
        while True:
            with self._cond:
                done = self._done.get(rid)
                if done is not None:
                    return dict(done)  # idempotent replay
                ev = self._inflight.get(rid)
                if ev is None:
                    self._inflight[rid] = ev = threading.Event()
                    break
            # A duplicate of an in-flight id: wait for the original,
            # then replay its answer (or become the new original if it
            # failed — the client's retry deserves a fresh attempt).
            ev.wait(
                timeout=self.queue_timeout_s
                + (self.retries + 1) * (self.timeout_s + _BACKOFF_CAP_S)
            )
        try:
            resp = self._route_once(rid, prompt, max_new, request)
            with self._cond:
                self._done[rid] = resp
                while len(self._done) > DONE_CACHE_MAX:
                    self._done.popitem(last=False)
            return dict(resp)
        finally:
            with self._cond:
                self._inflight.pop(rid, None)
            ev.set()

    def _route_once(
        self, rid: str, prompt: Any, max_new: int, request: dict
    ) -> dict:
        need = pages_needed(len(prompt), max_new, self.page_size)
        digests = (
            prefix_digests(prompt, self.page_size)
            if self.affinity else []
        )
        with self._cond:
            self._counters["accepted"] += 1
        request = self._maybe_ship(rid, prompt, request)
        attempt = 0
        tried: set[str] = set()
        last_replica: str | None = None
        last_err = "no eligible replica"
        queued_at = self._clock()
        # End-to-end tracing: the FrontDoor parks the minted
        # TraceContext under "_trace_ctx" (http_forward strips it — the
        # wire carries only the traceparent header). Untraced callers
        # pay one dict.get per request.
        ctx = request.get("_trace_ctx")
        prev_span: str | None = None
        while True:
            # ---- admission: wait (bounded) for a placeable replica
            deadline = self._clock() + self.queue_timeout_s
            wait_t0 = self._clock()
            with self._cond:
                self._waiting += 1
                _rec.gauge("router.queue_depth", self._waiting)
                try:
                    while True:
                        self._refresh_locked()
                        now = self._clock()
                        picked = self._pick_locked(
                            need, digests, tried, now
                        )
                        if picked is not None:
                            break
                        if now >= deadline:
                            self._counters["rejected"] += 1
                            _rec.event(
                                "router.reject",
                                request=rid,
                                reason="queue_timeout",
                                attempts=attempt,
                                pages=need,
                                last_error=str(last_err)[:200],
                            )
                            if ctx is not None:
                                ctx.escalate("queue_timeout")
                                dur = now - wait_t0
                                ctx.add_span(
                                    "router.queue",
                                    ts=time.time() - dur,
                                    dur_s=dur,
                                    parent=ctx.root_id,
                                    attempt=attempt,
                                )
                                ctx.add_span(
                                    "router.reject",
                                    ts=time.time(),
                                    parent=prev_span or ctx.root_id,
                                    reason="queue_timeout",
                                    attempts=attempt,
                                )
                            raise FleetBusy(
                                f"no fleet budget for {need} pages "
                                f"within {self.queue_timeout_s:.1f}s "
                                f"({last_err})"
                            )
                        self._cond.wait(
                            timeout=min(
                                self.wait_tick_s, deadline - now
                            )
                        )
                finally:
                    self._waiting -= 1
                    _rec.gauge("router.queue_depth", self._waiting)
                replica_id, row, affine = picked
                self._counters["wait_s"] += max(now - wait_t0, 0.0)
                self._charged[replica_id] = (
                    self._charged.get(replica_id, 0) + need
                )
                self._outstanding[replica_id] = (
                    self._outstanding.get(replica_id, 0) + 1
                )
            if affine:
                with self._cond:
                    self._counters["affinity_hits"] += 1
            rerouted = attempt > 0 and replica_id != last_replica
            if rerouted:
                with self._cond:
                    self._counters["reroutes"] += 1
                _rec.event(
                    "router.reroute",
                    request=rid,
                    attempt=attempt,
                    replica=replica_id,
                    failed=last_replica,
                )
                if ctx is not None:
                    # A reroute is tail-sampled: never lost to the
                    # head sampler.
                    ctx.escalate("reroute")
            if ctx is not None:
                dur = self._clock() - wait_t0
                ctx.add_span(
                    "router.queue",
                    ts=time.time() - dur,
                    dur_s=dur,
                    parent=ctx.root_id,
                    attempt=attempt,
                )
            _rec.event(
                "router.admit",
                request=rid,
                replica=replica_id,
                pages=need,
                attempt=attempt,
                affinity=affine,
                queue_wait_s=round(self._clock() - queued_at, 4),
            )
            # ---- forward (no router lock held across the network)
            fwd_span = None
            if ctx is not None:
                # Pre-assign this attempt's span id and make it the
                # propagation span: the replica's hop parents to the
                # exact forward attempt that carried it, and each
                # attempt links causally to the prior one.
                fwd_span = ctx.new_span_id()
                ctx.span_id = fwd_span
            fwd_t0 = self._clock()
            fwd_wall = time.time()
            try:
                resp = self._forward(row, request, self.timeout_s)
            except Exception as e:
                last_err = e
                attempt += 1
                with self._cond:
                    self._charged[replica_id] -= need
                    self._outstanding[replica_id] -= 1
                    self._counters["retries"] += 1
                    self._backoff_until[replica_id] = (
                        self._clock() + min(
                            self.backoff_s * (2 ** (attempt - 1)),
                            _BACKOFF_CAP_S,
                        )
                    )
                    self._cond.notify_all()
                tried.add(replica_id)
                last_replica = replica_id
                if ctx is not None:
                    ctx.escalate("error")
                    will_sleep = not (self.hedge and attempt == 1)
                    ctx.add_span(
                        "router.forward",
                        span_id=fwd_span,
                        parent=prev_span or ctx.root_id,
                        ts=fwd_wall,
                        dur_s=self._clock() - fwd_t0,
                        attempt=attempt - 1,
                        replica=replica_id,
                        ok=False,
                        error=str(e)[:200],
                        backoff_s=(
                            min(
                                self.backoff_s * (2 ** (attempt - 1)),
                                _BACKOFF_CAP_S,
                            )
                            if will_sleep and attempt <= self.retries
                            else 0.0
                        ),
                    )
                    prev_span = fwd_span
                if attempt > self.retries:
                    with self._cond:
                        self._counters["rejected"] += 1
                    _rec.event(
                        "router.reject",
                        request=rid,
                        reason="retries_exhausted",
                        attempts=attempt,
                        error=str(e)[:200],
                    )
                    if ctx is not None:
                        ctx.add_span(
                            "router.reject",
                            ts=time.time(),
                            parent=prev_span or ctx.root_id,
                            reason="retries_exhausted",
                            attempts=attempt,
                        )
                    raise FleetBusy(
                        f"retry budget ({self.retries}) exhausted: {e}"
                    ) from e
                _rec.event(
                    "router.retry",
                    request=rid,
                    attempt=attempt,
                    replica=replica_id,
                    error=str(e)[:200],
                )
                if not (self.hedge and attempt == 1):
                    self._sleep(
                        min(
                            self.backoff_s * (2 ** (attempt - 1)),
                            _BACKOFF_CAP_S,
                        )
                    )
                continue
            # ---- success
            if ctx is not None:
                ctx.add_span(
                    "router.forward",
                    span_id=fwd_span,
                    parent=prev_span or ctx.root_id,
                    ts=fwd_wall,
                    dur_s=self._clock() - fwd_t0,
                    attempt=attempt,
                    replica=replica_id,
                    ok=True,
                    reroute=rerouted,
                )
            with self._cond:
                self._charged[replica_id] -= need
                self._outstanding[replica_id] -= 1
                self._counters["requests"] += 1
                for dg in digests:
                    self._affinity_map[dg] = replica_id
                    self._affinity_map.move_to_end(dg)
                while len(self._affinity_map) > AFFINITY_MAP_MAX:
                    self._affinity_map.popitem(last=False)
                self._cond.notify_all()
            return resp

    # ----------------------------------------------------------- stats
    def stats(self) -> dict[str, Any]:
        """``router_*`` counters for the front door's /status (the JAX
        alert engine's reroute rule and the chaos harness's zero-drop
        audit read these keys). ``router_dropped`` is accepted work that
        is neither answered, rejected, nor still in flight: the
        invariant the chaos drives assert is 0."""
        with self._cond:
            c = dict(self._counters)
            inflight = len(self._inflight)
            return {
                "router_requests": c["requests"],
                "router_accepted": c["accepted"],
                "router_rejected": c["rejected"],
                "router_retries": c["retries"],
                "router_reroutes": c["reroutes"],
                "router_affinity_hits": c["affinity_hits"],
                "router_drains": c["drains"],
                "router_ships": c["ships"],
                "router_ship_fallbacks": c["ship_fallbacks"],
                "router_inflight": inflight,
                "router_queue_depth": self._waiting,
                "router_budget_pages": self._last_budget,
                "router_wait_s": round(c["wait_s"], 6),
                "router_dropped": max(
                    c["accepted"] - c["requests"] - c["rejected"]
                    - inflight,
                    0,
                ),
            }


# ----------------------------------------------------------- autoscale
def launch_command(action: str, replica_id: str) -> list[str]:
    """argv that builds a replacement replica's kernels before it takes
    traffic (the supervisor then starts the replica with its serve and
    export flags). The port has no compile cache to seed: its first-use
    cost is ``nvcc`` per kernel source (``ops/_build.py::build_all``),
    which a replacement must not pay under live load. The script path
    resolves relative to the package, never the caller's working
    directory: autoscale launches fire from a router whose working
    directory is not the repository."""
    script = pathlib.Path(__file__).resolve().parents[1] / "ops" / "_build.py"
    return [sys.executable, str(script)]


class AutoscaleController:
    """Minimal replacement/scale-up loop over fleet snapshots.

    Stateless policy, stateful dedup: each (action, key) pair fires at
    most once per ``cooldown_s`` — replacements must not flap faster
    than pods can start. ``launch`` is injectable (tests capture
    actions; production hands them to a process/pod supervisor);
    without one the controller still records and emits
    ``router.replace`` so the decision trail exists either way.
    """

    def __init__(
        self,
        launch: Callable[[dict], None] | None = None,
        *,
        enabled: bool = False,
        occ_high: float = 0.85,
        slo_rate_max: float = 0.05,
        cooldown_s: float = 120.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.enabled = bool(enabled)
        self.occ_high = float(occ_high)
        self.slo_rate_max = float(slo_rate_max)
        self.cooldown_s = float(cooldown_s)
        self._launch = launch
        self._clock = clock
        self._last_action: dict[str, float] = {}
        self._prev: tuple[float, float] | None = None
        self.actions: list[dict] = []

    def consider(self, snapshot: dict) -> list[dict]:
        """One policy sweep over a fleet snapshot; returns the actions
        THIS sweep caused (each also recorded on ``self.actions``)."""
        if not self.enabled:
            return []
        now = self._clock()
        out: list[dict] = []
        fleet = snapshot.get("fleet") or {}
        for row in snapshot.get("replicas") or []:
            if row.get("stale"):
                a = self._act(
                    "replace", str(row.get("id")), "stale", now
                )
                if a:
                    out.append(a)
        occ = fleet.get("slot_occupancy")
        if isinstance(occ, (int, float)) and occ > self.occ_high:
            a = self._act(
                "scale_up", "_fleet", f"occupancy {occ:.2f}", now
            )
            if a:
                out.append(a)
        req = fleet.get("requests")
        vio = fleet.get("slo_violations")
        if isinstance(req, (int, float)) and isinstance(
            vio, (int, float)
        ):
            if self._prev is not None:
                d_req = float(req) - self._prev[0]
                d_vio = float(vio) - self._prev[1]
                if d_req > 0 and d_vio / d_req > self.slo_rate_max:
                    a = self._act(
                        "scale_up", "_fleet",
                        f"slo_rate {d_vio / d_req:.3f}", now,
                    )
                    if a:
                        out.append(a)
            self._prev = (float(req), float(vio))
        return out

    def _act(
        self, action: str, key: str, reason: str, now: float
    ) -> dict | None:
        dedup = f"{action}:{key}"
        if (
            now - self._last_action.get(dedup, float("-inf"))
            < self.cooldown_s
        ):
            return None
        self._last_action[dedup] = now
        rec = {
            "action": action,
            "replica": key,
            "reason": reason,
            "command": launch_command(action, key),
        }
        _rec.event(
            "router.replace", action=action, replica=key, reason=reason
        )
        if self._launch is not None:
            try:
                self._launch(rec)
            except Exception as e:
                rec["error"] = str(e)[:200]
        self.actions.append(rec)
        return rec
