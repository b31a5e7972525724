"""End-to-end request tracing: the cross-process trace context, per-hop
spans and the critical-path TTFT attribution (counterpart of
``tpuflow/obs/trace.py``).

A request that enters through the front door crosses three processes
(FrontDoor -> Router forward -> ReplicaGateway -> ServeEngine) and, on a
reroute, several replicas. This module stitches those hops back into one
timeline:

- ``TraceContext``: a W3C-traceparent-style context (32-hex trace id,
  16-hex span id, sampled flag) minted at FrontDoor ingress
  (``maybe_mint``) and rebuilt replica-side from the ``traceparent`` HTTP
  header (``from_traceparent``). It carries the CLIENT request id, so
  every hop's spans key on the same id.
- **Sampling**: ``armed`` arms the whole layer (disarmed, every
  integration point is one ``is not None`` check), ``sample``
  head-samples at ingress, and ``escalate()`` force-records a context
  after the fact (SLO breach, reroute, forward error, queue timeout), so
  the tail is never lost to the head sampler. An unrecorded context still
  PROPAGATES (the flag rides the header), so a replica-side escalation can
  record the replica's half of the trace.
- **Spans** buffer on the context (``add_span``) and land in per-writer
  ``trace-<id>.jsonl`` files in one ``O_APPEND`` write each
  (``write_spans``): concurrent writers interleave spans, not bytes, and
  a crash tears at most the final line, which ``read_spans`` skips. The
  files are the JAX package's byte for byte, so either package's
  ``read_spans`` / ``assemble`` reads the other's.
- ``assemble`` / ``critical_path`` merge the cross-process spans into one
  timeline and attribute TTFT across router queue, forward attempts (each
  linked to the prior attempt; reroutes named), replica queue, prefill
  and the first decode tick; a rerouted request attributes across both
  replicas.

The JAX package reads ``TPUFLOW_TRACE``, ``TPUFLOW_TRACE_SAMPLE``,
``TPUFLOW_TRACE_DIR`` and ``TPUFLOW_FLEET_REPLICA_ID``; here they are the
``armed``, ``sample``, ``directory`` and ``writer`` arguments of the
functions that read them, with the JAX defaults (armed, every request
sampled, ``<recorder dir>/trace``, ``<host>-<pid>``). A context carries
its sink (``directory``, ``writer``) from where it is built to where it
is flushed.
"""

from __future__ import annotations

import importlib
import json
import os
import random
import re
import socket
import time
from typing import Any, Iterable

# The recorder submodule, not the package's ``recorder()`` accessor that
# shadows it once ``tpuflow_torch.obs`` is initialised.
_rec = importlib.import_module("tpuflow_torch.obs.recorder")

# W3C traceparent: version 00, 32-hex trace id, 16-hex parent span id,
# 2-hex flags (bit 0 = sampled). Anything else fails closed to None.
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)
_SAFE_RE = re.compile(r"[^A-Za-z0-9._-]+")

# Span names the assembled timeline's critical path attributes TTFT over,
# in hop order (span-record names in the trace JSONL, not telemetry
# catalog names).
ROUTER_QUEUE = "router.queue"
ROUTER_FORWARD = "router.forward"
ROUTER_INGRESS = "router.ingress"
ROUTER_REJECT = "router.reject"
GATEWAY_HOLD = "gateway.hold"
GATEWAY_ATTACH = "gateway.attach"
SERVE_QUEUE = "serve.queue"
SERVE_PREFILL = "serve.prefill"
SERVE_FIRST_TICK = "serve.first_tick"
SERVE_DECODE = "serve.decode"
SERVE_LIFECYCLE = "serve.lifecycle"


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class TraceContext:
    """One request's trace identity plus its in-process span buffer.

    ``span_id`` is the CURRENT propagation span (the router moves it to
    each forward attempt, so the replica's spans parent to the attempt
    that carried them); ``root_id`` stays the hop's entry span. The buffer
    is owned by exactly one request path per process: no lock.
    ``directory`` and ``writer`` are where ``flush`` writes (None: the
    defaults of :func:`trace_dir` and :func:`default_writer_id`).
    """

    __slots__ = (
        "trace_id", "span_id", "root_id", "request_id",
        "sampled", "escalated", "escalate_reason", "spans",
        "directory", "writer",
    )

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        request_id: str,
        sampled: bool,
        *,
        directory: str | None = None,
        writer: str | None = None,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.root_id = span_id
        self.request_id = request_id
        self.sampled = bool(sampled)
        self.escalated = False
        self.escalate_reason: str | None = None
        self.spans: list[dict] = []
        self.directory = directory
        self.writer = writer

    @property
    def recorded(self) -> bool:
        """Will this context's spans be written at flush?"""
        return self.sampled or self.escalated

    def to_traceparent(self) -> str:
        flag = "01" if self.recorded else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flag}"

    def new_span_id(self) -> str:
        return _hex_id(8)

    def escalate(self, reason: str) -> None:
        """Tail-sampling override: force-record this trace (SLO breach,
        reroute, error, queue timeout). The first escalation of a context
        emits the evidence event; repeats are silent."""
        if self.escalated:
            return
        self.escalated = True
        self.escalate_reason = str(reason)
        _rec.event(
            "trace.escalate",
            trace=self.trace_id,
            request=self.request_id,
            reason=str(reason),
        )

    def add_span(
        self,
        name: str,
        *,
        ts: float,
        dur_s: float | None = None,
        span_id: str | None = None,
        parent: str | None = None,
        **attrs,
    ) -> str:
        """Buffer one span; returns its span id (the causal handle the
        next hop or the next retry attempt links to)."""
        sid = span_id or self.new_span_id()
        span: dict[str, Any] = {
            "trace": self.trace_id,
            "span": sid,
            "parent": parent,
            "request": self.request_id,
            "name": str(name),
            "ts": round(float(ts), 6),
        }
        if dur_s is not None:
            span["dur_s"] = round(max(float(dur_s), 0.0), 6)
        span.update(attrs)
        self.spans.append(span)
        return sid


# ------------------------------------------------------------- minting
def maybe_mint(
    request_id: Any,
    *,
    armed: bool = True,
    sample: float = 1.0,
    directory: str | None = None,
    writer: str | None = None,
) -> TraceContext | None:
    """Ingress mint: None when ``armed`` is off, else a fresh context
    head-sampled at rate ``sample`` (an unsampled context still propagates
    so downstream escalation can record its own hops)."""
    if not armed:
        return None
    sampled = sample >= 1.0 or random.random() < sample
    return TraceContext(
        trace_id=_hex_id(16),
        span_id=_hex_id(8),
        request_id=str(request_id or ""),
        sampled=sampled,
        directory=directory,
        writer=writer,
    )


def from_traceparent(
    header: str | None,
    request_id: Any,
    *,
    armed: bool = True,
    directory: str | None = None,
    writer: str | None = None,
) -> TraceContext | None:
    """Replica-side context from a propagated ``traceparent`` header. None
    when ``armed`` is off, the header is absent, or it is malformed (fail
    closed: a garbled header must not break serving). The header's span id
    becomes the parent every local span hangs off."""
    if not header or not armed:
        return None
    m = _TRACEPARENT_RE.match(str(header).strip().lower())
    if m is None:
        return None
    return TraceContext(
        trace_id=m.group(1),
        span_id=m.group(2),
        request_id=str(request_id or ""),
        sampled=bool(int(m.group(3), 16) & 1),
        directory=directory,
        writer=writer,
    )


# ------------------------------------------------------------- writing
def default_writer_id(writer: str | None = None) -> str:
    """A span file's identity: ``writer`` (a fleet replica id, the JAX
    package's ``TPUFLOW_FLEET_REPLICA_ID``) when given, else host-pid."""
    if writer:
        return str(writer)
    return f"{socket.gethostname()}-{os.getpid()}"


def trace_dir(directory: str | None = None) -> str | None:
    """Where spans land: ``directory`` (the JAX ``TPUFLOW_TRACE_DIR``),
    else ``<recorder dir>/trace`` when an ``obs`` recorder is configured,
    else None (spans are counted dropped, never raised on)."""
    if directory:
        return directory
    rec = _rec.recorder()
    if rec is not None:
        return os.path.join(rec.directory, "trace")
    return None


def write_spans(
    spans: list[dict],
    *,
    writer: str,
    directory: str | None = None,
) -> bool:
    """Append spans to the writer's ``trace-<id>.jsonl`` in ONE O_APPEND
    write: concurrent writers interleave whole spans, never bytes, and a
    crash tears at most the final line, which ``read_spans`` skips.
    Failures count ``trace.dropped`` and return False: tracing never
    raises into the serving path."""
    if not spans:
        return True
    d = trace_dir(directory)
    if d is None:
        _rec.counter("trace.dropped", len(spans))
        return False
    safe = _SAFE_RE.sub("_", str(writer)) or "proc"
    try:
        data = b"".join(
            (
                json.dumps({**s, "writer": str(writer)}, default=str)
                + "\n"
            ).encode()
            for s in spans
        )
        os.makedirs(d, exist_ok=True)
        fd = os.open(
            os.path.join(d, f"trace-{safe}.jsonl"),
            os.O_WRONLY | os.O_CREAT | os.O_APPEND,
            0o644,
        )
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
    except OSError:
        _rec.counter("trace.dropped", len(spans))
        return False
    _rec.counter("trace.spans", len(spans))
    return True


def flush(ctx: TraceContext, *, writer: str | None = None) -> bool:
    """Drain the context's span buffer to disk IF it is recorded
    (head-sampled or escalated); an unrecorded buffer is discarded.
    Idempotent per buffer: the buffer empties either way. ``writer``
    overrides the context's."""
    spans, ctx.spans = ctx.spans, []
    if not spans:
        return True
    if not ctx.recorded:
        return True
    w = default_writer_id(writer or ctx.writer)
    ok = write_spans(spans, writer=w, directory=ctx.directory)
    if ok:
        _rec.event(
            "trace.flush",
            trace=ctx.trace_id,
            request=ctx.request_id,
            spans=len(spans),
            writer=w,
            escalated=ctx.escalate_reason,
        )
    return ok


def flush_lifecycle(
    ctx: TraceContext,
    phases: Iterable[dict],
    *,
    engine_request: Any = None,
    writer: str | None = None,
) -> bool:
    """Convert an engine request's lifecycle phases (submitted -> queued
    -> admitted -> first_token -> ticks -> complete/drained, monotonic
    times) into spans keyed by the PROPAGATED trace/request id and flush
    them: the replica half of the cross-process timeline. Called at the
    request's terminal transition."""
    phases = list(phases)
    if not phases:
        return False
    off = time.time() - time.monotonic()
    first_of: dict[str, dict] = {}
    for p in phases:
        ph = p.get("phase")
        if isinstance(ph, str) and ph not in first_of:
            first_of[ph] = p
    term = None
    for p in reversed(phases):
        if p.get("phase") in ("complete", "drained"):
            term = p
            break
    sub = first_of.get("submitted")
    adm = first_of.get("admitted")
    first = first_of.get("first_token")
    ticks = [p for p in phases if p.get("phase") == "tick"]
    parent = ctx.span_id

    def _seg(name: str, a: dict | None, b: dict | None, **attrs):
        if a is None or b is None:
            return
        ctx.add_span(
            name,
            ts=float(a["t"]) + off,
            dur_s=float(b["t"]) - float(a["t"]),
            parent=parent,
            **attrs,
        )

    queued = first_of.get("queued")
    _seg(
        SERVE_QUEUE, sub, adm,
        reason=queued.get("reason") if queued else None,
    )
    _seg(SERVE_PREFILL, adm, first,
         bucket=adm.get("bucket") if adm else None)
    _seg(SERVE_FIRST_TICK, first, ticks[0] if ticks else None)
    _seg(
        SERVE_DECODE, first, term,
        ticks=len(ticks),
        tokens=sum(int(t.get("tokens") or 0) for t in ticks),
    )
    if sub is not None and term is not None:
        ctx.add_span(
            SERVE_LIFECYCLE,
            ts=float(sub["t"]) + off,
            dur_s=float(term["t"]) - float(sub["t"]),
            parent=parent,
            terminal=term.get("phase"),
            engine_request=engine_request,
        )
    return flush(ctx, writer=writer)


# ------------------------------------------------------------- reading
def read_spans(directory: str) -> list[dict]:
    """Every well-formed span across the directory's ``*.jsonl`` files.
    Torn final lines (an append died mid-write), corrupt lines and
    non-span values are skipped: reading a damaged trail never raises."""
    out: list[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for fn in names:
        if not fn.endswith(".jsonl"):
            continue
        try:
            f = open(
                os.path.join(directory, fn),
                encoding="utf-8", errors="replace",
            )
        except OSError:
            continue
        with f:
            for line in f:
                if not line.endswith("\n"):
                    continue  # torn tail: the append died mid-write
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if (
                    isinstance(rec, dict)
                    and rec.get("trace")
                    and rec.get("name")
                ):
                    out.append(rec)
    return out


def spans_for_request(directory: str, request_id: Any) -> list[dict]:
    rid = str(request_id)
    return [
        s for s in read_spans(directory)
        if str(s.get("request")) == rid
    ]


def spans_for_trace(directory: str, trace_id: str) -> list[dict]:
    tid = str(trace_id)
    return [
        s for s in read_spans(directory) if str(s.get("trace")) == tid
    ]


# ------------------------------------------------------------ assembly
def _dur(s: dict) -> float:
    v = s.get("dur_s")
    return float(v) if isinstance(v, (int, float)) else 0.0


def critical_path(spans: list[dict]) -> list[dict]:
    """The TTFT critical path through the merged timeline, one segment a
    hop: router queue -> each failed forward attempt (+ its backoff) ->
    the reroute edge (named, with from/to replicas) -> replica queue ->
    prefill -> first decode tick. A rerouted request attributes across
    both replicas: the failed attempt's wall lives on the dead replica,
    the serve segments on the winner."""
    path: list[dict] = []
    queue_s = sum(
        _dur(s) for s in spans if s.get("name") == ROUTER_QUEUE
    )
    if any(s.get("name") == ROUTER_QUEUE for s in spans):
        path.append(
            {"segment": "router_queue", "dur_s": round(queue_s, 6)}
        )
    forwards = sorted(
        (s for s in spans if s.get("name") == ROUTER_FORWARD),
        key=lambda s: int(s.get("attempt") or 0),
    )
    last_failed = None
    for f in forwards:
        if f.get("ok"):
            if f.get("reroute"):
                path.append(
                    {
                        "segment": "reroute",
                        "from": last_failed,
                        "to": f.get("replica"),
                        "attempt": f.get("attempt"),
                    }
                )
            continue
        seg = {
            "segment": "forward_failed",
            "replica": f.get("replica"),
            "attempt": f.get("attempt"),
            "dur_s": round(_dur(f), 6),
            "error": f.get("error"),
        }
        if isinstance(f.get("backoff_s"), (int, float)):
            seg["backoff_s"] = round(float(f["backoff_s"]), 6)
        path.append(seg)
        last_failed = f.get("replica")
    for name, label in (
        (SERVE_QUEUE, "replica_queue"),
        (SERVE_PREFILL, "prefill"),
        (SERVE_FIRST_TICK, "first_decode_tick"),
        (SERVE_DECODE, "decode"),
    ):
        for s in spans:
            if s.get("name") == name:
                path.append(
                    {
                        "segment": label,
                        "replica": s.get("writer"),
                        "dur_s": round(_dur(s), 6),
                    }
                )
                break
    return path


def assemble(spans: list[dict]) -> dict[str, Any] | None:
    """Merge one request's cross-process spans into a single timeline:
    spans in wall-clock order, the participating writers, the
    client-observed wall (the ingress span when present, else the span
    envelope), the critical path and the TTFT breakdown. None when there
    is nothing to assemble."""
    spans = [s for s in spans if isinstance(s.get("ts"), (int, float))]
    if not spans:
        return None
    spans = sorted(spans, key=lambda s: (float(s["ts"]), str(s.get("name"))))
    t0 = float(spans[0]["ts"])
    ingress = next(
        (s for s in spans if s.get("name") == ROUTER_INGRESS), None
    )
    envelope = max(float(s["ts"]) + _dur(s) for s in spans) - t0
    wall = _dur(ingress) if ingress is not None and _dur(ingress) else envelope
    path = critical_path(spans)
    ttft_parts = {
        "router_queue_s": 0.0,
        "forward_failed_s": 0.0,
        "backoff_s": 0.0,
        "replica_queue_s": 0.0,
        "prefill_s": 0.0,
        "first_tick_s": 0.0,
    }
    for seg in path:
        if seg["segment"] == "router_queue":
            ttft_parts["router_queue_s"] += seg["dur_s"]
        elif seg["segment"] == "forward_failed":
            ttft_parts["forward_failed_s"] += seg["dur_s"]
            ttft_parts["backoff_s"] += seg.get("backoff_s", 0.0)
        elif seg["segment"] == "replica_queue":
            ttft_parts["replica_queue_s"] += seg["dur_s"]
        elif seg["segment"] == "prefill":
            ttft_parts["prefill_s"] += seg["dur_s"]
        elif seg["segment"] == "first_decode_tick":
            ttft_parts["first_tick_s"] += seg["dur_s"]
    ttft_parts = {k: round(v, 6) for k, v in ttft_parts.items()}
    return {
        "request": spans[0].get("request"),
        "trace": spans[0].get("trace"),
        "spans": spans,
        "writers": sorted(
            {str(s.get("writer")) for s in spans if s.get("writer")}
        ),
        "wall_s": round(wall, 6),
        "rerouted": any(seg["segment"] == "reroute" for seg in path),
        "critical_path": path,
        "ttft_breakdown": ttft_parts,
        "ttft_s": round(
            sum(v for k, v in ttft_parts.items() if k != "backoff_s")
            + ttft_parts["backoff_s"],
            6,
        ),
    }


def format_timeline(assembled: dict[str, Any]) -> list[str]:
    """Human lines of an assembled trace: the merged timeline (one line a
    span, offsets from the first span), then the critical-path TTFT
    breakdown."""
    out = [
        f"trace {assembled.get('trace')} request "
        f"{assembled.get('request')!r}: {len(assembled['spans'])} spans "
        f"across {', '.join(assembled['writers']) or '?'} — wall "
        f"{assembled['wall_s']:.4f}s"
        + (" [REROUTED]" if assembled.get("rerouted") else "")
    ]
    t0 = float(assembled["spans"][0]["ts"])
    for s in assembled["spans"]:
        extra = []
        for k in ("replica", "attempt", "ok", "reroute", "status",
                  "terminal", "error", "attached"):
            if s.get(k) is not None:
                extra.append(f"{k}={s[k]}")
        dur = f" dur={_dur(s):.4f}s" if s.get("dur_s") is not None else ""
        out.append(
            f"  +{float(s['ts']) - t0:8.4f}s  "
            f"{str(s.get('writer') or '?'):<16} {s['name']:<18}"
            f"{dur}"
            + (f"  [{' '.join(extra)}]" if extra else "")
        )
    out.append("critical path (TTFT attribution):")
    for seg in assembled["critical_path"]:
        if seg["segment"] == "reroute":
            out.append(
                f"  reroute: {seg.get('from')} -> {seg.get('to')} "
                f"(attempt {seg.get('attempt')})"
            )
            continue
        who = f" @{seg['replica']}" if seg.get("replica") else ""
        out.append(
            f"  {seg['segment']:<18} {seg.get('dur_s', 0.0):.4f}s{who}"
        )
    out.append(
        "ttft ~ " + " + ".join(
            f"{k.removesuffix('_s')}={v:.4f}s"
            for k, v in assembled["ttft_breakdown"].items()
            if v
        )
    )
    return out
