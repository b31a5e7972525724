"""Fleet observatory: discover N serving replicas, poll their ``/status``
endpoints and aggregate one fleet snapshot (counterpart of
``tpuflow/obs/fleet.py``). Host-side and stdlib only.

Exported TTFT/ITL percentiles are per-replica gauges that cannot merge
(the mean of N p99s is not the fleet p99). This module is the layer above
one replica's observatory, in four pieces:

- **Mergeable histograms.** :class:`MergeableHistogram` holds raw TTFT/ITL
  observations as fixed-edge bucket counts (the Prometheus histogram
  convention). Merging across replicas is an integer sum, bit-equal to
  the counts of the pooled raw observations, and :func:`hist_pctl` reads
  fleet percentiles off the merged counts. The default edges equal the
  JAX package's, so a fleet of both packages' replicas merges.
- **Discovery.** :func:`discover_replicas` resolves the fleet from an
  explicit target (a registration directory or a comma URL list), a URL
  list, or the file-based registry each exporting replica stamps at
  export start (:func:`maybe_register`). A URL whose hostname resolves to
  several A records expands into one replica per address.
- **Polling.** :class:`FleetObservatory` polls every replica's ``/status``
  with a per-replica timeout, exponential backoff on consecutive
  failures and staleness marking: a replica that stops answering, or
  answers with malformed JSON, is marked stale and never crashes the
  watcher.
- **Aggregation.** :meth:`FleetObservatory.poll` folds the fresh replicas
  into one fleet snapshot: summed load, occupancy-weighted decode
  utilisation, fleet-exact TTFT/ITL percentiles from the merged
  histograms, SLO violation rates by traffic group, and a per-replica
  health score (a router's admission signal); snapshots optionally
  append to a JSONL file.

The JAX package reads ``TPUFLOW_FLEET_REPLICA_ID``, ``_REGISTRATION_DIR``,
``_REPLICAS``, ``_POLL_S``, ``_STALE_S`` and ``_SNAPSHOT_PATH``; here each
is an argument of the function that reads it (README, "The serving replica
on the port"). Its ``_HIST_BUCKETS`` has no counterpart: a port replica's
histograms always use :data:`DEFAULT_HIST_EDGES`, the JAX default.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import socket
import threading
import time
from typing import Any, Callable, Iterable

from tpuflow_torch.obs.serve_ledger import pctl  # the shared nearest-rank math

# The recorder submodule, not the package's ``recorder()`` accessor that
# shadows it once ``tpuflow_torch.obs`` is initialised.
_rec = importlib.import_module("tpuflow_torch.obs.recorder")

# Default TTFT/ITL bucket upper edges (seconds): a Prometheus-style
# 1ms → 10s ladder wide enough for both sub-ms ITLs and multi-second
# cold TTFTs, equal to the JAX package's. Every replica of a fleet must
# agree on the edges or its histogram cannot merge (mismatches are
# flagged, never summed).
DEFAULT_HIST_EDGES: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# The observatory's staleness threshold and poll cadence, in seconds.
DEFAULT_STALE_S = 15.0
DEFAULT_POLL_S = 5.0


class MergeableHistogram:
    """Fixed-edge latency histogram whose cross-replica merge is a sum.

    ``counts[i]`` holds observations in ``(edges[i-1], edges[i]]``
    (first bucket: ``[0, edges[0]]``); ``counts[-1]`` is the overflow
    (> last edge). Cumulative-``le`` rendering happens at export time —
    internal counts stay per-bucket so merges and tests are plain
    integer sums."""

    __slots__ = ("edges", "counts", "count", "sum", "exemplars")

    def __init__(self, edges: Iterable[float] | None = None):
        self.edges: tuple[float, ...] = tuple(
            DEFAULT_HIST_EDGES if edges is None else edges
        )
        self.counts: list[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        # Prometheus-style exemplars: each bucket remembers the LAST
        # trace id observed into it, so a fleet percentile resolves to
        # a concrete `obs trace` timeline. None entries cost nothing
        # and to_dict omits the key entirely until one is set.
        self.exemplars: list[str | None] = [None] * (len(self.edges) + 1)

    def observe(self, v: float, exemplar: str | None = None) -> None:
        i = bisect.bisect_left(self.edges, float(v))
        self.counts[i] += 1
        self.count += 1
        self.sum += float(v)
        if exemplar is not None:
            self.exemplars[i] = str(exemplar)

    def to_dict(self) -> dict[str, Any]:
        out = {
            "edges": list(self.edges),
            "counts": list(self.counts),
            "count": self.count,
            "sum": round(self.sum, 9),
        }
        if any(e is not None for e in self.exemplars):
            out["exemplars"] = list(self.exemplars)
        return out

    def cumulative(self) -> list[int]:
        """Prometheus ``le`` counts: cumulative per-bucket counts, the
        last entry (``le="+Inf"``) equal to ``count``."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


def merge_hists(hists: Iterable[dict]) -> dict[str, Any] | None:
    """Sum histogram dicts (the ``to_dict`` shape) sharing one edge
    ladder. Dicts with different edges are SKIPPED and reported under
    ``"skipped"`` — summing across mismatched edges would silently
    corrupt the fleet percentiles, the exact failure gauges have.
    Returns None when nothing merges."""
    merged: dict[str, Any] | None = None
    skipped = 0
    for h in hists:
        try:
            edges = list(h["edges"])
            counts = [int(c) for c in h["counts"]]
            if len(counts) != len(edges) + 1:
                raise ValueError("count/edge shape")
        except (TypeError, KeyError, ValueError):
            skipped += 1
            continue
        ex = h.get("exemplars")
        if not (isinstance(ex, list) and len(ex) == len(counts)):
            ex = None  # absent/malformed exemplars degrade, never skip
        if merged is None:
            merged = {
                "edges": edges,
                "counts": counts,
                "count": int(h.get("count", sum(counts))),
                "sum": float(h.get("sum", 0.0)),
            }
            if ex is not None:
                merged["exemplars"] = list(ex)
        elif edges == merged["edges"]:
            merged["counts"] = [
                a + b for a, b in zip(merged["counts"], counts)
            ]
            merged["count"] += int(h.get("count", sum(counts)))
            merged["sum"] += float(h.get("sum", 0.0))
            if ex is not None:
                prev = merged.get("exemplars") or [None] * len(counts)
                merged["exemplars"] = [
                    b if b is not None else a for a, b in zip(prev, ex)
                ]
        else:
            skipped += 1
    if merged is not None and skipped:
        merged["skipped"] = skipped
    return merged


def hist_pctl(edges, counts, q: float) -> float | None:
    """Nearest-rank percentile over histogram counts: the upper edge of
    the bucket holding the rank-``q`` observation (the same rank index
    as the shared raw-observation :func:`pctl`, so the histogram answer
    is within one bucket width of the pooled raw answer — and two
    fleets with bit-equal counts report bit-equal percentiles).
    Overflow-bucket ranks return ``inf`` (the edges under-span the
    data); empty counts return None."""
    n = sum(counts)
    if n <= 0:
        return None
    rank = min(n - 1, int(q * (n - 1) + 0.5))
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc > rank:
            return float(edges[i]) if i < len(edges) else float("inf")
    return float("inf")


def hist_percentiles(h: dict | None) -> dict[str, float] | None:
    """{count, p50, p95, p99} from a histogram dict — the fleet twin of
    ``serve_ledger.percentiles`` (which works on raw observations)."""
    if not h or not h.get("count"):
        return None
    edges, counts = h["edges"], h["counts"]
    return {
        "count": int(h["count"]),
        "p50": hist_pctl(edges, counts, 0.50),
        "p95": hist_pctl(edges, counts, 0.95),
        "p99": hist_pctl(edges, counts, 0.99),
    }


def hist_exemplar(h: dict | None, q: float) -> str | None:
    """The trace-id exemplar for the bucket holding the rank-``q``
    observation (same rank walk as :func:`hist_pctl`), so "fleet p99
    TTFT regressed" resolves to a concrete ``obs trace`` timeline.
    None when the histogram is empty, carries no exemplars, or the
    target bucket never recorded one."""
    if not h or not h.get("count"):
        return None
    ex = h.get("exemplars")
    counts = h.get("counts") or []
    if not (isinstance(ex, list) and len(ex) == len(counts)):
        return None
    n = sum(counts)
    if n <= 0:
        return None
    rank = min(n - 1, int(q * (n - 1) + 0.5))
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc > rank:
            return ex[i] if isinstance(ex[i], str) else None
    return None


# ------------------------------------------------------ replica identity
def replica_identity(replica_id: str | None = None) -> dict[str, Any]:
    """This process's replica identity, stamped into ``/status`` and the
    registration file: ``replica_id`` (a deployment sets it from the pod
    name), else host and pid; the launch attempt (``utils/preempt.py``'s
    ``configure(attempt=)``); and the elastic mesh generation when this
    process is a gang member. The preemption and membership modules are
    consulted only if ALREADY imported: an export process must not pull
    the distributed runtime in for an id stamp."""
    rid = replica_id or f"{socket.gethostname()}-{os.getpid()}"
    ident: dict[str, Any] = {"id": str(rid)}
    import sys

    pm = sys.modules.get("tpuflow_torch.utils.preempt")
    ident["attempt"] = int(pm.launch_attempt()) if pm is not None else 0
    mm = sys.modules.get("tpuflow_torch.dist.membership")
    if mm is not None:
        try:
            ident["mesh_generation"] = int(mm.current_generation())
        except Exception:
            pass
    return ident


# ----------------------------------------------------------- registration
def registration_path(directory: str, replica_id: str) -> str:
    safe = "".join(
        c if c.isalnum() or c in "-_." else "_" for c in replica_id
    )
    return os.path.join(directory, f"replica-{safe}.json")


def register_replica(
    directory: str,
    url: str,
    *,
    identity: dict | None = None,
) -> str:
    """Stamp one replica's registration file (atomic tmp+rename so a
    concurrent fleet poll never reads a torn record — and if it does
    anyway, the poller's malformed-JSON path marks it stale rather than
    crashing). Returns the path written."""
    ident = dict(identity or replica_identity())
    path = registration_path(directory, str(ident.get("id", "replica")))
    os.makedirs(directory, exist_ok=True)
    record = {
        "url": url,
        "replica": ident,
        "pid": os.getpid(),
        "registered_ts": time.time(),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, path)
    _rec.event(
        "fleet.register", url=url, replica=ident.get("id"), path=path
    )
    return path


def maybe_register(
    url: str,
    registration_dir: str | None = None,
    *,
    replica_id: str | None = None,
) -> str | None:
    """Register into ``registration_dir`` when given (the export start
    calls this the moment /status starts answering); a write failure
    warns and returns None: registration must never take a serving
    process down."""
    if not registration_dir:
        return None
    try:
        return register_replica(
            registration_dir, url, identity=replica_identity(replica_id)
        )
    except OSError as e:
        print(f"[tpuflow] fleet registration failed ({e}); skipping")
        return None


def read_registrations(directory: str) -> list[dict]:
    """Every parseable registration record under ``directory`` (sorted
    by replica id). Torn/mid-write files are skipped — the replica they
    describe will register again or age into staleness."""
    out: list[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("replica-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict) and isinstance(rec.get("url"), str):
            out.append(rec)
    return out


# -------------------------------------------------------------- discovery
def _expand_dns(url: str) -> list[str]:
    """Expand a URL whose hostname resolves to multiple A records into
    one URL per address — the k8s headless-Service discovery mode (one
    DNS name → every pod IP). Literal IPs, localhost, and unresolvable
    names pass through unchanged."""
    try:
        from urllib.parse import urlsplit, urlunsplit

        parts = urlsplit(url)
        host = parts.hostname
        if not host or host == "localhost":
            return [url]
        try:
            socket.inet_aton(host)
            return [url]  # already a literal IPv4
        except OSError:
            pass
        infos = socket.getaddrinfo(
            host, parts.port or 80, socket.AF_INET, socket.SOCK_STREAM
        )
        addrs = sorted({i[4][0] for i in infos})
        if len(addrs) <= 1:
            return [url]
        port = f":{parts.port}" if parts.port else ""
        return [
            urlunsplit(
                (parts.scheme, f"{a}{port}", parts.path, parts.query, "")
            )
            for a in addrs
        ]
    except OSError:
        return [url]


def _normalize_url(u: str) -> str:
    u = u.strip().rstrip("/")
    if u and "://" not in u:
        u = f"http://{u}"
    return u


def discover_replicas(
    target: str | None = None,
    *,
    replicas: str | None = None,
    registration_dir: str | None = None,
) -> list[tuple[str, str | None]]:
    """Resolve the fleet into ``(url, replica_id_or_None)`` pairs.

    ``target`` may be a registration directory or a comma URL list; with
    no target, the ``replicas`` comma URL list wins over
    ``registration_dir``. Hostnames with multiple A records (a headless
    Service) expand into one replica per address."""
    if target:
        if os.path.isdir(target):
            return [
                (
                    _normalize_url(r["url"]),
                    (r.get("replica") or {}).get("id"),
                )
                for r in read_registrations(target)
            ]
        urls = [u for u in target.split(",") if u.strip()]
    elif replicas:
        urls = [u for u in replicas.split(",") if u.strip()]
    elif registration_dir:
        return discover_replicas(registration_dir)
    else:
        return []
    out: list[tuple[str, str | None]] = []
    for u in urls:
        for expanded in _expand_dns(_normalize_url(u)):
            out.append((expanded, None))
    return out


def _fetch_status(url: str, timeout_s: float) -> dict:
    """GET ``<url>/status`` → parsed dict. Raises OSError/ValueError on
    anything short of a whole, parseable JSON object — the poller's
    failure path (→ staleness) handles both a dead socket and a
    truncated body identically."""
    import urllib.request

    with urllib.request.urlopen(
        url.rstrip("/") + "/status", timeout=timeout_s
    ) as r:
        body = r.read().decode()
    obj = json.loads(body)  # truncated body → ValueError → stale
    if not isinstance(obj, dict):
        raise ValueError(f"/status returned {type(obj).__name__}")
    return obj


# ---------------------------------------------------------- health score
def health_score(
    status: dict | None,
    *,
    stale: bool,
    slo_delta: int = 0,
    queue_growing: bool = False,
) -> tuple[float, list[str]]:
    """One replica's admission-signal health in [0, 1] with the reasons
    that docked it. Deterministic and host-pure so the future router
    can rank replicas from a fleet snapshot alone:

    - ``stale``         → 0.0 (unreachable/torn /status: never route to it)
    - ``nonfinite``     → −0.5 (NaN/Inf in its exported numbers, or
      nonfinite_steps > 0: its gauges cannot be trusted)
    - ``slo_violating`` → −0.25 (new SLO violations since the last poll)
    - ``queue_growing`` → −0.25 (queue depth rose across recent polls:
      the replica is falling behind its arrivals)
    """
    if stale or status is None:
        return 0.0, ["stale"]
    score, reasons = 1.0, []
    nonfinite = int(status.get("nonfinite_steps", 0) or 0) > 0
    if not nonfinite:
        for k, v in status.items():
            if isinstance(v, float) and v != v:  # NaN without math import
                nonfinite = True
                break
    if nonfinite:
        score -= 0.5
        reasons.append("nonfinite")
    if slo_delta > 0:
        score -= 0.25
        reasons.append("slo_violating")
    if queue_growing:
        score -= 0.25
        reasons.append("queue_growing")
    return max(score, 0.0), reasons


# ------------------------------------------------------------ aggregation
def _sum_key(statuses: list[dict], key: str) -> float | None:
    vals = [
        s[key] for s in statuses if isinstance(s.get(key), (int, float))
    ]
    return sum(vals) if vals else None


def aggregate(statuses: list[dict]) -> dict[str, Any]:
    """Fold fresh replica ``/status`` dicts into the fleet view: sums
    for load (queue/pages/tokens/requests), occupancy-weighted decode
    utilization (a replica's ledger fraction weighted by its slot
    occupancy — an idle replica must not drag the fleet number), merged
    TTFT/ITL histograms → fleet-exact percentiles, and per-traffic-group
    SLO violation rates."""
    out: dict[str, Any] = {"replicas": len(statuses)}
    for key in (
        "serve_queue_depth", "serve_pages_free", "serve_tokens_per_s",
        "serve_requests", "serve_tokens", "serve_slo_violations",
        "serve_pages_host", "serve_pages_disk", "serve_tier_hits",
    ):
        v = _sum_key(statuses, key)
        if v is not None:
            out[key.replace("serve_", "")] = round(v, 4)
    # Occupancy-weighted decode utilization from the engine-time ledger.
    wsum = usum = 0.0
    for s in statuses:
        util = s.get("serve_decode_utilization")
        occ = s.get("serve_slot_occupancy")
        if isinstance(util, (int, float)) and isinstance(
            occ, (int, float)
        ):
            w = max(float(occ), 1e-9)
            wsum += w
            usum += w * float(util)
    if wsum > 0:
        out["decode_utilization"] = round(usum / wsum, 4)
    occs = [
        s["serve_slot_occupancy"] for s in statuses
        if isinstance(s.get("serve_slot_occupancy"), (int, float))
    ]
    if occs:
        out["slot_occupancy"] = round(sum(occs) / len(occs), 4)
    # HBM headroom: the router's admission constraint is the
    # TIGHTEST replica, so the fleet view carries the max used/peak
    # fraction and the min headroom — a fleet-mean would hide the one
    # replica about to OOM. Keys absent when no replica reports (CPU).
    hbm_fracs = [
        s["hbm_used_frac"] for s in statuses
        if isinstance(s.get("hbm_used_frac"), (int, float))
    ]
    if hbm_fracs:
        out["hbm_used_frac_max"] = round(max(hbm_fracs), 4)
        out["hbm_min_headroom_frac"] = round(
            min(1.0 - f for f in hbm_fracs), 4
        )
    hbm_peaks = [
        s["hbm_peak_frac"] for s in statuses
        if isinstance(s.get("hbm_peak_frac"), (int, float))
    ]
    if hbm_peaks:
        out["hbm_peak_frac_max"] = round(max(hbm_peaks), 4)
    # Fleet-exact latency percentiles: merged histogram counts are the
    # counts of the pooled observations, bit for bit.
    for which in ("ttft", "itl"):
        merged = merge_hists(
            s.get(f"serve_{which}_hist")
            for s in statuses
            if isinstance(s.get(f"serve_{which}_hist"), dict)
        )
        if merged:
            out[f"{which}_hist"] = merged
            p = hist_percentiles(merged)
            if p:
                out[which] = p
    # SLO violation counts + rates split by traffic group.
    by_group: dict[str, int] = {}
    req_group: dict[str, int] = {}
    for s in statuses:
        for g, n in (s.get("serve_slo_by_group") or {}).items():
            try:
                by_group[g] = by_group.get(g, 0) + int(n)
            except (TypeError, ValueError):
                continue
        for g, n in (s.get("serve_requests_by_group") or {}).items():
            try:
                req_group[g] = req_group.get(g, 0) + int(n)
            except (TypeError, ValueError):
                continue
    if by_group or req_group:
        out["slo_by_group"] = dict(sorted(by_group.items()))
        out["requests_by_group"] = dict(sorted(req_group.items()))
        out["slo_rate_by_group"] = {
            g: round(by_group.get(g, 0) / max(req_group.get(g, 0), 1), 4)
            for g in sorted(set(by_group) | set(req_group))
        }
    return out


def append_snapshot(path: str, snapshot: dict) -> bool:
    """Append one fleet snapshot as a JSONL line (post-hoc analysis
    trail); failures are reported via the return value, never raised.

    Multi-writer safe: a router's poller and a concurrent watcher may
    both point at the same snapshot path, so the whole line lands in ONE
    O_APPEND write — concurrent appenders interleave snapshots, not
    bytes (the registry's crash-safe idiom), and a crash tears at most
    the final line, which ``read_snapshots`` skips."""
    try:
        data = (json.dumps(snapshot, default=str) + "\n").encode()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
        return True
    except OSError:
        return False


def read_snapshots(path: str) -> list[dict]:
    """Every well-formed fleet snapshot in file order. A torn final line
    (an append died mid-write), a corrupt line, or a non-snapshot JSON
    value is skipped — reading a damaged trail never raises."""
    out: list[dict] = []
    try:
        f = open(path, encoding="utf-8", errors="replace")
    except OSError:
        return out
    with f:
        for line in f:
            if not line.endswith("\n"):
                continue  # torn tail: the append died mid-write
            line = line.strip()
            if not line:
                continue
            try:
                snap = json.loads(line)
            except ValueError:
                continue
            if isinstance(snap, dict) and isinstance(
                snap.get("fleet"), dict
            ):
                out.append(snap)
    return out


# ---------------------------------------------------------------- poller
class _Replica:
    __slots__ = (
        "url", "rid", "status", "last_ok", "failures", "next_ok_after",
        "error", "was_stale", "prev_requests", "prev_ts", "prev_slo",
        "queue_trend", "rate",
    )

    def __init__(self, url: str, rid: str | None):
        self.url = url
        self.rid = rid
        self.status: dict | None = None
        self.last_ok: float | None = None
        self.failures = 0
        self.next_ok_after = 0.0
        self.error: str | None = None
        self.was_stale = False
        self.prev_requests: float | None = None
        self.prev_ts: float | None = None
        self.prev_slo: float | None = None
        self.queue_trend = 0
        self.rate: float | None = None

    @property
    def id(self) -> str:
        if self.rid:
            return self.rid
        rep = (self.status or {}).get("replica")
        if isinstance(rep, dict) and rep.get("id"):
            return str(rep["id"])
        return self.url


class FleetObservatory:
    """Discover + poll + aggregate one serving fleet.

    ``target``: a registration directory or a comma URL list. ``fetch`` is
    injectable (tests drive malformed/truncated payloads without
    sockets). ``stale_s`` (default 15 s) and ``poll_interval_s`` (default
    5 s, also the base of the failure backoff) are the JAX package's
    ``TPUFLOW_FLEET_STALE_S`` and ``TPUFLOW_FLEET_POLL_S``;
    ``snapshot_path`` its ``TPUFLOW_FLEET_SNAPSHOT_PATH``."""

    def __init__(
        self,
        target: str | None = None,
        *,
        timeout_s: float = 2.0,
        stale_s: float | None = None,
        poll_interval_s: float | None = None,
        snapshot_path: str | None = None,
        fetch: Callable[[str, float], dict] | None = None,
    ):
        self.target = target
        self.timeout_s = float(timeout_s)
        self.stale_s = float(
            stale_s if stale_s is not None else DEFAULT_STALE_S
        )
        self.poll_interval_s = float(
            poll_interval_s if poll_interval_s is not None
            else DEFAULT_POLL_S
        )
        self.snapshot_path = snapshot_path
        self._fetch = fetch or _fetch_status
        self._replicas: dict[str, _Replica] = {}

    def discover(self) -> list[_Replica]:
        """Refresh the replica set (new registrations join, vanished
        registrations keep their slot — they age into staleness, which
        is the evidence a router needs; they never silently vanish)."""
        for url, rid in discover_replicas(self.target):
            rep = self._replicas.get(url)
            if rep is None:
                self._replicas[url] = _Replica(url, rid)
            elif rid and not rep.rid:
                rep.rid = rid
        return list(self._replicas.values())

    def _poll_one(self, rep: _Replica, now: float) -> None:
        if now < rep.next_ok_after:
            return  # backing off after consecutive failures
        try:
            status = self._fetch(rep.url, self.timeout_s)
        except (OSError, ValueError) as e:
            # Dead socket, HTTP error, or a torn/mid-write JSON body:
            # count the failure, back off, and let staleness marking
            # carry the evidence — the watcher itself never dies.
            rep.failures += 1
            rep.error = f"{type(e).__name__}: {e}"[:200]
            rep.next_ok_after = now + min(
                self.poll_interval_s * (2 ** (rep.failures - 1)), 60.0
            )
            return
        prev_q = (rep.status or {}).get("serve_queue_depth")
        rep.failures = 0
        rep.next_ok_after = 0.0
        rep.error = None
        # Per-replica request rate (fleet QPS term) from consecutive
        # successful polls of the cumulative completion counter.
        reqs = status.get("serve_requests")
        if isinstance(reqs, (int, float)):
            if rep.prev_requests is not None and now > (rep.prev_ts or 0):
                rep.rate = max(
                    (float(reqs) - rep.prev_requests)
                    / (now - rep.prev_ts),
                    0.0,
                )
            rep.prev_requests = float(reqs)
            rep.prev_ts = now
        q = status.get("serve_queue_depth")
        if isinstance(q, (int, float)) and isinstance(
            prev_q, (int, float)
        ):
            rep.queue_trend = (
                rep.queue_trend + 1 if q > prev_q else 0
            )
        rep.status = status
        rep.last_ok = now

    def poll(self) -> dict[str, Any]:
        """One sweep: discover, poll every replica, aggregate, persist.
        Returns the fleet snapshot (also appended to the snapshot JSONL
        when configured)."""
        with _rec.span("fleet.poll", replicas=len(self._replicas)):
            reps = self.discover()
            now = time.monotonic()
            for rep in reps:
                self._poll_one(rep, now)
            snapshot = self.snapshot(now=time.monotonic())
        _rec.gauge(
            "fleet.size",
            snapshot["fleet"]["replicas"],
            healthy=snapshot["fleet"]["healthy"],
        )
        if snapshot["fleet"].get("qps") is not None:
            _rec.gauge("fleet.qps", snapshot["fleet"]["qps"])
        if self.snapshot_path:
            append_snapshot(self.snapshot_path, snapshot)
        return snapshot

    def snapshot(self, now: float | None = None) -> dict[str, Any]:
        """The current fleet view without re-polling (poll() calls this;
        consumers wanting a fresh sweep call poll())."""
        if now is None:
            now = time.monotonic()
        rows: list[dict] = []
        fresh: list[dict] = []
        rates: list[float] = []
        for rep in self._replicas.values():
            stale = (
                rep.last_ok is None
                or (now - rep.last_ok) > self.stale_s
            )
            if stale and not rep.was_stale:
                _rec.event(
                    "fleet.replica_stale",
                    replica=rep.id,
                    url=rep.url,
                    age_s=(
                        None if rep.last_ok is None
                        else round(now - rep.last_ok, 3)
                    ),
                    error=rep.error,
                )
            rep.was_stale = stale
            slo_now = (rep.status or {}).get("serve_slo_violations")
            slo_delta = 0
            if isinstance(slo_now, (int, float)):
                if rep.prev_slo is not None:
                    slo_delta = int(slo_now - rep.prev_slo)
                rep.prev_slo = float(slo_now)
            score, reasons = health_score(
                rep.status,
                stale=stale,
                slo_delta=slo_delta,
                queue_growing=rep.queue_trend >= 2,
            )
            row: dict[str, Any] = {
                "id": rep.id,
                "url": rep.url,
                "stale": stale,
                "health": round(score, 3),
                "health_reasons": reasons,
                "queue_trend": rep.queue_trend,
            }
            if rep.last_ok is not None:
                row["age_s"] = round(now - rep.last_ok, 3)
            if rep.error:
                row["error"] = rep.error
            if rep.rate is not None:
                row["qps"] = round(rep.rate, 3)
            if rep.status is not None:
                rep_ident = rep.status.get("replica")
                if isinstance(rep_ident, dict):
                    row["replica"] = rep_ident
                for key in (
                    "serve_queue_depth", "serve_slot_occupancy",
                    "serve_tokens_per_s", "serve_requests",
                    "serve_slo_violations", "serve_pages_free",
                    "serve_decode_utilization", "serve_idle_fraction",
                    "serve_decode_fraction", "serve_ttft_p99_s",
                    "serve_itl_p99_s", "serve_draining",
                    "serve_role", "serve_pages_host", "serve_pages_disk",
                    "serve_tier_hits",
                    "generate_url", "uptime_s",
                    "step", "mfu", "hbm_used_frac", "hbm_peak_frac",
                ):
                    if key in rep.status:
                        row[key] = rep.status[key]
            rows.append(row)
            if not stale and rep.status is not None:
                fresh.append(rep.status)
                if rep.rate is not None:
                    rates.append(rep.rate)
        fleet = aggregate(fresh)
        fleet["replicas"] = len(rows)
        fleet["healthy"] = sum(
            1 for r in rows if not r["stale"] and r["health"] >= 0.5
        )
        fleet["stale"] = sum(1 for r in rows if r["stale"])
        if rates:
            fleet["qps"] = round(sum(rates), 3)
        fleet["min_health"] = min(
            (r["health"] for r in rows), default=0.0
        )
        return {"ts": time.time(), "fleet": fleet, "replicas": rows}


class FleetPoller:
    """Background sweep loop over a :class:`FleetObservatory`.

    The front-door router requires a CHEAP ``snapshot_fn`` —
    ``observatory.poll()`` is a synchronous HTTP sweep of every replica
    and must never run on the routing path (an unresponsive /status
    would stall admission exactly when the fleet is degraded). The
    poller owns that sweep on a daemon thread (``interval_s``, default
    the observatory's poll cadence) and hands consumers
    :meth:`snapshot`: the last COMPLETED sweep, a dict handoff under a
    lock — microseconds, never a round-trip. One synchronous sweep runs
    at construction so the first consumer already sees a populated
    fleet."""

    def __init__(
        self,
        observatory: FleetObservatory,
        interval_s: float | None = None,
    ):
        self.observatory = observatory
        self.interval_s = float(
            interval_s if interval_s is not None
            else observatory.poll_interval_s
        )
        self._lock = threading.Lock()
        self._snap: dict[str, Any] = {}
        self._stop = threading.Event()
        self._sweep()
        self._thread = threading.Thread(
            target=self._run, name="tpuflow-fleet-poller", daemon=True
        )
        self._thread.start()

    def _sweep(self) -> None:
        try:
            snap = self.observatory.poll()
        except Exception:  # noqa: BLE001 — a bad sweep must not kill
            return  # the loop; consumers keep the last good snapshot
        with self._lock:
            self._snap = snap

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._sweep()

    def snapshot(self) -> dict[str, Any]:
        """The last completed sweep (``{}`` until one succeeds)."""
        with self._lock:
            return self._snap

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


# ------------------------------------------------------------- rendering
def _fmt(v, spec="{:.3g}") -> str:
    return spec.format(v) if isinstance(v, (int, float)) else "-"


def format_fleet_line(fleet: dict) -> str:
    """The one-line fleet headline a fleet watcher prints."""
    t = (fleet.get("ttft") or {})
    i = (fleet.get("itl") or {})
    line = (
        f"fleet n={fleet.get('replicas', 0)} "
        f"healthy={fleet.get('healthy', 0)} "
        f"stale={fleet.get('stale', 0)} "
        f"qps={_fmt(fleet.get('qps'))} "
        f"tok/s={_fmt(fleet.get('tokens_per_s'), '{:.0f}')} "
        f"q={_fmt(fleet.get('queue_depth'), '{:.0f}')} "
        f"util={_fmt(fleet.get('decode_utilization'), '{:.2f}')} "
        f"ttft99={_fmt(t.get('p99'), '{:.3f}')}s "
        f"itl99={_fmt(i.get('p99'), '{:.4f}')}s "
        f"slo={_fmt(fleet.get('slo_violations'), '{:.0f}')}"
    )
    if fleet.get("hbm_used_frac_max") is not None:
        # The tightest replica's device memory.
        line += (
            f" hbm={_fmt(fleet.get('hbm_used_frac_max'), '{:.2f}')}"
            f"/{_fmt(fleet.get('hbm_peak_frac_max'), '{:.2f}')}pk"
        )
    return line


def format_replica_line(row: dict) -> str:
    """One babysitter line per replica."""
    health = f"{row.get('health', 0.0):.2f}"
    reasons = ",".join(row.get("health_reasons") or ())
    if reasons:
        health += f"({reasons})"
    base = f"  {row.get('id', '?')}: health={health}"
    if row.get("stale"):
        err = f" [{row['error']}]" if row.get("error") else ""
        return base + f" STALE age={_fmt(row.get('age_s'), '{:.1f}')}s" + err
    line = base + (
        f" q={_fmt(row.get('serve_queue_depth'), '{:.0f}')} "
        f"occ={_fmt(row.get('serve_slot_occupancy'), '{:.2f}')} "
        f"tok/s={_fmt(row.get('serve_tokens_per_s'), '{:.0f}')} "
        f"ttft99={_fmt(row.get('serve_ttft_p99_s'), '{:.3f}')}s "
        f"slo={_fmt(row.get('serve_slo_violations'), '{:.0f}')} "
        f"done={_fmt(row.get('serve_requests'), '{:.0f}')}"
    )
    if row.get("hbm_used_frac") is not None:
        line += f" hbm={_fmt(row.get('hbm_used_frac'), '{:.2f}')}"
    return line
