"""Tiered KV-page store: committed page sets as small checkpoints.

Counterpart of ``tpuflow/infer/kv_store.py``, with its on-disk format, so a
set committed by either package loads in the other. Paged KV content is
pad-invariant (page ``j`` of a prompt is a pure function of the prompt
prefix through that page), which makes a request's KV pages a shippable
artifact: a prefill-role engine runs the admission prefill once, extracts
the pages with the sha1 prefix-digest chain and commits them as a
:class:`KVPageSet`; a decode-role engine imports the set and admits the
request already prefilled, equal to a solo ``generate()``. The same
machinery is the spill path of the tiered prefix cache: pages evicted from
the card's pool drop to host DRAM (:class:`HostTier`) and node-local disk
(a :class:`KVStore` keyed by digest), and a lower-tier prefix hit promotes
pages back instead of recomputing them (:class:`TierCache`).

Commit protocol, one blob and one manifest per page set:

1. the ``.npz`` blob is staged at ``<key>.npz.tmp`` and published by one
   ``os.replace``;
2. the JSON manifest (digest chain, geometry, the blob's crc32) is staged
   and renamed LAST: the manifest IS the commit marker.

A crash at any point leaves either nothing visible or a blob without a
manifest; ``load`` requires both plus a crc match, so torn or corrupted
sets never load (they return ``None``: the caller's local-prefill
fallback, never an exception on the serving path). ``ckpt/manager.py``
writes its commit marker through :func:`atomic_write_json`, so the two
commit paths cannot drift.

Page leaves are named as the JAX engine names them for a non-scanned GPT-2:
``"['h<i>']['cached_key']"`` and ``"['h<i>']['cached_value']"``, each
``(pages, page_size, H, D)``.

Stdlib and numpy only: no torch, so the store and its tests run with no
model at all.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import io
import json
import os
import zlib

import numpy as np

BLOB_SUFFIX = ".npz"
MANIFEST_SUFFIX = ".json"
STAGE_SUFFIX = ".tmp"
FORMAT_NAME = "tpuflow-kvpages-v1"
SCHEMA = 1

_PAGE_PREFIX = "page::"


# ------------------------------------------------------- commit helpers
def atomic_write_bytes(path: str, data: bytes) -> None:
    """Stage ``data`` at ``path + '.tmp'``, fsync, publish with one
    ``os.replace`` — the write is all-or-nothing; a crash leaves only an
    invisible ``.tmp`` the next :func:`gc_stage_leftovers` reclaims.
    Shared with the checkpoint manager's marker writes."""
    tmp = path + STAGE_SUFFIX
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_json(path: str, obj) -> None:
    """JSON variant of :func:`atomic_write_bytes` (the commit-marker
    write: manifest/meta files become visible atomically or not at
    all)."""
    atomic_write_bytes(path, json.dumps(obj).encode("utf-8"))


def gc_stage_leftovers(root: str) -> int:
    """Remove ``*.tmp`` staging leftovers under ``root`` (a previous
    process died mid-commit; its set was never visible). Returns the
    count removed."""
    n = 0
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for name in names:
        if name.endswith(STAGE_SUFFIX):
            try:
                os.remove(os.path.join(root, name))
                n += 1
            except OSError:
                pass
    return n


# ------------------------------------------------------- digest chains
def chain_digests(prompt, page_size: int) -> list[bytes]:
    """sha1 prefix-digest chain over every FULLY-covered page: entry
    ``j`` keys the whole prompt prefix through page ``j`` (causal
    attention makes page content a pure function of that prefix) —
    byte-identical to ``PagePool.prefix_digests`` and the router's
    affinity keys."""
    p = np.asarray(prompt, np.int32).reshape(-1)
    ps = int(page_size)
    return [
        hashlib.sha1(p[: (j + 1) * ps].tobytes()).digest()
        for j in range(p.size // ps)
    ]


def chain_match(a: list[bytes], b: list[bytes]) -> int:
    """Longest common PREFIX of two digest chains (suffix resume: how
    many committed pages a longer prompt can import)."""
    m = 0
    for x, y in zip(a, b):
        if x != y:
            break
        m += 1
    return m


def prompt_key(prompt) -> str:
    """Store key of a prompt's page set: sha1 hex over the full token
    bytes (int32) — what the router forwards as ``kv_key``."""
    p = np.asarray(prompt, np.int32).reshape(-1)
    return hashlib.sha1(p.tobytes()).hexdigest()


# ----------------------------------------------------------- page sets
@dataclasses.dataclass
class KVPageSet:
    """One request's committed KV pages: the shippable artifact.

    ``pages`` maps each cache-leaf key (the engine's flattened pytree
    path) to a page-major array ``(k, ..., page_size, H, D)`` holding
    the first ``k = ceil(n_tokens / page_size)`` logical pages —
    including the partial tail page (private to the request: decode
    writes land there). ``digests`` covers only the FULL pages (the
    shareable ones). ``tok0`` is the prefill's first greedy token, so a
    decode-side import of the exact prompt admits with zero prefill."""

    page_size: int
    n_tokens: int
    prompt: np.ndarray  # (L,) int32
    digests: list[bytes]
    pages: dict[str, np.ndarray]
    tok0: int | None = None
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> str:
        return prompt_key(self.prompt)

    @property
    def n_pages(self) -> int:
        for arr in self.pages.values():
            return int(arr.shape[0])
        return 0

    def page_bundle(self, j: int) -> dict[str, np.ndarray]:
        """Page ``j`` as a per-leaf bundle (the tier/promotion unit)."""
        return {k: np.asarray(v[j]) for k, v in self.pages.items()}


class KVStore:
    """Directory of committed page sets, one blob + one manifest per
    key. All operations are torn-safe: ``load`` never returns a partial
    or corrupted set, and never raises on the serving path."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        gc_stage_leftovers(self.root)

    # internal ----------------------------------------------------------
    def _blob(self, key: str) -> str:
        return os.path.join(self.root, key + BLOB_SUFFIX)

    def _manifest(self, key: str) -> str:
        return os.path.join(self.root, key + MANIFEST_SUFFIX)

    # low-level (tier pages ride this without a prompt) -----------------
    def commit_arrays(
        self, key: str, arrays: dict[str, np.ndarray], extra: dict
    ) -> str:
        """Commit named arrays under ``key``: blob first, manifest (the
        commit marker, carrying the blob crc32) last."""
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        data = buf.getvalue()
        atomic_write_bytes(self._blob(key), data)
        manifest = {
            "schema": SCHEMA,
            "format": FORMAT_NAME,
            "crc32": zlib.crc32(data),
            "blob_bytes": len(data),
            **extra,
        }
        atomic_write_json(self._manifest(key), manifest)
        return key

    def load_arrays(
        self, key: str
    ) -> tuple[dict[str, np.ndarray], dict] | None:
        """(arrays, manifest) — or ``None`` for missing / torn (blob
        without manifest or vice versa) / crc-mismatched / malformed
        sets. Never raises."""
        try:
            with open(self._manifest(key)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        try:
            with open(self._blob(key), "rb") as f:
                data = f.read()
        except OSError:
            return None
        if (
            len(data) != manifest.get("blob_bytes")
            or zlib.crc32(data) != manifest.get("crc32")
        ):
            return None
        try:
            with np.load(io.BytesIO(data), allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception:  # noqa: BLE001 — torn-set tolerance by contract
            return None
        return arrays, manifest

    # page-set surface --------------------------------------------------
    def commit(self, pset: KVPageSet) -> str:
        """Commit a page set under its prompt key; returns the key."""
        arrays = {"prompt": np.asarray(pset.prompt, np.int32)}
        for name, arr in pset.pages.items():
            arrays[_PAGE_PREFIX + name] = arr
        extra = {
            "page_size": int(pset.page_size),
            "n_tokens": int(pset.n_tokens),
            "tok0": None if pset.tok0 is None else int(pset.tok0),
            "digests": [d.hex() for d in pset.digests],
            "meta": dict(pset.meta),
        }
        return self.commit_arrays(pset.key, arrays, extra)

    def load(self, key: str) -> KVPageSet | None:
        got = self.load_arrays(key)
        if got is None:
            return None
        arrays, manifest = got
        if "prompt" not in arrays:
            return None
        try:
            digests = [bytes.fromhex(h) for h in manifest["digests"]]
            tok0 = manifest["tok0"]
            return KVPageSet(
                page_size=int(manifest["page_size"]),
                n_tokens=int(manifest["n_tokens"]),
                prompt=np.asarray(arrays["prompt"], np.int32),
                digests=digests,
                pages={
                    k[len(_PAGE_PREFIX):]: v
                    for k, v in arrays.items()
                    if k.startswith(_PAGE_PREFIX)
                },
                tok0=None if tok0 is None else int(tok0),
                meta=dict(manifest.get("meta") or {}),
            )
        except (KeyError, ValueError, TypeError):
            return None

    def contains(self, key: str) -> bool:
        return os.path.exists(self._manifest(key)) and os.path.exists(
            self._blob(key)
        )

    def keys(self) -> list[str]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.endswith(MANIFEST_SUFFIX):
                key = name[: -len(MANIFEST_SUFFIX)]
                if os.path.exists(self._blob(key)):
                    out.append(key)
        return out

    def delete(self, key: str) -> None:
        # Manifest first: a crash between the two unlinks must leave a
        # torn (never-loading) set, not a manifest pointing at nothing
        # that later pairs with a recreated blob.
        for path in (self._manifest(key), self._blob(key)):
            try:
                os.remove(path)
            except OSError:
                pass

    def nbytes(self) -> int:
        total = 0
        for key in self.keys():
            try:
                total += os.path.getsize(self._blob(key))
            except OSError:
                pass
        return total

    def trim_to_bytes(self, max_bytes: int) -> list[str]:
        """LRU-trim (manifest mtime) the store under ``max_bytes``;
        returns the evicted keys."""
        entries = []
        for key in self.keys():
            try:
                entries.append((
                    os.path.getmtime(self._manifest(key)),
                    os.path.getsize(self._blob(key)),
                    key,
                ))
            except OSError:
                continue
        total = sum(e[1] for e in entries)
        evicted = []
        for _, size, key in sorted(entries):
            if total <= max_bytes:
                break
            self.delete(key)
            total -= size
            evicted.append(key)
        return evicted


# ---------------------------------------------------------------- tiers
def _bundle_bytes(bundle: dict[str, np.ndarray]) -> int:
    return sum(int(v.nbytes) for v in bundle.values())


class HostTier:
    """Host-DRAM page tier: digest → per-leaf page bundle, LRU within a
    byte budget. ``put`` returns the bundles evicted to make room (the
    cascade the disk tier absorbs)."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._data: collections.OrderedDict[
            bytes, dict[str, np.ndarray]
        ] = collections.OrderedDict()
        self.used_bytes = 0

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._data

    @property
    def count(self) -> int:
        return len(self._data)

    def put(
        self, digest: bytes, bundle: dict[str, np.ndarray]
    ) -> list[tuple[bytes, dict[str, np.ndarray]]]:
        nb = _bundle_bytes(bundle)
        evicted: list[tuple[bytes, dict[str, np.ndarray]]] = []
        if nb > self.budget_bytes:
            return [(digest, bundle)]  # never fits: cascade straight down
        old = self._data.pop(digest, None)
        if old is not None:
            self.used_bytes -= _bundle_bytes(old)
        while self._data and self.used_bytes + nb > self.budget_bytes:
            d, b = self._data.popitem(last=False)  # LRU-first
            self.used_bytes -= _bundle_bytes(b)
            evicted.append((d, b))
        self._data[digest] = bundle
        self.used_bytes += nb
        return evicted

    def get(
        self, digest: bytes, *, pop: bool = False
    ) -> dict[str, np.ndarray] | None:
        bundle = self._data.get(digest)
        if bundle is None:
            return None
        if pop:
            del self._data[digest]
            self.used_bytes -= _bundle_bytes(bundle)
        else:
            self._data.move_to_end(digest)
        return bundle

    def drop(self, digest: bytes) -> None:
        self.get(digest, pop=True)


class TierCache:
    """The card pool's lower tiers: host DRAM first, node-local disk
    below it, with one bounded digest→tier index on top (an evicted
    prefix stays distinguishable from a never-cached one, and the index
    never grows past ``index_max``). Spill order is card → host → disk;
    host-budget overflow cascades LRU bundles down to disk. A disk dir alone (no
    host budget) spills straight to disk — and is rescanned at
    construction, which is what lets a hot prefix survive an engine
    restart."""

    def __init__(
        self,
        *,
        host_bytes: int = 0,
        disk_dir: str | None = None,
        index_max: int = 4096,
        disk_max_bytes: int = 0,
    ):
        self.host = HostTier(host_bytes) if host_bytes > 0 else None
        self.disk = KVStore(disk_dir) if disk_dir else None
        self.index_max = max(int(index_max), 1)
        self.disk_max_bytes = int(disk_max_bytes)
        self._index: collections.OrderedDict[bytes, str] = (
            collections.OrderedDict()
        )
        self.spills_host = 0
        self.spills_disk = 0
        self.hits_host = 0
        self.hits_disk = 0
        if self.disk is not None:
            for key in self.disk.keys():
                try:
                    d = bytes.fromhex(key)
                except ValueError:
                    continue
                self._index[d] = "disk"
            self._trim_index()

    @property
    def armed(self) -> bool:
        return self.host is not None or self.disk is not None

    @property
    def pages_host(self) -> int:
        return 0 if self.host is None else self.host.count

    @property
    def pages_disk(self) -> int:
        return sum(1 for t in self._index.values() if t == "disk")

    def _trim_index(self) -> None:
        while len(self._index) > self.index_max:
            d, tier = self._index.popitem(last=False)
            if tier == "host" and self.host is not None:
                # Host bundles are only findable through the index;
                # reclaim the DRAM. Disk files stay (a restart rescan
                # re-finds them) — the index stays bounded either way.
                self.host.drop(d)

    def _to_disk(self, digest: bytes, bundle) -> bool:
        if self.disk is None:
            return False
        key = digest.hex()
        if not self.disk.contains(key):
            # Page content is a pure function of the digest — an
            # existing entry is already the right bytes.
            self.disk.commit_arrays(key, bundle, {"kind": "tier_page"})
            if self.disk_max_bytes > 0:
                self.disk.trim_to_bytes(self.disk_max_bytes)
        self.spills_disk += 1
        return True

    def spill(
        self, digest: bytes, bundle: dict[str, np.ndarray]
    ) -> str | None:
        """Absorb one HBM-evicted page. Returns the tier it landed in
        (``"host"`` / ``"disk"``) or ``None`` when no tier could take
        it."""
        if self.host is not None:
            for d, b in self.host.put(digest, bundle):
                if d == digest:
                    break  # over-budget bundle: fall through to disk
                if self._to_disk(d, b):
                    self._index[d] = "disk"
                    self._index.move_to_end(d)
                else:
                    self._index.pop(d, None)
            else:
                self._index[digest] = "host"
                self._index.move_to_end(digest)
                self.spills_host += 1
                self._trim_index()
                return "host"
        if self._to_disk(digest, bundle):
            self._index[digest] = "disk"
            self._index.move_to_end(digest)
            self._trim_index()
            return "disk"
        self._index.pop(digest, None)
        return None

    def locate(self, digest: bytes) -> str | None:
        """Which tier (if any) holds ``digest`` — index-only, no IO."""
        tier = self._index.get(digest)
        if tier is not None:
            self._index.move_to_end(digest)
        return tier

    def fetch(
        self, digest: bytes
    ) -> tuple[dict[str, np.ndarray], str] | None:
        """(bundle, tier) for a promotion, or ``None`` (an indexed disk
        entry may still be torn/corrupt on read — the caller falls back
        to prefill). A host hit frees the DRAM copy (the page is going
        back to HBM); a disk hit keeps the file for restart survival."""
        tier = self._index.get(digest)
        if tier == "host" and self.host is not None:
            bundle = self.host.get(digest, pop=True)
            if bundle is not None:
                del self._index[digest]
                self.hits_host += 1
                return bundle, "host"
            self._index.pop(digest, None)
            return None
        if tier == "disk" and self.disk is not None:
            got = self.disk.load_arrays(digest.hex())
            if got is not None:
                self._index.move_to_end(digest)
                self.hits_disk += 1
                return got[0], "disk"
            self.disk.delete(digest.hex())
            self._index.pop(digest, None)
        return None
