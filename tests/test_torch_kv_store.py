"""The port's KV-page store (tpuflow_torch.infer.kv_store), mirroring
tests/test_kv_store.py: every case runs on the JAX module and on the
port's copy with the same inputs (numpy seeds), holds each to the JAX
test's expectations and the two modules' observations to each other. Then
the cross-package contract: a set committed by either package's
``KVStore`` loads in the other with equal arrays and manifest, and a torn
or corrupt set never loads in either."""

import json
import os
import zlib

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow.infer import kv_store as jkv
from tpuflow_torch.infer import kv_store as tkv

MODS = {"jax": jkv, "port": tkv}


def _both(tmp_path, case):
    """``case(mod, dir)`` on each module in a directory of its own; the
    two modules' observations must be equal. Returns the port's."""
    got = {}
    for name, mod in MODS.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = case(mod, str(d))
    assert got["port"] == got["jax"]
    return got["port"]


def _pset(mod, prompt, ps=4, n_leaves=2, tok0=7, seed=0):
    """A KVPageSet with random page payloads shaped like cache leaves."""
    rng = np.random.default_rng(seed)
    p = np.asarray(prompt, np.int32)
    k = -(-p.size // ps)  # ceil: full pages + the partial tail page
    pages = {
        f"leaf{i}": rng.normal(size=(k, 2, ps, 3, 5)).astype(np.float32)
        for i in range(n_leaves)
    }
    return mod.KVPageSet(
        page_size=ps, n_tokens=int(p.size), prompt=p,
        digests=mod.chain_digests(p, ps), pages=pages, tok0=tok0,
        meta={"quant": False},
    )


def _bundle(seed, nbytes=400):
    rng = np.random.default_rng(seed)
    return {"k": rng.normal(size=nbytes // 8).astype(np.float64)}


def _digests(n):
    return [bytes([i]) * 20 for i in range(n)]


# ------------------------------------------------------------- constants
def test_format_constants_match_jax():
    for name in ("BLOB_SUFFIX", "MANIFEST_SUFFIX", "STAGE_SUFFIX",
                 "FORMAT_NAME", "SCHEMA", "_PAGE_PREFIX"):
        assert getattr(tkv, name) == getattr(jkv, name), name


# --------------------------------------------------------- digest chains
def test_chain_digests_prefix_property():
    ps = 4
    base = np.arange(8, dtype=np.int32)
    ext = np.arange(13, dtype=np.int32)
    other = np.arange(1, 14, dtype=np.int32)
    cb, ce = tkv.chain_digests(base, ps), tkv.chain_digests(ext, ps)
    assert len(cb) == 2 and len(ce) == 3  # FULL pages only
    assert tkv.chain_match(cb, ce) == 2
    assert tkv.chain_match(ce, tkv.chain_digests(other, ps)) == 0
    assert tkv.chain_match([], ce) == 0
    assert ce == jkv.chain_digests(ext, ps)
    rng = np.random.default_rng(1)
    for ps in (1, 3, 8, 16):
        p = rng.integers(0, 50257, size=int(rng.integers(1, 80)))
        assert tkv.chain_digests(p, ps) == jkv.chain_digests(p, ps)


def test_prompt_key_is_token_exact():
    a = np.arange(9, dtype=np.int32)
    assert tkv.prompt_key(a) == tkv.prompt_key(list(range(9)))
    assert tkv.prompt_key(a) != tkv.prompt_key(a[:-1])
    assert tkv.prompt_key(a) == jkv.prompt_key(a)
    assert _pset(tkv, a).key == tkv.prompt_key(a)


# ------------------------------------------------------------ the store
def test_commit_load_roundtrip_bytes_exact(tmp_path):
    def case(mod, d):
        store = mod.KVStore(d)
        pset = _pset(mod, np.arange(11, dtype=np.int32))
        key = store.commit(pset)
        assert key == pset.key and store.contains(key)
        assert store.keys() == [key]
        got = store.load(key)
        assert got.page_size == 4 and got.n_tokens == 11 and got.tok0 == 7
        assert got.digests == pset.digests and got.meta == {"quant": False}
        np.testing.assert_array_equal(got.prompt, pset.prompt)
        assert sorted(got.pages) == sorted(pset.pages)
        for name, arr in pset.pages.items():
            np.testing.assert_array_equal(got.pages[name], arr)
            np.testing.assert_array_equal(got.page_bundle(1)[name], arr[1])
        return key, got.n_pages, sorted(got.pages)

    _both(tmp_path, case)


def test_torn_and_corrupt_sets_never_load(tmp_path):
    def case(mod, d):
        store = mod.KVStore(d)
        pset = _pset(mod, np.arange(10, dtype=np.int32))
        key = store.commit(pset)
        seen = [store.load("no-such-key") is None]
        os.remove(store._manifest(key))  # blob without manifest
        seen += [store.load(key) is None, store.contains(key)]
        store.commit(pset)
        os.remove(store._blob(key))  # manifest without blob
        seen.append(store.load(key) is None)
        store.commit(pset)
        blob = store._blob(key)
        data = bytearray(open(blob, "rb").read())
        data[len(data) // 2] ^= 0xFF  # corrupted byte: crc32 rejects
        open(blob, "wb").write(bytes(data))
        seen.append(store.load(key) is None)
        store.commit(pset)
        open(blob, "wb").write(open(blob, "rb").read()[:-3])  # truncated
        seen.append(store.load(key) is None)
        store.commit(pset)
        open(store._manifest(key), "w").write("{not json")
        seen.append(store.load(key) is None)
        return seen

    assert _both(tmp_path, case) == [True, True, False, True, True, True,
                                     True]


def test_manifest_is_the_commit_marker(tmp_path):
    def case(mod, d):
        store = mod.KVStore(d)
        key = store.commit(_pset(mod, np.arange(6, dtype=np.int32)))
        manifest = json.load(open(store._manifest(key)))
        data = open(store._blob(key), "rb").read()
        assert manifest["blob_bytes"] == len(data)
        assert manifest["crc32"] == zlib.crc32(data)
        assert manifest["format"] == mod.FORMAT_NAME
        return sorted(manifest)

    _both(tmp_path, case)


def test_gc_stage_leftovers_and_delete(tmp_path):
    def case(mod, d):
        store = mod.KVStore(d)
        key = store.commit(_pset(mod, np.arange(5, dtype=np.int32)))
        stage = os.path.join(d, "other.npz" + mod.STAGE_SUFFIX)
        open(stage, "wb").write(b"partial")
        seen = [store.keys() == [key], mod.KVStore(d).keys() == [key],
                os.path.exists(stage)]
        store.delete(key)
        seen += [store.keys(), store.load(key)]
        store.delete(key)  # idempotent
        return seen

    assert _both(tmp_path, case) == [True, True, False, [], None]


def test_trim_to_bytes_evicts_lru_first(tmp_path):
    def case(mod, d):
        store = mod.KVStore(d)
        keys = []
        for i in range(3):
            key = store.commit(_pset(
                mod, np.arange(i * 7, i * 7 + 9, dtype=np.int32), seed=i))
            os.utime(store._manifest(key), (1000.0 + i, 1000.0 + i))
            keys.append(key)
        per = store.nbytes() // 3
        evicted = store.trim_to_bytes(2 * per + per // 2)
        assert evicted == [keys[0]]  # the oldest manifest mtime first
        assert sorted(store.keys()) == sorted(keys[1:])
        assert store.trim_to_bytes(0) and store.keys() == []
        return evicted

    _both(tmp_path, case)


# ------------------------------------------------------------- host tier
def test_host_tier_lru_budget_and_cascade(tmp_path):
    def case(mod, _d):
        tier = mod.HostTier(budget_bytes=1000)  # two 400-byte bundles
        d = _digests(4)
        seen = [tier.put(d[0], _bundle(0)), tier.put(d[1], _bundle(1)),
                (tier.count, tier.used_bytes)]
        ev = tier.put(d[2], _bundle(2))  # evicts the LRU, d0
        np.testing.assert_array_equal(ev[0][1]["k"], _bundle(0)["k"])
        seen.append([e[0] for e in ev])
        seen.append(tier.get(d[1]) is not None)  # refreshes d1
        seen.append([e[0] for e in tier.put(d[3], _bundle(3))])
        got = tier.get(d[1], pop=True)
        seen += [got is not None, d[1] in tier, tier.used_bytes]
        huge = {"k": np.zeros(400, np.float64)}  # 3200 > 1000
        out = tier.put(d[0], huge)
        seen += [len(out) == 1 and out[0][1] is huge, d[0] in tier]
        tier.drop(d[3])
        return seen + [tier.count, tier.used_bytes]

    d = _digests(4)
    assert _both(tmp_path, case) == [
        [], [], (2, 800), [d[0]], True, [d[2]], True, False, 400, True,
        False, 0, 0]


# ------------------------------------------------------------ tier cache
def test_tier_cache_spill_locate_fetch_semantics(tmp_path):
    def case(mod, root):
        cache = mod.TierCache(host_bytes=1000,
                              disk_dir=os.path.join(root, "disk"))
        d = _digests(4)
        seen = [cache.armed] + [cache.spill(d[i], _bundle(i))
                                for i in range(3)]
        seen += [cache.locate(d[0]), cache.pages_host, cache.pages_disk,
                 cache.spills_host, cache.spills_disk]
        got = cache.fetch(d[1])  # a host fetch pops
        np.testing.assert_array_equal(got[0]["k"], _bundle(1)["k"])
        seen += [got[1], cache.locate(d[1]), cache.hits_host]
        got = cache.fetch(d[0])  # a disk fetch keeps the file
        np.testing.assert_array_equal(got[0]["k"], _bundle(0)["k"])
        seen += [got[1], cache.locate(d[0]), cache.hits_disk,
                 cache.fetch(b"\xee" * 20)]
        return seen

    assert _both(tmp_path, case) == [
        True, "host", "host", "host", "disk", 2, 1, 3, 1, "host", None, 1,
        "disk", "disk", 1, None]


def test_tier_cache_disk_only_restart_rescan(tmp_path):
    def case(mod, root):
        disk = os.path.join(root, "disk")
        cache = mod.TierCache(host_bytes=0, disk_dir=disk)
        d = _digests(3)
        seen = [cache.host is None] + [cache.spill(d[i], _bundle(i))
                                       for i in range(3)]
        reborn = mod.TierCache(host_bytes=0, disk_dir=disk)
        seen.append(reborn.pages_disk)
        for i in range(3):
            seen.append(reborn.locate(d[i]))
            got = reborn.fetch(d[i])
            np.testing.assert_array_equal(got[0]["k"], _bundle(i)["k"])
            seen.append(got[1])
        return seen

    assert _both(tmp_path, case) == [True, "disk", "disk", "disk", 3] + [
        "disk"] * 6


def test_tier_cache_corrupt_disk_page_drops_cleanly(tmp_path):
    def case(mod, root):
        cache = mod.TierCache(host_bytes=0, disk_dir=os.path.join(root, "d"))
        d = b"\x05" * 20
        seen = [cache.spill(d, _bundle(5))]
        blob = cache.disk._blob(d.hex())
        data = bytearray(open(blob, "rb").read())
        data[-4] ^= 0xFF
        open(blob, "wb").write(bytes(data))
        return seen + [cache.fetch(d), cache.locate(d),
                       cache.disk.contains(d.hex())]

    assert _both(tmp_path, case) == ["disk", None, None, False]


def test_tier_cache_index_is_bounded(tmp_path):
    def case(mod, root):
        disk = os.path.join(root, "disk")
        cache = mod.TierCache(host_bytes=10**9, disk_dir=disk, index_max=3)
        d = _digests(5)
        for i in range(5):
            cache.spill(d[i], _bundle(i))
        seen = [len(cache._index), cache.pages_host] + [
            cache.locate(x) for x in d]
        cache2 = mod.TierCache(host_bytes=0, disk_dir=disk, index_max=2)
        for i in range(5):
            cache2.spill(d[i], _bundle(i))
        return seen + [len(cache2._index),
                       mod.TierCache(host_bytes=0, disk_dir=disk).pages_disk]

    assert _both(tmp_path, case) == [3, 3, None, None, "host", "host",
                                     "host", 2, 5]


def test_tier_cache_disk_budget_trims(tmp_path):
    def case(mod, root):
        cache = mod.TierCache(host_bytes=0, disk_dir=os.path.join(root, "d"),
                              disk_max_bytes=1)
        for i, d in enumerate(_digests(3)):
            cache.spill(d, _bundle(i))
        return len(cache.disk.keys())

    assert _both(tmp_path, case) <= 1


def test_tier_cache_unarmed_without_tiers(tmp_path):
    def case(mod, _d):
        cache = mod.TierCache(host_bytes=0, disk_dir=None)
        d = b"\x01" * 20
        return [cache.armed, cache.spill(d, _bundle(1)), cache.locate(d),
                cache.fetch(d), cache.pages_host, cache.pages_disk]

    assert _both(tmp_path, case) == [False, None, None, None, 0, 0]


# ------------------------------------------------- ckpt-manager sharing
def test_ckpt_manager_marker_rides_the_same_commit_helper(tmp_path,
                                                          monkeypatch):
    """The port's checkpoint manager writes its commit marker through
    this module's atomic_write_json, with the same staging suffix."""
    from tpuflow_torch.ckpt import manager as ckpt_manager

    assert ckpt_manager._STAGE_SUFFIX == tkv.STAGE_SUFFIX
    path = str(tmp_path / "marker.json")
    tkv.atomic_write_json(path, {"step": 3})
    assert json.load(open(path)) == {"step": 3}
    assert os.listdir(str(tmp_path)) == ["marker.json"]
    # A manager save's metadata.json goes through the helper.
    import torch

    written = []
    real = tkv.atomic_write_json
    monkeypatch.setattr(
        tkv, "atomic_write_json",
        lambda p, obj: (written.append(os.path.basename(p)), real(p, obj)))
    mgr = ckpt_manager.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"w": torch.zeros(3)})
    mgr.wait_until_finished()
    assert written == ["metadata.json"]
    assert mgr.all_steps() == [1]


# ------------------------------------------------ across the two packages
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_set_committed_by_either_package_loads_in_the_other(
        tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    wmod, rmod = MODS[writer], MODS[reader]
    d = str(tmp_path)
    pset = _pset(wmod, np.arange(3, 17, dtype=np.int32), ps=4, n_leaves=3,
                 tok0=11, seed=4)
    pset.pages = {
        f"['h{i // 2}']['cached_{'key' if i % 2 == 0 else 'value'}']": a
        for i, a in enumerate(pset.pages.values())}
    key = wmod.KVStore(d).commit(pset)
    assert key == rmod.prompt_key(pset.prompt)
    got = rmod.KVStore(d).load(key)
    assert isinstance(got, rmod.KVPageSet)
    for field in ("page_size", "n_tokens", "digests", "tok0", "meta"):
        assert getattr(got, field) == getattr(pset, field), field
    np.testing.assert_array_equal(got.prompt, pset.prompt)
    assert sorted(got.pages) == sorted(pset.pages)
    for name, arr in pset.pages.items():
        assert got.pages[name].dtype == arr.dtype
        assert got.pages[name].tobytes() == arr.tobytes()
    # The other package's commit of the same set: the same manifest but
    # for the blob's crc32 (the npz carries its write time), the same
    # arrays.
    d2 = str(tmp_path / "again")
    rmod.KVStore(d2).commit(got)
    m1 = json.load(open(os.path.join(d, key + ".json")))
    m2 = json.load(open(os.path.join(d2, key + ".json")))
    m1.pop("crc32")
    m2.pop("crc32")
    assert m1 == m2
    back = wmod.KVStore(d2).load(key)
    for name, arr in pset.pages.items():
        assert back.pages[name].tobytes() == arr.tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_torn_set_never_loads_across_packages(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    d = str(tmp_path)
    wstore = MODS[writer].KVStore(d)
    pset = _pset(MODS[writer], np.arange(9, dtype=np.int32))
    key = wstore.commit(pset)
    rstore = MODS[reader].KVStore(d)
    blob = rstore._blob(key)
    data = bytearray(open(blob, "rb").read())
    data[len(data) // 3] ^= 0x55
    open(blob, "wb").write(bytes(data))
    assert rstore.load(key) is None
    wstore.commit(pset)
    os.remove(rstore._manifest(key))  # the marker never written
    assert rstore.load(key) is None and not rstore.contains(key)
    # A staged blob from a writer killed mid-commit: invisible, reclaimed.
    open(blob + tkv.STAGE_SUFFIX, "wb").write(b"partial")
    assert MODS[reader].KVStore(d).keys() == []
    assert not os.path.exists(blob + tkv.STAGE_SUFFIX)
