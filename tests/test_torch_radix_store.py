"""The port's radix prefix tree, disk tier and persistent prefix store
(serving/radix_tree.py, kv_disk.py, lifecycle.py) against the JAX
package's, in float64 on the CPU.

The port's RadixPrefixTree answers the JAX tree's register / match /
reclaim / expire / forget identically on seeded random call sequences
(same digests, same block ids, same retained sets). Multi-turn serving
with the tree on and off gives the JAX engine's tokens and host syncs,
and the tree keeps the first turn resident; the TTL drain releases the
same blocks at the same iterations. The disk pool round-trips both key
namespaces, holds its byte cap, recovers a crashed directory and treats
a rotted file as a miss; the prefix store keeps its LRU and shape
rules, saves and loads atomically, spills through the disk tier, evicts
by the tree's heat, and restores a restarted engine's prefix with the
JAX engine's tokens. bfloat16 payloads keep their bits through the disk
tier and the spill file, also through a bf16 engine's restart.
"""
import os
import random
import warnings

import pytest

import torch

from deeplearning4j_tpu.serving import Request as JaxRequest
from deeplearning4j_tpu.serving import ServingEngine as JaxEngine
from deeplearning4j_tpu.serving.block_table import \
    BlockAllocator as JaxAllocator
from deeplearning4j_tpu.serving.radix_tree import \
    RadixPrefixTree as JaxTree
from deeplearning4j_tpu_torch.serving import (BlockAllocator, DiskBlockPool,
                                              PersistentPrefixStore,
                                              RadixPrefixTree, Request,
                                              ServingEngine,
                                              resolve_disk_pool,
                                              resolve_prefix_radix,
                                              resolve_prefix_store)
from deeplearning4j_tpu_torch.serving.block_table import chain_digests
from deeplearning4j_tpu_torch.serving.engine import resolve_radix_ttl

from tests.test_torch_serving import _nets

torch.set_num_threads(1)    # small CPU tensors: one thread per test process


@pytest.fixture(scope="module")
def nets():
    return _nets()


# ------------------------------------------------- the tree against JAX
class _Pool:
    """The part of a KV pool a radix tree calls: its allocator."""

    def __init__(self, allocator):
        self.allocator = allocator


class _Side:
    """One tree on one allocator, with slots mapping blocks the way
    KVCache.admit / free do (a freed block drops its claims)."""

    def __init__(self, tree_cls, alloc_cls, n_blocks, bs):
        self.alloc = alloc_cls(n_blocks)
        self.pool = _Pool(self.alloc)
        self.tree = tree_cls(bs).bind_pool(self.pool)
        self.slots = {}

    def admit(self, sid, tokens, bs):
        matched, mblocks = self.tree.match(tokens)
        n_full = min(matched, len(tokens) - 1) // bs
        shared = mblocks[:n_full]
        need = -(-len(tokens) // bs)
        fresh = self.alloc.alloc_many(need - len(shared))
        if fresh is None:
            short = need - len(shared) - self.alloc.n_free
            freed = self.tree.reclaim(short, protect=set(shared))
            fresh = self.alloc.alloc_many(need - len(shared))
            if fresh is None:
                return ("full", matched, freed)
        for b in shared:
            self.alloc.incref(b)
        row = list(shared) + fresh
        self.slots[sid] = row
        hits = self.tree.register(tokens, row)
        return ("ok", matched, list(mblocks), row, hits)

    def free(self, sid):
        for b in self.slots.pop(sid):
            if self.alloc.decref(b):
                self.tree.forget(b)

    def state(self):
        t = self.tree
        return (t.n_entries, sorted(t.retained_blocks()), self.alloc.n_free,
                self.alloc.n_shared, t.n_nodes, t.n_blocks_indexed,
                t.lineage_hits_total, t.lineage_hit_counts(),
                [t.lineage(b) for b in range(self.alloc.num_blocks)])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_radix_tree_matches_jax_on_random_calls(seed):
    bs, n_blocks = 2, 24
    rng = random.Random(seed)
    bases = [[rng.randrange(1, 6) for _ in range(14)] for _ in range(3)]
    sides = [_Side(JaxTree, JaxAllocator, n_blocks, bs),
             _Side(RadixPrefixTree, BlockAllocator, n_blocks, bs)]
    next_sid = 0
    for _ in range(300):
        op = rng.choice(["admit", "admit", "free", "match", "reclaim",
                         "expire", "tick", "tick"])
        if op == "admit":
            base = rng.choice(bases)
            toks = base[:rng.randrange(2, len(base))] + \
                [rng.randrange(1, 6) for _ in range(rng.randrange(0, 3))]
            outs = [s.admit(next_sid, toks, bs) for s in sides]
            next_sid += 1
        elif op == "free":
            live = sorted(sides[0].slots)
            if not live:
                continue
            sid = rng.choice(live)
            outs = [s.free(sid) for s in sides]
        elif op == "match":
            base = rng.choice(bases)
            toks = base[:rng.randrange(1, len(base) + 1)]
            outs = [s.tree.match(toks) for s in sides]
        elif op == "reclaim":
            n = rng.randrange(1, 5)
            outs = [s.tree.reclaim(n) for s in sides]
        elif op == "expire":
            ttl = rng.randrange(0, 6)
            outs = [s.tree.expire(ttl) for s in sides]
        else:
            outs = [s.alloc.tick() for s in sides]
        assert outs[0] == outs[1], (op, outs)
        assert sides[0].state() == sides[1].state(), op
        assert sorted(sides[0].slots) == sorted(sides[1].slots)
    assert sides[0].tree.n_retained > 0 or sides[0].tree.lineage_hits_total


def test_store_victim_and_reclaim_all_match_jax():
    bs = 2
    sides = [_Side(JaxTree, JaxAllocator, 16, bs),
             _Side(RadixPrefixTree, BlockAllocator, 16, bs)]
    for s in sides:
        s.admit(0, [1, 2, 3, 4, 5, 6], bs)
        s.alloc.tick()
        s.admit(1, [9, 8, 7, 6], bs)
        s.free(0)
        s.free(1)
    digs = chain_digests([1, 2, 3, 4, 5, 6], bs) + \
        chain_digests([9, 8, 7, 6], bs)
    entries = {d: None for d in [b"orphan" * 3] + digs}
    assert [s.tree.store_victim(entries) for s in sides] == [b"orphan" * 3] * 2
    entries = {d: None for d in digs}
    assert sides[0].tree.store_victim(entries) == \
        sides[1].tree.store_victim(entries)
    assert [s.tree.reclaim_all() for s in sides] == [5, 5]
    assert sides[1].alloc.n_free == 16


def test_resolve_prefix_radix_and_ttl(nets, monkeypatch):
    monkeypatch.delenv("DL4J_TPU_PREFIX_RADIX", raising=False)
    monkeypatch.delenv("DL4J_TPU_RADIX_TTL", raising=False)
    assert resolve_prefix_radix() is False and resolve_prefix_radix(True)
    assert resolve_radix_ttl() is None and resolve_radix_ttl(0) is None
    assert resolve_radix_ttl(5) == 5
    for v, want in (("1", True), ("on", True), ("0", False), ("off", False)):
        monkeypatch.setenv("DL4J_TPU_PREFIX_RADIX", v)
        assert resolve_prefix_radix() is want
    monkeypatch.setenv("DL4J_TPU_RADIX_TTL", "7")
    assert resolve_radix_ttl() == 7
    eng = ServingEngine(nets[1], max_seqs=1, max_len=16, device="cpu")
    assert eng._radix_ttl == 7


# ------------------------------------------------ engines: radix, TTL
SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]


def _engine(cls, net, **kw):
    if cls is ServingEngine:
        kw["device"] = "cpu"
    kw.setdefault("kv_block", 4)
    kw.setdefault("prefix_share", True)
    return cls(net, max_seqs=4, max_len=64, seed=3, **kw)


def _turns(eng, req_cls, k):
    """Two conversations on one system prompt, two turns each: turn 2 extends
    turn 1's prompt with its output and two new tokens."""
    firsts = eng.generate([req_cls(SYSTEM + [7], max_new_tokens=5),
                           req_cls(SYSTEM + [2, 2], max_new_tokens=5)])
    seconds = eng.generate([
        req_cls(SYSTEM + [7] + firsts[0].tokens + [1, 2], max_new_tokens=5),
        req_cls(SYSTEM + [2, 2] + firsts[1].tokens + [3], max_new_tokens=5)])
    return firsts + seconds


@pytest.mark.parametrize("k", [1, 8])
def test_multi_turn_radix_on_off_matches_jax(nets, k):
    net, tnet = nets
    runs = {}
    for name, cls, req, n in (("jax_on", JaxEngine, JaxRequest, net),
                              ("on", ServingEngine, Request, tnet),
                              ("off", ServingEngine, Request, tnet)):
        eng = _engine(cls, n, decode_chunk=k, prefill_chunk=0,
                      prefix_radix=name != "off")
        runs[name] = (eng, _turns(eng, req, k))
    toks = {n: [r.tokens for r in res] for n, (_, res) in runs.items()}
    assert toks["on"] == toks["off"] == toks["jax_on"]
    s = {n: e.stats() for n, (e, _) in runs.items()}
    for key in ("host_syncs", "tokens_out", "prefix_hits",
                "prefix_shared_tokens", "kv_blocks_cached"):
        assert s["on"][key] == s["jax_on"][key], key
    assert s["on"]["host_syncs"] == s["off"]["host_syncs"]
    assert s["on"]["kv_blocks_cached"] > 0 == s["off"]["kv_blocks_cached"]
    # the first turn-2 admission finds turn 1 resident only in the tree
    on_turn2 = [r.shared_prefix_tokens for r in runs["on"][1][2:]]
    off_turn2 = [r.shared_prefix_tokens for r in runs["off"][1][2:]]
    assert on_turn2[0] > off_turn2[0] and sum(on_turn2) > sum(off_turn2)


def _ttl_expired(eng):
    return eng.metrics.get("serving.kv.ttl_expired_blocks").value


@pytest.mark.parametrize("via", ["argument", "env"])
def test_radix_ttl_drain_matches_jax(nets, via, monkeypatch):
    net, tnet = nets
    curves = []
    for cls, req, n in ((JaxEngine, JaxRequest, net),
                        (ServingEngine, Request, tnet)):
        if via == "env":
            monkeypatch.setenv("DL4J_TPU_PREFIX_RADIX", "1")
            monkeypatch.setenv("DL4J_TPU_RADIX_TTL", "3")
            eng = _engine(cls, n, decode_chunk=1, overlap=False)
        else:
            eng = _engine(cls, n, decode_chunk=1, overlap=False,
                          prefix_radix=True, radix_ttl=3)
        eng.generate([req(SYSTEM + [7], max_new_tokens=4)])
        curve = [(eng.stats()["kv_blocks_cached"], _ttl_expired(eng))]
        for _ in range(6):               # idle iterations tick the clock
            eng.step()
            curve.append((eng.stats()["kv_blocks_cached"],
                          _ttl_expired(eng)))
        curves.append(curve)
    assert curves[0] == curves[1]
    assert curves[1][0][0] > 0 and curves[1][-1] == (0, curves[1][0][0])


# ------------------------------------------------------------ disk tier
def _bf(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_disk_pool_round_trip_both_namespaces(tmp_path):
    pool = DiskBlockPool(str(tmp_path), capacity_bytes=1 << 20)
    k = torch.randn((2, 3, 4, 2), dtype=torch.float64)
    v = torch.randn((2, 3, 4, 2), dtype=torch.float64)
    ks, vs = torch.rand((2, 3, 4)), torch.rand((2, 3, 4))
    pool.put(7, k, v, k.nbytes + v.nbytes)
    pool.put(b"\x01\x02", k, v, k.nbytes + v.nbytes, k_scale=ks, v_scale=vs)
    assert 7 in pool and b"\x01\x02" in pool and pool.n_entries == 2
    k2, v2, sc = pool.fetch(7)
    assert torch.equal(k2, k) and torch.equal(v2, v) and sc is None
    k3, _, sc3 = pool.fetch(b"\x01\x02")
    assert torch.equal(k3, k) and torch.equal(sc3[0], ks)
    assert torch.equal(sc3[1], vs)
    assert pool.n_entries == 0 and pool.bytes_used == 0
    assert [f for f in os.listdir(str(tmp_path)) if f.endswith(".npz")] == []
    with pytest.raises(KeyError):
        pool.fetch(7)


def test_disk_pool_lru_eviction_under_cap(tmp_path):
    pool = DiskBlockPool(str(tmp_path), capacity_bytes=1 << 20)
    big = torch.randn((64, 64), dtype=torch.float32)
    pool.put(1, big, big, 2 * big.nbytes)
    pool.capacity_bytes = int(pool.bytes_used * 1.5)
    pool.put(2, big, big, 2 * big.nbytes)
    assert 1 not in pool and 2 in pool
    assert pool.bytes_used <= pool.capacity_bytes


def test_disk_pool_crash_leftovers_recovery(tmp_path):
    d = str(tmp_path)
    good = DiskBlockPool(d, capacity_bytes=1 << 20)
    k = torch.randn((2, 3), dtype=torch.float64)
    good.put(b"\xaa", k, k, 2 * k.nbytes)
    good.put(5, k, k, 2 * k.nbytes)
    (tmp_path / "pfx_bb.npz.tmp").write_bytes(b"half-written demotion")
    (tmp_path / "pfx_cc.npz").write_bytes(b"this is not a zip file")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fresh = DiskBlockPool(d, capacity_bytes=1 << 20)
    assert any("unreadable" in str(x.message) for x in w)
    assert fresh.n_corrupt == 1 and fresh.n_entries == 1
    assert b"\xaa" in fresh and 5 not in fresh
    assert sorted(os.listdir(d)) == ["pfx_aa.npz"]
    assert torch.equal(fresh.fetch(b"\xaa")[0], k)


def test_disk_pool_rotted_file_is_a_miss(tmp_path):
    pool = DiskBlockPool(str(tmp_path), capacity_bytes=1 << 20)
    k = torch.randn((2, 3), dtype=torch.float64)
    pool.put(9, k, k, 2 * k.nbytes)
    path = os.path.join(str(tmp_path), "swap_9.npz")
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04truncated")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with pytest.raises(KeyError):
            pool.fetch(9)
    assert any("unreadable" in str(x.message) for x in w)
    assert 9 not in pool and pool.n_corrupt == 1 and not os.path.exists(path)


def test_resolve_disk_pool_knobs(tmp_path, monkeypatch):
    monkeypatch.delenv("DL4J_TPU_KV_DISK", raising=False)
    assert resolve_disk_pool(None) is None and resolve_disk_pool("0") is None
    inst = DiskBlockPool(str(tmp_path / "a"))
    assert resolve_disk_pool(inst) is inst
    assert resolve_disk_pool(str(tmp_path / "b"), 1 << 16).capacity_bytes \
        == 1 << 16
    monkeypatch.setenv("DL4J_TPU_KV_DISK", str(tmp_path / "c"))
    monkeypatch.setenv("DL4J_TPU_KV_DISK_BYTES", str(1 << 20))
    assert resolve_disk_pool(None).capacity_bytes == 1 << 20


def test_bf16_bits_through_disk_and_store(tmp_path):
    k, v = _bf((2, 4, 1, 8), 1), _bf((2, 4, 1, 8), 2)
    k.view(torch.int16)[0, 0, 0, :3] = torch.tensor([0x7FC1, -1, 0x0001],
                                                   dtype=torch.int16)
    pool = DiskBlockPool(str(tmp_path / "disk"), capacity_bytes=1 << 20)
    pool.put(3, k, v, k.nbytes + v.nbytes)
    k2, v2, _ = pool.fetch(3)
    assert _bits_equal(k2, k) and _bits_equal(v2, v)
    path = str(tmp_path / "store.npz")
    store = PersistentPrefixStore(path=path)
    d = chain_digests([1, 2, 3, 4], 4)[0]
    store.put(d, k, v, k.nbytes + v.nbytes, block_shape=k.shape)
    assert store.block_dtype == "bfloat16"
    store.save()
    fresh = resolve_prefix_store(path)
    assert fresh.block_dtype == "bfloat16" and fresh.covered([d]) == 1
    k3, v3 = fresh.fetch([d])
    assert _bits_equal(k3[:, 0], k) and _bits_equal(v3[:, 0], v)


# ------------------------------------------------------ the prefix store
def test_prefix_store_covered_missing_lru_and_shape_guard():
    store = PersistentPrefixStore(capacity_bytes=300)
    digs = [bytes([i]) * 4 for i in range(4)]
    assert store.covered(digs) == 0 and store.missing(digs) == [0, 1, 2, 3]
    store.put(digs[0], 1, 2, 100)
    store.put(digs[1], 3, 4, 100)
    assert store.covered(digs) == 2 and store.missing(digs) == [2, 3]
    assert store.covered(digs[3:]) == 0
    store.put(digs[2], 5, 6, 200)
    assert store.bytes_used <= 300 and store.covered(digs) == 0
    store.put(digs[3], 7, 8, 1000)
    assert store.missing([digs[3]]) == [0]
    store.put(digs[2], 9, 9, 200)
    assert store._entries[digs[2]][0] == 5
    shaped = PersistentPrefixStore()
    shaped.put(b"d1", 1, 2, 8, block_shape=(1, 4, 1, 2))
    with pytest.raises(ValueError):
        shaped.put(b"d2", 1, 2, 8, block_shape=(2, 4, 1, 2))


def test_prefix_store_save_is_atomic_and_load_tolerates_corruption(
        tmp_path):
    path = str(tmp_path / "spill.npz")
    st = PersistentPrefixStore(capacity_bytes=1 << 20, path=path)
    k = torch.full((2, 4, 1, 2), 1.0, dtype=torch.float64)
    st.put(b"d" * 20, k, k + 1, 2 * k.nbytes, block_shape=k.shape)
    assert st.save() == path and not os.path.exists(path + ".tmp")
    ok = PersistentPrefixStore(capacity_bytes=1 << 20, path=path)
    assert ok.load() == 1 and ok.block_dtype == "float64"
    assert torch.equal(ok.fetch([b"d" * 20])[1][:, 0], k + 1)
    with open(path, "wb") as f:
        f.write(b"\x00garbage, not a zip")
    bad = PersistentPrefixStore(capacity_bytes=1 << 20, path=path)
    with pytest.warns(UserWarning, match="unreadable"):
        assert bad.load() == 0
    assert bad.n_entries == 0 and bad.bytes_used == 0
    assert PersistentPrefixStore(path=str(tmp_path / "nope.npz")).load() == 0


def test_prefix_store_spills_through_disk_and_promotes_back(tmp_path):
    store = PersistentPrefixStore(capacity_bytes=300)
    store.disk = DiskBlockPool(str(tmp_path), capacity_bytes=1 << 20)
    k0 = torch.randn((1, 4, 1, 2), dtype=torch.float64)
    d0, d1 = b"\x01" * 4, b"\x02" * 4
    store.put(d0, k0, k0 * 2, 200, block_shape=k0.shape)
    store.put(d1, k0 + 1, k0, 200, block_shape=k0.shape)
    assert store.disk_demotions == 1 and d0 in store.disk
    assert store.covered([d0]) == 1
    assert store.disk_promotions == 1 and d0 not in store.disk
    k2, v2 = store.fetch([d0])
    assert torch.equal(k2[:, 0], k0) and torch.equal(v2[:, 0], k0 * 2)


def test_prefix_store_eviction_follows_tree_policy():
    bs = 2
    side = _Side(RadixPrefixTree, BlockAllocator, 16, bs)
    tokens = [1, 2, 3, 4, 5, 6]
    side.admit(0, tokens, bs)
    tree_digests = chain_digests(tokens, bs)
    st = PersistentPrefixStore(capacity_bytes=4 * 64)
    st.evict_policy = side.tree.store_victim
    k = torch.zeros((1, bs, 1, 2))
    for d in tree_digests + [b"o1" * 10, b"o2" * 10, b"o3" * 10]:
        st.put(d, k, k, 64, block_shape=k.shape)
    assert all(d in st._entries for d in tree_digests)
    st.evict_policy = lambda entries: b"not-present"
    st.put(b"o5" * 10, k, k, 64, block_shape=k.shape)
    assert st.bytes_used <= st.capacity_bytes


@pytest.mark.parametrize("radix", [False, True])
def test_store_restart_survival_matches_jax(nets, radix, tmp_path):
    """A prefix prefilled by engine 1 survives its shutdown through the
    spill file: a fresh engine restores the blocks host -> device at
    admission and decodes the JAX engine's tokens."""
    net, tnet = nets
    req = SYSTEM + [7, 9]
    out = {}
    for tag, cls, rcls, n in (("jax", JaxEngine, JaxRequest, net),
                              ("port", ServingEngine, Request, tnet)):
        path = str(tmp_path / f"{tag}.npz")
        kw = dict(decode_chunk=1, overlap=False, prefix_radix=radix)
        e1 = _engine(cls, n, prefix_store=path, **kw)
        r1 = e1.generate([rcls(list(req), max_new_tokens=6)])[0]
        e1.shutdown()
        assert os.path.exists(path) and not os.path.exists(path + ".tmp")
        e2 = _engine(cls, n, prefix_store=path, **kw)
        assert e2.prefix_store.n_entries > 0
        r2 = e2.generate([rcls(list(req), max_new_tokens=6)])[0]
        out[tag] = (r1.tokens, r2.tokens, e2.stats())
    assert out["port"][0] == out["port"][1] == out["jax"][1]
    s, js = out["port"][2], out["jax"][2]
    assert s["prefix_store_hits"] > 0 and s["prefix_hits"] == 0
    for key in ("prefix_store_hits", "prefix_store_tokens", "host_syncs",
                "tokens_out"):
        assert s[key] == js[key], key


def test_store_env_knob_matches_jax(nets, tmp_path, monkeypatch):
    net, tnet = nets
    out = []
    for tag, cls, rcls, n in (("jax", JaxEngine, JaxRequest, net),
                              ("port", ServingEngine, Request, tnet)):
        monkeypatch.setenv("DL4J_TPU_PREFIX_STORE", str(tmp_path / tag))
        e1 = _engine(cls, n, decode_chunk=1, overlap=False)
        e1.generate([rcls(SYSTEM + [7], max_new_tokens=3)])
        e1.shutdown()
        e2 = _engine(cls, n, decode_chunk=1, overlap=False)
        r = e2.generate([rcls(SYSTEM + [7], max_new_tokens=3)])[0]
        out.append((r.tokens, e2.stats()["prefix_store_tokens"],
                    e2.stats()["host_syncs"]))
    assert out[0] == out[1] and out[1][1] > 0


def test_int8_engine_store_restart_restores_scales(nets, tmp_path):
    """An int8 pool's stored blocks carry their scales through the spill
    file: the restarted engine restores them and decodes a cold run's
    tokens; a float store is refused by an int8 engine."""
    _, tnet = nets
    path = str(tmp_path / "int8.npz")
    kw = dict(decode_chunk=1, overlap=False, kv_quant=True)
    req = SYSTEM + [7, 9]
    cold = _engine(ServingEngine, tnet, **kw).generate(
        [Request(req, max_new_tokens=6)])[0]
    e1 = _engine(ServingEngine, tnet, prefix_store=path, **kw)
    e1.generate([Request(req, max_new_tokens=6)])
    e1.shutdown()
    e2 = _engine(ServingEngine, tnet, prefix_store=path, **kw)
    assert e2.prefix_store.block_dtype == "int8"
    r = e2.generate([Request(req, max_new_tokens=6)])[0]
    assert r.tokens == cold.tokens
    assert e2.stats()["prefix_store_tokens"] == 12
    float_eng = _engine(ServingEngine, tnet, prefix_store=path,
                        decode_chunk=1, overlap=False)
    assert float_eng.prefix_store is None


def test_bf16_engine_store_restart_restores_bits(nets, tmp_path):
    """A bf16 engine's stored prefix blocks go to the spill file as uint16
    bits and come back bit for bit: the restarted engine's restored
    blocks equal the first engine's and its tokens equal a cold run's."""
    _, tnet = nets
    path = str(tmp_path / "bf16.npz")
    kw = dict(decode_chunk=1, overlap=False, dtype=torch.bfloat16)
    cold = _engine(ServingEngine, tnet, **kw).generate(
        [Request(SYSTEM + [7, 9], max_new_tokens=6)])[0]
    e1 = _engine(ServingEngine, tnet, prefix_store=path, **kw)
    r1 = e1.generate([Request(SYSTEM + [7, 9], max_new_tokens=6)])[0]
    d = chain_digests(SYSTEM, 4)
    k1, v1 = e1.prefix_store.fetch(d)
    e1.shutdown()
    e2 = _engine(ServingEngine, tnet, prefix_store=path, **kw)
    assert e2.prefix_store.block_dtype == "bfloat16"
    r2 = e2.generate([Request(SYSTEM + [7, 9], max_new_tokens=6)])[0]
    assert r1.tokens == r2.tokens == cold.tokens
    assert e2.stats()["prefix_store_tokens"] == 12
    # a fresh pool hands out blocks lowest id first: the restored prefix
    # went into blocks 0-2, which later writes (positions >= 12) skip
    st = e2.decoder.cache.state
    k2, v2 = st.k[:, :3], st.v[:, :3]
    assert _bits_equal(k2, k1) and _bits_equal(v2, v1)
