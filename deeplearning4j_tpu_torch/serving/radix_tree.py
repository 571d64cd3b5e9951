"""Radix-tree prefix cache over token KV blocks, copied from
serving/radix_tree.py (RadixAttention, Zheng et al. 2023 / SGLang).
The linear-chain `PrefixRegistry` (serving/block_table.py) indexes
RESIDENT prompt blocks under sha1 chain digests: it already returns the
longest registered prefix of an arbitrary prompt, but it forgets a block
the moment its last slot mapping drops — so the KV a retired chat turn
prefilled is gone by the time the follow-up turn arrives, and only the
host-side `PersistentPrefixStore` (a device->host->device round trip)
can bridge turns. This module closes that gap with the RadixAttention
design:

- `RadixPrefixTree`: a radix tree whose nodes own PATH-COMPRESSED runs
  of full token blocks (children branch at block granularity, keyed by
  the next block's token content). It is a drop-in for `PrefixRegistry`
  — same `bind_pool` / `match` / `register` / `forget` / `lineage` /
  `n_entries` duck type — so the KV cache, the engine, and the
  `ShardedServingGroup` router consume it unchanged.

- DEVICE-RESIDENT RETENTION: at `register` time the tree takes its OWN
  allocator reference on every newly claimed full prompt block. When the
  owning request retires and `KVCache.free` drops the slot's mapping,
  the tree's reference keeps the block in the pool — refcount >= 1, so
  the block never returns to the free list and a later turn (or a
  mid-conversation fork) `match()`es it and COW-shares it exactly like
  a concurrently resident prefix. Partial tail blocks are NOT retained:
  a tail certifies only one exact prompt, so pinning a whole block for
  it buys one rare rematch — tails keep the linear registry's
  resident-only lifetime.

- `reclaim(n)`: cache-pressure eviction. When admission cannot allocate,
  the cache asks the tree to release up to `n` retained blocks whose
  ONLY reference is the tree's — coldest node first, deepest block
  first. `match()` stamps every traversed node, so an ancestor's
  `last_touch` is always >= its descendants' and cold-first order frees
  leaves before the prefixes they depend on.

- `store_victim(entries)`: the ONE tree-wide LRU the persistent prefix
  store plugs in as its `evict_policy` (serving/lifecycle.py), replacing
  the store's private byte-cap LRU: digests belonging to no known
  lineage (orphans from a previous process) evict first in store LRU
  order, then the digest whose tree node is coldest.

Chain digests (`block_table._block_digest`) stay the content addresses:
node digest i commits to tokens [0, (i+1)*block_size), so tree nodes,
`PersistentPrefixStore` keys, and observatory lineage labels all agree
across restarts and replicas by construction.

Per-lineage hit counting: `register` returns how
many of the prompt's digests were ALREADY claimed (first registration
wins; the re-registration is the popularity signal), and
`lineage_hit_counts()` exposes the per-digest tallies the eviction
policy reads. The linear `PrefixRegistry` counts the same way.

Pure host bookkeeping over python ints/bytes: no torch import, no device
access. The only allocator calls are incref/decref/refcount: host
integers. Digests come from this package's `_block_digest` copy, which is
byte-identical to the JAX package's.
"""
from __future__ import annotations

import os
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.serving.block_table import _block_digest

_BlockKey = Tuple[int, ...]


def resolve_prefix_radix(prefix_radix: Optional[bool] = None) -> bool:
    """Constructor resolution of the radix knob: explicit argument wins,
    else `DL4J_TPU_PREFIX_RADIX` (default OFF — radix off keeps the
    linear-chain registry and is bit-identical to the pre-radix engine)."""
    if prefix_radix is None:
        return os.environ.get("DL4J_TPU_PREFIX_RADIX", "0") \
            not in ("", "0", "off")
    return bool(prefix_radix)


class _Node:
    """One radix node: a path-compressed run of full token blocks.

    `tok_blocks[j]` is the j-th block's token content (the edge label at
    block granularity), `phys[j]` the physical block currently holding
    its KV (None = evicted/never resident — the digest and structure
    outlive the residency), `digests[j]` its chain digest, `hobjs[j]`
    the live sha1 chain object AFTER block j (needed to extend the chain
    into tail digests without re-hashing the whole prefix)."""

    __slots__ = ("parent", "tok_blocks", "phys", "digests", "hobjs",
                 "children", "last_touch", "hits")

    def __init__(self, parent: Optional["_Node"]):
        self.parent = parent
        self.tok_blocks: List[_BlockKey] = []
        self.phys: List[Optional[int]] = []
        self.digests: List[bytes] = []
        self.hobjs: List[object] = []
        self.children: Dict[_BlockKey, "_Node"] = {}
        self.last_touch = 0
        self.hits = 0

    def depth(self) -> int:
        d, n = 0, self.parent
        while n is not None:
            d, n = d + 1, n.parent
        return d


class RadixPrefixTree:
    """Radix tree over token blocks, `PrefixRegistry`-compatible.

    Like the linear registry, a tree is bound to exactly ONE block pool
    (`bind_pool`) because physical block ids are pool-scoped; routers may
    run read-only `match()` affinity queries against it. Unlike the
    linear registry it RETAINS registered full prompt blocks in the pool
    after their owners retire (see module docstring), so consumers that
    free blocks must budget for `reclaim()` under pressure."""

    #: duck-typed marker the KV cache keys retention behavior off
    is_radix = True

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._root = _Node(None)
        # full-claim reverse map: physical block -> (node, index in run)
        self._by_block: Dict[int, Tuple[_Node, int]] = {}
        # digest -> node holding it (kept while the NODE lives, even when
        # the block was evicted — the store eviction policy reads lineage
        # heat through this map)
        self._by_digest: Dict[bytes, _Node] = {}
        # exact-prompt partial tails: same shape as the linear registry
        self._tail: Dict[bytes, int] = {}
        self._tail_claims: Dict[int, List[bytes]] = {}
        # blocks the tree itself holds an allocator reference on
        self._retained: set = set()
        self._pool: Optional[weakref.ref] = None
        self.lineage_hits_total = 0
        self._lineage_hits: Dict[str, int] = {}

    # ------------------------------------------------------------ binding
    def bind_pool(self, pool: object) -> "RadixPrefixTree":
        """Claim this tree for one block pool (idempotent per pool) —
        same contract as PrefixRegistry.bind_pool."""
        if self._pool is not None:
            owner = self._pool()
            if owner is not None and owner is not pool:
                raise ValueError(
                    "RadixPrefixTree is already bound to another KV pool; "
                    "physical block ids are pool-scoped, so one tree "
                    "cannot serve two pools (give each replica its own)")
        self._pool = weakref.ref(pool)
        return self

    def _pool_obj(self):
        return self._pool() if self._pool is not None else None

    def _clock(self) -> int:
        pool = self._pool_obj()
        return pool.allocator.clock if pool is not None else 0

    # ------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """(matched_len, physical blocks covering it) for the longest
        RESIDENT prefix of `tokens`: walk the tree block by block,
        stopping at the first token mismatch or evicted (phys=None)
        block — admission needs contiguous coverage — then try the
        exact-prompt partial tail when every full block matched. Stamps
        every traversed node at the allocator clock (tree LRU heat)."""
        bs = self.block_size
        n_full = len(tokens) // bs
        blocks: List[int] = []
        clock = self._clock()
        node, j = self._root, 0
        h = None
        i = 0
        while i < n_full:
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            if j == len(node.tok_blocks):
                nxt = node.children.get(key)
                if nxt is None:
                    break
                node, j = nxt, 0
            if node.tok_blocks[j] != key or node.phys[j] is None:
                break
            blocks.append(node.phys[j])
            h = node.hobjs[j]
            node.last_touch = clock
            i += 1
            j += 1
        if i == n_full:
            tail = tokens[n_full * bs:]
            if tail:
                b = self._tail.get(
                    _block_digest(h, tail, tail=True).digest())
                if b is not None:
                    blocks.append(b)
                    return len(tokens), blocks
        return i * bs, blocks

    # ----------------------------------------------------------- register
    def register(self, tokens: Sequence[int],
                 phys_blocks: Sequence[int]) -> int:
        """File every prompt block of a just-prefilled request, inserting
        tree structure (descend / leaf-extend / split) as needed. First
        registration wins — an already-claimed position keeps its block
        (identical content by the chain-hash certificate) and counts one
        LINEAGE HIT. Newly claimed blocks are RETAINED: the tree increfs
        them on the bound pool's allocator so they survive their owner's
        retirement. Returns the number of lineage hits recorded."""
        bs = self.block_size
        n_full = len(tokens) // bs
        clock = self._clock()
        hits = 0
        node, j = self._root, 0
        h = None
        for i in range(n_full):
            seg = tokens[i * bs:(i + 1) * bs]
            key = tuple(int(t) for t in seg)
            h = _block_digest(h, seg)
            if j == len(node.tok_blocks):
                child = node.children.get(key)
                if child is not None:
                    node, j = child, 0
                elif node.children or node is self._root:
                    # a branch point: start a new child run here
                    child = _Node(node)
                    node.children[key] = child
                    node, j = child, 0
                # else: leaf — extend its run in place (path compression)
            elif node.tok_blocks[j] != key:
                # divergence INSIDE a run: split, then branch a new child
                self._split(node, j)
                child = _Node(node)
                node.children[key] = child
                node, j = child, 0
            if j == len(node.tok_blocks):
                node.tok_blocks.append(key)
                node.phys.append(None)
                node.digests.append(h.digest())
                node.hobjs.append(h)
                self._by_digest[h.digest()] = node
            if node.phys[j] is None:
                self._claim_full(node, j, int(phys_blocks[i]))
            else:
                hits += 1
                node.hits += 1
                hx = node.digests[j].hex()
                self._lineage_hits[hx] = self._lineage_hits.get(hx, 0) + 1
            node.last_touch = clock
            j += 1
        tail = tokens[n_full * bs:]
        if tail:
            d = _block_digest(h, tail, tail=True).digest()
            if d in self._tail:
                hits += 1
                self._lineage_hits[d.hex()] = \
                    self._lineage_hits.get(d.hex(), 0) + 1
            else:
                b = int(phys_blocks[n_full])
                self._tail[d] = b
                self._tail_claims.setdefault(b, []).append(d)
        self.lineage_hits_total += hits
        return hits

    def _claim_full(self, node: _Node, j: int, block: int) -> None:
        node.phys[j] = block
        self._by_block[block] = (node, j)
        pool = self._pool_obj()
        if pool is not None:
            # the tree's OWN reference — retention past slot lifetime
            pool.allocator.incref(block)
            self._retained.add(block)

    def _split(self, node: _Node, j: int) -> _Node:
        """Split `node`'s run at index j: node keeps run[:j], a new child
        takes run[j:] plus the children. Returns the new child."""
        child = _Node(node)
        child.tok_blocks = node.tok_blocks[j:]
        child.phys = node.phys[j:]
        child.digests = node.digests[j:]
        child.hobjs = node.hobjs[j:]
        child.children = node.children
        child.last_touch = node.last_touch
        child.hits = node.hits
        for c in child.children.values():
            c.parent = child
        node.tok_blocks = node.tok_blocks[:j]
        node.phys = node.phys[:j]
        node.digests = node.digests[:j]
        node.hobjs = node.hobjs[:j]
        node.children = {child.tok_blocks[0]: child}
        for idx, b in enumerate(child.phys):
            if b is not None:
                self._by_block[b] = (child, idx)
        for d in child.digests:
            self._by_digest[d] = child
        return child

    # ------------------------------------------------------- invalidation
    def forget(self, block: int) -> None:
        """Invalidate every claim backed by `block` — called when the
        allocator actually frees it (its content is about to be
        overwritten). Under retention that only happens for tail blocks,
        for blocks the tree itself released via `reclaim`, and for
        never-registered blocks."""
        ent = self._by_block.pop(block, None)
        if ent is not None:
            node, j = ent
            node.phys[j] = None
            self._retained.discard(block)
            self._maybe_prune(node)
        for d in self._tail_claims.pop(block, ()):
            if self._tail.get(d) == block:
                del self._tail[d]

    def _maybe_prune(self, node: _Node) -> None:
        """Drop nodes that hold no resident block and no children —
        structure is only worth keeping while it can serve a match or
        carries live descendants. Recurses upward."""
        while (node is not self._root and not node.children
               and all(p is None for p in node.phys)):
            parent = node.parent
            if node.tok_blocks:
                parent.children.pop(node.tok_blocks[0], None)
            for d in node.digests:
                if self._by_digest.get(d) is node:
                    del self._by_digest[d]
            node.parent = None
            node = parent

    # ---------------------------------------------------------- retention
    def retained_blocks(self) -> frozenset:
        """Blocks the tree currently holds its own allocator reference
        on (the `cached_prefix` attribution category when no slot maps
        them)."""
        return frozenset(self._retained)

    @property
    def n_retained(self) -> int:
        return len(self._retained)

    def release(self, block: int) -> bool:
        """Drop the tree's reference on one retained block. Returns True
        when that freed the block (no slot was mapping it) — the claim is
        then forgotten; otherwise the claim stays valid exactly like a
        linear-registry entry (it dies when the last slot drops it)."""
        if block not in self._retained:
            return False
        self._retained.discard(block)
        pool = self._pool_obj()
        if pool is None:
            return False
        if pool.allocator.decref(block):
            self.forget(block)
            return True
        return False

    def reclaim(self, n_blocks: int, protect: Iterable[int] = ()) -> int:
        """Free up to `n_blocks` retained blocks whose ONLY reference is
        the tree's (freeing a slot-mapped block reclaims nothing).
        Victims are taken coldest-node-first; within a node, deepest
        block first — match() stamps every node on the path, so
        ancestors are never colder than the descendants that need them.
        `protect` exempts blocks an in-flight admission is about to map.
        Returns the number of blocks actually freed."""
        pool = self._pool_obj()
        if pool is None or n_blocks <= 0 or not self._retained:
            return 0
        alloc = pool.allocator
        protect = set(protect)
        cand = [b for b in self._retained
                if b not in protect and alloc.refcount(b) == 1]

        def _score(b):
            node, j = self._by_block[b]
            return (node.last_touch, -node.depth(), -j)

        cand.sort(key=_score)
        freed = 0
        for b in cand:
            if freed >= n_blocks:
                break
            if self.release(b):
                freed += 1
        return freed

    def expire(self, ttl: Optional[int] = None) -> int:
        """TTL drain: release every retained block
        whose owning node went UNTOUCHED for more than `ttl` allocator
        ticks (scheduler iterations), so an idle fleet eventually returns
        its cached-prefix bytes to the free list without admission
        pressure. Blocks a slot still maps (refcount > 1) are never
        touched, and a node re-stamped by match()/register() heat
        survives. Returns the number of blocks freed. (The JAX tree's
        wall-seconds `ttl_s` is not ported: no caller sets it.)"""
        if self._pool is None or not self._retained or ttl is None:
            return 0
        alloc = self._pool_obj().allocator
        clk = alloc.clock
        freed = 0
        for b in list(self._retained):
            ent = self._by_block.get(b)
            if ent is None or alloc.refcount(b) != 1:
                continue
            node, _j = ent
            if clk - node.last_touch > ttl and self.release(b):
                freed += 1
        return freed

    def reclaim_all(self) -> int:
        """Release every retained block (teardown/drain helper)."""
        freed = 0
        for b in list(self._retained):
            if self.release(b):
                freed += 1
        return freed

    # ------------------------------------------------- store eviction hook
    def store_victim(self, entries) -> Optional[bytes]:
        """`PersistentPrefixStore.evict_policy` hook: the ONE tree-wide
        LRU. `entries` is the store's digest-keyed mapping in its own LRU
        order; pick the first digest belonging to NO known lineage (an
        orphan from a previous process — the tree has never seen it), else
        the digest whose node is coldest."""
        victim, victim_touch = None, None
        for d in entries:
            node = self._by_digest.get(d)
            if node is None:
                return d
            if victim_touch is None or node.last_touch < victim_touch:
                victim, victim_touch = d, node.last_touch
        return victim

    # ------------------------------------------------------ observability
    def lineage(self, block: int) -> Optional[str]:
        """Hex digest of the prefix chain `block` serves (the full-claim
        digest, else the first tail claim), or None — same contract as
        PrefixRegistry.lineage."""
        ent = self._by_block.get(block)
        if ent is not None:
            node, j = ent
            return node.digests[j].hex()
        tails = self._tail_claims.get(block)
        if tails:
            return tails[0].hex()
        return None

    def lineage_hit_counts(self) -> Dict[str, int]:
        """Per-digest re-registration tallies (the popular-prefix signal
        the eviction policy reads)."""
        return dict(self._lineage_hits)

    @property
    def n_entries(self) -> int:
        """Resident claims: full blocks currently holding KV + tails."""
        return len(self._by_block) + len(self._tail)

    @property
    def n_nodes(self) -> int:
        stack, n = [self._root], -1       # root is structural, not counted
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n

    @property
    def n_blocks_indexed(self) -> int:
        """Token blocks the tree knows (resident or evicted)."""
        stack, n = [self._root], 0
        while stack:
            node = stack.pop()
            n += len(node.tok_blocks)
            stack.extend(node.children.values())
        return n
