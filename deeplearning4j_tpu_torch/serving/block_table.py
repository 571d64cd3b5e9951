"""Host-side paged-KV bookkeeping, copied from serving/block_table.py:
the refcounted block allocator, the content-addressed prefix registry and
`chain_digests`. Pure Python, never touches the device.

- `BlockAllocator`: a refcounted heapq free list over physical block ids
  (lowest id first) and the scheduler-iteration clock. The JAX package's
  per-block heat stamps feed its KV observatory, which is not ported.
- `PrefixRegistry`: chain-hash index of RESIDENT prompt blocks. The digest
  of block i covers prompt tokens [0, (i+1)*block_size), so a hit
  certifies the whole prefix; a prompt ending mid-block also registers its
  partial tail under an exact-prompt digest (copy-on-write at admission).
"""
from __future__ import annotations

import hashlib
import heapq
import weakref
from typing import Dict, List, Optional, Sequence, Tuple


class BlockAllocator:
    """Refcounted heapq free list over physical block ids [0, num_blocks)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least one block, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(self.num_blocks))
        self._ref: List[int] = [0] * self.num_blocks
        self._n_shared = 0          # blocks with refcount >= 2
        self.clock = 0

    def tick(self) -> int:
        """Advance the iteration clock (one scheduler iteration)."""
        self.clock += 1
        return self.clock

    def alloc(self) -> Optional[int]:
        """Claim one free block (lowest id first, refcount 1) or None."""
        if not self._free:
            return None
        b = heapq.heappop(self._free)
        self._ref[b] = 1
        return b

    def alloc_many(self, n: int) -> Optional[List[int]]:
        """Claim `n` blocks all-or-nothing; None without side effects when
        fewer than `n` are free."""
        if n < 0:
            raise ValueError(f"negative block count {n}")
        if len(self._free) < n:
            return None
        return [self.alloc() for _ in range(n)]

    def incref(self, block: int) -> None:
        """One more mapping of an already-resident block (prefix sharing)."""
        if self._ref[block] < 1:
            raise ValueError(f"incref on free block {block}")
        self._ref[block] += 1
        if self._ref[block] == 2:
            self._n_shared += 1

    def decref(self, block: int) -> bool:
        """Drop one mapping; True when the block just became free."""
        if self._ref[block] < 1:
            raise ValueError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 1:
            self._n_shared -= 1
        if self._ref[block] == 0:
            heapq.heappush(self._free, block)
            return True
        return False

    def refcount(self, block: int) -> int:
        return self._ref[block]

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_shared(self) -> int:
        return self._n_shared


def _block_digest(prev, tokens: Sequence[int], tail: bool = False):
    """Extend a chain hash by one block of prompt tokens; tail digests get a
    distinct domain tag so a partial block never collides with a full one.
    Byte-identical to the JAX package's digests."""
    h = prev.copy() if prev is not None else hashlib.sha1(b"kvprefix:")
    h.update(b"t:" if tail else b"b:")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    h.update(b";")
    return h


def chain_digests(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chain digests of every FULL block of `tokens`."""
    bs = int(block_size)
    out: List[bytes] = []
    h = None
    for i in range(len(tokens) // bs):
        h = _block_digest(h, tokens[i * bs:(i + 1) * bs])
        out.append(h.digest())
    return out


class PrefixRegistry:
    """Content-addressed index of resident prompt KV blocks: match() finds
    the longest registered prefix, register() files a freshly prefilled
    prompt's blocks (first registration wins; a re-registration counts one
    lineage hit), forget() drops every claim backed by a freed block. One
    registry serves one block pool (`bind_pool`)."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._full: Dict[bytes, int] = {}
        self._tail: Dict[bytes, int] = {}
        self._claims: Dict[int, List[Tuple[str, bytes]]] = {}
        self._pool: Optional[weakref.ref] = None
        self.lineage_hits_total = 0

    def bind_pool(self, pool: object) -> "PrefixRegistry":
        if self._pool is not None:
            owner = self._pool()
            if owner is not None and owner is not pool:
                raise ValueError(
                    "PrefixRegistry is already bound to another KV pool; "
                    "physical block ids are pool-scoped")
        self._pool = weakref.ref(pool)
        return self

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """(matched_len, physical blocks covering it) for the longest
        registered prefix of `tokens`."""
        bs = self.block_size
        n_full = len(tokens) // bs
        blocks: List[int] = []
        h = None
        for i in range(n_full):
            h = _block_digest(h, tokens[i * bs:(i + 1) * bs])
            b = self._full.get(h.digest())
            if b is None:
                return i * bs, blocks
            blocks.append(b)
        tail = tokens[n_full * bs:]
        if tail:
            b = self._tail.get(_block_digest(h, tail, tail=True).digest())
            if b is not None:
                blocks.append(b)
                return len(tokens), blocks
        return n_full * bs, blocks

    def register(self, tokens: Sequence[int], phys_blocks: Sequence[int]
                 ) -> int:
        """File every prompt block of a just-prefilled request; returns the
        lineage hits recorded."""
        bs = self.block_size
        n_full = len(tokens) // bs
        h = None
        hits = 0
        for i in range(n_full):
            h = _block_digest(h, tokens[i * bs:(i + 1) * bs])
            hits += self._claim("full", h.digest(), phys_blocks[i])
        tail = tokens[n_full * bs:]
        if tail:
            d = _block_digest(h, tail, tail=True).digest()
            hits += self._claim("tail", d, phys_blocks[n_full])
        self.lineage_hits_total += hits
        return hits

    def _claim(self, kind: str, digest: bytes, block: int) -> int:
        index = self._full if kind == "full" else self._tail
        if digest in index:
            return 1
        index[digest] = block
        self._claims.setdefault(block, []).append((kind, digest))
        return 0

    def forget(self, block: int) -> None:
        for kind, digest in self._claims.pop(block, ()):
            index = self._full if kind == "full" else self._tail
            if index.get(digest) == block:
                del index[digest]

    @property
    def n_entries(self) -> int:
        return len(self._full) + len(self._tail)
