"""Paged preallocated KV cache (counterpart of serving/kv_cache.py).

One preallocated pair of buffers carved into physical blocks:

    k, v: (n_layers, num_blocks + 1, block_size, n_kv_heads, head_dim)

plus per-slot `lengths` (S,) int32 and a device block table
`block_tables` (S, max_len // block_size) int32 mapping logical to
physical blocks. Block `num_blocks` is the TRASH block, outside the
allocator's pool: every write from an inactive slot, a padding row or an
out-of-range position lands there, so a stale table row can never corrupt
a block already reused by another request. Duplicate scatter indices occur
only inside trash, where the unspecified winner is harmless.

The pool is mutated IN PLACE (`index_put_` on the preallocated tensors): a
literal port of the JAX package's functional `.at[].set` would copy the
whole pool on every token. Consequences the engine relies on: a write is
ordered after every read dispatched before it on the same stream, and a
reader that needs an old value must copy it first (COW copies a block
before the sharer's first write, as in the JAX package).

The invariants are the JAX package's: position p of slot s is visible iff
p < lengths[s]; shared (refcount >= 2) blocks are never written.

The int8 pool (`kv_quant`, serving/quant.py) stores int8 k/v plus float32
k_scale/v_scale (n_layers, num_blocks + 1, n_kv_heads), one scale per
(block, kv head). Whole-block prefill writes quantize the block; every
sub-block write is a read-modify-write of the blocks it touches
(dequantize, insert, requantize), and only touched blocks are written back
with new bytes.

Swap and restore (serving/lifecycle.py): `gather_blocks` copies whole
blocks out of the pool with one `index_select` per buffer on the current
stream, so the gather is ordered after every write dispatched before it
and before every write dispatched after it: the blocks may go back on
the free list right away. `gather_blocks_host` adds the device->host copy
into pinned memory on a side stream that waits on an event recorded after
the gather; `PendingHost.get()` waits on the copy's event. Nothing that
leaves the device keeps a CUDA tensor. `restore_blocks` scatters host
bytes back through pinned memory and `index_copy_` (the pinned source of
a non-blocking copy stays reserved by PyTorch's caching host allocator
until the copy has run on its stream), the exact inverse of the gather.

With `prefix_radix` (serving/radix_tree.py) the registry is a radix tree
that keeps its own reference on registered prompt blocks, so a retired
request's prompt stays resident for a later turn; admission reclaims the
coldest of those blocks before it fails.
"""
from __future__ import annotations

import heapq
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving import quant, radix_tree
from deeplearning4j_tpu_torch.serving.block_table import (BlockAllocator,
                                                          PrefixRegistry)

DEFAULT_BLOCK = 16


def resolve_block_size(block_size: Optional[int], max_len: int) -> int:
    """The env/default block size clamped to the largest divisor of
    max_len not exceeding it."""
    if block_size is None:
        block_size = int(os.environ.get("DL4J_TPU_KV_BLOCK",
                                        str(DEFAULT_BLOCK)))
    bs = max(1, min(int(block_size), int(max_len)))
    while max_len % bs:
        bs -= 1
    return bs


class CacheState:
    """The device tensors of the paged cache. With `kv_quant` the payload
    is int8 and `k_scale`/`v_scale` (n_layers, num_blocks + 1, Hk) float32
    hold the per-(block, head) scales (1.0 everywhere at start: payload 0
    dequantizes to 0 either way); otherwise both are None."""

    def __init__(self, n_layers: int, max_seqs: int, max_len: int,
                 n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                 block_size: int, num_blocks: int, device: torch.device,
                 kv_quant: bool = False):
        bps = max_len // block_size
        shape = (n_layers, num_blocks + 1, block_size, n_kv_heads, head_dim)
        pdt = quant.PAYLOAD_DTYPE if kv_quant else dtype
        self.k = torch.zeros(shape, dtype=pdt, device=device)
        self.v = torch.zeros(shape, dtype=pdt, device=device)
        self.k_scale = self.v_scale = None
        if kv_quant:
            sshape = (n_layers, num_blocks + 1, n_kv_heads)
            self.k_scale = torch.ones(sshape, dtype=quant.SCALE_DTYPE,
                                      device=device)
            self.v_scale = torch.ones(sshape, dtype=quant.SCALE_DTYPE,
                                      device=device)
        self.lengths = torch.zeros((max_seqs,), dtype=torch.int32,
                                   device=device)
        self.block_tables = torch.full((max_seqs, bps), num_blocks,
                                       dtype=torch.int32, device=device)
        self.block_size = block_size
        self.blocks_per_seq = bps
        self.trash = num_blocks
        # the side stream of device->host block copies (made on first use)
        self.copy_stream = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def scales(self, layer: int) -> dict:
        """The layer's k_scale/v_scale keywords for the attention calls
        (empty for a float pool)."""
        if self.k_scale is None:
            return {}
        return {"k_scale": self.k_scale[layer],
                "v_scale": self.v_scale[layer]}


def _rmw_blocks(state: CacheState, layer: int, phys: torch.Tensor,
                idx, k_new: torch.Tensor, v_new: torch.Tensor,
                touched: torch.Tensor) -> None:
    """Read-modify-write of the int8 blocks `phys` (any index shape P):
    dequantize them plus one zero dummy block (appended last along the
    block axis), scatter k_new/v_new at `idx` (an index tuple into the
    (P + dummy, bs) block/offset axes; rows aimed at the dummy are
    discarded), requantize, and write back new bytes only where `touched`
    (P,) is set. Untouched blocks get their own bytes back."""
    for pool, scales, new in ((state.k, state.k_scale, k_new),
                              (state.v, state.v_scale, v_new)):
        pq = pool[layer][phys]                       # (P, bs, Hk, D)
        ps = scales[layer][phys]                     # (P, Hk)
        f = quant.kv_dequantize(pq, ps)
        f = torch.cat([f, torch.zeros_like(f.narrow(-4, 0, 1))], dim=-4)
        f[idx] = new.to(f.dtype)
        q2, s2 = quant.kv_quantize(f.narrow(-4, 0, f.shape[-4] - 1))
        pool[layer][phys] = torch.where(touched[..., None, None, None], q2,
                                        pq)
        scales[layer][phys] = torch.where(touched[..., None], s2, ps)


def write_prefill(state: CacheState, layer: int, slot: int,
                  k_block: torch.Tensor, v_block: torch.Tensor) -> None:
    """Write one layer's prompt k/v (T_pad, Hk, D) into `slot` at logical
    positions [0, T_pad), whole blocks at a time. Padding blocks past the
    slot's reservation hit table entries that point at trash. An int8
    pool quantizes each whole block and scatters payload and scale."""
    bs = state.block_size
    T = k_block.shape[0]
    if T % bs:
        raise ValueError(f"prefill block length {T} not a multiple of "
                         f"block_size {bs}")
    nb = T // bs
    phys = state.block_tables[slot, :nb].long()
    kb = k_block.reshape((nb, bs) + k_block.shape[1:])
    vb = v_block.reshape((nb, bs) + v_block.shape[1:])
    if state.quantized:
        kq, ks = quant.kv_quantize(kb)
        vq, vs = quant.kv_quantize(vb)
        state.k[layer].index_put_((phys,), kq)
        state.v[layer].index_put_((phys,), vq)
        state.k_scale[layer].index_put_((phys,), ks)
        state.v_scale[layer].index_put_((phys,), vs)
        return
    state.k[layer].index_put_((phys,), kb.to(state.k.dtype))
    state.v[layer].index_put_((phys,), vb.to(state.v.dtype))


def write_positions(state: CacheState, layer: int, slot: int,
                    positions: torch.Tensor, valid: torch.Tensor,
                    k_seq: torch.Tensor, v_seq: torch.Tensor) -> None:
    """Scatter k/v (T, Hk, D) to logical `positions` (T,) of `slot`
    through its block table; rows with valid=False route to trash. An
    int8 pool does a read-modify-write over the slot's whole row (a
    prefill-time call): invalid rows land in the dummy block, and only
    touched blocks get new bytes."""
    bs, bps = state.block_size, state.blocks_per_seq
    row = state.block_tables[slot].long()
    bidx = torch.clamp(positions // bs, 0, bps - 1)
    off = positions % bs
    if state.quantized:
        tgt = torch.where(valid, bidx, bps)                # bps = dummy
        touched = torch.zeros((bps + 1,), dtype=torch.int32,
                              device=row.device)
        touched.index_add_(0, tgt, valid.to(torch.int32))
        _rmw_blocks(state, layer, row, (tgt, off), k_seq, v_seq,
                    touched[:bps] > 0)
        return
    phys = torch.where(valid, row[bidx], state.trash)
    state.k[layer].index_put_((phys, off), k_seq.to(state.k.dtype))
    state.v[layer].index_put_((phys, off), v_seq.to(state.v.dtype))


def set_length(state: CacheState, slot: int, length: int) -> None:
    state.lengths[slot] = int(length)


def append_token(state: CacheState, layer: int, k_t: torch.Tensor,
                 v_t: torch.Tensor, active: torch.Tensor) -> None:
    """Batched one-position append for ALL slots at each slot's current
    `lengths` position. Inactive slots route to trash (a freed slot's stale
    row may point at reused blocks). Does not move `lengths`. An int8 pool
    read-modify-writes each active slot's current block; an inactive slot
    reads and writes back trash only."""
    bs, bps = state.block_size, state.blocks_per_seq
    pos = state.lengths.long()
    bidx = torch.clamp(pos // bs, 0, bps - 1)
    phys = torch.gather(state.block_tables, 1, bidx[:, None])[:, 0].long()
    phys = torch.where(active, phys, state.trash)
    off = pos % bs
    if state.quantized:
        S = pos.shape[0]
        rows = torch.arange(S, device=pos.device)
        _rmw_blocks(state, layer, phys, (rows, off), k_t, v_t,
                    active.to(torch.bool))
        return
    state.k[layer].index_put_((phys, off), k_t.to(state.k.dtype))
    state.v[layer].index_put_((phys, off), v_t.to(state.v.dtype))


def append_tokens(state: CacheState, layer: int, k_t: torch.Tensor,
                  v_t: torch.Tensor, positions: torch.Tensor,
                  valid: torch.Tensor) -> None:
    """Batched MULTI-position append for all slots (speculative verify):
    k_t/v_t (S, Q, Hk, D) land at logical `positions` (S, Q) of each slot
    through its block table. Rows with valid=False (inactive slots, rows
    past a slot's draft length) route to trash, so a short draft's padding
    never lands in live blocks. Valid rows of one slot are distinct
    consecutive positions and slots own disjoint blocks, so valid rows
    never alias. Does not move `lengths`: rollback after verification is
    the engine's set-length commit.

    An int8 pool read-modify-writes a fixed window of blocks per slot: Q
    consecutive positions from positions[:, 0] span at most
    (Q + bs - 2) // bs + 1 blocks. A slot with no valid row, and a window
    entry past the table's end, reads and writes back trash only."""
    bs, bps = state.block_size, state.blocks_per_seq
    S, Q = positions.shape
    positions = positions.long()
    bidx = torch.clamp(positions // bs, 0, bps - 1)           # (S, Q)
    if state.quantized:
        dev = positions.device
        nblk = min(bps, (Q + bs - 2) // bs + 1)
        b0 = torch.clamp(positions[:, 0] // bs, 0, bps - 1)   # (S,)
        lidx = b0[:, None] + torch.arange(nblk, device=dev)   # (S, nblk)
        in_range = lidx < bps
        physw = torch.gather(state.block_tables, 1,
                             torch.clamp(lidx, 0, bps - 1)).long()
        live = valid.any(dim=1)
        physw = torch.where(live[:, None] & in_range, physw, state.trash)
        rel = bidx - b0[:, None]                              # (S, Q)
        ok = valid & (rel >= 0) & (rel < nblk)
        tgt = torch.where(ok, rel, nblk)                      # nblk = dummy
        sidx = torch.arange(S, device=dev)[:, None].expand(S, Q)
        touched = torch.zeros((S, nblk + 1), dtype=torch.int32, device=dev)
        touched.index_put_((sidx, tgt), ok.to(torch.int32), accumulate=True)
        _rmw_blocks(state, layer, physw, (sidx, tgt, positions % bs), k_t,
                    v_t, touched[:, :nblk] > 0)
        return
    phys = torch.gather(state.block_tables, 1, bidx).long()
    phys = torch.where(valid, phys, state.trash).reshape(S * Q)
    off = (positions % bs).reshape(S * Q)
    state.k[layer].index_put_((phys, off), k_t.reshape(
        (S * Q,) + k_t.shape[2:]).to(state.k.dtype))
    state.v[layer].index_put_((phys, off), v_t.reshape(
        (S * Q,) + v_t.shape[2:]).to(state.v.dtype))


def advance_lengths(state: CacheState, active: torch.Tensor) -> None:
    """lengths += 1 on active slots only."""
    state.lengths += active.to(torch.int32)


def set_block_table(state: CacheState, slot: int, row: np.ndarray) -> None:
    """Install a slot's logical->physical row (admission/free time)."""
    src = torch.from_numpy(np.ascontiguousarray(row, np.int32))
    if state.block_tables.device.type == "cuda":
        src = src.pin_memory()
    state.block_tables[slot].copy_(src, non_blocking=True)


def copy_block(state: CacheState, src: int, dst: int) -> None:
    """Copy one physical block across ALL layers (the COW copy); an int8
    block's scales travel with its payload, bit-exact."""
    state.k[:, dst].copy_(state.k[:, src])
    state.v[:, dst].copy_(state.v[:, src])
    if state.quantized:
        state.k_scale[:, dst].copy_(state.k_scale[:, src])
        state.v_scale[:, dst].copy_(state.v_scale[:, src])


def is_quantized(state: CacheState) -> bool:
    return state.quantized


def _to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array or CPU tensor on `device` without a blocking copy
    (through pinned memory on a CUDA device; a tensor already pinned,
    such as a host-pool payload or a slice of one, is copied as it is)."""
    x = host_value(x)
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t if dtype is None else t.to(dtype)


def block_index(blocks: Sequence[int], device: torch.device) -> torch.Tensor:
    """Physical block ids as an int64 index tensor on `device`. On a CUDA
    device a non-blocking copy from pageable memory: CUDA stages
    these few bytes when the copy is issued, so no pinned buffer is
    allocated, and the host does not wait for the stream (a blocking
    copy would synchronize it)."""
    idx = torch.tensor(list(blocks), dtype=torch.long)
    return idx.to(device, non_blocking=True) if device.type == "cuda" \
        else idx


def gather_blocks(state: CacheState, blocks: Sequence[int],
                  with_scales: bool = False) -> tuple:
    """Copies of the k/v of physical `blocks` across all layers: (k_blk,
    v_blk), each (n_layers, len(blocks), block_size, n_kv_heads,
    head_dim), plus (k_scale, v_scale) (n_layers, len(blocks), n_kv_heads)
    with `with_scales` on an int8 pool. Device tensors, gathered on the
    current stream."""
    idx = block_index(blocks, state.k.device)
    out = (state.k.index_select(1, idx), state.v.index_select(1, idx))
    if with_scales and state.quantized:
        out += (state.k_scale.index_select(1, idx),
                state.v_scale.index_select(1, idx))
    return out


class HostCopy:
    """Tensors copied into pinned host memory without blocking the host:
    on `stream` (default: the current stream; another stream first waits
    for the current one, so the copies follow the work that produced the
    tensors, and the caching allocator keeps the tensors until copied),
    then an event recorded after the copies. `wait()` blocks on that event
    only and returns the host tensors by key; work enqueued later keeps
    running. On the CPU the tensors are cloned at once."""

    def __init__(self, tensors: Dict[object, torch.Tensor], stream=None):
        self.event = None
        devs = [t.device for t in tensors.values() if t.device.type == "cuda"]
        if not devs:
            self.host = {k: t.clone() for k, t in tensors.items()}
            return
        cur = torch.cuda.current_stream(devs[0])
        side = cur if stream is None else stream
        if side is not cur:
            side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.host = {k: torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True).copy_(
                                            t, non_blocking=True)
                         for k, t in tensors.items()}
        if side is not cur:
            for t in tensors.values():
                t.record_stream(side)
        self.event = torch.cuda.Event()
        self.event.record(side)

    def wait(self) -> Dict[object, torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.host

    def numpy(self) -> Dict[object, np.ndarray]:
        """`wait()`, as numpy arrays over the same host memory."""
        return {k: t.numpy() for k, t in self.wait().items()}


class PendingHost:
    """One tensor of a `HostCopy` (or its block `j` along the block
    axis): `get()` waits for the copy (the caller counts that wait as a
    host sync) and returns the CPU tensor."""
    __slots__ = ("_copy", "_i", "_j")

    def __init__(self, copy: HostCopy, i: int, j: Optional[int] = None):
        self._copy, self._i, self._j = copy, i, j

    def get(self) -> torch.Tensor:
        t = self._copy.wait()[self._i]
        return t if self._j is None else t[:, self._j]

    def block(self, j: int) -> "PendingHost":
        """Block `j` of this gathered stack, without waiting."""
        return PendingHost(self._copy, self._i, j)

    @property
    def dtype(self):
        return self._copy.host[self._i].dtype


def host_value(x):
    """The host value of a block payload: waits for an in-flight copy;
    CPU tensors and numpy arrays pass through."""
    return x.get() if isinstance(x, PendingHost) else x


def gather_blocks_host(state: CacheState, blocks: Sequence[int],
                       with_scales: bool = False) -> tuple:
    """`gather_blocks`, then the device->host copy started without
    blocking: a `PendingHost` per gathered tensor."""
    got = gather_blocks(state, blocks, with_scales=with_scales)
    side = None
    if state.k.device.type == "cuda":
        if state.copy_stream is None:
            state.copy_stream = torch.cuda.Stream(state.k.device)
        side = state.copy_stream
    cp = HostCopy(dict(enumerate(got)), stream=side)
    return tuple(PendingHost(cp, i) for i in range(len(got)))


def restore_blocks(state: CacheState, blocks: Sequence[int], k_blk, v_blk,
                   k_scale=None, v_scale=None) -> None:
    """Scatter gathered block bytes (host or device) back into physical
    `blocks` across all layers, in place: the exact inverse of
    `gather_blocks`, so a round trip is bit-identical. An int8 pool needs
    the matching scales."""
    dev = state.k.device
    idx = block_index(blocks, dev)
    state.k.index_copy_(1, idx, _to_device(k_blk, dev, state.k.dtype))
    state.v.index_copy_(1, idx, _to_device(v_blk, dev, state.v.dtype))
    if state.quantized:
        if k_scale is None or v_scale is None:
            raise ValueError(
                "restore_blocks on a quantized pool requires k_scale/"
                "v_scale (gather with with_scales=True)")
        state.k_scale.index_copy_(1, idx, _to_device(
            k_scale, dev, state.k_scale.dtype))
        state.v_scale.index_copy_(1, idx, _to_device(
            v_scale, dev, state.v_scale.dtype))


@dataclass
class AdmissionPlan:
    """What `KVCache.admit` decided for one request."""
    slot: int
    n_blocks: int
    shared_len: int
    n_shared_blocks: int
    cow: bool


class KVCache:
    """Host-side slot + block allocator around the device `state`.
    Admission, freeing and prefix matching are host decisions made between
    decode iterations and read nothing back from the device."""

    def __init__(self, n_layers: int, max_seqs: int, max_len: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefix_share: Optional[bool] = None,
                 kv_quant: Optional[bool] = None,
                 prefix_radix: Optional[bool] = None,
                 device="cuda"):
        if max_seqs < 1 or max_len < 1:
            raise ValueError(f"bad cache shape: max_seqs={max_seqs}, "
                             f"max_len={max_len}")
        self.n_layers = int(n_layers)
        self.max_seqs = int(max_seqs)
        self.max_len = int(max_len)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.block_size = resolve_block_size(block_size, self.max_len)
        self.blocks_per_seq = self.max_len // self.block_size
        self.num_blocks = int(num_blocks) if num_blocks is not None \
            else self.max_seqs * self.blocks_per_seq
        if self.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {self.num_blocks}")
        self.trash_block = self.num_blocks
        if prefix_share is None:
            prefix_share = os.environ.get("DL4J_TPU_PREFIX_SHARE", "1") != "0"
        self.prefix_share = bool(prefix_share)
        self.kv_quant = quant.resolve_kv_quant(kv_quant)
        self.state = CacheState(self.n_layers, self.max_seqs, self.max_len,
                                self.n_kv_heads, self.head_dim, dtype,
                                self.block_size, self.num_blocks,
                                torch.device(device), kv_quant=self.kv_quant)
        self._free_slots: List[int] = list(range(max_seqs))
        self.allocator = BlockAllocator(self.num_blocks)
        if radix_tree.resolve_prefix_radix(prefix_radix):
            self.registry = radix_tree.RadixPrefixTree(self.block_size)
        else:
            self.registry = PrefixRegistry(self.block_size)
        self.registry.bind_pool(self)
        self.prefix_radix = bool(getattr(self.registry, "is_radix", False))
        self._owner: Dict[int, object] = {}
        self._slot_blocks: Dict[int, List[int]] = {}
        self._block_sharers: Dict[int, set] = {}
        self.shared_blocks_total = 0
        self.shared_tokens_total = 0
        self.cow_copies_total = 0

    # ---------------- admission (slot + block allocation) ----------------
    def allocate(self, owner=None, n_positions: Optional[int] = None,
                 prompt: Optional[Sequence[int]] = None) -> Optional[int]:
        plan = self.admit(owner, n_positions=n_positions, prompt=prompt)
        return None if plan is None else plan.slot

    def admit(self, owner=None, n_positions: Optional[int] = None,
              prompt: Optional[Sequence[int]] = None
              ) -> Optional[AdmissionPlan]:
        """Reserve ceil(n_positions / block_size) blocks for a slot, mapping
        leading blocks onto resident shared-prefix blocks when `prompt`
        matches the registry, COW-copying the block that holds the first
        divergent write. All-or-nothing: None without side effects."""
        if not self._free_slots:
            return None
        bs = self.block_size
        if n_positions is None:
            n_positions = self.max_len
        n_positions = max(1, min(int(n_positions), self.max_len))
        need = -(-n_positions // bs)
        shared_len, shared_blocks, cow_src = 0, [], None
        if self.prefix_share and prompt is not None and len(prompt) > 1:
            matched, mblocks = self.registry.match(prompt)
            # always recompute at least the LAST prompt position
            shared_len = min(matched, len(prompt) - 1)
            if shared_len >= 1:
                n_full = shared_len // bs
                shared_blocks = mblocks[:n_full]
                if matched > n_full * bs:
                    cow_src = mblocks[n_full]
            else:
                shared_len = 0
        n_fresh = need - len(shared_blocks)
        fresh = self.allocator.alloc_many(n_fresh)
        if fresh is None and self.prefix_radix:
            # the tree's cold retained blocks go before the admission
            # fails; blocks this admission is about to map are protected
            protect = set(shared_blocks)
            if cow_src is not None:
                protect.add(cow_src)
            short = n_fresh - self.allocator.n_free
            if short > 0 and self.registry.reclaim(short,
                                                   protect=protect) > 0:
                fresh = self.allocator.alloc_many(n_fresh)
        if fresh is None:
            return None
        slot = heapq.heappop(self._free_slots)
        for b in shared_blocks:
            self.allocator.incref(b)
        row_blocks = list(shared_blocks) + fresh
        if cow_src is not None:
            copy_block(self.state, cow_src, fresh[0])
            self.cow_copies_total += 1
        row = np.full((self.blocks_per_seq,), self.trash_block, np.int32)
        row[:len(row_blocks)] = row_blocks
        set_block_table(self.state, slot, row)
        self._owner[slot] = owner
        self._slot_blocks[slot] = row_blocks
        for b in row_blocks:
            self._block_sharers.setdefault(b, set()).add(slot)
        self.shared_blocks_total += len(shared_blocks)
        self.shared_tokens_total += shared_len
        return AdmissionPlan(slot=slot, n_blocks=len(row_blocks),
                             shared_len=shared_len,
                             n_shared_blocks=len(shared_blocks),
                             cow=cow_src is not None)

    def ensure_writable(self, slot: int, start: int, end: int) -> int:
        """Make every block of `slot` covering positions [start, end)
        private (copy-on-write) before a write lands there. Returns the
        number of blocks copied."""
        if end <= start:
            return 0
        bs = self.block_size
        row_blocks = self._slot_blocks.get(slot)
        if row_blocks is None:
            raise ValueError(f"slot {slot} is not resident")
        copied = 0
        for li in range(max(0, start // bs),
                        min(len(row_blocks), -(-end // bs))):
            old = row_blocks[li]
            if self.allocator.refcount(old) < 2:
                continue
            fresh = self.allocator.alloc_many(1)
            if fresh is None:
                raise RuntimeError(
                    f"copy-on-write for slot {slot} block {li}: no free "
                    "block despite an admission-time reservation")
            copy_block(self.state, old, fresh[0])
            row_blocks[li] = fresh[0]
            row = np.full((self.blocks_per_seq,), self.trash_block, np.int32)
            row[:len(row_blocks)] = row_blocks
            set_block_table(self.state, slot, row)
            self._block_sharers[old].discard(slot)
            if not self._block_sharers[old]:
                # under radix retention refcount 2 may be one slot + the
                # tree's own reference
                del self._block_sharers[old]
            self._block_sharers.setdefault(fresh[0], set()).add(slot)
            self.allocator.decref(old)
            self.cow_copies_total += 1
            copied += 1
        return copied

    def register_prefix(self, slot: int, prompt: Sequence[int]) -> int:
        """File the slot's prompt blocks in the prefix registry (after the
        prefill was dispatched: stream order puts its writes ahead of any
        sharer's reads). Under a radix registry this is also where the
        tree takes its own reference on new full prompt blocks."""
        if self.prefix_share and len(prompt) >= 2:
            return int(self.registry.register(
                prompt, self._slot_blocks[slot]) or 0)
        return 0

    def free(self, slot: int) -> None:
        """Return a slot and its block reservations; the device row resets
        to trash and lengths[slot] to 0."""
        if slot not in self._slot_blocks:
            raise ValueError(f"slot {slot} already free")
        for b in self._slot_blocks.pop(slot):
            sharers = self._block_sharers.get(b)
            if sharers is not None:
                sharers.discard(slot)
                if not sharers:
                    del self._block_sharers[b]
            if self.allocator.decref(b):
                self.registry.forget(b)
        self._owner.pop(slot, None)
        set_length(self.state, slot, 0)
        set_block_table(self.state, slot, np.full(
            (self.blocks_per_seq,), self.trash_block, np.int32))
        heapq.heappush(self._free_slots, slot)

    def owner(self, slot: int):
        return self._owner.get(slot)

    # ---------------------------------------------------- heat / snapshot
    def touch_blocks(self, slot: int, start: int, end: int) -> None:
        """Stamp every block of `slot` covering logical positions
        [start, end) as written at the allocator's current clock."""
        if end <= start:
            return
        bs = self.block_size
        row_blocks = self._slot_blocks.get(slot)
        if not row_blocks:
            return
        for li in range(max(0, start // bs),
                        min(len(row_blocks), -(-end // bs))):
            self.allocator.touch(row_blocks[li])

    def sharers(self, block: int) -> frozenset:
        """Slots currently mapping `block` (empty when free)."""
        return frozenset(self._block_sharers.get(block, ()))

    def pool_snapshot(self, live_positions: Optional[Dict[int, int]] = None,
                      include_blocks: bool = True) -> Dict[str, object]:
        """One consistent host-side view of the pool (no device reads).
        `live_positions` (slot -> positions written, the engine's
        bookkeeping) splits reservations into live and waste;
        `include_blocks=False` skips the per-block table."""
        alloc = self.allocator
        slots: Dict[int, Dict[str, object]] = {}
        for slot in sorted(self._slot_blocks):
            owner = self._owner.get(slot)
            req_id = getattr(owner, "req_id", None)
            if req_id is None and isinstance(owner, (int, str)):
                req_id = owner
            blocks = self._slot_blocks[slot]
            slots[slot] = {
                "req_id": req_id,
                "blocks": list(blocks),
                "reserved_positions": len(blocks) * self.block_size,
                "live_positions": None if live_positions is None
                else int(live_positions.get(slot, 0)),
                "deadline": getattr(owner, "deadline", None),
                "t_submit": getattr(owner, "t_submit", None),
            }
        cached = (self.registry.retained_blocks()
                  if self.prefix_radix else frozenset())
        snap: Dict[str, object] = {
            "clock": alloc.clock,
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "bytes_per_position": self.bytes_per_position,
            "block_overhead_bytes": self.block_overhead_bytes,
            "blocks_free": alloc.n_free,
            "blocks_shared": alloc.n_shared,
            "blocks_cached": len(cached),
            "slots_free": len(self._free_slots),
            "slots_active": self.max_seqs - len(self._free_slots),
            "slots": slots,
        }
        if include_blocks:
            snap["blocks"] = {
                b: {
                    "refcount": alloc.refcount(b),
                    "last_touch": alloc.last_touch(b),
                    "alloc_epoch": alloc.alloc_epoch(b),
                    "sharers": sorted(self._block_sharers.get(b, ())),
                    "cached": b in cached,
                    "lineage": self.registry.lineage(b),
                }
                for b in sorted(set(self._block_sharers) | set(cached))
            }
        return snap

    # ------------------------------------------------------------- stats
    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def blocks_free(self) -> int:
        return self.allocator.n_free

    @property
    def blocks_shared(self) -> int:
        return self.allocator.n_shared

    @property
    def blocks_cached(self) -> int:
        """Blocks held only by the radix tree's reference (0 without it)."""
        return len(self.registry.retained_blocks()) \
            if self.prefix_radix else 0

    def active_slots(self) -> List[int]:
        return sorted(self._owner)

    @property
    def bytes_per_position(self) -> int:
        """Per-token KV payload bytes (k+v, all layers), from the pool's
        own dtype (int8 when quantized). Scale bytes are per block and
        live in `block_overhead_bytes`."""
        return self.n_layers * self.n_kv_heads * self.head_dim * (
            self.state.k.element_size() + self.state.v.element_size())

    @property
    def block_overhead_bytes(self) -> int:
        """Scale bytes per physical block (0 on a float pool): one float32
        per (layer, kv head) for each of k and v."""
        st = self.state
        if not st.quantized:
            return 0
        return self.n_layers * self.n_kv_heads * (
            st.k_scale.element_size() + st.v_scale.element_size())

    @property
    def block_bytes(self) -> int:
        """Bytes of one physical block: payload plus its scales."""
        return self.block_size * self.bytes_per_position \
            + self.block_overhead_bytes

    def bytes(self) -> int:
        """Device memory held by the k/v buffers and their scales (trash
        block included)."""
        return (self.num_blocks + 1) * self.block_bytes
