"""KV lifecycle under memory pressure, copied from serving/lifecycle.py:
preemption, a host-RAM swap tier and a persistent prefix store.

- `KVLifecycleManager`: policy and cost-model state for preemption. When
  admission fails the engine asks the manager for a victim plan, which
  comes from `plan_eviction` (telemetry/kv_observatory.py). Per victim the
  manager picks RECOMPUTE (free the blocks; the engine requeues the
  request with its generated history and rebuilds the KV by prefill) or
  SWAP (the victim's block bytes move to the `HostBlockPool` and are
  scattered back on resume, bit for bit). `mode="auto"` follows the cost
  model's per-candidate `cheaper` verdict, capped by what the storage
  ladder can hold.

- `HostBlockPool`: a capacity-capped host-RAM tier for swapped-out KV
  block bytes. `put()` takes the `PendingHost` payloads of
  `kv_cache.gather_blocks_host`: pinned CPU tensors whose device->host
  copies may still be in flight (the pool never holds a CUDA tensor).
  `fetch()` (swap-in) and `materialize()` (the deferred harvest of an
  asynchronous swap-out) wait on the copy; the engine counts that wait
  as a host sync and times it (the measured swap bandwidth).

- `PersistentPrefixStore`: a content-addressed host store of full
  prefix-block KV bytes keyed by the chain digests of
  block_table.chain_digests (digest i certifies tokens
  [0, (i+1)*block_size)). Entries carry bytes, not physical block ids,
  so they survive a restart through `save()`/`load()` (an npz spill
  file; env `DL4J_TPU_PREFIX_STORE`). On admission the engine restores
  stored blocks that extend the registry's resident coverage and
  prefills only the remaining suffix.

Below the host pool sits an optional `DiskBlockPool`
(serving/kv_disk.py): cold host entries demote to npz files under
host-pool pressure (`rebalance()`), and a swap-in whose entry went cold
promotes it disk -> host -> device; the prefix store spills through the
same tier. A bfloat16 payload travels to disk and to the spill file as
its uint16 bits with a dtype tag (kv_disk.to_numpy / from_numpy).

With the lifecycle disabled (the default) none of this runs; enabled,
the only added host syncs are on the pressure paths (preemption history
readback, harvest, swap-in, disk demotion, prefix-store restore), each
counted by the engine at the same point as the JAX engine counts it.

Env knobs: `DL4J_TPU_KV_EVICT` (policy name, empty/0/off disables),
`DL4J_TPU_KV_SWAP_BYTES` (host-pool cap in bytes; 0 = recompute only
unless the disk tier is armed), `DL4J_TPU_PREFIX_STORE` (spill-file
path, also enables the store), `DL4J_TPU_KV_DISK` (spill directory),
`DL4J_TPU_KV_DISK_BYTES` (disk cap, default 1 GiB),
`DL4J_TPU_KV_SWAP_ASYNC` (engine knob: deferred harvest, default on).
"""
from __future__ import annotations

import os
import time
import warnings
import zipfile
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.kv_cache import host_value
from deeplearning4j_tpu_torch.serving.kv_disk import (from_numpy,
                                                      resolve_disk_pool,
                                                      to_numpy)
from deeplearning4j_tpu_torch.telemetry.kv_observatory import (
    DEFAULT_FLOPS_PER_SEC, DEFAULT_POLICIES, DEFAULT_SWAP_BYTES_PER_SEC,
    plan_eviction)


def dtype_name(dtype) -> str:
    """A payload dtype as one string for torch and numpy alike
    ("bfloat16", "float32", "int8")."""
    return str(dtype).replace("torch.", "")


def _host_tensor(x) -> torch.Tensor:
    """The CPU tensor of a payload (waits for an in-flight copy)."""
    x = host_value(x)
    return x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(x))


class HostBlockPool:
    """Capacity-capped host-RAM tier for swapped-out KV block bytes.

    Entries are (k, v) per swap key: `PendingHost` payloads whose copies
    complete by `fetch()` / `materialize()`. Byte accounting is nominal
    (the blocks' device size), charged at put() so `can_fit`
    back-pressures swap decisions while the copies are in flight."""

    def __init__(self, capacity_bytes: int = 0):
        self.capacity_bytes = max(0, int(capacity_bytes))
        # insertion-ordered: demotion spills the LRU entry to disk
        self._entries: "OrderedDict[object, Tuple[object, object, int]]" = \
            OrderedDict()
        # an int8 pool's per-(block, head) scales ride beside the payload
        self._scales: Dict[object, Tuple[object, object]] = {}
        self.bytes_used = 0

    def can_fit(self, nbytes: int) -> bool:
        return (self.capacity_bytes > 0
                and self.bytes_used + int(nbytes) <= self.capacity_bytes)

    def put(self, key, k_blocks, v_blocks, nbytes: int,
            k_scale=None, v_scale=None) -> None:
        if key in self._entries:
            raise ValueError(f"swap key {key!r} already held")
        self._entries[key] = (k_blocks, v_blocks, int(nbytes))
        if k_scale is not None:
            self._scales[key] = (k_scale, v_scale)
        self.bytes_used += int(nbytes)

    def fetch_scales(self, key) -> Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]]:
        """(k_scale, v_scale) of a quantized entry, or None. A peek: call
        before `fetch()`, which drops the scales with the payload."""
        sc = self._scales.get(key)
        if sc is None:
            return None
        return _host_tensor(sc[0]), _host_tensor(sc[1])

    def fetch(self, key) -> Tuple[torch.Tensor, torch.Tensor]:
        """Remove one entry and return its host tensors, waiting for their
        copy. The wait happens BEFORE the entry is dropped, so a failed
        materialization leaves the entry (and its bytes) in the pool."""
        k, v, n = self._entries[key]
        k_h = _host_tensor(k)
        v_h = _host_tensor(v)
        del self._entries[key]
        self._scales.pop(key, None)
        self.bytes_used -= n
        return k_h, v_h

    def materialize(self, key) -> int:
        """Wait for one entry's copies and keep the host tensors in place
        (the deferred swap-out harvest). Idempotent; an entry a rebalance
        already demoted to disk is a no-op. Returns the entry's bytes."""
        if key not in self._entries:
            return 0
        k, v, n = self._entries[key]
        self._entries[key] = (_host_tensor(k), _host_tensor(v), n)
        sc = self._scales.get(key)
        if sc is not None:
            self._scales[key] = (_host_tensor(sc[0]), _host_tensor(sc[1]))
        return n

    def pop_lru(self) -> Tuple[object, object, object, int,
                               Optional[Tuple[object, object]]]:
        """Remove the least recently inserted entry: (key, k, v, nbytes,
        scales-or-None)."""
        key, (k, v, n) = self._entries.popitem(last=False)
        sc = self._scales.pop(key, None)
        self.bytes_used -= n
        return key, k, v, n, sc

    def drop(self, key) -> None:
        ent = self._entries.pop(key, None)
        self._scales.pop(key, None)
        if ent is not None:
            self.bytes_used -= ent[2]

    def __contains__(self, key) -> bool:
        return key in self._entries

    @property
    def n_entries(self) -> int:
        return len(self._entries)


class PersistentPrefixStore:
    """Content-addressed host store of full prefix-block KV bytes.

    Entry `d` holds one block's (k, v), each (n_layers, block_size,
    n_kv_heads, head_dim), valid for any pool of the same geometry and
    dtype. LRU-capped; `save()`/`load()` spill to an npz file (keys
    ``k_<hex>``, ``v_<hex>``, ``ks_<hex>``, ``vs_<hex>``, and
    ``dt_<hex>`` for a bfloat16 entry stored as uint16 bits)."""

    def __init__(self, capacity_bytes: int = 256 << 20,
                 path: Optional[str] = None):
        self.capacity_bytes = max(0, int(capacity_bytes))
        self.path = path
        # digest -> (k_block, v_block, nbytes); k/v may be in-flight
        # host copies until save()/fetch() waits for them
        self._entries: "OrderedDict[bytes, Tuple[object, object, int]]" = \
            OrderedDict()
        self._scales: Dict[bytes, Tuple[object, object]] = {}
        self.bytes_used = 0
        self.block_shape: Optional[tuple] = None
        # payload dtype name, set at the first put: the engine refuses a
        # store whose dtype differs from its pool's
        self.block_dtype: Optional[str] = None
        # optional victim chooser: called with the live entries, returns
        # the digest to evict (None = the LRU head); a radix engine wires
        # its tree's `store_victim` here
        self.evict_policy: Optional[Callable[..., Optional[bytes]]] = None
        # disk spill-through: byte-cap victims demote to this tier and
        # covered() promotes them back
        self.disk = None
        self.disk_demotions = 0
        self.disk_promotions = 0

    # ------------------------------------------------------------ lookup
    def covered(self, digests: Sequence[bytes]) -> int:
        """How many LEADING digests the store holds (a usable restore is
        always a prefix of the chain); touches the hits' LRU position. A
        digest spilled to the disk tier is promoted back first; an
        unreadable spill ends the covered prefix."""
        n = 0
        for d in digests:
            if d not in self._entries and not self._promote(d):
                break
            self._entries.move_to_end(d)
            n += 1
        return n

    def _promote(self, digest: bytes) -> bool:
        """Pull one digest's bytes back from the disk tier into RAM."""
        if self.disk is None or digest not in self.disk:
            return False
        try:
            k, v, sc = self.disk.fetch(digest)
        except KeyError:
            return False
        nbytes = k.nbytes + v.nbytes
        if sc is not None:
            nbytes += sc[0].nbytes + sc[1].nbytes
        kw = {} if sc is None else {"k_scale": sc[0], "v_scale": sc[1]}
        self.put(digest, k, v, nbytes, block_shape=tuple(k.shape), **kw)
        if digest not in self._entries:      # put refused (cap too small)
            return False
        self.disk_promotions += 1
        return True

    def missing(self, digests: Sequence[bytes]) -> List[int]:
        """Indices of `digests` not yet stored."""
        return [i for i, d in enumerate(digests) if d not in self._entries]

    # ------------------------------------------------------------- write
    def put(self, digest: bytes, k_block, v_block, nbytes: int,
            block_shape: Optional[tuple] = None,
            k_scale=None, v_scale=None) -> None:
        """File one block's bytes under its chain digest (first write
        wins), evicting entries to stay under the byte cap (into the disk
        tier when one is wired)."""
        if digest in self._entries:
            self._entries.move_to_end(digest)
            return
        if block_shape is not None:
            if self.block_shape is None:
                self.block_shape = tuple(block_shape)
            elif tuple(block_shape) != self.block_shape:
                raise ValueError(
                    f"prefix-store block shape {tuple(block_shape)} != "
                    f"established {self.block_shape}")
        if self.block_dtype is None:
            dt = getattr(k_block, "dtype", None)
            self.block_dtype = None if dt is None else dtype_name(dt)
        nbytes = int(nbytes)
        if self.capacity_bytes and nbytes > self.capacity_bytes:
            return
        while self.capacity_bytes and self._entries \
                and self.bytes_used + nbytes > self.capacity_bytes:
            old_d = None
            if self.evict_policy is not None:
                old_d = self.evict_policy(self._entries)
                if old_d is not None and old_d not in self._entries:
                    old_d = None   # stale advice: fall back to the LRU head
            if old_d is None:
                old_d, (old_k, old_v, old) = self._entries.popitem(last=False)
            else:
                old_k, old_v, old = self._entries.pop(old_d)
            old_sc = self._scales.pop(old_d, None)
            self.bytes_used -= old
            if self.disk is not None and self.disk.can_fit(old):
                self.disk.put(old_d, old_k, old_v, old,
                              k_scale=None if old_sc is None else old_sc[0],
                              v_scale=None if old_sc is None else old_sc[1])
                self.disk_demotions += 1
        self._entries[digest] = (k_block, v_block, nbytes)
        if k_scale is not None:
            self._scales[digest] = (k_scale, v_scale)
        self.bytes_used += nbytes

    def fetch(self, digests: Sequence[bytes]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(k, v) stacks for `digests` (all must be held), each (n_layers,
        len(digests), block_size, n_kv_heads, head_dim): the layout
        `kv_cache.restore_blocks` scatters."""
        ks, vs = [], []
        for d in digests:
            k, v, _ = self._entries[d]
            ks.append(_host_tensor(k))
            vs.append(_host_tensor(v))
        return torch.stack(ks, dim=1), torch.stack(vs, dim=1)

    def fetch_scales(self, digests: Sequence[bytes]
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(k_scale, v_scale) stacks (n_layers, len(digests), n_kv_heads),
        or None when any digest lacks scales."""
        if any(d not in self._scales for d in digests):
            return None
        ks = [_host_tensor(self._scales[d][0]) for d in digests]
        vs = [_host_tensor(self._scales[d][1]) for d in digests]
        return torch.stack(ks, dim=1), torch.stack(vs, dim=1)

    # ----------------------------------------------------- persistence
    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Spill every entry to an npz file (digests hex-encoded in the
        array names) through a sibling temp file renamed into place, so a
        crash mid-write leaves the previous spill intact."""
        path = path or self.path
        if not path:
            return None
        arrays: Dict[str, np.ndarray] = {}
        for d, (k, v, _) in self._entries.items():
            arrays[f"k_{d.hex()}"], tag = to_numpy(k)
            arrays[f"v_{d.hex()}"] = to_numpy(v)[0]
            if tag:
                arrays[f"dt_{d.hex()}"] = np.asarray(tag)
            sc = self._scales.get(d)
            if sc is not None:
                arrays[f"ks_{d.hex()}"] = to_numpy(sc[0])[0]
                arrays[f"vs_{d.hex()}"] = to_numpy(sc[1])[0]
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        return path

    def load(self, path: Optional[str] = None) -> int:
        """Load entries from an npz spill file (a missing file is an empty
        store). A truncated or corrupt spill warns and leaves the store
        empty. Returns the number of blocks loaded."""
        path = path or self.path
        if not path or not os.path.exists(path):
            return 0
        loaded = 0
        try:
            with np.load(path) as z:
                for name in z.files:
                    if not name.startswith("k_"):
                        continue
                    hexd = name[2:]
                    vname = f"v_{hexd}"
                    if vname not in z.files:
                        continue
                    tname = f"dt_{hexd}"
                    tag = str(z[tname]) if tname in z.files else ""
                    k = from_numpy(z[name], tag)
                    v = from_numpy(z[vname], tag)
                    nbytes = k.nbytes + v.nbytes
                    kw = {}
                    ksn, vsn = f"ks_{hexd}", f"vs_{hexd}"
                    if ksn in z.files and vsn in z.files:
                        kw = {"k_scale": from_numpy(z[ksn]),
                              "v_scale": from_numpy(z[vsn])}
                        nbytes += kw["k_scale"].nbytes \
                            + kw["v_scale"].nbytes
                    self.put(bytes.fromhex(hexd), k, v, nbytes,
                             block_shape=tuple(k.shape), **kw)
                    loaded += 1
        except (zipfile.BadZipFile, ValueError, OSError, EOFError,
                KeyError) as e:
            warnings.warn(
                f"prefix-store spill at {path!r} unreadable ({e!r}); "
                "starting with an empty store", stacklevel=2)
            # a half-loaded chain would satisfy covered() for a prefix it
            # cannot restore
            self._entries.clear()
            self._scales.clear()
            self.bytes_used = 0
            return 0
        return loaded

    @property
    def n_entries(self) -> int:
        return len(self._entries)


class KVLifecycleManager:
    """Victim selection and recompute/swap state for one engine.

    `plan()` delegates to `plan_eviction`. The manager owns the
    `HostBlockPool` (and the disk tier below it) and the swap byte/wall
    accounting; the ENGINE owns the preemption itself (slots, masks,
    history) under its scheduler lock."""

    MODES = ("auto", "recompute", "swap")

    def __init__(self, policy: str = "lru", swap_bytes: int = 0,
                 mode: str = "auto", *, flops_per_token: float = 0.0,
                 swap_bytes_per_sec: float = DEFAULT_SWAP_BYTES_PER_SEC,
                 flops_per_sec: float = DEFAULT_FLOPS_PER_SEC,
                 score_fn: Optional[Callable] = None,
                 disk_pool=None):
        if score_fn is None:
            if policy not in DEFAULT_POLICIES:
                raise ValueError(
                    f"unknown eviction policy {policy!r}; known: "
                    f"{sorted(DEFAULT_POLICIES)}")
            score_fn = DEFAULT_POLICIES[policy]
        if mode not in self.MODES:
            raise ValueError(f"kv_evict_mode {mode!r} not in {self.MODES}")
        self.policy = policy
        self.score_fn = score_fn
        self.mode = mode
        self.flops_per_token = float(flops_per_token)
        self.swap_bytes_per_sec = float(swap_bytes_per_sec)
        self.flops_per_sec = float(flops_per_sec)
        self.host_pool = HostBlockPool(swap_bytes)
        self.disk_pool = disk_pool        # None: no disk tier
        self.evictions_recompute = 0
        self.evictions_swap = 0
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.swap_wall_s = 0.0      # swap-in materialization wall
        self.harvests = 0           # deferred swap-out materializations
        self.harvest_wall_s = 0.0
        self.disk_demotions = 0     # host -> disk spills
        self.disk_promotions = 0    # disk -> host restores
        self.disk_wall_s = 0.0      # disk read + write wall
        self.demoted_bytes = 0
        # the engine's init-time round trip, GB/s (None before it ran)
        self.calibrated_gbps: Optional[float] = None

    # ------------------------------------------------------------- plan
    def plan(self, snapshot: Dict[str, object], needed_blocks: int, *,
             eligible: Optional[set] = None,
             now: Optional[float] = None) -> dict:
        """The victims this manager's policy preempts to reclaim
        `needed_blocks`."""
        return plan_eviction(snapshot, needed_blocks, self.score_fn, now,
                             flops_per_token=self.flops_per_token,
                             swap_bytes_per_sec=self.swap_bytes_per_sec,
                             flops_per_sec=self.flops_per_sec,
                             eligible=eligible, policy=self.policy)

    def can_absorb(self, nbytes: int) -> bool:
        """Can the storage ladder hold `nbytes` more of swap payload: the
        host pool directly, or (disk tier armed) after demoting host
        entries to disk?"""
        if self.host_pool.can_fit(nbytes):
            return True
        if self.disk_pool is None:
            return False
        nbytes = int(nbytes)
        disk_free = self.disk_pool.capacity_bytes - self.disk_pool.bytes_used
        if nbytes <= self.host_pool.capacity_bytes:
            overflow = self.host_pool.bytes_used + nbytes \
                - self.host_pool.capacity_bytes
            return overflow <= disk_free
        return nbytes <= disk_free

    def choose_mode(self, victim: dict, nbytes: int) -> str:
        """recompute vs swap for one plan entry: forced by `mode`, or
        (auto) the cost model's verdict; swap only when the ladder can
        hold the bytes."""
        if self.mode == "recompute":
            return "recompute"
        fits = self.can_absorb(nbytes)
        if self.mode == "swap":
            return "swap" if fits else "recompute"
        return "swap" if (victim.get("cheaper") == "swap" and fits) \
            else "recompute"

    # ------------------------------------------------------------- swap
    def swap_out(self, key, k_blocks, v_blocks, nbytes: int,
                 k_scale=None, v_scale=None) -> None:
        """File a victim's gathered block bytes in the host pool; bytes
        are charged now and waited for at harvest / swap-in. Never waits:
        the pool may run over its cap until the next `rebalance()`."""
        self.host_pool.put(key, k_blocks, v_blocks, nbytes,
                           k_scale=k_scale, v_scale=v_scale)
        self.evictions_swap += 1
        self.swap_out_bytes += int(nbytes)

    def rebalance(self) -> dict:
        """Demote LRU host-pool entries to the disk tier until the pool is
        under its byte cap (no-op without a disk tier or under cap).
        Returns {demotions, bytes, wall_s}."""
        out = {"demotions": 0, "bytes": 0, "wall_s": 0.0}
        if self.disk_pool is None \
                or self.host_pool.bytes_used <= self.host_pool.capacity_bytes:
            return out
        t0 = time.perf_counter()
        while self.host_pool.bytes_used > self.host_pool.capacity_bytes \
                and self.host_pool.n_entries:
            key, k, v, n, sc = self.host_pool.pop_lru()
            if not self.disk_pool.can_fit(n):
                # disk full: the entry stays host-resident
                self.host_pool.put(key, k, v, n,
                                   k_scale=None if sc is None else sc[0],
                                   v_scale=None if sc is None else sc[1])
                break
            self.disk_pool.put(key, k, v, n,
                               k_scale=None if sc is None else sc[0],
                               v_scale=None if sc is None else sc[1])
            out["demotions"] += 1
            out["bytes"] += n
        out["wall_s"] = time.perf_counter() - t0
        self.disk_demotions += out["demotions"]
        self.demoted_bytes += out["bytes"]
        self.disk_wall_s += out["wall_s"]
        return out

    def harvest(self, key) -> None:
        """Deferred swap-out harvest: wait for a swapped entry's copies at
        a chunk boundary."""
        t0 = time.perf_counter()
        self.host_pool.materialize(key)
        self.harvest_wall_s += time.perf_counter() - t0
        self.harvests += 1

    def has_swap(self, key) -> bool:
        """Is `key`'s payload restorable from any tier? False means it was
        lost (e.g. a corrupt disk spill): the engine resumes by
        recompute."""
        return key in self.host_pool or (
            self.disk_pool is not None and key in self.disk_pool)

    def drop(self, key) -> None:
        """Forget a swapped entry on every tier."""
        self.host_pool.drop(key)
        if self.disk_pool is not None:
            self.disk_pool.drop(key)

    def swap_in(self, key, nbytes: int
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[Tuple[torch.Tensor, torch.Tensor]],
                           dict]:
        """A swapped request's host bytes from whichever tier holds them:
        (k, v, scales-or-None, {"tier": "host"|"disk", "wall_s",
        "disk_wall_s"}). Raises KeyError when no tier holds the entry."""
        t0 = time.perf_counter()
        tier, disk_wall = "host", 0.0
        if key in self.host_pool:
            scales = self.host_pool.fetch_scales(key)
            k, v = self.host_pool.fetch(key)
        elif self.disk_pool is not None and key in self.disk_pool:
            tier = "disk"
            k, v, scales = self.disk_pool.fetch(key)   # KeyError if corrupt
            disk_wall = time.perf_counter() - t0
            self.disk_wall_s += disk_wall
            self.disk_promotions += 1
        else:
            raise KeyError(key)
        wall = time.perf_counter() - t0
        self.swap_wall_s += wall
        self.swap_in_bytes += int(nbytes)
        return k, v, scales, {"tier": tier, "wall_s": wall,
                              "disk_wall_s": disk_wall}

    # ------------------------------------------------------ measurement
    def calibrate(self, nbytes: int, wall_s: float) -> float:
        """Install the engine's init-time gather round trip as the swap
        bandwidth of every later cost verdict. Returns bytes/s."""
        bps = max(1e6, float(nbytes) / max(1e-9, float(wall_s)))
        self.swap_bytes_per_sec = bps
        self.calibrated_gbps = bps / 1e9
        return bps

    def measured_swap_gbps(self) -> Optional[float]:
        """Swap-in bytes over the materialization wall (harvests
        included), GB/s; None before a swap round trip ran."""
        wall = self.swap_wall_s + self.harvest_wall_s
        if self.swap_in_bytes <= 0 or wall <= 0:
            return None
        return self.swap_in_bytes / wall / 1e9


def resolve_lifecycle(kv_evict, kv_swap_bytes, kv_evict_mode: str = "auto",
                      *, flops_per_token: float = 0.0,
                      kv_disk=None, kv_disk_bytes: Optional[int] = None
                      ) -> Optional[KVLifecycleManager]:
    """Engine-constructor resolution of the lifecycle knobs: `kv_evict` is
    a policy name (True = lru), None defers to `DL4J_TPU_KV_EVICT`;
    empty/"0"/"off" disables (no manager). `kv_disk`/`kv_disk_bytes` arm
    the disk tier (serving/kv_disk.py)."""
    if kv_evict is None:
        kv_evict = os.environ.get("DL4J_TPU_KV_EVICT", "")
    if isinstance(kv_evict, KVLifecycleManager):
        return kv_evict
    if isinstance(kv_evict, bool):
        kv_evict = "lru" if kv_evict else ""
    if not kv_evict or kv_evict in ("0", "off"):
        return None
    if kv_swap_bytes is None:
        kv_swap_bytes = int(os.environ.get("DL4J_TPU_KV_SWAP_BYTES", "0"))
    return KVLifecycleManager(policy=str(kv_evict),
                              swap_bytes=int(kv_swap_bytes),
                              mode=kv_evict_mode,
                              flops_per_token=flops_per_token,
                              disk_pool=resolve_disk_pool(kv_disk,
                                                          kv_disk_bytes))


def resolve_prefix_store(prefix_store) -> Optional[PersistentPrefixStore]:
    """Engine-constructor resolution of the prefix-store knob: an instance
    passes through, True builds a RAM-only store, a string is a spill
    path (loaded when it exists); None defers to `DL4J_TPU_PREFIX_STORE`
    (path, empty = off)."""
    if prefix_store is None:
        path = os.environ.get("DL4J_TPU_PREFIX_STORE", "")
        if not path or path == "0":
            return None
        prefix_store = path
    if isinstance(prefix_store, PersistentPrefixStore):
        return prefix_store
    if prefix_store is True:
        return PersistentPrefixStore()
    store = PersistentPrefixStore(path=str(prefix_store))
    store.load()
    return store
