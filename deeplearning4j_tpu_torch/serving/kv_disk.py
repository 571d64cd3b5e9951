"""Disk tier of the KV storage ladder, copied from serving/kv_disk.py.

Below the lifecycle manager's `HostBlockPool` (serving/lifecycle.py), a
capacity-capped host-RAM shelf for swapped-out KV block bytes, sits this
`DiskBlockPool`: a spill DIRECTORY holding one npz file per entry.

    device pool  --gather/scatter-->  HostBlockPool (pinned RAM)
                                            |  demote on pressure
                                            v  promote on swap-in
                                       DiskBlockPool (npz files)

Two key namespaces share one pool: swap entries (int request ids, files
``swap_<id>.npz``) and prefix-store entries (sha1 chain digests, files
``pfx_<hex>.npz``), so one byte cap governs everything below RAM.

Every write lands in a sibling ``.tmp`` file and `os.replace`s into place
(a kill mid-demotion leaves the previous entry intact); construction over
an existing directory sweeps leftover ``.tmp`` files, drops stale
``swap_`` entries (request ids are process-scoped) and ingests ``pfx_``
entries tolerantly (a corrupt file warns and is removed); `fetch()` of a
file that rotted after the put warns and raises ``KeyError``, a miss.

Arrays are stored as numpy arrays. A bfloat16 tensor, which numpy cannot
hold, is stored as its uint16 bits beside a ``dtype`` tag and comes back
as the same bits (`to_numpy` / `from_numpy`); the prefix store's spill
file uses the same pair. `fetch()` returns CPU tensors.

Env knobs: ``DL4J_TPU_KV_DISK`` (spill directory; setting it enables
the tier), ``DL4J_TPU_KV_DISK_BYTES`` (byte cap, default 1 GiB).
"""
from __future__ import annotations

import os
import warnings
import zipfile
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.kv_cache import host_value

__all__ = ["DiskBlockPool", "resolve_disk_pool", "DEFAULT_DISK_BYTES",
           "to_numpy", "from_numpy"]

#: Default spill-directory byte cap (DL4J_TPU_KV_DISK_BYTES overrides).
DEFAULT_DISK_BYTES = 1 << 30

#: Exception set a rotten npz read can raise (the same tolerance as
#: PersistentPrefixStore.load).
_READ_ERRORS = (zipfile.BadZipFile, ValueError, OSError, EOFError, KeyError)

#: torch dtypes numpy cannot hold, stored as their uint16 bits
_BITS = (torch.bfloat16,)
_BY_NAME = {str(dt).split(".")[-1]: dt for dt in _BITS}


def to_numpy(x) -> Tuple[np.ndarray, str]:
    """(numpy array, dtype tag) of a block payload: a tensor of a dtype
    numpy lacks becomes its raw bits under the tag of its dtype; other
    payloads keep their dtype and an empty tag."""
    x = host_value(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in _BITS:
            return (x.contiguous().view(torch.int16).numpy().view(np.uint16),
                    str(x.dtype).split(".")[-1])
        return x.numpy(), ""
    return np.asarray(x), ""


def from_numpy(arr: np.ndarray, tag: str = "") -> torch.Tensor:
    """Inverse of `to_numpy`: the CPU tensor holding the same bits."""
    dt = _BY_NAME.get(str(tag))
    if dt is not None:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(dt)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _fname(key) -> str:
    """Collision-free filename per key namespace: request ids (ints, or
    caller-supplied strings — hex-encoded to stay filesystem-safe) are
    swap entries, bytes digests are prefix-store entries."""
    if isinstance(key, bytes):
        return f"pfx_{key.hex()}.npz"
    if isinstance(key, str):
        return f"swap_x{key.encode('utf-8').hex()}.npz"
    return f"swap_{int(key)}.npz"


class DiskBlockPool:
    """Byte-capped spill directory of KV block bytes, one npz per entry.

    LRU over entries (an `OrderedDict` of key -> file bytes); `put()`
    evicts cold files to stay under the cap. Accounting uses the actual
    file sizes, not the nominal device bytes the host pool charges."""

    def __init__(self, directory: str,
                 capacity_bytes: int = DEFAULT_DISK_BYTES):
        self.directory = str(directory)
        self.capacity_bytes = max(0, int(capacity_bytes))
        os.makedirs(self.directory, exist_ok=True)
        self._entries: "OrderedDict[object, int]" = OrderedDict()
        self.bytes_used = 0
        # lifetime counters the lifecycle manager mirrors into stats
        self.n_writes = 0
        self.bytes_written = 0
        self.n_corrupt = 0
        self._scan()

    # --------------------------------------------------------- recovery
    def _scan(self) -> None:
        """Recover an existing spill directory: sweep crash leftovers
        (``.tmp`` from a kill mid-demotion), drop stale ``swap_`` files
        (request ids don't survive the process that minted them), and
        ingest ``pfx_`` entries — tolerantly: a file the zip reader
        rejects warns and is removed rather than poisoning the pool."""
        for name in sorted(os.listdir(self.directory)):
            path = os.path.join(self.directory, name)
            if name.endswith(".tmp") or name.startswith("swap_"):
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            if not (name.startswith("pfx_") and name.endswith(".npz")):
                continue
            try:
                with np.load(path) as z:
                    _ = z.files            # forces the zip directory read
                digest = bytes.fromhex(name[len("pfx_"):-len(".npz")])
            except _READ_ERRORS as e:
                self.n_corrupt += 1
                warnings.warn(
                    f"disk KV spill {path!r} unreadable ({e!r}); treating "
                    "as empty and removing it", stacklevel=2)
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            nbytes = os.path.getsize(path)
            self._entries[digest] = nbytes
            self.bytes_used += nbytes

    # ------------------------------------------------------------ access
    def _path(self, key) -> str:
        return os.path.join(self.directory, _fname(key))

    def can_fit(self, nbytes: int) -> bool:
        return (self.capacity_bytes > 0
                and self.bytes_used + int(nbytes) <= self.capacity_bytes)

    def __contains__(self, key) -> bool:
        return key in self._entries

    @property
    def n_entries(self) -> int:
        return len(self._entries)

    def put(self, key, k_blocks, v_blocks, nbytes: int,
            k_scale=None, v_scale=None) -> int:
        """Spill one entry to its npz file (crash-safe: sibling tmp +
        atomic rename), evicting LRU entries to stay under the cap. Waits
        for an in-flight device->host copy: demotion is a pressure path,
        callers count the sync. Returns the file bytes written."""
        if key in self._entries:
            self.drop(key)
        k_np, tag = to_numpy(k_blocks)
        arrays = {"k": k_np, "v": to_numpy(v_blocks)[0],
                  "dtype": np.asarray(tag)}
        if k_scale is not None:
            arrays["ks"] = to_numpy(k_scale)[0]
            arrays["vs"] = to_numpy(v_scale)[0]
        path = self._path(key)
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
        file_bytes = os.path.getsize(path)
        while self.capacity_bytes and self._entries \
                and self.bytes_used + file_bytes > self.capacity_bytes:
            old_key, _ = next(iter(self._entries.items()))
            self.drop(old_key)
        self._entries[key] = file_bytes
        self.bytes_used += file_bytes
        self.n_writes += 1
        self.bytes_written += file_bytes
        return file_bytes

    def fetch(self, key) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]]]:
        """Remove and read one entry: (k, v, scales-or-None) as CPU
        tensors of the dtype that was put. The whole file is decoded
        BEFORE the entry is dropped, so a read error leaves no partially
        promoted state: the entry is removed (it is unrestorable), a
        warning fires, and ``KeyError`` tells the caller to treat it as a
        miss."""
        if key not in self._entries:
            raise KeyError(key)
        path = self._path(key)
        try:
            with np.load(path) as z:
                tag = str(z["dtype"]) if "dtype" in z.files else ""
                k = from_numpy(z["k"], tag)
                v = from_numpy(z["v"], tag)
                sc = None
                if "ks" in z.files and "vs" in z.files:
                    sc = (from_numpy(z["ks"]), from_numpy(z["vs"]))
        except _READ_ERRORS as e:
            self.n_corrupt += 1
            self.drop(key)
            warnings.warn(
                f"disk KV spill {path!r} unreadable ({e!r}); entry "
                "dropped, caller falls back", stacklevel=2)
            raise KeyError(key) from e
        self.drop(key)
        return k, v, sc

    def drop(self, key) -> None:
        n = self._entries.pop(key, None)
        if n is None:
            return
        self.bytes_used -= n
        try:
            os.remove(self._path(key))
        except OSError:
            pass


def resolve_disk_pool(kv_disk=None, kv_disk_bytes: Optional[int] = None
                      ) -> Optional[DiskBlockPool]:
    """Engine-constructor resolution of the disk-tier knobs: an instance
    passes through, a string is the spill directory, None defers to
    ``DL4J_TPU_KV_DISK`` (empty/"0" = no disk tier — no pool, no code
    on any path). ``kv_disk_bytes`` caps the directory (None defers to
    ``DL4J_TPU_KV_DISK_BYTES``, default 1 GiB)."""
    if isinstance(kv_disk, DiskBlockPool):
        return kv_disk
    if kv_disk is None:
        kv_disk = os.environ.get("DL4J_TPU_KV_DISK", "")
    if not kv_disk or kv_disk == "0":
        return None
    if kv_disk_bytes is None:
        kv_disk_bytes = int(os.environ.get("DL4J_TPU_KV_DISK_BYTES",
                                           str(DEFAULT_DISK_BYTES)))
    return DiskBlockPool(str(kv_disk), capacity_bytes=int(kv_disk_bytes))
