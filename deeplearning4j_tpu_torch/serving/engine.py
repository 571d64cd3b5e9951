"""Continuous-batching autoregressive serving engine (counterpart of
serving/engine.py), colocated scheduling over the paged KV cache.

Iteration-level scheduling: between decode iterations the host admits
queued requests (block allocation with copy-on-write prefix sharing),
retires finished ones and frees their blocks. The scheduling logic is the
JAX engine's, so the same schedule gives the same tokens and the same
counted host syncs.

Hot loop:
- one decode CHUNK is K micro-steps dispatched by one host loop with no
  host read inside (`_run_chunk`, the counterpart of `_build_chunk`):
  embed each slot's last token on the device, cached attention through
  StackDecoder (the CUDA kernel on the card), sample, write the token into
  the device history, update the active mask (EOS / max-token tests run on
  the device);
- after the chunk the host copies one small bundle (entry masks, final
  mask, nonfinite sentinel, history) into pinned memory without blocking
  and records a CUDA event; reading the bundle waits on that event only.
  That readback is the one counted sync per chunk; each admission's
  first-token read is the other kind. K adapts down to 1 while requests
  queue or a prefill is being chunked;
- OVERLAPPED drain (`overlap=True`): chunk i+1 is dispatched before chunk
  i's bundle is read, the device-side active mask threading chunk to chunk.

Sampling keys are chain positions (serving/sampler.py): micro-step i of a
chunk uses the position the i-th sequential step would, and only the
micro-steps that ran with an active slot are committed, so K in {1, 8} is
token-identical in synchronous stepping even at temperature > 0.

Speculative decoding (`spec_decode`, env DL4J_TPU_SPEC_DECODE=1) replaces
the chunk: each iteration proposes per-slot n-gram drafts on the host
(serving/spec.py), verifies [last token, drafts] at Q consecutive positions
in ONE multi-query dispatch (StackDecoder._spec_decode_fn, kernel K2 on the
card), accepts with the point-mass rule (sampler.spec_accept_tokens) and
commits the accepted prefix by setting `lengths`; rejected rows stay
invisible. Still one counted sync per iteration, and a spec engine always
steps synchronously (the committed tokens feed the draft index).
`kv_quant` (env DL4J_TPU_KV_QUANT) stores the KV pool in int8 with
per-(block, head) scales, `quant_weights` (env DL4J_TPU_W8) the attention
projections in int8 (serving/quant.py).

Serving under KV pressure (serving/lifecycle.py, `kv_evict`, env
DL4J_TPU_KV_EVICT): when the head-of-queue reservation fails, the policy
plans victims among the decode-active slots and the engine PREEMPTS them.
A recompute victim requeues with its generated tokens and re-prefills
prompt + history[:-1] on resume; a swap victim's blocks are gathered on
the decode stream before they return to the free list, copied into
pinned host memory on a side stream, and scattered back on resume, so
decode continues on the same bytes. `kv_swap_async` (default on) defers
the victim's history readback and the wait on its copy to the next chunk
boundary (`_harvest_swaps`), and the victim's history row is snapshotted
into pinned memory at preempt time, since its slot may be reused within
the same admission pass. The host pool spills to a disk tier
(`kv_disk`). `prefix_radix` keeps finished prompts resident in a radix
tree (drained by `radix_ttl`), and `prefix_store` keeps prefix blocks in
host memory and an npz file across restarts. Every request carries a
timeline of host-clock spans that tile its life (queue, admission,
prefill, decode chunks, preempt, swap, retire).

Options of the JAX engine that this slice does not port raise
NotImplementedError when set (argument or environment variable):
non-colocated policies, the flight recorder, the KV observatory, time
series and alerts, the journal, and the registry / metrics parent shared
across replica groups.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.serving import kv_cache as _kvc
from deeplearning4j_tpu_torch.serving import spec as spec_mod
from deeplearning4j_tpu_torch.serving.block_table import chain_digests
from deeplearning4j_tpu_torch.serving.decode import (StackDecoder,
                                                     one_hot_embedder)
from deeplearning4j_tpu_torch.serving.kv_disk import resolve_disk_pool
from deeplearning4j_tpu_torch.serving.lifecycle import (dtype_name,
                                                        resolve_lifecycle,
                                                        resolve_prefix_store)
from deeplearning4j_tpu_torch.serving.policy import ColocatedPolicy
from deeplearning4j_tpu_torch.serving.sampler import (Sampler,
                                                      spec_accept_tokens)
from deeplearning4j_tpu_torch.telemetry.registry import (DEFAULT_S_BUCKETS,
                                                         MetricsRegistry)

DEFAULT_PREFILL_CHUNK = 256

#: scheduler-iteration ids, unique across engines in the process (the
#: "iter" stamp of timeline events)
_ITER_IDS = itertools.count(1)

# (constructor argument, environment variable) of every JAX engine option
# this slice does not port
_UNPORTED = (
    ("flight_recorder", "DL4J_TPU_FLIGHT_RECORDER"),
    ("kv_observatory", "DL4J_TPU_KV_OBS"), ("timeseries", "DL4J_TPU_TS"),
    ("ts_window", None), ("alerts", "DL4J_TPU_ALERTS"),
    ("journal", "DL4J_TPU_JOURNAL"),
    ("prefix_registry", None), ("metrics_parent", None),
)


def _host_rows(t: torch.Tensor) -> np.ndarray:
    """Logprob rows as a host array (bf16/fp16 widened to float32, which
    numpy can hold)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def resolve_radix_ttl(ttl=None) -> Optional[int]:
    """The radix-retention TTL in allocator ticks (scheduler iterations):
    an explicit argument wins, else `DL4J_TPU_RADIX_TTL`; empty/0 means
    no TTL. The engine is the one place the TTL is decided; the policy's
    `evict` reads it from the pressure view."""
    if ttl is None:
        env = os.environ.get("DL4J_TPU_RADIX_TTL", "")
        ttl = int(env) if env not in ("", "0", "off") else 0
    ttl = int(ttl)
    return ttl if ttl > 0 else None


def _env_on(name: Optional[str]) -> bool:
    return name is not None and os.environ.get(name, "").lower() \
        not in ("", "0", "off", "false")


@dataclass
class Request:
    """One generation request (token ids in, token ids out)."""
    tokens: Sequence[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_id: Optional[int] = None
    timeout_s: Optional[float] = None


@dataclass
class GenerationResult:
    tokens: List[int]                 # generated ids (prompt NOT included)
    finish_reason: str                # "length" | "eos" | "timeout" | "shutdown"
    prompt_len: int
    # per-generated-token (V,) logprob rows under capture_logprobs=True
    logprobs: Optional[List[np.ndarray]] = None
    ttft_s: Optional[float] = None
    tokens_per_sec: Optional[float] = None
    req_id: int = -1
    queue_wait_s: Optional[float] = None
    admission_retries: int = 0
    # ordered {"phase", "t0", "t1", ...} events on the host monotonic
    # clock that tile the request's life, from timestamps the scheduler
    # already takes (no device reads)
    timeline: List[dict] = field(default_factory=list)
    shared_prefix_tokens: int = 0


class _Future:
    """Observable-future result holder."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Optional[GenerationResult] = None

    def _set(self, value):
        self._value = value
        self._event.set()

    def get(self, timeout: Optional[float] = None) -> GenerationResult:
        if not self._event.wait(timeout):
            raise TimeoutError("generation result not ready")
        return self._value


@dataclass
class _Active:
    """Host-side bookkeeping for a request occupying a slot."""
    req: Request
    fut: _Future
    slot: int
    n_generated: int                  # includes the prefill-sampled token
    deadline: Optional[float]
    logprobs: Optional[List[np.ndarray]] = None
    t_submit: float = 0.0
    t_first: float = 0.0
    req_id: int = -1
    retries: int = 0
    t_admit: float = 0.0
    timeline: List[dict] = field(default_factory=list)
    prefilled: int = 0                # prompt positions [0, prefilled) resident
    shared_len: int = 0
    n_chunks: int = 0
    # set while requeued after a preemption: {"mode": "recompute"|"swap",
    # "tokens": generated ids, "t_requeue", "nbytes"}
    resume: Optional[dict] = None
    preemptions: int = 0
    # the first failed reservation, held until the "queue" event exists
    kv_rejection: Optional[dict] = None


class ServingEngine:
    """Continuous-batching generation over a StackDecoder.

    Drive it synchronously (`generate`, or `submit` + `step` in a loop) or
    through the background thread (`start`, `submit`, `shutdown`).
    `decode_chunk` (default 8; env DL4J_TPU_DECODE_CHUNK) is the number of
    decode micro-steps per host scheduling opportunity; `overlap` (default
    True) lets `drain` dispatch the next chunk before reading the previous
    one's masks (off under capture_logprobs); `prefill_chunk` (default 256;
    env DL4J_TPU_PREFILL_CHUNK; 0 disables) is the per-iteration prefill
    token budget. `spec_decode` (env DL4J_TPU_SPEC_DECODE=1) turns on
    n-gram speculative decoding with at most `spec_draft` (default 4; env
    DL4J_TPU_SPEC_DRAFT) drafts per slot and step; `kv_quant` and
    `quant_weights` select the int8 KV pool and int8 attention weights.

    Under KV pressure: `kv_evict` (a victim policy: "lru",
    "slo_deadline", "refcount_weighted"; env DL4J_TPU_KV_EVICT) arms
    preemption, `kv_evict_mode` ("auto" | "recompute" | "swap") picks how
    victims resume, `kv_swap_bytes` (env DL4J_TPU_KV_SWAP_BYTES) caps the
    pinned host pool, `kv_disk` / `kv_disk_bytes` (env DL4J_TPU_KV_DISK /
    DL4J_TPU_KV_DISK_BYTES) arm the disk tier below it, `kv_swap_async`
    (default on; env DL4J_TPU_KV_SWAP_ASYNC) defers the swap-out readback
    to the next chunk boundary. `prefix_radix` (env DL4J_TPU_PREFIX_RADIX)
    retains finished prompts in a radix tree, drained after `radix_ttl`
    idle iterations (env DL4J_TPU_RADIX_TTL); `prefix_store` (True, a
    path, or a PersistentPrefixStore; env DL4J_TPU_PREFIX_STORE) keeps
    prefix blocks across restarts. `name` labels the engine."""

    def __init__(self, net, max_seqs: int, max_len: int, *, dtype=None,
                 seed: int = 0, top_k: int = 0,
                 max_new_tokens_cap: int = 512,
                 embed: Optional[Callable] = None,
                 capture_logprobs: bool = False,
                 decode_chunk: Optional[int] = None,
                 overlap: bool = True,
                 prefill_chunk: Optional[int] = None,
                 kv_block: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 prefix_share: Optional[bool] = None,
                 spec_decode: Optional[bool] = None,
                 spec_draft: Optional[int] = None,
                 kv_evict=None,
                 kv_swap_bytes: Optional[int] = None,
                 kv_evict_mode: str = "auto",
                 kv_disk=None,
                 kv_disk_bytes: Optional[int] = None,
                 kv_swap_async: Optional[bool] = None,
                 prefix_store=None,
                 kv_quant: Optional[bool] = None,
                 quant_weights: Optional[bool] = None,
                 prefix_radix: Optional[bool] = None,
                 policy=None,
                 radix_ttl: Optional[int] = None,
                 name: Optional[str] = None,
                 device="cuda",
                 **unported):
        for key in unported:
            if key not in dict(_UNPORTED):
                raise TypeError(f"unexpected keyword argument {key!r}")
        for key, env in _UNPORTED:
            val = unported.get(key)
            if (val is not None and val is not False) or \
                    (val is None and _env_on(env)):
                raise NotImplementedError(
                    f"ServingEngine option {key!r}"
                    f"{f' (env {env})' if env else ''} is not ported to "
                    "deeplearning4j_tpu_torch yet")
        if policy is not None and type(policy) is not ColocatedPolicy:
            raise NotImplementedError(
                f"scheduling policy {type(policy).__name__} is not ported "
                "yet (only ColocatedPolicy)")
        if _env_on("DL4J_TPU_DISAGG"):
            raise NotImplementedError(
                "disaggregated serving (env DL4J_TPU_DISAGG) is not ported "
                "yet")
        self.device = resolve_device(device)
        if self.device != net.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"network's {net.device}")
        self.decoder = StackDecoder(net, max_seqs, max_len, dtype=dtype,
                                    block_size=kv_block, num_blocks=kv_blocks,
                                    prefix_share=prefix_share,
                                    kv_quant=kv_quant,
                                    quant_weights=quant_weights,
                                    prefix_radix=prefix_radix,
                                    device=self.device)
        if embed is None:
            if self.decoder.n_in is None:
                raise ValueError("stack has no n_in; pass embed=")
            embed = one_hot_embedder(self.decoder.n_in, self.decoder.dtype)
        self.embed = embed
        self.sampler = Sampler(seed, top_k, device=self.device)
        self.capture_logprobs = bool(capture_logprobs)
        self._cap = int(max_new_tokens_cap)
        if decode_chunk is None:
            decode_chunk = int(os.environ.get("DL4J_TPU_DECODE_CHUNK", "8"))
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.decode_chunk = int(decode_chunk)
        self.overlap = bool(overlap)
        if prefill_chunk is None:
            prefill_chunk = int(os.environ.get(
                "DL4J_TPU_PREFILL_CHUNK", str(DEFAULT_PREFILL_CHUNK)))
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0 (0 disables), got "
                             f"{prefill_chunk}")
        bs_kv = self.decoder.cache.block_size
        if prefill_chunk:
            prefill_chunk = max(bs_kv, (prefill_chunk // bs_kv) * bs_kv)
        self.prefill_chunk = int(prefill_chunk)
        self.policy = policy if policy is not None else ColocatedPolicy()
        self.name = name
        self._iter_id = 0
        # speculative decoding replaces chunking: one spec step is one
        # scheduling opportunity committing 1..Q tokens per slot
        self.spec_decode = spec_mod.resolve_spec_decode(spec_decode)
        self.spec_draft = spec_mod.resolve_spec_draft(spec_draft)
        self._spec_index = (spec_mod.NgramDraftIndex()
                            if self.spec_decode else None)
        S = self.decoder.cache.max_seqs
        dev = self.device
        # device-side per-slot state, mutated in place
        self._hist = torch.zeros((S, self._cap), dtype=torch.int32,
                                 device=dev)
        self._last = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._plens = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._eos = torch.full((S,), -1, dtype=torch.int32, device=dev)
        self._maxgen = torch.ones((S,), dtype=torch.int32, device=dev)
        self._slots = torch.arange(S, device=dev)
        # device-side active mask: only while the overlapped drain runs
        self._dev_active: Optional[torch.Tensor] = None
        # host-side
        self._active_mask = np.zeros((S,), bool)
        self._temps = np.zeros((S,), np.float32)
        self._by_slot: Dict[int, _Active] = {}
        self._queue: List[_Active] = []
        self._prefilling: List[_Active] = []
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._drain_on_stop = True
        self._next_req_id = 0
        self._resident_seqs_max = 0
        self._seen_shapes: set = set()
        # every metric is fed from host values: recording adds no sync
        m = self.metrics = MetricsRegistry()
        self._c_syncs = m.counter("serving.host_syncs",
                                  "device->host materializations in the "
                                  "serve loop")
        self._c_tokens = m.counter("serving.tokens_out",
                                   "generated tokens delivered")
        self._c_admits = m.counter("serving.admissions")
        self._c_retires = m.counter("serving.retirements")
        self._c_timeouts = m.counter("serving.timeouts")
        self._c_nonfinite = m.counter("serving.nonfinite_chunks")
        self._c_compiles = m.counter(
            "serving.jit_compiles", "first-use shapes (prefill buckets + "
            "chunk lengths), the JAX engine's compile-miss key")
        self._c_prefix_hits = m.counter("serving.prefix_hits")
        self._c_prefix_tokens = m.counter("serving.prefix_shared_tokens")
        self._c_lineage_hits = m.counter("serving.kv.prefix_lineage_hits")
        self._c_adm_retries = m.counter("serving.admission_retries")
        self._c_pf_chunks = m.counter("serving.prefill_chunks")
        self._h_ttft = m.histogram("serving.ttft_s", "submit -> first token",
                                   buckets=DEFAULT_S_BUCKETS)
        self._h_queue_wait = m.histogram("serving.queue_wait_s",
                                         buckets=DEFAULT_S_BUCKETS)
        self._h_chunk_k = m.histogram("serving.chunk_k",
                                      buckets=(1, 2, 4, 8, 16, 32, 64))
        self._h_chunk_ms = m.histogram("serving.decode_chunk_ms",
                                       "dispatch+readback wall per chunk")
        self._h_stall = m.histogram("serving.decode_stall_ms")
        self._c_spec_acc = m.counter(
            "serving.spec_tokens_accepted", "draft tokens accepted by "
            "speculative verification")
        self._c_spec_rej = m.counter(
            "serving.spec_tokens_rejected", "draft tokens rejected by "
            "speculative verification")
        self._h_spec_accept = m.histogram(
            "serving.spec_accept_rate", "per-slot accepted/drafted ratio per "
            "spec step (steps that proposed at least one draft)",
            buckets=(0.01, 0.125, 0.25, 0.5, 0.75, 0.9, 1.0))
        self._h_spec_draft = m.histogram(
            "serving.spec_draft_len", "draft tokens proposed per slot per "
            "spec step", buckets=(1, 2, 4, 8, 16))
        self._h_tps = m.histogram(
            "serving.tokens_per_sec",
            buckets=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                     10000, 50000))
        self._g_queue = m.gauge("serving.queue_depth")
        self._g_occ = m.gauge("serving.slot_occupancy")
        cache = self.decoder.cache
        self._kv_bytes_per_pos = cache.bytes_per_position
        self._kv_block_overhead = cache.block_overhead_bytes
        m.gauge("serving.kv_cache_bytes").set(cache.bytes())
        self._g_kv_res = m.gauge("serving.kv_bytes_resident")
        self._g_kv_waste = m.gauge("serving.kv_bytes_waste")
        self._g_blocks_free = m.gauge("serving.kv_blocks_free")
        self._g_blocks_shared = m.gauge("serving.kv_blocks_shared")
        self._g_blocks_free.set(cache.blocks_free)
        self._init_lifecycle(kv_evict, kv_swap_bytes, kv_evict_mode, kv_disk,
                             kv_disk_bytes, kv_swap_async, prefix_store,
                             radix_ttl)

    def _init_lifecycle(self, kv_evict, kv_swap_bytes, kv_evict_mode,
                        kv_disk, kv_disk_bytes, kv_swap_async, prefix_store,
                        radix_ttl) -> None:
        """The KV lifecycle manager, the prefix store, the radix TTL and
        their counters."""
        cache = self.decoder.cache
        m = self.metrics
        # recompute cost unit of the victim planner: ~2 * params FLOPs per
        # token (shape metadata, no device read)
        n_params = sum(int(t.numel()) for p in self.decoder.params
                       for t in p.values())
        self.lifecycle = resolve_lifecycle(kv_evict, kv_swap_bytes,
                                           kv_evict_mode,
                                           flops_per_token=2.0 * n_params,
                                           kv_disk=kv_disk,
                                           kv_disk_bytes=kv_disk_bytes)
        if kv_swap_async is None:
            kv_swap_async = os.environ.get(
                "DL4J_TPU_KV_SWAP_ASYNC", "1") not in ("", "0")
        self.kv_swap_async = bool(kv_swap_async)
        # swap-preempted victims awaiting their chunk-boundary harvest: in
        # neither _queue nor _by_slot
        self._pending_swaps: List[dict] = []
        self.prefix_store = resolve_prefix_store(prefix_store)
        if self.prefix_store is not None:
            expect = (cache.n_layers, cache.block_size, cache.n_kv_heads,
                      cache.head_dim)
            expect_dt = dtype_name(cache.state.k.dtype)
            store = self.prefix_store
            if store.block_shape is None:
                store.block_shape = expect
            if store.block_dtype is None:
                store.block_dtype = expect_dt
            if store.block_shape != expect or store.block_dtype != expect_dt:
                # a spill of another geometry or payload dtype: ignore it
                # rather than restore garbage bytes
                self.prefix_store = None
        if (self.prefix_store is not None and cache.prefix_radix
                and self.prefix_store.evict_policy is None):
            # one tree-wide LRU governs device-pool reclaim and store
            # eviction
            self.prefix_store.evict_policy = cache.registry.store_victim
        if self.prefix_store is not None and self.prefix_store.disk is None:
            # the store's byte-cap victims spill into the same disk tier
            # the lifecycle manager demotes into
            if self.lifecycle is not None \
                    and self.lifecycle.disk_pool is not None:
                self.prefix_store.disk = self.lifecycle.disk_pool
            elif self.lifecycle is None:
                self.prefix_store.disk = resolve_disk_pool(kv_disk,
                                                           kv_disk_bytes)
        self._radix_ttl = resolve_radix_ttl(radix_ttl)
        self._c_evict_rec = m.counter(
            "serving.kv.evictions_recompute", "preemptions resumed by "
            "re-prefilling prompt + history")
        self._c_evict_swap = m.counter(
            "serving.kv.evictions_swap", "preemptions resumed from block "
            "bytes swapped to the host pool")
        self._c_preempt = m.counter("serving.kv.preemptions")
        self._c_swap_out = m.counter("serving.kv.swap_out_bytes")
        self._c_swap_in = m.counter("serving.kv.swap_in_bytes")
        self._g_host_pool = m.gauge("serving.kv.host_pool_bytes")
        self._c_pstore_hits = m.counter("serving.prefix_store_hits")
        self._c_pstore_tokens = m.counter("serving.prefix_store_tokens")
        self._c_ttl_expired = m.counter("serving.kv.ttl_expired_blocks")
        self._g_disk_pool = m.gauge("serving.kv.disk_pool_bytes")
        self._c_disk_demote = m.counter("serving.kv.disk_demotions")
        self._c_disk_promote = m.counter("serving.kv.disk_promotions")
        self._c_swap_harvest = m.counter("serving.kv.swap_async_harvests")
        self._c_swap_lost = m.counter(
            "serving.kv.swap_lost", "swap victims whose payload vanished "
            "and resumed by recompute")
        self._g_swap_gbps = m.gauge(
            "serving.kv.measured_swap_gbps", "device<->host swap bandwidth "
            "in GB/s (init round trip, then the swap-in/harvest average)")
        self._h_preempt_ms = m.histogram(
            "serving.kv.preempt_stall_ms", "host wall of one preemption "
            "(dispatch + bookkeeping, plus the readback when synchronous)")
        if self.lifecycle is not None:
            # one tiny gather round trip calibrates the swap bandwidth of
            # the cost verdicts (an init-time wait, not counted)
            t_cal = time.perf_counter()
            cal = _kvc.gather_blocks_host(cache.state, [0])
            cal_bytes = sum(_kvc.host_value(x).nbytes for x in cal[:2])
            self.lifecycle.calibrate(cal_bytes, time.perf_counter() - t_cal)
            self._g_swap_gbps.set(self.lifecycle.calibrated_gbps)

    # ------------------------------------------------------------ helpers
    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a blocking copy."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    @property
    def host_syncs(self) -> int:
        return self._c_syncs.value

    @host_syncs.setter
    def host_syncs(self, v: int) -> None:
        self._c_syncs.reset(int(v))

    @property
    def tokens_out(self) -> int:
        return self._c_tokens.value

    @tokens_out.setter
    def tokens_out(self, v: int) -> None:
        self._c_tokens.reset(int(v))

    def stats(self) -> Dict[str, float]:
        """One consistent snapshot (under the scheduler lock) of the
        engine counters and the live queue/slot state."""
        with self._lock:
            syncs, toks = self._c_syncs.value, self._c_tokens.value
            cache = self.decoder.cache
            snap = cache.pool_snapshot(include_blocks=False)
            lc = self.lifecycle
            return {"host_syncs": syncs, "tokens_out": toks,
                    "host_syncs_per_token": syncs / max(1, toks),
                    "decode_chunk": self.decode_chunk,
                    "prefill_chunk": self.prefill_chunk,
                    "prefill_chunks": self._c_pf_chunks.value,
                    "nonfinite_chunks": self._c_nonfinite.value,
                    "jit_compiles": self._c_compiles.value,
                    "queue_depth": len(self._queue),
                    "free_slots": snap["slots_free"],
                    "active_slots": len(self._by_slot),
                    "kv_blocks_free": snap["blocks_free"],
                    "kv_blocks_shared": snap["blocks_shared"],
                    "kv_blocks_cached": snap["blocks_cached"],
                    "kv_clock": snap["clock"],
                    "kv_bytes_waste": self._g_kv_waste.value,
                    "prefix_radix": int(cache.prefix_radix),
                    "prefix_hits": self._c_prefix_hits.value,
                    "prefix_shared_tokens": self._c_prefix_tokens.value,
                    "prefix_lineage_hits": self._c_lineage_hits.value,
                    "admission_retries": self._c_adm_retries.value,
                    "resident_seqs_max": self._resident_seqs_max,
                    "spec_decode": int(self.spec_decode),
                    "spec_draft": self.spec_draft,
                    "spec_tokens_accepted": self._c_spec_acc.value,
                    "spec_tokens_rejected": self._c_spec_rej.value,
                    "spec_accept_rate": self._c_spec_acc.value / max(
                        1, self._c_spec_acc.value + self._c_spec_rej.value),
                    "kv_evictions_recompute": self._c_evict_rec.value,
                    "kv_evictions_swap": self._c_evict_swap.value,
                    "kv_preemptions": self._c_preempt.value,
                    "kv_swap_out_bytes": self._c_swap_out.value,
                    "kv_swap_in_bytes": self._c_swap_in.value,
                    "kv_host_pool_bytes": (lc.host_pool.bytes_used
                                           if lc is not None else 0),
                    "kv_disk_pool_bytes": (
                        lc.disk_pool.bytes_used if lc is not None
                        and lc.disk_pool is not None else 0),
                    "kv_disk_demotions": self._c_disk_demote.value,
                    "kv_disk_promotions": self._c_disk_promote.value,
                    "kv_swap_harvests": self._c_swap_harvest.value,
                    "kv_pending_swaps": len(self._pending_swaps),
                    "kv_swap_lost": self._c_swap_lost.value,
                    "kv_measured_swap_gbps": self._g_swap_gbps.value,
                    "kv_ttl_expired_blocks": self._c_ttl_expired.value,
                    "prefix_store_hits": self._c_pstore_hits.value,
                    "prefix_store_tokens": self._c_pstore_tokens.value}

    def kv_pool_snapshot(self, include_blocks: bool = True
                         ) -> Dict[str, object]:
        """Pool snapshot (under the scheduler lock) with each slot's live
        positions filled in, ready for kv_observatory.attribute_pool."""
        with self._lock:
            return self.decoder.cache.pool_snapshot(
                live_positions=self._live_kv_positions(),
                include_blocks=include_blocks)

    # ------------------------------------------------------------- submit
    def submit(self, request) -> _Future:
        """Queue a request; returns a future resolving to GenerationResult."""
        req = request if isinstance(request, Request) else Request(request)
        plen = len(req.tokens)
        if plen < 1 or plen >= self.decoder.cache.max_len:
            raise ValueError(f"prompt length {plen} outside [1, max_len)")
        if not 1 <= req.max_new_tokens <= self._cap:
            raise ValueError(f"max_new_tokens {req.max_new_tokens} outside "
                             f"[1, {self._cap}] (max_new_tokens_cap)")
        if plen + req.max_new_tokens > self.decoder.cache.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds cache max_len {self.decoder.cache.max_len}")
        fut = _Future()
        deadline = None if req.timeout_s is None else \
            time.monotonic() + req.timeout_s
        with self._work:
            if self._stop.is_set():
                raise RuntimeError("engine is shut down")
            self._next_req_id += 1
            self._queue.append(_Active(req, fut, -1, 0, deadline,
                                       t_submit=time.monotonic(),
                                       req_id=self._next_req_id))
            self._work.notify()
        return fut

    # ---------------------------------------------------------- iteration
    def _admit(self) -> None:
        """Move queued requests into cache slots (prefill + first token).
        The head request is peeked until its block plan succeeds, keeping
        FIFO order when blocks run short; a failed plan consults the
        policy, which may preempt residents (at most one round per request
        and call: victims requeue at the back, so the head holds its
        reservation and the loop ends). Lock held."""
        cache = self.decoder.cache
        evicted_for: set = set()
        while self._queue:
            act = self._queue[0]
            if act.deadline is not None and time.monotonic() > act.deadline:
                self._shed(self._queue.pop(0))
                continue
            req = act.req
            plen = len(req.tokens)
            # the prompt, or prompt + history[:-1] when resuming
            pseq = self._admission_sequence(act)
            plen_eff = len(pseq)
            t_adm0 = time.monotonic()
            plan = cache.admit(act, n_positions=plen + req.max_new_tokens,
                               prompt=pseq)
            if plan is None:           # no slot / not enough blocks: wait
                act.retries += 1
                self._c_adm_retries.inc()
                if act.retries == 1:
                    bs = cache.block_size
                    needed = -(-(plen + req.max_new_tokens) // bs)
                    act.kv_rejection = {
                        "phase": "kv_rejection", "t0": t_adm0, "t1": t_adm0,
                        "blocks_needed": needed,
                        "blocks_free": cache.blocks_free,
                        "shortfall": max(0, needed - cache.blocks_free)}
                if act.req_id not in evicted_for:
                    decision = self.policy.admit(
                        req, self._admission_view(act, t_adm0))
                    if decision.kind == "preempt" \
                            and self._execute_evictions(decision.victims):
                        evicted_for.add(act.req_id)
                        continue
                    if decision.hint and act.kv_rejection is not None:
                        act.kv_rejection.setdefault(
                            "hint_reclaimable_bytes",
                            decision.hint.get("reclaimable_bytes", 0))
                        act.kv_rejection["hint_retry_after_s"] = \
                            decision.hint.get("retry_after_s", 0.0)
                break
            self._queue.pop(0)
            slot = plan.slot
            act.slot = slot
            if act.resume is None:
                self._h_queue_wait.observe(t_adm0 - act.t_submit)
            act.t_admit = t_adm0
            t_q0 = act.resume["t_requeue"] if act.resume is not None \
                else act.t_submit
            act.timeline.append({"phase": "queue", "t0": t_q0,
                                 "t1": t_adm0, "retries": act.retries})
            if act.kv_rejection is not None:
                act.timeline.append(act.kv_rejection)
                act.kv_rejection = None
            shared = plan.shared_len
            act.prefilled = act.shared_len = shared
            if shared:
                self._c_prefix_hits.inc()
                self._c_prefix_tokens.inc(shared)
            # _plens stays the ORIGINAL prompt length on resume: history
            # columns are lengths - plens
            self._plens[slot] = plen
            self._eos[slot] = -1 if req.eos_id is None else int(req.eos_id)
            self._maxgen[slot] = int(req.max_new_tokens)
            self._temps[slot] = req.temperature
            self._by_slot[slot] = act
            self._resident_seqs_max = max(self._resident_seqs_max,
                                          len(self._by_slot))
            self._c_admits.inc()
            if act.resume is not None and act.resume["mode"] == "swap" \
                    and not self.lifecycle.has_swap(act.req_id):
                # a lost spill resumes by recompute: compute, not tokens
                self._c_swap_lost.inc()
                act.resume["mode"] = "recompute"
            if act.resume is not None and act.resume["mode"] == "swap":
                self._resume_swap(act, plan, t_adm0)
                continue
            if self.prefix_store is not None and act.resume is None:
                shared = self._restore_from_store(act, plan, shared)
            if self.prefill_chunk and plen_eff - shared > self.prefill_chunk:
                # chunked prefill: hold the reservation, prefill one bounded
                # chunk per scheduler iteration (_prefill_step)
                act.timeline.append({"phase": "admission", "t0": t_adm0,
                                     "t1": time.monotonic(), "slot": slot,
                                     "blocks": plan.n_blocks,
                                     "shared": shared,
                                     "iter": self._iter_id})
                self._prefilling.append(act)
                self._update_kv_resident()
                continue
            toks = self._h2d(np.asarray(pseq, np.int32))
            if shared:
                skey = self.decoder.shared_buckets(plen_eff, shared)
                key, bucket = ("prefill_shared", skey), skey[0]
            else:
                bucket = self.decoder.prefill_bucket(plen_eff)
                key = ("prefill", bucket)
            miss = key not in self._seen_shapes
            if miss:
                self._seen_shapes.add(key)
                self._c_compiles.inc()
            had_active = bool(self._active_mask.any())
            t_pf = time.perf_counter()
            t_pf_mono = time.monotonic()
            act.timeline.append({"phase": "admission", "t0": t_adm0,
                                 "t1": t_pf_mono, "slot": slot,
                                 "blocks": plan.n_blocks, "shared": shared,
                                 "iter": self._iter_id})
            with torch.no_grad():
                if shared:
                    feats = self.embed(toks[shared:]).T
                    lp = self.decoder.prefill_shared(slot, feats, plen_eff,
                                                     shared)
                else:
                    lp = self.decoder.prefill(slot, self.embed(toks).T)
            if had_active:
                self._h_stall.observe((time.perf_counter() - t_pf) * 1e3)
            cache.touch_blocks(slot, shared, plen_eff)
            extras = {"plen": plen_eff, "bucket": bucket, "shared": shared,
                      "iter": self._iter_id}
            if miss:
                extras["compile"] = True
            self._finish_first_token(act, lp, t_pf_mono, extras)

    def _shed(self, act: _Active) -> None:
        """Resolve a request whose deadline passed while queued. A
        preempted one returns the tokens it had, and its parked swap bytes
        are forgotten on every tier. Lock held."""
        now = time.monotonic()
        toks_out = [int(t) for t in act.resume["tokens"]] \
            if act.resume is not None else []
        t_q0 = act.resume["t_requeue"] if act.resume is not None \
            else act.t_submit
        act.timeline.append({"phase": "queue", "t0": t_q0, "t1": now,
                             "retries": act.retries})
        if act.kv_rejection is not None:
            act.timeline.append(act.kv_rejection)
            act.kv_rejection = None
        act.timeline.append({"phase": "retire", "t0": now, "t1": now,
                             "reason": "timeout", "tokens": len(toks_out)})
        act.fut._set(GenerationResult(
            toks_out, "timeout", len(act.req.tokens), req_id=act.req_id,
            admission_retries=act.retries, timeline=act.timeline))
        self._c_retires.inc()
        self._c_timeouts.inc()
        if act.resume is not None and act.resume["mode"] == "swap" \
                and self.lifecycle is not None:
            self.lifecycle.drop(act.req_id)
            self._g_host_pool.set(self.lifecycle.host_pool.bytes_used)

    def _finish_first_token(self, act: _Active, lp, t_pf_mono: float,
                            extras: dict) -> None:
        """Prefill completed: register the resident sequence for sharing
        (and the prefix store), then sample the first token and activate
        the slot, holding the one counted admission readback. A recompute
        resume instead restores its decode state and samples nothing.
        Lock held."""
        req, slot = act.req, act.slot
        seq = self._admission_sequence(act)
        hits = self.decoder.cache.register_prefix(slot, seq)
        if hits:
            self._c_lineage_hits.inc(hits)
        self._offer_prefix_store(act, seq)
        if act.resume is not None:
            self._finish_resume(act, t_pf_mono, extras)
            return
        temp = torch.full((1,), float(req.temperature), device=self.device)
        t0 = self.sampler.sample(lp[None], temp, self.sampler.next_key(),
                                 any_sampled=req.temperature > 0)[0]
        act.n_generated = 1
        act.prefilled = len(req.tokens)
        if self.capture_logprobs:
            act.logprobs = [_host_rows(lp)]
        self._hist[slot, 0] = t0
        self._last[slot] = t0
        self._active_mask[slot] = True
        if self._dev_active is not None:
            self._dev_active[slot] = True
        first = int(t0)            # admission readback (scheduling event)
        self._c_syncs.inc()
        self._c_tokens.inc()
        if self._spec_index is not None:
            # seed the draft index from host values: prompt + first token
            self._spec_index.reset(slot, req.tokens)
            self._spec_index.extend(slot, [first])
        act.t_first = time.monotonic()
        act.timeline.append({"phase": "prefill", "t0": t_pf_mono,
                             "t1": act.t_first, **extras})
        self._update_kv_resident()
        self._h_ttft.observe(act.t_first - act.t_submit)
        if req.max_new_tokens == 1 or (req.eos_id is not None
                                       and first == req.eos_id):
            self._active_mask[slot] = False
            if self._dev_active is not None:
                self._dev_active[slot] = False
            self._retire(slot, "shutdown")  # reason fixed inside

    def _prefill_step(self) -> None:
        """Run AT MOST ONE prefill chunk per scheduler iteration for the
        head of the partially-prefilled FIFO; the final chunk samples the
        first token. The chunk's timeline event tiles from the request's
        previous event. Lock held."""
        if not self._prefilling:
            return
        act = self._prefilling[0]
        slot = act.slot
        seq = self._admission_sequence(act)
        plen = len(seq)
        start = act.prefilled
        end = min(plen, start + self.prefill_chunk)
        skey = self.decoder.shared_buckets(end, start)
        miss = ("prefill_shared", skey) not in self._seen_shapes
        if miss:
            self._seen_shapes.add(("prefill_shared", skey))
            self._c_compiles.inc()
        had_active = bool(self._active_mask.any())
        t0_mono = act.timeline[-1]["t1"]
        t_pf = time.perf_counter()
        toks = self._h2d(np.asarray(seq[start:end], np.int32))
        with torch.no_grad():
            lp = self.decoder.prefill_chunk(slot, self.embed(toks).T, start,
                                            end)
        wall_ms = (time.perf_counter() - t_pf) * 1e3
        if had_active:
            self._h_stall.observe(wall_ms)
        now = time.monotonic()
        ev = {"phase": "prefill_chunk", "t0": t0_mono, "t1": now,
              "chunk": act.n_chunks, "tokens": end - start,
              "shared": act.shared_len if act.n_chunks == 0 else 0,
              "iter": self._iter_id, "wall_s": wall_ms / 1e3}
        if miss:
            ev["compile"] = True
        act.timeline.append(ev)
        act.n_chunks += 1
        act.prefilled = end
        self.decoder.cache.touch_blocks(slot, start, end)
        self._c_pf_chunks.inc()
        if end >= plen:
            self._prefilling.pop(0)
            self._finish_first_token(
                act, lp, now, {"plen": plen, "chunks": act.n_chunks,
                               "shared": act.shared_len, "bucket": skey[0],
                               "iter": self._iter_id})
        self._update_kv_resident()

    def _retire(self, slot: int, default_reason: str, hist=None) -> None:
        """Resolve the request in `slot` and free it. `hist` is the host
        copy of the history from the chunk that finished the slot; without
        it the row is read from the device. Lock held."""
        act = self._by_slot.pop(slot)
        if act in self._prefilling:
            self._prefilling.remove(act)
        if self._spec_index is not None:
            self._spec_index.drop(slot)
        t_ret0 = time.monotonic()
        n = act.n_generated
        if hist is not None:
            row = [int(t) for t in hist[slot, :n]]
        else:
            row = self._hist[slot, :n].tolist()   # retirement readback
        req = act.req
        if req.eos_id is not None and n and row[-1] == req.eos_id:
            reason = "eos"
        elif n >= req.max_new_tokens:
            reason = "length"
        else:
            reason = default_reason
        lps = act.logprobs[:n] if act.logprobs is not None else None
        self.decoder.cache.free(slot)
        now = time.monotonic()
        ttft = act.t_first - act.t_submit if act.t_first else None
        span = now - act.t_first if act.t_first else 0.0
        total = now - act.t_submit if act.t_submit else 0.0
        if n > 1 and span > 0:
            tps = (n - 1) / span
        elif n >= 1 and total > 0:
            tps = n / total
        else:
            tps = None
        act.timeline.append({"phase": "retire", "t0": t_ret0, "t1": now,
                             "reason": reason, "tokens": n})
        qw = act.t_admit - act.t_submit if act.t_admit else None
        act.fut._set(GenerationResult(
            row, reason, len(req.tokens), lps, ttft_s=ttft,
            tokens_per_sec=tps, req_id=act.req_id, queue_wait_s=qw,
            admission_retries=act.retries, timeline=act.timeline,
            shared_prefix_tokens=act.shared_len))
        self._c_retires.inc()
        if tps is not None:
            self._h_tps.observe(tps)
        self._update_kv_resident()

    def _live_kv_positions(self) -> Dict[int, int]:
        """Per-slot KV positions actually written (prefilled +
        n_generated - 1 once decode starts: the last sampled token's KV
        lands next iteration). Host bookkeeping only."""
        return {a.slot: a.prefilled + max(0, a.n_generated - 1)
                for a in self._by_slot.values()}

    def _update_kv_resident(self) -> None:
        """Publish resident / wasted KV bytes and block gauges from host
        bookkeeping. Lock held."""
        snap = self.decoder.cache.pool_snapshot(include_blocks=False)
        pos = sum(a.prefilled + a.n_generated for a in self._by_slot.values())
        self._g_kv_res.set(pos * self._kv_bytes_per_pos)
        reserved = sum(info["reserved_positions"]
                       for info in snap["slots"].values())
        self._g_kv_waste.set(max(0, reserved - pos) * self._kv_bytes_per_pos)
        self._g_blocks_free.set(snap["blocks_free"])
        self._g_blocks_shared.set(snap["blocks_shared"])

    def _expire_timeouts(self) -> None:
        now = time.monotonic()
        for slot, act in list(self._by_slot.items()):
            if act.deadline is not None and now > act.deadline:
                self._active_mask[slot] = False
                if self._dev_active is not None:
                    self._dev_active[slot] = False
                self._c_timeouts.inc()
                self._retire(slot, "timeout")

    def _chunk_size(self) -> int:
        """Adaptive K: 1 while requests queue or a prefill is mid-chunking,
        else decode_chunk capped at the largest remaining token budget,
        rounded down to a power of two."""
        if self._queue or self._prefilling or self.decode_chunk <= 1:
            return 1
        rems = [act.req.max_new_tokens - act.n_generated
                for slot, act in self._by_slot.items()
                if self._active_mask[slot]]
        if not rems:
            return 1
        k = min(self.decode_chunk, max(1, max(rems)))
        if k < self.decode_chunk:
            k = 1 << (k.bit_length() - 1)
        return k

    # ------------------------------------------------------- KV lifecycle
    def _admission_sequence(self, act: _Active) -> List[int]:
        """The sequence admission and prefill run over: the prompt, or,
        resuming a preempted request, prompt + every generated token but
        the last (whose KV its own next decode step writes), so lengths
        land where the never-preempted run had them."""
        if act.resume is None:
            return list(act.req.tokens)
        return list(act.req.tokens) + \
            [int(t) for t in act.resume["tokens"][:-1]]

    def _admission_view(self, act: _Active, t_adm0: float) -> dict:
        """Pool-pressure view for the policy's `admit` decision point: the
        head-of-queue block shortfall, the preemptable DECODE-ACTIVE slots,
        the admittee's queue age and the bytes a reclaim could free. The
        pool snapshot is taken only when the policy plans victims."""
        cache = self.decoder.cache
        bs = cache.block_size
        need = -(-(len(act.req.tokens) + act.req.max_new_tokens) // bs)
        shortfall = need - cache.blocks_free
        if cache.n_free == 0:
            shortfall = max(shortfall, 1)   # any one victim frees a slot
        eligible = {s for s, a in self._by_slot.items()
                    if self._active_mask[s] and a.n_generated >= 1}
        return {"lifecycle": self.lifecycle, "shortfall": shortfall,
                "eligible": eligible, "req_id": act.req_id, "replica": None,
                "now": t_adm0,
                "t_submit": act.resume["t_requeue"]
                if act.resume is not None else act.t_submit,
                "reclaimable_bytes": (cache.num_blocks - cache.blocks_free)
                * cache.block_bytes,
                "burn_rate_short": None,
                "snapshot_fn": lambda: cache.pool_snapshot(
                    live_positions=self._live_kv_positions())}

    def _execute_evictions(self, plan: dict) -> bool:
        """Preempt the victims of a policy plan; True when at least one
        was preempted (the caller retries the admission). Lock held."""
        cache = self.decoder.cache
        preempted = False
        for victim in plan["evicted"]:
            slot = victim["slot"]
            a = self._by_slot.get(slot)
            if a is None or not self._active_mask[slot]:
                continue
            nbytes = victim["blocks_total"] * cache.block_bytes
            mode = self.lifecycle.choose_mode(victim, nbytes)
            self._preempt(slot, mode, victim)
            preempted = True
        return preempted

    def _preempt(self, slot: int, mode: str, victim: dict) -> None:
        """Preempt the request in `slot`: deactivate it, stash its
        generated history (and, for swap, its block bytes), free the
        reservation, requeue it at the back. Lock held.

        Swap: the blocks are gathered on the current (decode) stream
        before `free` returns them to the free list, so any later write
        into them is ordered after the gather; their device->host copy
        runs on a side stream behind an event. The history row: a
        synchronous preempt reads it now (the counted sync); an
        asynchronous one copies it into pinned memory without blocking,
        ordered before a new occupant of the slot writes the row in this
        same admission pass, and `_harvest_swaps` reads it at the next
        chunk boundary. Results of a chunk in flight for this slot are
        discarded by _finish_steps' identity check."""
        t_p0 = time.perf_counter()
        cache = self.decoder.cache
        act = self._by_slot.pop(slot)
        self._active_mask[slot] = False
        if self._dev_active is not None:
            self._dev_active[slot] = False
        if self._spec_index is not None:
            self._spec_index.drop(slot)
        n = act.n_generated
        t_prev = act.timeline[-1]["t1"] if act.timeline else act.t_submit
        nbytes = victim["blocks_total"] * cache.block_bytes
        async_swap = mode == "swap" and self.kv_swap_async
        if mode == "swap":
            payload = _kvc.gather_blocks_host(
                cache.state, list(cache._slot_blocks[slot]),
                with_scales=_kvc.is_quantized(cache.state))
            scales = payload[2:] if len(payload) == 4 else (None, None)
            self.lifecycle.swap_out(act.req_id, payload[0], payload[1],
                                    nbytes, k_scale=scales[0],
                                    v_scale=scales[1])
            self._c_evict_swap.inc()
            self._c_swap_out.inc(nbytes)
        else:
            self.lifecycle.evictions_recompute += 1
            self._c_evict_rec.inc()
        if async_swap:
            gen = None
            hist_rb = _kvc.HostCopy({"row": self._hist[slot, :n]})
        else:
            gen = self._hist[slot, :n].tolist()  # preemption readback
            self._c_syncs.inc()
        self._c_preempt.inc()
        self._g_host_pool.set(self.lifecycle.host_pool.bytes_used)
        cache.free(slot)
        now = time.monotonic()
        act.n_generated = 0
        act.prefilled = 0
        act.shared_len = 0
        act.preemptions += 1
        act.timeline.append({"phase": "preempt", "t0": t_prev, "t1": now,
                             "mode": mode, "score": victim.get("score"),
                             "blocks_freed": victim.get("blocks_freed"),
                             "bytes": nbytes,
                             "policy": self.lifecycle.policy})
        if async_swap:
            self._pending_swaps.append({
                "act": act, "slot": slot, "hist": hist_rb, "n": n,
                "nbytes": nbytes, "t0": now})
        else:
            if mode == "swap":
                # a synchronous swap pays the demotion inside the stall
                now = self._rebalance_disk(act, now)
            act.resume = {"mode": mode, "tokens": gen, "t_requeue": now,
                          "nbytes": nbytes}
            self._queue.append(act)
        self._update_kv_resident()
        self._h_preempt_ms.observe((time.perf_counter() - t_p0) * 1e3)

    def _rebalance_disk(self, act: Optional[_Active], t0: float) -> float:
        """Demote cold host-pool entries to the disk tier until the pool
        is under its cap (no-op without a disk tier); one counted sync
        when anything was demoted. Appends a "disk_demote" span tiling
        [t0, end] to `act` and returns the end. Lock held."""
        if self.lifecycle is None or self.lifecycle.disk_pool is None:
            return t0
        res = self.lifecycle.rebalance()
        if not res["demotions"]:
            return t0
        self._c_syncs.inc()
        self._c_disk_demote.inc(res["demotions"])
        self._g_disk_pool.set(self.lifecycle.disk_pool.bytes_used)
        self._g_host_pool.set(self.lifecycle.host_pool.bytes_used)
        t1 = time.monotonic()
        if act is not None:
            act.timeline.append({"phase": "disk_demote", "t0": t0,
                                 "t1": t1, "demotions": res["demotions"],
                                 "bytes": res["bytes"]})
        return t1

    def _harvest_swaps(self) -> None:
        """Chunk-boundary harvest of asynchronous swap-outs: read each
        parked victim's history row and wait for its payload copy (one
        counted sync each), rebalance into the disk tier, requeue at the
        back. The "swap_pending" then "swap_out_async" spans tile the
        wait. Lock held."""
        if not self._pending_swaps:
            return
        pendings, self._pending_swaps = self._pending_swaps, []
        for rec in pendings:
            act = rec["act"]
            t_h0 = time.monotonic()
            gen = [int(t) for t in rec["hist"].numpy()["row"]]
            self.lifecycle.harvest(act.req_id)
            self._c_syncs.inc()
            self._c_swap_harvest.inc()
            t_h1 = time.monotonic()
            act.timeline.append({"phase": "swap_pending", "t0": rec["t0"],
                                 "t1": t_h0})
            act.timeline.append({"phase": "swap_out_async", "t0": t_h0,
                                 "t1": t_h1, "bytes": rec["nbytes"],
                                 "tokens": len(gen)})
            t_req = self._rebalance_disk(act, t_h1)
            act.resume = {"mode": "swap", "tokens": gen,
                          "t_requeue": t_req, "nbytes": rec["nbytes"]}
            self._queue.append(act)
        self._g_host_pool.set(self.lifecycle.host_pool.bytes_used)
        gbps = self.lifecycle.measured_swap_gbps()
        if gbps:
            self._g_swap_gbps.set(gbps)

    def _resume_swap(self, act: _Active, plan, t_adm0: float) -> None:
        """Reactivate a swap victim with NO prefill: the new reservation's
        private blocks below the live length get their bytes back from
        whichever tier holds them (one counted sync), lengths jump to the
        preemption point and decode continues on the same bytes. Blocks
        mapped shared (refcount >= 2) already hold this prefix. Lock
        held."""
        cache = self.decoder.cache
        req, slot = act.req, act.slot
        plen = len(req.tokens)
        gen = [int(t) for t in act.resume["tokens"]]
        n = len(gen)
        live = plen + n - 1
        nbytes = act.resume["nbytes"]
        k_host, v_host, scales, sw_info = self.lifecycle.swap_in(
            act.req_id, nbytes)
        self._c_syncs.inc()
        self._c_swap_in.inc(nbytes)
        self._g_host_pool.set(self.lifecycle.host_pool.bytes_used)
        if sw_info["tier"] == "disk":
            self._c_disk_promote.inc()
            self._g_disk_pool.set(self.lifecycle.disk_pool.bytes_used)
        gbps = self.lifecycle.measured_swap_gbps()
        if gbps:
            self._g_swap_gbps.set(gbps)
        row = cache._slot_blocks[slot]
        bs = cache.block_size
        lis = [li for li in range(min(len(row), k_host.shape[1]))
               if li * bs < live and cache.allocator.refcount(row[li]) == 1]
        if lis:
            # a run of blocks is a view of the payload, not a copy
            sel = slice(lis[0], lis[-1] + 1) \
                if lis == list(range(lis[0], lis[-1] + 1)) else lis
            skw = {} if scales is None else {
                "k_scale": scales[0][:, sel], "v_scale": scales[1][:, sel]}
            _kvc.restore_blocks(cache.state, [row[li] for li in lis],
                                k_host[:, sel], v_host[:, sel], **skw)
        _kvc.set_length(cache.state, slot, live)
        cache.touch_blocks(slot, 0, live)
        hits = cache.register_prefix(slot, self._admission_sequence(act))
        if hits:
            self._c_lineage_hits.inc(hits)
        act.resume = None
        act.n_generated = n
        act.prefilled = plen
        self._restore_decode_state(act, gen)
        now = time.monotonic()
        t_mid = t_adm0
        if sw_info["tier"] == "disk":
            t_mid = min(now, t_adm0 + sw_info["disk_wall_s"])
            act.timeline.append({"phase": "disk_promote", "t0": t_adm0,
                                 "t1": t_mid, "bytes": nbytes})
        act.timeline.append({"phase": "swap_in", "t0": t_mid, "t1": now,
                             "blocks": len(lis), "bytes": nbytes,
                             "resumed_tokens": n, "tier": sw_info["tier"]})
        self._update_kv_resident()

    def _restore_decode_state(self, act: _Active, gen: List[int]) -> None:
        """History row, last token, active mask and draft index of a
        resumed request (host values to the device, no sync)."""
        slot = act.slot
        self._hist[slot, :len(gen)] = self._h2d(np.asarray(gen, np.int32))
        self._last[slot] = int(gen[-1])
        self._active_mask[slot] = True
        if self._dev_active is not None:
            self._dev_active[slot] = True
        if self._spec_index is not None:
            self._spec_index.reset(slot, act.req.tokens)
            self._spec_index.extend(slot, gen)

    def _finish_resume(self, act: _Active, t_pf_mono: float,
                       extras: dict) -> None:
        """Recompute-resume epilogue: the re-prefill over prompt + history
        completed with lengths at the preemption point; restore the decode
        state. The prefill's last logprob row predicts the already known
        last token and is discarded: no key, no counted sync. Lock
        held."""
        req, slot = act.req, act.slot
        gen = [int(t) for t in act.resume["tokens"]]
        n = len(gen)
        act.resume = None
        act.n_generated = n
        act.prefilled = len(req.tokens)
        self._restore_decode_state(act, gen)
        act.timeline.append({"phase": "prefill", "t0": t_pf_mono,
                             "t1": time.monotonic(), "resume": True,
                             "resumed_tokens": n, **extras})
        self._update_kv_resident()
        if n >= req.max_new_tokens or (req.eos_id is not None
                                       and gen[-1] == req.eos_id):
            self._active_mask[slot] = False
            if self._dev_active is not None:
                self._dev_active[slot] = False
            self._retire(slot, "length")

    def _policy_evict(self) -> None:
        """Background-eviction decision point, once per scheduler
        iteration: the radix TTL drain. Free when no TTL is armed. Lock
        held."""
        if self._radix_ttl is None:
            return
        reg = self.decoder.cache.registry
        if not getattr(reg, "is_radix", False):
            return
        freed = self.policy.evict({"registry": reg, "ttl": self._radix_ttl})
        if freed:
            self._c_ttl_expired.inc(freed)

    def _restore_from_store(self, act: _Active, plan, shared: int) -> int:
        """Extend the resident shared coverage with blocks restored from
        the persistent prefix store into this admission's FRESH private
        blocks (full blocks past the registry match, no COW admission).
        One counted sync. Returns the new shared length. Lock held."""
        cache = self.decoder.cache
        bs = cache.block_size
        pseq = self._admission_sequence(act)
        if plan.cow or shared % bs or len(pseq) <= bs:
            return shared
        digs = chain_digests(pseq, bs)
        k_cov = self.prefix_store.covered(digs)
        k_cov = min(k_cov, (len(pseq) - 1) // bs)  # prefill needs a suffix
        n_sh = shared // bs
        if k_cov <= n_sh:
            return shared
        lis = list(range(n_sh, k_cov))
        row = cache._slot_blocks[act.slot]
        if any(cache.allocator.refcount(row[li]) != 1 for li in lis):
            return shared
        quantized = _kvc.is_quantized(cache.state)
        if quantized and self.prefix_store.fetch_scales(
                [digs[i] for i in lis]) is None:
            # a scale-less entry cannot be restored into an int8 pool
            return shared
        k_host, v_host = self.prefix_store.fetch([digs[i] for i in lis])
        sc = self.prefix_store.fetch_scales([digs[i] for i in lis]) \
            if quantized else None
        self._c_syncs.inc()
        skw = {} if sc is None else {"k_scale": sc[0], "v_scale": sc[1]}
        _kvc.restore_blocks(cache.state, [row[li] for li in lis], k_host,
                            v_host, **skw)
        new_shared = k_cov * bs
        cache.touch_blocks(act.slot, shared, new_shared)
        act.prefilled = act.shared_len = new_shared
        self._c_pstore_hits.inc()
        self._c_pstore_tokens.inc(new_shared - shared)
        return new_shared

    def _offer_prefix_store(self, act: _Active, seq: List[int]) -> None:
        """File the just-prefilled sequence's full blocks in the prefix
        store under their chain digests: a gather and a device->host copy
        started without blocking (full prompt blocks are final once the
        prefill was dispatched). Lock held."""
        store = self.prefix_store
        cache = self.decoder.cache
        bs = cache.block_size
        if store is None or len(seq) < bs:
            return
        digs = chain_digests(seq, bs)
        missing = store.missing(digs)
        if not missing:
            return
        row = cache._slot_blocks[act.slot]
        payload = _kvc.gather_blocks_host(
            cache.state, [row[i] for i in missing],
            with_scales=_kvc.is_quantized(cache.state))
        nb = cache.block_bytes
        shape = (cache.n_layers, bs, cache.n_kv_heads, cache.head_dim)
        for j, i in enumerate(missing):
            skw = {} if len(payload) == 2 else {
                "k_scale": payload[2].block(j),
                "v_scale": payload[3].block(j)}
            store.put(digs[i], payload[0].block(j), payload[1].block(j), nb,
                      block_shape=shape, **skw)

    # ------------------------------------------------------------ decode
    @torch.no_grad()
    def _run_chunk(self, active: torch.Tensor, positions: List[int]):
        """K = len(positions) decode micro-steps as one host loop of device
        work with no host read inside. Micro-step i samples at chain
        position positions[i]. Returns (final active mask, (K, S) entry
        masks, (K, S, V) logprobs or None, nonfinite sentinel), all device
        tensors; history and last tokens update in place."""
        dec = self.decoder
        lengths = dec.cache.state.lengths
        temps = self._h2d(self._temps)
        any_sampled = bool((self._temps > 0).any())
        cap = self._cap
        entries, lps = [], []
        nf = torch.zeros((), dtype=torch.bool, device=self.device)
        for pos in positions:
            lp = dec._decode_fn(self.embed(self._last), active)
            toks = self.sampler.sample(lp, temps, pos, any_sampled)
            gen_idx = lengths - self._plens                 # post-advance
            gi = gen_idx.clamp(0, cap - 1).long()
            self._hist[self._slots, gi] = torch.where(
                active, toks, self._hist[self._slots, gi])
            self._last = torch.where(active, toks, self._last)
            new_active = active & (toks != self._eos) \
                & (gen_idx + 1 < self._maxgen)
            nf = nf | (active & ~torch.isfinite(lp).all(dim=-1)).any()
            entries.append(active)
            if self.capture_logprobs:
                lps.append(lp)
            active = new_active
        return (active, torch.stack(entries),
                torch.stack(lps) if lps else None, nf)

    def _dispatch(self, active: torch.Tensor, k_eff: int):
        """Count the chunk shape and run it; returns (final mask,
        readback bundle, logprobs, first-use flag)."""
        self._h_chunk_k.observe(k_eff)
        self._g_queue.set(len(self._queue))
        self._g_occ.set(len(self._by_slot))
        miss = ("chunk", k_eff) not in self._seen_shapes
        if miss:
            self._seen_shapes.add(("chunk", k_eff))
            self._c_compiles.inc()
        final, entries, lps, nf = self._run_chunk(
            active, self.sampler.peek_keys(k_eff))
        rb = _kvc.HostCopy({"entries": entries, "final": final, "nf": nf,
                        "hist": self._hist})
        return final, rb, lps, miss

    def _finish_steps(self, snapshot: Dict[int, _Active], entry_np, new_np,
                      lp_np, hist=None, span=None) -> None:
        """Host bookkeeping after a chunk's masks materialize: one token
        per micro-step each slot entered active; retire slots whose final
        mask dropped. `snapshot` is the slot -> request map at dispatch (an
        identity check keeps a stale mask off a slot's new occupant or a
        preempted request). `span` = {"t0", "k", "wall_s", "iter",
        "compile"} becomes each request's "decode_chunk" event, t1 stamped
        here. Lock held."""
        K = entry_np.shape[0]
        for slot, act in snapshot.items():
            if self._by_slot.get(slot) is not act \
                    or not self._active_mask[slot]:
                continue
            n_new = int(entry_np[:, slot].sum())
            act.n_generated += n_new
            # the chunk appended KV at the n_new positions ending at
            # prefilled + n_generated - 1
            p_end = act.prefilled + act.n_generated - 1
            self.decoder.cache.touch_blocks(slot, p_end - n_new, p_end)
            self._c_tokens.inc(n_new)
            if span is not None:
                ev = {"phase": "decode_chunk", "t0": span["t0"],
                      "t1": time.monotonic(), "k": span["k"],
                      "tokens": n_new, "iter": span["iter"],
                      "wall_s": span["wall_s"]}
                if span.get("compile"):
                    ev["compile"] = True
                act.timeline.append(ev)
            if lp_np is not None and act.logprobs is not None:
                act.logprobs.extend(lp_np[i, slot] for i in range(K)
                                    if entry_np[i, slot])
            if not new_np[slot]:
                self._active_mask[slot] = False
                self._retire(slot, "length", hist=hist)
        self._update_kv_resident()

    def _begin_iteration(self) -> float:
        """Iteration start: the timeline anchor, a fresh iteration id and
        one tick of the block heat clock. Lock held."""
        t_iter0 = time.monotonic()
        self._iter_id = next(_ITER_IDS)
        self.decoder.cache.allocator.tick()
        return t_iter0

    def step(self) -> bool:
        """One scheduler iteration: admit, at most one prefill chunk, ONE
        decode chunk (adaptive K, one counted sync), retire, then harvest
        any victim an admission parked. Returns True while any request is
        active, queued or parked."""
        with self._lock:
            t_iter0 = self._begin_iteration()
            self._policy_evict()
            self._admit()
            if not self._by_slot:
                # no chunk runs this iteration: this is the boundary
                self._harvest_swaps()
                return bool(self._queue)
            self._expire_timeouts()
            self._prefill_step()
            if not self._active_mask.any():
                self._harvest_swaps()
                return bool(self._by_slot or self._queue)
            snapshot = {s: a for s, a in self._by_slot.items()
                        if self._active_mask[s]}
            if self.spec_decode:
                more = self._spec_step(snapshot, t_iter0)
                self._harvest_swaps()
                return more or bool(self._queue)
            k_eff = self._chunk_size()
            t_chunk = time.perf_counter()
            _, rb, lps, miss = self._dispatch(self._h2d(self._active_mask),
                                              k_eff)
            got = rb.numpy()                 # the counted per-chunk sync
            if bool(got["nf"]):
                self._c_nonfinite.inc()
            self._c_syncs.inc()
            # commit exactly the micro-steps that ran with active work
            self.sampler.advance(int(got["entries"].any(axis=1).sum())
                                 if k_eff > 1 else 1)
            chunk_ms = (time.perf_counter() - t_chunk) * 1e3
            self._h_chunk_ms.observe(chunk_ms)
            lp_np = _host_rows(lps) if lps is not None else None
            self._finish_steps(snapshot, got["entries"], got["final"], lp_np,
                               hist=got["hist"],
                               span={"t0": t_iter0, "k": k_eff,
                                     "wall_s": chunk_ms / 1e3,
                                     "iter": self._iter_id,
                                     "compile": miss})
            # chunk boundary: the dispatch above retired, so parked
            # victims harvest without waiting on work in flight
            self._harvest_swaps()
            return bool(self._by_slot or self._queue)

    # ------------------------------------------------ speculative decoding
    @torch.no_grad()
    def _run_spec(self, active: torch.Tensor, positions: List[int],
                  draft: torch.Tensor, draft_len: torch.Tensor):
        """One speculative iteration of device work with no host read
        inside: verify [last, draft_0..draft_{Q-2}] at Q consecutive
        positions per slot, accept (row i samples at chain position
        positions[i]), then COMMIT the accepted prefix by setting `lengths`
        (the whole rollback: rejected rows' KV lies at positions >= the new
        length and stays invisible). draft (S, Q-1), draft_len (S,) real
        draft rows per slot (0 = a plain decode row). Returns (tokens,
        committed counts, accepted counts, final active mask, logprobs,
        nonfinite sentinel), all device tensors; history and last tokens
        update in place."""
        dec = self.decoder
        st = dec.cache.state
        temps = self._h2d(self._temps)
        any_sampled = bool((self._temps > 0).any())
        Q = draft.shape[1] + 1
        toks_in = torch.cat([self._last[:, None], draft], dim=1)  # (S, Q)
        x = torch.stack([self.embed(toks_in[:, i]) for i in range(Q)],
                        dim=1)                                    # (S,Q,n_in)
        pos = st.lengths.clone()                                  # pre-commit
        lp = dec._spec_decode_fn(x, active, draft_len)
        toks, n_accept, n_commit = spec_accept_tokens(
            self.sampler, positions, lp, draft, draft_len, temps,
            any_sampled)
        i = torch.arange(Q, dtype=torch.int32, device=self.device)[None, :]
        gen0 = pos - self._plens + 1      # generation index of row 0's token
        # EOS inside the accepted prefix truncates the commit to include it
        eos_hit = (i < n_commit[:, None]) & (toks == self._eos[:, None])
        first_eos = torch.argmax(eos_hit.to(torch.int32), dim=1)
        c_eff = torch.where(eos_hit.any(dim=1), first_eos.to(torch.int32) + 1,
                            n_commit)
        # never past max_new_tokens (the host caps drafts to the budget, so
        # this is a backstop); inactive slots commit nothing
        c_eff = torch.minimum(c_eff, torch.clamp(self._maxgen - gen0, min=1))
        c_eff = torch.where(active, c_eff, torch.zeros_like(c_eff))
        st.lengths.copy_(pos + c_eff)           # the only lengths move
        # history: committed offset j lands at column gen0 + j
        col = torch.arange(self._cap, dtype=torch.int32,
                           device=self.device)[None, :]
        j = col - gen0[:, None]                                   # (S, cap)
        sel = active[:, None] & (j >= 0) & (j < c_eff[:, None])
        vals = torch.gather(toks, 1, j.clamp(0, Q - 1).long())
        self._hist.copy_(torch.where(sel, vals, self._hist))
        last_c = torch.gather(toks, 1, (c_eff - 1).clamp(0, Q - 1)
                              .long()[:, None])[:, 0]
        self._last = torch.where(active, last_c, self._last)
        new_active = active & (last_c != self._eos) \
            & (gen0 + c_eff < self._maxgen)
        # nonfinite sentinel over the rows that fed the accept decision
        row_ok = i <= draft_len[:, None]
        nf = (active[:, None] & row_ok
              & ~torch.isfinite(lp).all(dim=-1)).any()
        return toks, c_eff, n_accept, new_active, lp, nf

    def _spec_step(self, snapshot: Dict[int, _Active],
                   t_iter0: float) -> bool:
        """One SPECULATIVE scheduler iteration, in place of the decode
        chunk: propose per-slot n-gram drafts on the host (the index only
        sees tokens already read back), verify them plus the bonus token in
        ONE dispatch, commit the accepted prefix. Exactly one counted host
        sync per iteration, so spec with no n-gram match is sync-for-sync
        K=1 stepping. Lock held."""
        cache = self.decoder.cache
        S = cache.max_seqs
        drafts: Dict[int, List[int]] = {}
        d_max = 0
        for s, a in snapshot.items():
            cap_s = min(self.spec_draft, a.req.max_new_tokens
                        - a.n_generated - 1)
            prop = self._spec_index.propose(s, cap_s) if cap_s > 0 else []
            drafts[s] = prop
            d_max = max(d_max, len(prop))
        # the draft width buckets to a power of two: Q in {2, 3, 5, 9}
        d_bucket = 1
        while d_bucket < d_max:
            d_bucket *= 2
        q_eff = d_bucket + 1
        draft_np = np.zeros((S, d_bucket), np.int32)
        dl_np = np.zeros((S,), np.int32)
        for s, prop in drafts.items():
            draft_np[s, :len(prop)] = prop
            dl_np[s] = len(prop)
            if prop:
                # the verify rows [pos, pos + d] must not land in COW-shared
                # blocks (a shared prefix may end past the prompt)
                act = snapshot[s]
                pos = act.prefilled + act.n_generated - 1
                cache.ensure_writable(s, pos, pos + len(prop) + 1)
        t_chunk = time.perf_counter()
        self._h_chunk_k.observe(q_eff)
        self._g_queue.set(len(self._queue))
        self._g_occ.set(len(self._by_slot))
        miss = ("spec", q_eff) not in self._seen_shapes
        if miss:
            self._seen_shapes.add(("spec", q_eff))
            self._c_compiles.inc()
        toks, c_eff, n_accept, new_active, lps, nf = self._run_spec(
            self._h2d(self._active_mask), self.sampler.peek_keys(q_eff),
            self._h2d(draft_np), self._h2d(dl_np))
        rb = _kvc.HostCopy({"toks": toks, "c_eff": c_eff, "acc": n_accept,
                        "final": new_active, "nf": nf, "hist": self._hist})
        got = rb.numpy()                     # the counted per-iteration sync
        if bool(got["nf"]):
            self._c_nonfinite.inc()
        self._c_syncs.inc()
        toks_np, c_np, acc_np = got["toks"], got["c_eff"], got["acc"]
        # chain positions consumed = the deepest commit across slots
        self.sampler.advance(int(c_np.max()))
        chunk_ms = (time.perf_counter() - t_chunk) * 1e3
        self._h_chunk_ms.observe(chunk_ms)
        lp_np = _host_rows(lps) if self.capture_logprobs else None
        for slot, act in snapshot.items():
            if self._by_slot.get(slot) is not act \
                    or not self._active_mask[slot]:
                continue
            n_new = int(c_np[slot])
            d_s = int(dl_np[slot])
            acc = int(acc_np[slot])
            act.n_generated += n_new
            # committed rows only: rejected rows past the commit are
            # invisible and not stamped
            p_end = act.prefilled + act.n_generated - 1
            cache.touch_blocks(slot, p_end - n_new, p_end)
            self._c_tokens.inc(n_new)
            self._spec_index.extend(slot, toks_np[slot, :n_new])
            if d_s > 0:
                self._c_spec_acc.inc(acc)
                self._c_spec_rej.inc(d_s - acc)
                self._h_spec_accept.observe(acc / d_s)
                self._h_spec_draft.observe(d_s)
            ev = {"phase": "spec_step", "t0": t_iter0,
                  "t1": time.monotonic(), "draft": d_s, "accepted": acc,
                  "tokens": n_new, "iter": self._iter_id,
                  "wall_s": chunk_ms / 1e3}
            if miss:
                ev["compile"] = True
            act.timeline.append(ev)
            if lp_np is not None and act.logprobs is not None:
                act.logprobs.extend(lp_np[slot, j] for j in range(n_new))
            if not got["final"][slot]:
                self._active_mask[slot] = False
                self._retire(slot, "length", hist=got["hist"])
        self._update_kv_resident()
        return bool(self._by_slot or self._queue)

    # ------------------------------------------------- overlapped pipeline
    def _drain_overlapped(self) -> None:
        """One-chunk-deep pipelining: dispatch chunk i+1 on the device-side
        active mask, then read chunk i's bundle while the device computes.
        Finished slots decode at most one extra chunk fully masked; keys are
        consumed unconditionally (throughput mode). Parked swap victims
        harvest after each readback."""
        pending = None   # (snapshot, readback, t_dispatch, k, t0, iter, miss)
        with self._lock:
            self._dev_active = self._h2d(self._active_mask)
        try:
            while True:
                with self._lock:
                    t_iter0 = self._begin_iteration()
                    self._admit()
                    self._expire_timeouts()
                    self._prefill_step()
                    dispatched = None
                    if self._active_mask.any():
                        k_eff = self._chunk_size()
                        snapshot = {s: a for s, a in self._by_slot.items()
                                    if self._active_mask[s]}
                        t_disp = time.perf_counter()
                        self._dev_active, rb, _, miss = self._dispatch(
                            self._dev_active, k_eff)
                        self.sampler.advance(k_eff)
                        dispatched = (snapshot, rb, t_disp, k_eff, t_iter0,
                                      self._iter_id, miss)
                    if pending is not None:
                        (snapshot, rb, t_disp, k_prev, t_disp_mono, it_prev,
                         miss_prev) = pending
                        got = rb.numpy()     # the counted per-chunk sync
                        if bool(got["nf"]):
                            self._c_nonfinite.inc()
                        self._c_syncs.inc()
                        chunk_ms = (time.perf_counter() - t_disp) * 1e3
                        self._h_chunk_ms.observe(chunk_ms)
                        self._finish_steps(snapshot, got["entries"],
                                           got["final"], None,
                                           hist=got["hist"],
                                           span={"t0": t_disp_mono,
                                                 "k": k_prev,
                                                 "wall_s": chunk_ms / 1e3,
                                                 "iter": it_prev,
                                                 "compile": miss_prev})
                    self._harvest_swaps()
                    pending = dispatched
                    if pending is None and not (self._by_slot or self._queue):
                        return
        finally:
            with self._lock:
                self._dev_active = None

    def drain(self) -> None:
        """Run iterations until no active or queued work remains (a spec
        engine always steps synchronously)."""
        if self.overlap and self.decode_chunk > 1 \
                and not self.capture_logprobs and not self.spec_decode:
            self._drain_overlapped()
        else:
            while self.step():
                pass

    def generate(self, prompts, **kw) -> List[GenerationResult]:
        """Submit every prompt (a Request or a token-id sequence; **kw
        applies to bare sequences), drain, return results in order."""
        futs = [self.submit(p if isinstance(p, Request) else Request(p, **kw))
                for p in prompts]
        self.drain()
        return [f.get(timeout=0) for f in futs]

    # --------------------------------------------------- background thread
    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            with self._work:
                while not (self._queue or self._by_slot
                           or self._stop.is_set()):
                    self._work.wait(timeout=0.1)
                if self._stop.is_set():
                    break
            self.step()
        if self._drain_on_stop:
            self.drain()

    def shutdown(self, wait: bool = True) -> None:
        """Stop the background loop. wait=True finishes in-flight requests
        first; wait=False resolves them with finish_reason='shutdown' and
        forgets parked swap bytes on every tier. A path-backed prefix
        store is saved last."""
        self._drain_on_stop = wait
        self._stop.set()
        with self._work:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:
            if not wait:
                for slot in list(self._by_slot):
                    self._active_mask[slot] = False
                    self._retire(slot, "shutdown")
                # parked victims: resolved without reading their bytes
                for rec in self._pending_swaps:
                    act = rec["act"]
                    act.fut._set(GenerationResult(
                        [], "shutdown", len(act.req.tokens),
                        req_id=act.req_id, admission_retries=act.retries,
                        timeline=act.timeline))
                    if self.lifecycle is not None:
                        self.lifecycle.drop(act.req_id)
                self._pending_swaps.clear()
                for act in self._queue:
                    # a requeued victim's life is tiled up to t_requeue
                    t_q0 = act.resume["t_requeue"] \
                        if act.resume is not None else act.t_submit
                    act.timeline.append({"phase": "queue", "t0": t_q0,
                                         "t1": time.monotonic(),
                                         "retries": act.retries})
                    act.fut._set(GenerationResult(
                        [], "shutdown", len(act.req.tokens),
                        req_id=act.req_id, admission_retries=act.retries,
                        timeline=act.timeline))
                    if act.resume is not None \
                            and act.resume["mode"] == "swap" \
                            and self.lifecycle is not None:
                        self.lifecycle.drop(act.req_id)
                self._queue.clear()
            elif self._by_slot or self._queue or self._pending_swaps:
                self.drain()
        if self.prefix_store is not None and self.prefix_store.path:
            self.prefix_store.save()
