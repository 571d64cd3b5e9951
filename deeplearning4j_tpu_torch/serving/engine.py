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

Options of the JAX engine that this slice does not port raise
NotImplementedError when set (argument or environment variable): the radix
prefix tree, KV eviction/swap/disk tiers and the prefix store,
non-colocated policies, the flight recorder, the KV observatory, time
series and alerts, the journal.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.serving import spec as spec_mod
from deeplearning4j_tpu_torch.serving.decode import (StackDecoder,
                                                     one_hot_embedder)
from deeplearning4j_tpu_torch.serving.policy import ColocatedPolicy
from deeplearning4j_tpu_torch.serving.sampler import (Sampler,
                                                      spec_accept_tokens)
from deeplearning4j_tpu_torch.telemetry.registry import (DEFAULT_S_BUCKETS,
                                                         MetricsRegistry)

DEFAULT_PREFILL_CHUNK = 256

# (constructor argument, environment variable) of every JAX engine option
# this slice does not port
_UNPORTED = (
    ("prefix_radix", "DL4J_TPU_PREFIX_RADIX"),
    ("kv_evict", "DL4J_TPU_KV_EVICT"), ("kv_swap_bytes", None),
    ("kv_disk", "DL4J_TPU_KV_DISK"), ("kv_disk_bytes", None),
    ("prefix_store", None), ("flight_recorder", "DL4J_TPU_FLIGHT_RECORDER"),
    ("kv_observatory", "DL4J_TPU_KV_OBS"), ("timeseries", "DL4J_TPU_TS"),
    ("ts_window", None), ("alerts", "DL4J_TPU_ALERTS"),
    ("journal", "DL4J_TPU_JOURNAL"), ("radix_ttl", None),
    ("prefix_registry", None), ("metrics_parent", None),
)


def _host_rows(t: torch.Tensor) -> np.ndarray:
    """Logprob rows as a host array (bf16/fp16 widened to float32, which
    numpy can hold)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


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
    prefilled: int = 0                # prompt positions [0, prefilled) resident
    shared_len: int = 0
    n_chunks: int = 0


class _Readback:
    """One chunk's bundle copied device -> host without blocking: pinned
    buffers plus a CUDA event recorded after the copies. `wait()` blocks on
    that event only (work enqueued later keeps running)."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.event = None
        if any(t.device.type == "cuda" for t in tensors.values()):
            self.host = {k: torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True).copy_(
                                            t, non_blocking=True)
                         for k, t in tensors.items()}
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = {k: t.clone() for k, t in tensors.items()}

    def wait(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return {k: t.numpy() for k, t in self.host.items()}


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
    `quant_weights` select the int8 KV pool and int8 attention weights."""

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
                 kv_quant: Optional[bool] = None,
                 quant_weights: Optional[bool] = None,
                 policy=None,
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
        m.gauge("serving.kv_cache_bytes").set(cache.bytes())
        self._g_kv_res = m.gauge("serving.kv_bytes_resident")
        self._g_kv_waste = m.gauge("serving.kv_bytes_waste")
        self._g_blocks_free = m.gauge("serving.kv_blocks_free")
        self._g_blocks_shared = m.gauge("serving.kv_blocks_shared")
        self._g_blocks_free.set(cache.blocks_free)

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
            snap = self.decoder.cache.pool_snapshot()
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
                    "kv_clock": snap["clock"],
                    "kv_bytes_waste": self._g_kv_waste.value,
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
                        1, self._c_spec_acc.value + self._c_spec_rej.value)}

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
    def _admission_view(self, act: _Active, t_adm0: float) -> dict:
        """Pool-pressure view for the policy's `admit` decision point."""
        cache = self.decoder.cache
        bs = cache.block_size
        need = -(-(len(act.req.tokens) + act.req.max_new_tokens) // bs)
        shortfall = need - cache.blocks_free
        if cache.n_free == 0:
            shortfall = max(shortfall, 1)
        eligible = {s for s, a in self._by_slot.items()
                    if self._active_mask[s] and a.n_generated >= 1}
        return {"lifecycle": None, "shortfall": shortfall,
                "eligible": eligible, "req_id": act.req_id, "replica": None,
                "now": t_adm0, "t_submit": act.t_submit,
                "reclaimable_bytes": (cache.num_blocks - cache.blocks_free)
                * cache.block_bytes,
                "burn_rate_short": None,
                "snapshot_fn": cache.pool_snapshot}

    def _admit(self) -> None:
        """Move queued requests into cache slots (prefill + first token).
        The head request is peeked until its block plan succeeds, keeping
        FIFO order when blocks run short. Lock held."""
        cache = self.decoder.cache
        while self._queue:
            act = self._queue[0]
            if act.deadline is not None and time.monotonic() > act.deadline:
                self._queue.pop(0)
                act.fut._set(GenerationResult(
                    [], "timeout", len(act.req.tokens), req_id=act.req_id,
                    admission_retries=act.retries))
                self._c_retires.inc()
                self._c_timeouts.inc()
                continue
            req = act.req
            plen = len(req.tokens)
            pseq = list(req.tokens)
            t_adm0 = time.monotonic()
            plan = cache.admit(act, n_positions=plen + req.max_new_tokens,
                               prompt=pseq)
            if plan is None:           # no slot / not enough blocks: wait
                act.retries += 1
                self._c_adm_retries.inc()
                decision = self.policy.admit(req,
                                             self._admission_view(act, t_adm0))
                if decision.kind == "preempt":
                    raise NotImplementedError(
                        "preemption needs the KV lifecycle manager, which "
                        "is not ported yet")
                break
            self._queue.pop(0)
            slot = plan.slot
            act.slot = slot
            self._h_queue_wait.observe(t_adm0 - act.t_submit)
            act.t_admit = t_adm0
            shared = plan.shared_len
            act.prefilled = act.shared_len = shared
            if shared:
                self._c_prefix_hits.inc()
                self._c_prefix_tokens.inc(shared)
            self._plens[slot] = plen
            self._eos[slot] = -1 if req.eos_id is None else int(req.eos_id)
            self._maxgen[slot] = int(req.max_new_tokens)
            self._temps[slot] = req.temperature
            self._by_slot[slot] = act
            self._resident_seqs_max = max(self._resident_seqs_max,
                                          len(self._by_slot))
            self._c_admits.inc()
            if self.prefill_chunk and plen - shared > self.prefill_chunk:
                # chunked prefill: hold the reservation, prefill one bounded
                # chunk per scheduler iteration (_prefill_step)
                self._prefilling.append(act)
                self._update_kv_resident()
                continue
            toks = self._h2d(np.asarray(pseq, np.int32))
            if shared:
                key = ("prefill_shared", self.decoder.shared_buckets(plen,
                                                                     shared))
            else:
                key = ("prefill", self.decoder.prefill_bucket(plen))
            if key not in self._seen_shapes:
                self._seen_shapes.add(key)
                self._c_compiles.inc()
            had_active = bool(self._active_mask.any())
            t_pf = time.perf_counter()
            with torch.no_grad():
                if shared:
                    feats = self.embed(toks[shared:]).T
                    lp = self.decoder.prefill_shared(slot, feats, plen,
                                                     shared)
                else:
                    lp = self.decoder.prefill(slot, self.embed(toks).T)
            if had_active:
                self._h_stall.observe((time.perf_counter() - t_pf) * 1e3)
            self._finish_first_token(act, lp)

    def _finish_first_token(self, act: _Active, lp) -> None:
        """Prefill completed: register the resident prompt for sharing,
        sample the first token, activate the slot. Holds the one counted
        admission readback. Lock held."""
        req, slot = act.req, act.slot
        hits = self.decoder.cache.register_prefix(slot, list(req.tokens))
        if hits:
            self._c_lineage_hits.inc(hits)
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
        first token. Lock held."""
        if not self._prefilling:
            return
        act = self._prefilling[0]
        slot = act.slot
        seq = list(act.req.tokens)
        plen = len(seq)
        start = act.prefilled
        end = min(plen, start + self.prefill_chunk)
        key = ("prefill_shared", self.decoder.shared_buckets(end, start))
        if key not in self._seen_shapes:
            self._seen_shapes.add(key)
            self._c_compiles.inc()
        had_active = bool(self._active_mask.any())
        t_pf = time.perf_counter()
        toks = self._h2d(np.asarray(seq[start:end], np.int32))
        with torch.no_grad():
            lp = self.decoder.prefill_chunk(slot, self.embed(toks).T, start,
                                            end)
        if had_active:
            self._h_stall.observe((time.perf_counter() - t_pf) * 1e3)
        act.n_chunks += 1
        act.prefilled = end
        self._c_pf_chunks.inc()
        if end >= plen:
            self._prefilling.pop(0)
            self._finish_first_token(act, lp)
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
        qw = act.t_admit - act.t_submit if act.t_admit else None
        act.fut._set(GenerationResult(
            row, reason, len(req.tokens), lps, ttft_s=ttft,
            tokens_per_sec=tps, req_id=act.req_id, queue_wait_s=qw,
            admission_retries=act.retries,
            shared_prefix_tokens=act.shared_len))
        self._c_retires.inc()
        if tps is not None:
            self._h_tps.observe(tps)
        self._update_kv_resident()

    def _update_kv_resident(self) -> None:
        """Publish resident / wasted KV bytes and block gauges from host
        bookkeeping. Lock held."""
        snap = self.decoder.cache.pool_snapshot()
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
        readback bundle, logprobs)."""
        self._h_chunk_k.observe(k_eff)
        self._g_queue.set(len(self._queue))
        self._g_occ.set(len(self._by_slot))
        if ("chunk", k_eff) not in self._seen_shapes:
            self._seen_shapes.add(("chunk", k_eff))
            self._c_compiles.inc()
        final, entries, lps, nf = self._run_chunk(
            active, self.sampler.peek_keys(k_eff))
        rb = _Readback({"entries": entries, "final": final, "nf": nf,
                        "hist": self._hist})
        return final, rb, lps

    def _finish_steps(self, snapshot: Dict[int, _Active], entry_np, new_np,
                      lp_np, hist=None) -> None:
        """Host bookkeeping after a chunk's masks materialize: one token
        per micro-step each slot entered active; retire slots whose final
        mask dropped. `snapshot` is the slot -> request map at dispatch (an
        identity check keeps a stale mask off a slot's new occupant).
        Lock held."""
        K = entry_np.shape[0]
        for slot, act in snapshot.items():
            if self._by_slot.get(slot) is not act \
                    or not self._active_mask[slot]:
                continue
            n_new = int(entry_np[:, slot].sum())
            act.n_generated += n_new
            self._c_tokens.inc(n_new)
            if lp_np is not None and act.logprobs is not None:
                act.logprobs.extend(lp_np[i, slot] for i in range(K)
                                    if entry_np[i, slot])
            if not new_np[slot]:
                self._active_mask[slot] = False
                self._retire(slot, "length", hist=hist)
        self._update_kv_resident()

    def step(self) -> bool:
        """One scheduler iteration: admit, at most one prefill chunk, ONE
        decode chunk (adaptive K, one counted sync), retire. Returns True
        while any request is active or queued."""
        with self._lock:
            self.decoder.cache.allocator.tick()
            self._admit()
            if not self._by_slot:
                return bool(self._queue)
            self._expire_timeouts()
            self._prefill_step()
            if not self._active_mask.any():
                return bool(self._by_slot or self._queue)
            snapshot = {s: a for s, a in self._by_slot.items()
                        if self._active_mask[s]}
            if self.spec_decode:
                return self._spec_step(snapshot) or bool(self._queue)
            k_eff = self._chunk_size()
            t_chunk = time.perf_counter()
            _, rb, lps = self._dispatch(self._h2d(self._active_mask), k_eff)
            got = rb.wait()                  # the counted per-chunk sync
            if bool(got["nf"]):
                self._c_nonfinite.inc()
            self._c_syncs.inc()
            # commit exactly the micro-steps that ran with active work
            self.sampler.advance(int(got["entries"].any(axis=1).sum())
                                 if k_eff > 1 else 1)
            self._h_chunk_ms.observe((time.perf_counter() - t_chunk) * 1e3)
            lp_np = _host_rows(lps) if lps is not None else None
            self._finish_steps(snapshot, got["entries"], got["final"], lp_np,
                               hist=got["hist"])
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

    def _spec_step(self, snapshot: Dict[int, _Active]) -> bool:
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
        if ("spec", q_eff) not in self._seen_shapes:
            self._seen_shapes.add(("spec", q_eff))
            self._c_compiles.inc()
        toks, c_eff, n_accept, new_active, lps, nf = self._run_spec(
            self._h2d(self._active_mask), self.sampler.peek_keys(q_eff),
            self._h2d(draft_np), self._h2d(dl_np))
        rb = _Readback({"toks": toks, "c_eff": c_eff, "acc": n_accept,
                        "final": new_active, "nf": nf, "hist": self._hist})
        got = rb.wait()                      # the counted per-iteration sync
        if bool(got["nf"]):
            self._c_nonfinite.inc()
        self._c_syncs.inc()
        toks_np, c_np, acc_np = got["toks"], got["c_eff"], got["acc"]
        # chain positions consumed = the deepest commit across slots
        self.sampler.advance(int(c_np.max()))
        self._h_chunk_ms.observe((time.perf_counter() - t_chunk) * 1e3)
        lp_np = _host_rows(lps) if self.capture_logprobs else None
        for slot, act in snapshot.items():
            if self._by_slot.get(slot) is not act \
                    or not self._active_mask[slot]:
                continue
            n_new = int(c_np[slot])
            d_s = int(dl_np[slot])
            acc = int(acc_np[slot])
            act.n_generated += n_new
            self._c_tokens.inc(n_new)
            self._spec_index.extend(slot, toks_np[slot, :n_new])
            if d_s > 0:
                self._c_spec_acc.inc(acc)
                self._c_spec_rej.inc(d_s - acc)
                self._h_spec_accept.observe(acc / d_s)
                self._h_spec_draft.observe(d_s)
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
        consumed unconditionally (throughput mode)."""
        pending = None   # (snapshot, readback, t_dispatch)
        with self._lock:
            self._dev_active = self._h2d(self._active_mask)
        try:
            while True:
                with self._lock:
                    self.decoder.cache.allocator.tick()
                    self._admit()
                    self._expire_timeouts()
                    self._prefill_step()
                    dispatched = None
                    if self._active_mask.any():
                        k_eff = self._chunk_size()
                        snapshot = {s: a for s, a in self._by_slot.items()
                                    if self._active_mask[s]}
                        t_disp = time.perf_counter()
                        self._dev_active, rb, _ = self._dispatch(
                            self._dev_active, k_eff)
                        self.sampler.advance(k_eff)
                        dispatched = (snapshot, rb, t_disp)
                    if pending is not None:
                        snapshot, rb, t_disp = pending
                        got = rb.wait()      # the counted per-chunk sync
                        if bool(got["nf"]):
                            self._c_nonfinite.inc()
                        self._c_syncs.inc()
                        self._h_chunk_ms.observe(
                            (time.perf_counter() - t_disp) * 1e3)
                        self._finish_steps(snapshot, got["entries"],
                                           got["final"], None,
                                           hist=got["hist"])
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
        first; wait=False resolves them with finish_reason='shutdown'."""
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
                for act in self._queue:
                    act.fut._set(GenerationResult(
                        [], "shutdown", len(act.req.tokens),
                        req_id=act.req_id, admission_retries=act.retries))
                self._queue.clear()
            elif self._by_slot or self._queue:
                self.drain()
