"""KV-pressure planning, copied from telemetry/kv_observatory.py: pool
byte attribution, eviction candidates, the three victim scores, the
recompute-vs-swap cost model, `plan_eviction` and `dry_run`.

`plan_eviction` is the one source of truth for victim selection: the
serving lifecycle manager (serving/lifecycle.py) preempts exactly the
victims it names. Everything here reads `KVCache.pool_snapshot()` and host
integers the engine owns: no torch import, no device access. The JAX
package's `KVObservatory` (gauges, rejection forensics) is not ported.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

# reference rates for the recompute-vs-swap verdict of a manager built by
# hand; a lifecycle-armed engine replaces the swap rate at init with its
# own measured device<->host bandwidth (KVLifecycleManager.calibrate)
DEFAULT_SWAP_BYTES_PER_SEC = 16e9
DEFAULT_FLOPS_PER_SEC = 100e12


# --------------------------------------------------------- attribution
def attribute_pool(snapshot: Dict[str, object]) -> Dict[str, object]:
    """Exact byte attribution of one pool snapshot.

    Partition of `pool_bytes = num_blocks * block_size * bpp`:

    - free: unmapped blocks.
    - shared: blocks with refcount >= 2, counted ONCE (they serve a
      prefix lineage, not any single request; admission maps them only
      over fully-covered prompt-prefix positions, so they carry no
      waste by construction — see block_table.py's safety argument).
    - private_live: positions actually written (prompt + committed
      tokens) falling in refcount-1 blocks, attributed to the owning
      request.
    - waste_tail: the unwritten remainder of a private block that holds
      live positions (internal fragmentation).
    - waste_reserved: private blocks reserved ahead of the live length
      with no live positions at all (the decode reservation).

    A slot whose snapshot carries `live_positions=None` (caller did not
    thread live bookkeeping) is attributed at block granularity: its
    private blocks count as fully live and contribute no waste. The five
    terms always sum to `pool_bytes` because every mapped block is
    either shared or mapped by exactly one slot — the conservation
    invariant the randomized stress test pins.

    A quantized pool carries a per-block scale overhead
    (`block_overhead_bytes`, fp32 scales per layer x kv head) on top of
    the positional payload: each block's bytes become
    `bs * bpp + overhead`, and a partially-live private block's overhead
    is attributed to the LIVE side (the scales exist because the block
    holds live content), keeping the conservation sum exact.

    With the radix prefix tree on a block may be RETAINED by
    the tree after every request sharing it retired: refcount 1, mapped
    into no slot, flagged `cached` in the snapshot. Those bytes are a
    sixth partition term, `cached_prefix_bytes` — spent memory, but
    reclaimable on demand (radix reclaim frees them before admission
    fails) and the entire source of cross-turn prefill savings. A cached
    block still mapped by a live slot has refcount >= 2 and counts as
    shared, exactly as before; with the tree off the term is zero and
    the original five-way partition is unchanged."""
    bs = int(snapshot["block_size"])
    bpp = int(snapshot["bytes_per_position"])
    ovh = int(snapshot.get("block_overhead_bytes", 0))
    block_bytes = bs * bpp + ovh
    blocks: Dict[int, dict] = snapshot["blocks"]  # type: ignore[assignment]
    pool_bytes = int(snapshot["num_blocks"]) * block_bytes
    free_bytes = int(snapshot["blocks_free"]) * block_bytes
    shared_bytes = sum(block_bytes for b in blocks.values()
                       if b["refcount"] >= 2)
    # radix-retained blocks no live slot maps (refcount 1 = the tree's
    # own reference): the cross-turn cache residency term
    cached_bytes = sum(block_bytes for b in blocks.values()
                       if b.get("cached") and b["refcount"] == 1)
    private_live = 0
    waste_tail = 0
    waste_reserved = 0
    per_slot: Dict[int, Dict[str, int]] = {}
    by_lineage: Dict[str, int] = {}
    for b in blocks.values():
        if b["refcount"] >= 2 or (b.get("cached") and b["refcount"] == 1):
            key = b["lineage"] or "<unregistered>"
            by_lineage[key] = by_lineage.get(key, 0) + block_bytes
    for slot, info in snapshot["slots"].items():  # type: ignore[union-attr]
        live = info["live_positions"]
        slot_live = 0
        slot_shared = 0
        slot_waste = 0
        for li, blk in enumerate(info["blocks"]):
            if blocks[blk]["refcount"] >= 2:
                slot_shared += block_bytes
                continue
            if live is None:
                covered = bs
            else:
                covered = max(0, min(bs, int(live) - li * bs))
            slot_live += covered * bpp + (ovh if covered > 0 else 0)
            if covered == 0:
                waste_reserved += block_bytes
                slot_waste += block_bytes
            elif covered < bs:
                waste_tail += (bs - covered) * bpp
                slot_waste += (bs - covered) * bpp
        private_live += slot_live
        per_slot[slot] = {"req_id": info["req_id"],
                          "private_live_bytes": slot_live,
                          "shared_bytes": slot_shared,
                          "waste_bytes": slot_waste}
    total = (free_bytes + shared_bytes + private_live
             + waste_tail + waste_reserved + cached_bytes)
    return {
        "pool_bytes": pool_bytes,
        "free_bytes": free_bytes,
        "shared_bytes": shared_bytes,
        "private_live_bytes": private_live,
        "waste_tail_bytes": waste_tail,
        "waste_reserved_bytes": waste_reserved,
        "cached_prefix_bytes": cached_bytes,
        "per_slot": per_slot,
        "shared_by_lineage": by_lineage,
        "conserved": total == pool_bytes,
    }


# ---------------------------------------------------- eviction scoring
def eviction_candidates(snapshot: Dict[str, object]) -> List[dict]:
    """One eviction candidate per resident slot, carrying everything a
    scoring policy and the cost model need. `blocks_freed` here is the
    STATIC count (refcount-1 blocks); the dry run re-simulates refcounts
    in eviction order so cumulative reclaim accounts for shared blocks
    whose last other sharer was itself evicted."""
    bs = int(snapshot["block_size"])
    bpp = int(snapshot["bytes_per_position"])
    ovh = int(snapshot.get("block_overhead_bytes", 0))
    blocks: Dict[int, dict] = snapshot["blocks"]  # type: ignore[assignment]
    out = []
    for slot, info in snapshot["slots"].items():  # type: ignore[union-attr]
        live = info["live_positions"]
        if live is None:
            live = info["reserved_positions"]
        slot_blocks = info["blocks"]
        private = [b for b in slot_blocks if blocks[b]["refcount"] == 1]
        live_blocks = min(len(slot_blocks), -(-int(live) // bs))
        out.append({
            "slot": slot,
            "req_id": info["req_id"],
            "blocks_total": len(slot_blocks),
            "blocks_freed": len(private),
            "bytes_freed": len(private) * (bs * bpp + ovh),
            "live_positions": int(live),
            "swap_bytes": int(live) * bpp + live_blocks * ovh,
            "recompute_tokens": int(live),
            "last_touch": max((blocks[b]["last_touch"]
                               for b in slot_blocks), default=0),
            "alloc_epoch": min((blocks[b]["alloc_epoch"]
                                for b in slot_blocks), default=0),
            # the slot's refcount-weighted share of the pool: each block
            # contributes 1/refcount, so shared blocks split their cost
            "weighted_blocks": sum(1.0 / blocks[b]["refcount"]
                                   for b in slot_blocks),
            "deadline": info.get("deadline"),
            "t_submit": info.get("t_submit"),
        })
    return out


def lru_score(cand: dict, snapshot: Dict[str, object], now: float) -> float:
    """Coldest request first: iterations since ANY of its blocks was
    touched (a request is as hot as its hottest block — evicting a
    sequence is all-or-nothing)."""
    return int(snapshot["clock"]) - cand["last_touch"]


def slo_deadline_score(cand: dict, snapshot: Dict[str, object],
                       now: float) -> float:
    """Most SLO slack first (DistServe's goodput lens: a victim that was
    going to miss its deadline anyway costs no goodput; one with ample
    slack can absorb a recompute). Requests with no deadline are the
    safest victims of all; an overdue request (negative slack) scores
    worst. Uses the request's deadline stamp carried on the snapshot."""
    deadline = cand.get("deadline")
    if deadline is None:
        return 1e12
    return deadline - now


def refcount_weighted_score(cand: dict, snapshot: Dict[str, object],
                            now: float) -> float:
    """Largest refcount-weighted footprint first: shared blocks split
    their cost over their sharers, so this evicts the request holding
    the most bytes that are truly ITS OWN — evicting a heavy sharer of a
    hot prefix reclaims almost nothing and is scored accordingly."""
    return cand["weighted_blocks"]


DEFAULT_POLICIES: Dict[str, Callable[[dict, Dict[str, object], float],
                                     float]] = {
    "lru": lru_score,
    "slo_deadline": slo_deadline_score,
    "refcount_weighted": refcount_weighted_score,
}


def candidate_costs(cand: dict, *, flops_per_token: float,
                    swap_bytes_per_sec: float = DEFAULT_SWAP_BYTES_PER_SEC,
                    flops_per_sec: float = DEFAULT_FLOPS_PER_SEC) -> dict:
    """Recompute-vs-swap cost estimate for one candidate. Swap pays the live KV bytes over the host link TWICE (out at
    eviction, back at resume); recompute pays ~flops_per_token (the
    engine passes 2*params) per live token at readmission prefill."""
    swap_bytes = cand["swap_bytes"]
    swap_est_s = 2.0 * swap_bytes / swap_bytes_per_sec
    recompute_flops = cand["recompute_tokens"] * flops_per_token
    recompute_est_s = recompute_flops / flops_per_sec
    return {
        "swap_bytes": swap_bytes,
        "swap_est_s": swap_est_s,
        "recompute_flops": recompute_flops,
        "recompute_est_s": recompute_est_s,
        "cheaper": ("recompute" if recompute_est_s <= swap_est_s
                    else "swap"),
    }


def plan_eviction(snapshot: Dict[str, object], needed_blocks: int,
                  score_fn: Callable[[dict, Dict[str, object], float],
                                     float],
                  now: Optional[float] = None, *,
                  flops_per_token: float = 0.0,
                  swap_bytes_per_sec: float = DEFAULT_SWAP_BYTES_PER_SEC,
                  flops_per_sec: float = DEFAULT_FLOPS_PER_SEC,
                  eligible: Optional[set] = None,
                  policy: str = "<custom>") -> dict:
    """What ONE policy would evict to reclaim `needed_blocks` — the
    single source of truth for victim selection, shared by the dry-run
    scorer and the REAL eviction in serving/lifecycle.py.

    Rank the candidates (highest score = first victim), then walk the
    ranking simulating refcounts — a shared block frees only when its
    LAST sharer is evicted, so cumulative reclaim is order-dependent and
    the per-victim `blocks_freed` recorded here is the simulated
    marginal reclaim, not the static private count. Stops as soon as
    the shortfall is covered; `satisfies=False` means even evicting
    everything would not cover it. `eligible`, when given, restricts the
    candidate pool to those slots (the lifecycle manager passes slots
    that are safely preemptible this iteration)."""
    if now is None:
        now = time.monotonic()
    cands = eviction_candidates(snapshot)
    if eligible is not None:
        cands = [c for c in cands if c["slot"] in eligible]
    blocks: Dict[int, dict] = snapshot["blocks"]  # type: ignore[assignment]
    bs = int(snapshot["block_size"])
    bpp = int(snapshot["bytes_per_position"])
    ovh = int(snapshot.get("block_overhead_bytes", 0))
    block_bytes = bs * bpp + ovh
    ranked = sorted(cands, key=lambda c: score_fn(c, snapshot, now),
                    reverse=True)
    refs = {b: info["refcount"] for b, info in blocks.items()}
    slot_map = {c["slot"]: snapshot["slots"][c["slot"]]["blocks"]
                for c in cands}  # type: ignore[index]
    evicted = []
    freed = 0
    for cand in ranked:
        if freed >= needed_blocks:
            break
        marginal = 0
        for b in slot_map[cand["slot"]]:
            refs[b] -= 1
            if refs[b] == 0:
                marginal += 1
        freed += marginal
        entry = dict(cand)
        entry["score"] = score_fn(cand, snapshot, now)
        entry["blocks_freed"] = marginal
        entry["bytes_freed"] = marginal * block_bytes
        entry.update(candidate_costs(
            cand, flops_per_token=flops_per_token,
            swap_bytes_per_sec=swap_bytes_per_sec,
            flops_per_sec=flops_per_sec))
        evicted.append(entry)
    return {
        "policy": policy,
        "needed_blocks": int(needed_blocks),
        "evicted": evicted,
        "blocks_freed": freed,
        "bytes_freed": freed * block_bytes,
        "swap_bytes_total": sum(e["swap_bytes"] for e in evicted),
        "recompute_flops_total": sum(e["recompute_flops"]
                                     for e in evicted),
        "satisfies": freed >= needed_blocks,
    }


def dry_run(snapshot: Dict[str, object], needed_blocks: int,
            policies: Optional[Dict[str, Callable]] = None,
            now: Optional[float] = None, *, flops_per_token: float = 0.0,
            swap_bytes_per_sec: float = DEFAULT_SWAP_BYTES_PER_SEC,
            flops_per_sec: float = DEFAULT_FLOPS_PER_SEC) -> List[dict]:
    """What each policy WOULD evict to reclaim `needed_blocks` — a thin
    loop over `plan_eviction`, one row per policy, so the dry-run
    verdicts and the real eviction in serving/lifecycle.py can never
    disagree on victim selection."""
    if now is None:
        now = time.monotonic()
    policies = DEFAULT_POLICIES if policies is None else policies
    return [plan_eviction(snapshot, needed_blocks, score_fn, now,
                          flops_per_token=flops_per_token,
                          swap_bytes_per_sec=swap_bytes_per_sec,
                          flops_per_sec=flops_per_sec, policy=name)
            for name, score_fn in policies.items()]
