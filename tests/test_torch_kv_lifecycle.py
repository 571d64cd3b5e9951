"""The port's serving under KV pressure (serving/lifecycle.py, kv_disk.py
and the engine's preemption paths) against the JAX package's, in float64
on the CPU.

For the same net and request schedule, with preemption by recompute, by
synchronous swap and by asynchronous swap (with and without the disk
tier), at decode_chunk 1 and 8, overlap on and off: the greedy tokens,
the timeline phase sequence of every request, the counted host syncs and
every lifecycle counter equal the JAX engine's. Inside the port: a
pressured run gives the unpressured run's tokens in both modes, a victim
whose slot is reused in the same admission pass resumes with its own
tokens, a swap round trip is bit-exact on float and int8 pools, the
host-pool and mode rules, the queue-shed of a parked victim, timelines
that tile on every exit path, the environment knobs, and every JAX
constructor option either ported or refused by name.

The overlapped scenarios are ones where the JAX engine terminates: with
every slot thrashing, its overlapped drain preempts each re-admitted
request before its chunk is credited and never ends, and the port, a
copy of its scheduling, does the same.
"""
import inspect
import os

import pytest

import torch

from deeplearning4j_tpu.serving import Request as JaxRequest
from deeplearning4j_tpu.serving import ServingEngine as JaxEngine
from deeplearning4j_tpu.telemetry import blame
from deeplearning4j_tpu.telemetry.flight_recorder import max_gap_s
from deeplearning4j_tpu_torch.serving import (HostBlockPool, KVCache,
                                              KVLifecycleManager, Request,
                                              ServingEngine,
                                              resolve_lifecycle)
from deeplearning4j_tpu_torch.serving import engine as tengine
from deeplearning4j_tpu_torch.serving import kv_cache as tkv
from deeplearning4j_tpu_torch.serving.kv_disk import DiskBlockPool
from deeplearning4j_tpu_torch.telemetry.kv_observatory import attribute_pool

from tests.test_torch_serving import _nets

torch.set_num_threads(1)    # small CPU tensors: one thread per test process

PROMPTS = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12],
           [2, 4, 6, 8, 10, 12], [9, 7, 5, 3, 1, 2]]
# (max_seqs, kv_blocks, max_new_tokens per request, scheduler steps before
# the requests past the second are submitted); 4 blocks of 4 positions a
# request, so 9 blocks hold two residents
SCENARIOS = {"all_at_once": (4, 9, (10, 10, 10, 10), 0),
             "late_short": (3, 9, (12, 12, 4), 2),
             "later_short": (3, 9, (12, 12, 4), 5)}
STATS = ("host_syncs", "tokens_out", "kv_preemptions", "kv_evictions_swap",
         "kv_evictions_recompute", "kv_swap_out_bytes", "kv_swap_in_bytes",
         "kv_disk_demotions", "kv_disk_promotions", "kv_swap_harvests",
         "kv_pending_swaps", "kv_swap_lost", "prefix_hits",
         "admission_retries")


@pytest.fixture(scope="module")
def nets():
    return _nets()


def _engine(cls, net, scenario="all_at_once", **kw):
    ms, nb, _, _ = SCENARIOS[scenario]
    if cls is ServingEngine:
        kw["device"] = "cpu"
    kw.setdefault("kv_block", 4)
    kw.setdefault("kv_blocks", nb)
    kw.setdefault("decode_chunk", 1)
    kw.setdefault("overlap", False)
    return cls(net, max_seqs=ms, max_len=64, seed=3, **kw)


def _drive(eng, req_cls, scenario="all_at_once"):
    """Submit the first two requests, step `late` times, submit the rest,
    drain; returns the results in submission order."""
    _, _, news, late = SCENARIOS[scenario]
    futs = [eng.submit(req_cls(PROMPTS[i], max_new_tokens=news[i]))
            for i in range(2)]
    for _ in range(late):
        eng.step()
    futs += [eng.submit(req_cls(PROMPTS[i], max_new_tokens=news[i]))
             for i in range(2, len(news))]
    eng.drain()
    return [f.get(timeout=0) for f in futs]


def _both(nets, scenario, tmp_path=None, **kw):
    """The same pressured schedule through the JAX engine and the port;
    the disk tier (kv_disk=True) gets a directory of its own per engine."""
    out = []
    for cls, req, net, tag in ((JaxEngine, JaxRequest, nets[0], "jax"),
                               (ServingEngine, Request, nets[1], "port")):
        ekw = dict(kw)
        if ekw.get("kv_disk") is True:
            ekw["kv_disk"] = str(tmp_path / tag)
        eng = _engine(cls, net, scenario, **ekw)
        out.append((eng, _drive(eng, req, scenario)))
    return out


def _assert_parity(jax_run, port_run):
    (jeng, jres), (teng, tres) = jax_run, port_run
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    assert [r.finish_reason for r in tres] == \
        [r.finish_reason for r in jres]
    assert [[e["phase"] for e in r.timeline] for r in tres] == \
        [[e["phase"] for e in r.timeline] for r in jres]
    js, ts = jeng.stats(), teng.stats()
    for key in STATS:
        assert ts[key] == js[key], (key, js[key], ts[key])


# (kv_evict_mode, kv_swap_async, decode_chunk, overlap, scenario, disk)
PARITY = {
    "recompute_k1": ("recompute", False, 1, False, "all_at_once", False),
    "swap_sync_k1": ("swap", False, 1, False, "all_at_once", False),
    "swap_async_k1": ("swap", True, 1, False, "all_at_once", False),
    "recompute_k8": ("recompute", False, 8, False, "all_at_once", False),
    "swap_sync_k8": ("swap", False, 8, False, "all_at_once", False),
    "swap_async_k8": ("swap", True, 8, False, "all_at_once", False),
    "recompute_k8_overlap": ("recompute", False, 8, True, "late_short",
                             False),
    "swap_sync_k8_overlap": ("swap", False, 8, True, "late_short", False),
    "swap_async_k8_overlap": ("swap", True, 8, True, "later_short", False),
    "swap_sync_k1_disk": ("swap", False, 1, False, "all_at_once", True),
    "swap_async_k1_disk": ("swap", True, 1, False, "all_at_once", True),
    "swap_async_k8_overlap_disk": ("swap", True, 8, True, "later_short",
                                   True),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_pressure_tokens_syncs_and_timelines_match_jax(nets, case,
                                                       tmp_path):
    mode, async_, k, overlap, scenario, disk = PARITY[case]
    kw = dict(kv_evict="lru", kv_evict_mode=mode, kv_swap_async=async_,
              decode_chunk=k, overlap=overlap,
              kv_swap_bytes=(1 << 10) if disk else (1 << 24))
    if disk:
        kw.update(kv_disk=True, kv_disk_bytes=1 << 24)
    jax_run, port_run = _both(nets, scenario, tmp_path, **kw)
    _assert_parity(jax_run, port_run)
    s = port_run[0].stats()
    assert s["kv_preemptions"] >= 4
    assert (s["kv_evictions_swap"] > 0) == (mode == "swap")
    assert (s["kv_swap_harvests"] > 0) == async_
    if disk:
        assert s["kv_disk_demotions"] > 0 and s["kv_disk_promotions"] > 0
    lc = port_run[0].lifecycle
    assert lc.host_pool.n_entries == 0 and s["kv_pending_swaps"] == 0
    if lc.disk_pool is not None:
        assert lc.disk_pool.n_entries == 0
        assert [f for f in os.listdir(lc.disk_pool.directory)
                if f.endswith(".npz")] == []


def test_int8_pool_swap_through_disk_matches_jax(nets, tmp_path):
    """The int8 pool's scales travel with its payload through the host
    pool and the disk tier (a cap below one victim sends every entry to
    disk)."""
    jax_run, port_run = _both(nets, "all_at_once", tmp_path, kv_quant=True,
                              kv_evict="lru", kv_evict_mode="swap",
                              kv_swap_async=True, kv_swap_bytes=256,
                              kv_disk=True, kv_disk_bytes=1 << 24)
    _assert_parity(jax_run, port_run)
    s = port_run[0].stats()
    assert s["kv_evictions_swap"] >= 4 and s["kv_disk_promotions"] > 0
    ref = _drive(_engine(ServingEngine, nets[1], kv_quant=True,
                         kv_blocks=64), Request)
    assert [r.tokens for r in port_run[1]] == [r.tokens for r in ref]


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_evicted_matches_never_evicted(nets, mode):
    _, tnet = nets
    ref = _drive(_engine(ServingEngine, tnet, kv_blocks=64), Request)
    eng = _engine(ServingEngine, tnet, kv_evict="lru", kv_evict_mode=mode,
                  kv_swap_bytes=1 << 24)
    futs = [eng.submit(Request(p, max_new_tokens=10)) for p in PROMPTS]
    while eng.step():      # the pool's bytes are conserved every iteration
        assert attribute_pool(eng.kv_pool_snapshot())["conserved"]
    res = [f.get(timeout=0) for f in futs]
    assert [r.tokens for r in res] == [r.tokens for r in ref]
    assert eng.stats()["kv_preemptions"] > 0
    assert eng.decoder.cache.blocks_free == eng.decoder.cache.num_blocks


def test_reused_slot_victim_resumes_with_its_own_tokens(nets):
    """An asynchronous swap victim's slot goes to the admitted request in
    the same pass, whose first token overwrites the history row before
    the harvest; the victim still resumes with its own tokens, because
    the row was copied at preempt time."""
    _, tnet = nets
    ref = _drive(_engine(ServingEngine, tnet, "later_short", kv_blocks=64,
                         decode_chunk=8), Request, "later_short")
    eng = _engine(ServingEngine, tnet, "later_short", kv_evict="lru",
                  kv_evict_mode="swap", kv_swap_bytes=1 << 24,
                  kv_swap_async=True, decode_chunk=8)
    seen = []
    harvest = eng._harvest_swaps

    def spy():
        for rec in eng._pending_swaps:
            occupant = eng._by_slot.get(rec["slot"])
            row = eng._hist[rec["slot"], :rec["n"]].tolist()
            gen = [int(t) for t in rec["hist"].wait()["row"]]
            seen.append((rec["act"].req_id, occupant is not None
                         and occupant is not rec["act"], row, gen))
        harvest()

    eng._harvest_swaps = spy
    res = _drive(eng, Request, "later_short")
    assert [r.tokens for r in res] == [r.tokens for r in ref]
    reused = [s for s in seen if s[1]]
    assert reused, "no victim's slot was reused before its harvest"
    by_id = {r.req_id: r.tokens for r in ref}
    for req_id, _, row, gen in reused:
        assert gen == by_id[req_id][:len(gen)]
    # the live row had been overwritten by the new occupant
    assert any(row != gen for _, _, row, gen in reused)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_swap_round_trip_bit_identity(kv_quant):
    c = KVCache(n_layers=2, max_seqs=2, max_len=32, n_kv_heads=2,
                head_dim=4, dtype=torch.float64, block_size=4,
                num_blocks=12, prefix_share=False, kv_quant=kv_quant,
                device="cpu")
    plan = c.admit("a", n_positions=12, prompt=list(range(1, 9)))
    row = list(c._slot_blocks[plan.slot])
    g = torch.Generator().manual_seed(7)
    k_pat = torch.randn((12, 2, 4), generator=g, dtype=torch.float64)
    v_pat = torch.randn((12, 2, 4), generator=g, dtype=torch.float64)
    for layer in range(2):
        tkv.write_prefill(c.state, layer, plan.slot, k_pat, v_pat)
    payload = tkv.gather_blocks_host(c.state, row, with_scales=kv_quant)
    before = [tkv.host_value(p).clone() for p in payload]
    pool = HostBlockPool(capacity_bytes=1 << 20)
    nbytes = len(row) * c.block_bytes
    assert pool.can_fit(nbytes)
    sc = {} if not kv_quant else {"k_scale": payload[2],
                                  "v_scale": payload[3]}
    pool.put("req", payload[0], payload[1], nbytes, **sc)
    assert pool.bytes_used == nbytes and "req" in pool
    c.free(plan.slot)
    other = c.admit("b", n_positions=12, prompt=list(range(20, 28)))
    for layer in range(2):                  # the freed blocks are reused
        tkv.write_prefill(c.state, layer, other.slot, -k_pat, v_pat * 3)
    c.free(other.slot)
    plan2 = c.admit("c", n_positions=12, prompt=list(range(1, 9)))
    row2 = list(c._slot_blocks[plan2.slot])
    scales = pool.fetch_scales("req")
    k_host, v_host = pool.fetch("req")
    assert pool.bytes_used == 0 and pool.n_entries == 0
    skw = {} if scales is None else {"k_scale": scales[0],
                                     "v_scale": scales[1]}
    tkv.restore_blocks(c.state, row2, k_host, v_host, **skw)
    after = tkv.gather_blocks(c.state, row2, with_scales=kv_quant)
    assert len(after) == len(before) == (4 if kv_quant else 2)
    for a, b in zip(after, before):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_host_pool_capacity_and_duplicate_guard():
    pool = HostBlockPool(capacity_bytes=100)
    assert not pool.can_fit(101) and pool.can_fit(100)
    pool.put("a", 1, 2, 60)
    assert not pool.can_fit(60)
    with pytest.raises(ValueError):
        pool.put("a", 1, 2, 10)
    pool.drop("a")
    assert pool.bytes_used == 0
    assert HostBlockPool(0).can_fit(1) is False


def test_choose_mode_and_ladder_capacity(tmp_path):
    cheap_swap, cheap_rec = {"cheaper": "swap"}, {"cheaper": "recompute"}
    auto = KVLifecycleManager(policy="lru", swap_bytes=100, mode="auto")
    assert auto.choose_mode(cheap_swap, 50) == "swap"
    assert auto.choose_mode(cheap_rec, 50) == "recompute"
    assert auto.choose_mode(cheap_swap, 200) == "recompute"
    forced = KVLifecycleManager(policy="lru", swap_bytes=100, mode="swap")
    assert forced.choose_mode(cheap_rec, 50) == "swap"
    assert forced.choose_mode(cheap_rec, 200) == "recompute"
    rec = KVLifecycleManager(policy="lru", swap_bytes=100, mode="recompute")
    assert rec.choose_mode(cheap_swap, 1) == "recompute"
    mgr = KVLifecycleManager(
        policy="lru", swap_bytes=100, mode="swap",
        disk_pool=DiskBlockPool(str(tmp_path), capacity_bytes=1000))
    mgr.host_pool.put("old", torch.zeros(4), torch.zeros(4), 80)
    assert mgr.can_absorb(90) and mgr.can_absorb(600)
    assert not mgr.can_absorb(2000)
    assert mgr.choose_mode(cheap_rec, 90) == "swap"
    with pytest.raises(ValueError):
        KVLifecycleManager(policy="no_such_policy")


def test_resolve_lifecycle_knobs(monkeypatch, tmp_path):
    monkeypatch.delenv("DL4J_TPU_KV_DISK", raising=False)
    assert resolve_lifecycle("", 0) is None
    assert resolve_lifecycle("off", 0) is None
    assert resolve_lifecycle(False, 0) is None
    assert resolve_lifecycle(True, 0).policy == "lru"
    monkeypatch.setenv("DL4J_TPU_KV_EVICT", "refcount_weighted")
    monkeypatch.setenv("DL4J_TPU_KV_SWAP_BYTES", str(1 << 20))
    monkeypatch.setenv("DL4J_TPU_KV_DISK", str(tmp_path / "d"))
    mgr = resolve_lifecycle(None, None)
    assert mgr.policy == "refcount_weighted"
    assert mgr.host_pool.capacity_bytes == 1 << 20
    assert mgr.disk_pool.directory == str(tmp_path / "d")
    assert resolve_lifecycle(mgr, None) is mgr
    monkeypatch.setenv("DL4J_TPU_KV_EVICT", "0")
    assert resolve_lifecycle(None, None) is None


def test_plan_eviction_lru_picks_the_coldest():
    c = KVCache(n_layers=1, max_seqs=4, max_len=32, n_kv_heads=1,
                head_dim=2, dtype=torch.float64, block_size=4,
                num_blocks=16, prefix_share=True, device="cpu")
    mgr = KVLifecycleManager(policy="lru")
    cold = c.admit("cold", n_positions=8, prompt=[1, 2, 3, 4, 5])
    c.allocator.tick()
    hot = c.admit("hot", n_positions=8, prompt=[6, 7, 8, 9, 10])
    c.touch_blocks(hot.slot, 0, 5)
    snap = c.pool_snapshot(live_positions={cold.slot: 5, hot.slot: 5})
    assert attribute_pool(snap)["conserved"]
    plan = mgr.plan(snap, 1)
    assert plan["evicted"][0]["slot"] == cold.slot and plan["satisfies"]
    assert [v["slot"] for v in mgr.plan(snap, 1, eligible={hot.slot})[
        "evicted"]] == [hot.slot]
    assert mgr.plan(snap, 1, eligible=set())["evicted"] == []


def _step_until_requeued(eng, mode, limit=400):
    for _ in range(limit):
        eng.step()
        if any(a.resume is not None and a.resume["mode"] == mode
               for a in eng._queue):
            return
    pytest.fail("the schedule no longer preempts")


def test_queue_shed_drops_a_parked_victim(nets, tmp_path):
    """A swap victim whose deadline passes while it is requeued returns
    the tokens it had, and its bytes are forgotten on every tier."""
    _, tnet = nets
    eng = _engine(ServingEngine, tnet, kv_evict="lru", kv_evict_mode="swap",
                  kv_swap_bytes=1 << 10, kv_disk=str(tmp_path),
                  kv_swap_async=False)
    futs = [eng.submit(Request(p, max_new_tokens=12)) for p in PROMPTS]
    _step_until_requeued(eng, "swap")
    victim = next(a for a in eng._queue if a.resume is not None)
    lc = eng.lifecycle
    assert lc.has_swap(victim.req_id)
    had = list(victim.resume["tokens"])
    victim.deadline = 0.0
    eng.step()
    res = [f.get(timeout=0) for f in futs if f._event.is_set()]
    shed = [r for r in res if r.req_id == victim.req_id]
    assert shed and shed[0].finish_reason == "timeout"
    assert shed[0].tokens == had and had
    assert not lc.has_swap(victim.req_id)
    eng.drain()
    assert lc.host_pool.n_entries == 0 and lc.disk_pool.n_entries == 0


def _assert_tiles(results):
    for r in results:
        period = max(e["t1"] - e["t0"] for e in r.timeline)
        assert max_gap_s(r.timeline) <= max(period, 1e-3)
        for prev, ev in zip(r.timeline, r.timeline[1:]):
            if prev["phase"] in ("preempt", "swap_pending",
                                 "swap_out_async"):
                assert ev["t0"] == prev["t1"], (prev, ev)
        blame.assert_conserved(blame.blame_timeline(r.timeline,
                                                    req_id=r.req_id))


@pytest.mark.parametrize("exit_path", ["drain", "shutdown_wait",
                                       "shutdown_abandon"])
def test_timelines_tile_on_every_exit_path(nets, exit_path):
    _, tnet = nets
    eng = _engine(ServingEngine, tnet, kv_evict="lru", kv_evict_mode="swap",
                  kv_swap_bytes=1 << 24, kv_swap_async=True)
    futs = [eng.submit(Request(p, max_new_tokens=12))
            for p in PROMPTS * 2]
    if exit_path == "drain":
        eng.drain()
    else:
        _step_until_requeued(eng, "swap")
        eng.shutdown(wait=exit_path == "shutdown_wait")
    results = [f.get(timeout=30) for f in futs]
    _assert_tiles(results)
    phases = {e["phase"] for r in results for e in r.timeline}
    assert {"preempt", "swap_pending", "swap_out_async"} <= phases
    if exit_path == "shutdown_abandon":
        assert any(r.finish_reason == "shutdown" for r in results)
        assert eng.lifecycle.host_pool.n_entries == 0
    else:
        assert all(r.finish_reason == "length" for r in results)


ENV_KNOBS = {
    "DL4J_TPU_KV_EVICT": ({"DL4J_TPU_KV_EVICT": "lru",
                           "DL4J_TPU_KV_SWAP_BYTES": str(1 << 24)},
                          {"kv_evict_mode": "swap", "kv_swap_async": False}),
    "DL4J_TPU_KV_SWAP_ASYNC": ({"DL4J_TPU_KV_SWAP_ASYNC": "0"},
                               {"kv_evict": "lru", "kv_evict_mode": "swap",
                                "kv_swap_bytes": 1 << 24,
                                "decode_chunk": 8}),
    "DL4J_TPU_KV_DISK": ({"DL4J_TPU_KV_DISK": "<dir>",
                          "DL4J_TPU_KV_DISK_BYTES": str(1 << 24)},
                         {"kv_evict": "lru", "kv_evict_mode": "swap",
                          "kv_swap_bytes": 1 << 10}),
}


@pytest.mark.parametrize("knob", list(ENV_KNOBS))
def test_env_knobs_match_jax(nets, knob, monkeypatch, tmp_path):
    env, kw = ENV_KNOBS[knob]
    runs = []
    for cls, req, net, tag in ((JaxEngine, JaxRequest, nets[0], "jax"),
                               (ServingEngine, Request, nets[1], "port")):
        for name, val in env.items():
            monkeypatch.setenv(name, str(tmp_path / tag) if val == "<dir>"
                               else val)
        eng = _engine(cls, net, decode_chunk=kw.get("decode_chunk", 1),
                      overlap=False,
                      **{k: v for k, v in kw.items() if k != "decode_chunk"})
        runs.append((eng, _drive(eng, req)))
    _assert_parity(*runs)
    s = runs[1][0].stats()
    assert s["kv_preemptions"] > 0
    if knob == "DL4J_TPU_KV_SWAP_ASYNC":
        assert s["kv_swap_harvests"] == 0 and s["kv_evictions_swap"] > 0
    if knob == "DL4J_TPU_KV_DISK":
        assert s["kv_disk_demotions"] > 0


def test_every_jax_option_is_ported_or_refused_by_name(nets):
    """Each parameter of the JAX engine's constructor is either in the
    port's signature or raises NotImplementedError naming itself when
    set, never TypeError."""
    _, tnet = nets
    jax_params = inspect.signature(JaxEngine.__init__).parameters
    port_params = inspect.signature(ServingEngine.__init__).parameters
    unported = [p for p in jax_params if p not in port_params]
    assert sorted(unported) == sorted(k for k, _ in tengine._UNPORTED)
    for name in unported:
        with pytest.raises(NotImplementedError, match=name):
            ServingEngine(tnet, max_seqs=2, max_len=32, device="cpu",
                          **{name: True})
    eng = ServingEngine(tnet, max_seqs=2, max_len=32, device="cpu",
                        name="replica0", kv_evict_mode="swap",
                        kv_swap_async=False)
    assert eng.name == "replica0" and eng.lifecycle is None
    assert eng.kv_swap_async is False
