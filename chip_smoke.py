#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line; any failure exits non-zero:

1. device   - CUDA present with compute capability (9, 0).
2. build    - compile every CUDA kernel of the path from the checkout's
              sources (one nvcc per source, all started together).
3. kernel   - each kernel against its plain PyTorch version on the card
              (fp32, bf16 and an int8 pool; GQA groups 1/2/4; windows 0/64;
              block sizes 8/16; ragged visible lengths; shuffled block tables
              with trash entries), then timed at the served shape.
4. serve    - the bench_decode_serving model at full width (2 causal GQA
              attention layers, d_model 256, 4 heads, 2 kv heads, vocab 64,
              bf16, max_seqs 8, max_len 1024, KV block 16; random XAVIER
              weights from seed 42) served by ServingEngine: a warmup
              request, then 4 requests of 512 prompt tokens and 256 new
              tokens with 4 more submitted at the halfway mark. The kernel
              launch counts are zeroed just before and read just after; one
              decode chunk is then dispatched under
              torch.cuda.set_sync_debug_mode("error").
5. oracle   - the same model in fp32 with capture_logprobs: every captured
              row matches the full-recompute MultiLayerNetwork.output at its
              position within atol 2e-3.

Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and finally {"ok": true, "device": {...}}. Exits non-zero without a
result when CUDA is not available or the package is not beside this file.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3, NVIDIA data sheet
# the kernel computes in fp32 on the CUDA cores, not the tensor cores
FP32_OPS_PER_S = 67e12               # H100 SXM fp32, NVIDIA data sheet

VOCAB, D_MODEL, HEADS, KV_HEADS = 64, 256, 4, 2
PROMPT, NEW_TOKENS, WAVE = 512, 256, 4
MAX_SEQS, MAX_LEN = 2 * WAVE, 1024


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one eager call: CUDA events around `iters` back-to-back
    calls, so the host's launch overhead counts wherever it exceeds the
    device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, reps: int = 20, iters: int = 20) -> float:
    """Device time of one call without the host's launch overhead: `reps`
    calls captured in one CUDA graph, replayed `iters` times between CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


# ------------------------------------------------------------------ kernel
def paged_case(torch, S, Hk, G, D, bs, bps, window, dtype, quant, seed,
               visible=None):
    """Random q, pool and block table on the card: every slot maps its
    visible blocks onto a shuffled set of physical blocks and the rest of
    its row onto the trash block (index NB)."""
    dev = "cuda"
    g = torch.Generator().manual_seed(seed)
    H, L = Hk * G, bps * bs
    NB = S * bps + 3
    if visible is None:
        visible = [1, L] + [int(torch.randint(1, L + 1, (1,), generator=g))
                            for _ in range(S - 2)]
    perm = torch.randperm(NB, generator=g)
    bt = torch.full((S, bps), NB, dtype=torch.int32)
    used = 0
    for s in range(S):
        nblk = -(-visible[s] // bs)
        bt[s, :nblk] = perm[used:used + nblk].to(torch.int32)
        used += nblk
    shape = (NB + 1, bs, Hk, D)
    q = torch.randn((S, H, D), generator=g).to(dev, dtype)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g,
                           dtype=torch.int8).to(dev)
        vp = torch.randint(-127, 128, shape, generator=g,
                           dtype=torch.int8).to(dev)
        ks = (torch.rand((NB + 1, Hk), generator=g) * 0.02 + 0.001).to(dev)
        vs = (torch.rand((NB + 1, Hk), generator=g) * 0.02 + 0.001).to(dev)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        kp = torch.randn(shape, generator=g).to(dev, dtype)
        vp = torch.randn(shape, generator=g).to(dev, dtype)
        scales = {}
    vis = torch.tensor(visible, dtype=torch.int32).to(dev)
    return (q, kp, vp, bt.to(dev), vis, 1.0 / math.sqrt(D), window), scales


def phase_kernel(torch):
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    tol = {"float32": 1e-4, "int8": 1e-4, "bfloat16": 2e-2}
    worst = {}
    n_cases = 0
    for kind in ("float32", "bfloat16", "int8"):
        dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
        for G in (1, 2, 4):
            for window in (0, 64):
                for bs in (8, 16):
                    args, sc = paged_case(torch, 6, 2, G, 64, bs, 12, window,
                                          dtype, kind == "int8",
                                          seed=n_cases)
                    out = da.flash_decode_attention_paged(*args, **sc)
                    ref = da.decode_attention_dense_paged(*args, **sc)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    if not math.isfinite(err) or err > tol[kind]:
                        fail(f"kernel vs plain: {kind} G={G} window={window} "
                             f"bs={bs}: max abs err {err} > {tol[kind]}")
                    worst[kind] = max(worst.get(kind, 0.0), err)
                    n_cases += 1
    # the served shape: 8 slots at ~768 visible positions, bf16 pool
    S, Hk, G, D, bs, bps = MAX_SEQS, KV_HEADS, HEADS // KV_HEADS, \
        D_MODEL // HEADS, 16, MAX_LEN // 16
    visible = [768 - 3 * s for s in range(S)]
    args, _ = paged_case(torch, S, Hk, G, D, bs, bps, 0, torch.bfloat16,
                         False, seed=1234, visible=visible)
    out = da.flash_decode_attention_paged(*args)
    ref = da.decode_attention_dense_paged(*args)
    served_err = (out.float() - ref.float()).abs().max().item()
    if served_err > tol["bfloat16"]:
        fail(f"kernel vs plain at the served shape: {served_err}")
    # device time per call (CUDA-graph replay) and the eager call's time,
    # which the host's launch overhead dominates at this size
    ms = graph_ms(torch, lambda: da.flash_decode_attention_paged(*args))
    plain_ms = graph_ms(torch,
                        lambda: da.decode_attention_dense_paged(*args))
    kernel_only_ms = graph_ms(torch, lambda: da.flash_decode_partials(*args))
    eager_ms = time_ms(torch, lambda: da.flash_decode_attention_paged(*args))
    eager_plain_ms = time_ms(
        torch, lambda: da.decode_attention_dense_paged(*args), iters=50)
    # least work this call needs: q read, the visible K/V blocks read once,
    # block table + lengths read, output written; two matmul-shaped
    # contractions over the visible positions
    elt = 2
    blocks = sum(-(-v // bs) for v in visible)
    nbytes = (S * Hk * G * D * elt * 2 + blocks * bs * Hk * D * elt * 2
              + S * bps * 4 + S * 4)
    ops = 4 * sum(visible) * Hk * G * D
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S \
        else "operations"
    res = {"phase": "kernel", "cases": n_cases,
           "max_abs_err": {k: v for k, v in worst.items()},
           "tolerance": tol, "served_shape": {
               "S": S, "H": Hk * G, "Hk": Hk, "D": D, "bs": bs, "bps": bps,
               "visible": visible, "dtype": "bfloat16"},
           "served_max_abs_err": served_err, "ms": ms, "plain_ms": plain_ms,
           "kernel_only_ms": kernel_only_ms, "eager_ms": eager_ms,
           "eager_plain_ms": eager_plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "ops": ops}
    emit(res)
    return res


# ------------------------------------------------------------------- serve
def build_net(torch, dtype: str):
    from deeplearning4j_tpu_torch import (Activation, InputType,
                                          MultiLayerNetwork,
                                          NeuralNetConfiguration,
                                          RnnOutputLayer, SelfAttentionLayer,
                                          WeightInit)
    b = (NeuralNetConfiguration.Builder().seed(42)
         .weight_init(WeightInit.XAVIER).dtype(dtype).list())
    for _ in range(2):
        b.layer(SelfAttentionLayer(n_out=D_MODEL, n_heads=HEADS,
                                   n_kv_heads=KV_HEADS, causal=True,
                                   block_size=0))
    b.layer(RnnOutputLayer(n_out=VOCAB, activation=Activation.SOFTMAX))
    conf = b.set_input_type(InputType.recurrent(VOCAB)).build()
    # the weights are drawn in fp32 on a CPU generator, then cast, so the
    # bf16 and fp32 models hold the same values up to rounding
    return MultiLayerNetwork(conf, device="cuda").init(
        generator=torch.Generator().manual_seed(42))


def phase_serve(torch, np):
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine
    net = build_net(torch, "float32")
    eng = ServingEngine(net, max_seqs=MAX_SEQS, max_len=MAX_LEN,
                        dtype=torch.bfloat16, max_new_tokens_cap=NEW_TOKENS,
                        device="cuda")
    rng = np.random.RandomState(0)

    def prompt():
        return rng.randint(0, VOCAB, PROMPT).tolist()

    eng.generate([Request(prompt(),
                          max_new_tokens=max(2, 2 * eng.decode_chunk))])
    torch.cuda.synchronize()
    eng.metrics.reset()
    da.flash_decode_attention_paged.launches = 0      # main path starts
    t0 = time.perf_counter()
    futs = [eng.submit(Request(prompt(), max_new_tokens=NEW_TOKENS))
            for _ in range(WAVE)]
    midpoint = WAVE * (NEW_TOKENS // 2)
    while eng.tokens_out < midpoint and eng.step():
        pass
    futs += [eng.submit(Request(prompt(), max_new_tokens=NEW_TOKENS))
             for _ in range(WAVE)]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = da.flash_decode_attention_paged.launches   # main path ends
    results = [f.get(timeout=0) for f in futs]
    total = sum(len(r.tokens) for r in results)
    if total != MAX_SEQS * NEW_TOKENS:
        fail(f"served {total} tokens, expected {MAX_SEQS * NEW_TOKENS}")
    if launches <= 0:
        fail("the serve ran no flash_decode_attention_paged launch")
    bad = [r.tokens for r in results if any(not 0 <= t < VOCAB
                                            for t in r.tokens)]
    if bad:
        fail("generated token ids outside the vocabulary")
    st = eng.stats()
    res = {"phase": "serve", "tokens": total, "wall_s": wall,
           "tokens_per_s": total / wall,
           "host_syncs": st["host_syncs"],
           "host_syncs_per_token": st["host_syncs_per_token"],
           "mean_ttft_s": float(np.mean([r.ttft_s for r in results])),
           "decode_chunk": st["decode_chunk"],
           "resident_seqs_max": st["resident_seqs_max"],
           "flash_decode_launches": launches,
           "launches_per_token": launches / total}
    res["sync_free_chunk"] = sync_free_chunk(torch, eng, prompt())
    res["decode_profile"] = profile_decode(torch, eng, rng)
    emit(res)
    return res


def profile_decode(torch, eng, rng) -> dict:
    """Device busy share and the top kernels over a decode-dominated serve
    (8 requests of 32 prompt tokens and 64 new tokens), from torch.profiler;
    None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.serving import Request
    new = min(64, NEW_TOKENS)
    reqs = [Request(rng.randint(0, VOCAB, 32).tolist(), max_new_tokens=new)
            for _ in range(MAX_SEQS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        # device-side rows only: the aten op rows repeat their kernels' time
        if str(getattr(evt, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us:
            rows.append((us, evt.key, evt.count))
    busy_s = sum(r[0] for r in rows) / 1e6
    rows.sort(reverse=True)
    return {"wall_s": wall, "tokens": MAX_SEQS * new,
            "device_busy_s": busy_s if rows else None,
            "device_idle_share": 1 - busy_s / wall if rows else None,
            "top_device": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                           for us, k, n in rows[:8]]}


def sync_free_chunk(torch, eng, tokens) -> int:
    """Admit one request (syncs allowed), then dispatch one K-step decode
    chunk with CUDA sync debugging set to raise on any host sync."""
    from deeplearning4j_tpu_torch.serving import Request
    fut = eng.submit(Request(tokens, max_new_tokens=2 * eng.decode_chunk))
    with eng._lock:
        eng._admit()
        while eng._prefilling:
            eng._prefill_step()
        snapshot = {s: a for s, a in eng._by_slot.items()
                    if eng._active_mask[s]}
        active = eng._h2d(eng._active_mask)
        torch.cuda.synchronize()
        k = eng.decode_chunk
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, rb, _ = eng._dispatch(active, k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        eng.sampler.advance(k)
        got = rb.wait()
        eng._c_syncs.inc()
        eng._finish_steps(snapshot, got["entries"], got["final"], None,
                          hist=got["hist"])
    eng.drain()
    fut.get(timeout=60)
    return k


# ------------------------------------------------------------------ oracle
def phase_oracle(torch, np):
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine
    net = build_net(torch, "float32")
    eng = ServingEngine(net, max_seqs=2, max_len=MAX_LEN,
                        capture_logprobs=True, device="cuda")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, VOCAB, 128).tolist() for _ in range(2)]
    results = eng.generate([Request(p, max_new_tokens=64) for p in prompts])
    worst, rows = 0.0, 0
    for p, r in zip(prompts, results):
        full = list(p) + r.tokens
        x = torch.nn.functional.one_hot(torch.tensor(full), VOCAB).T[None]
        probs = net.output(x.float())[0]                      # (V, T)
        ref = torch.log(probs.clamp(min=1e-30)).cpu().numpy()
        if len(r.logprobs) != len(r.tokens):
            fail("captured logprob rows do not match generated tokens")
        for i, lp in enumerate(r.logprobs):
            worst = max(worst, float(np.abs(lp - ref[:, len(p) - 1 + i])
                                     .max()))
            rows += 1
    if not worst <= 2e-3:
        fail(f"cached decode vs full recompute: max abs err {worst} > 2e-3")
    res = {"phase": "oracle", "rows": rows, "max_abs_err": worst,
           "atol": 2e-3}
    emit(res)
    return res


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not os.path.isdir(os.path.join(REPO, "deeplearning4j_tpu_torch")):
        fail("deeplearning4j_tpu_torch is not beside chip_smoke.py")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    emit({"phase": "device", "name": name, "capability": list(cap),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi})
    if cap != (9, 0):
        fail(f"compute capability {cap}, expected (9, 0)")

    from deeplearning4j_tpu_torch.ops import build, decode_attention as da
    t0 = time.perf_counter()
    built = build.build([da.SOURCE])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {s: {"seconds": b["seconds"],
                          "ptxas": [ln.strip() for ln in b["log"].splitlines()
                                    if "registers" in ln or "smem" in ln]}
                      for s, b in built.items()}})

    kern = phase_kernel(torch)
    serve = phase_serve(torch, np)
    oracle = phase_oracle(torch, np)
    emit({"kernels": [{
        "name": "flash_decode_attention_paged", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/flash_decode_paged.cu",
        "replaces": "deeplearning4j_tpu/ops/decode_attention.py:281",
        "launches": serve["flash_decode_launches"],
        "max_abs_err": max(max(kern["max_abs_err"].values()),
                           kern["served_max_abs_err"]),
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None, "us_per_call": kern["ms"] * 1e3,
        "oracle_max_abs_err": oracle["max_abs_err"]}]})
    for line in smi:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
