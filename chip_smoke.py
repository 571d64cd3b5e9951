#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line; any failure exits non-zero:

1. device   - CUDA present with compute capability (9, 0).
2. build    - compile every CUDA kernel of the path from the checkout's
              sources (one nvcc per source, all started together).
3. kernel   - each kernel against its plain PyTorch version on the card,
              then timed at the served shape (device time by CUDA-graph
              replay, kernel alone and with the merge; the eager call; the
              plain version):
              K1 (paged decode): fp32, bf16, and an int8 pool with fp32
              and with bf16 queries; GQA groups 1/2/4; windows 0/64; block
              sizes 8/16; ragged visible lengths; shuffled block tables
              with trash entries; then the served shape with the bf16 pool
              and with the int8 pool (bf16 queries, as the serves run).
              K2 (multi-query paged decode, "kernel_spec"): the same sweep
              with Q = 2/3/5/9 queries per slot, and each row i of K2
              against K1 at visible + i on the same pool; then the served
              shape at Q = 2/3/5 with both pools.
              K6 (contiguous split-K decode, "kernel_contiguous"): fp32 and
              bf16, cache lengths whose partition is 256, 64 and 4 (below
              8), head dims 64 and 128 (the shared-memory cap); timed beside
              torch's scaled_dot_product_attention with a boolean mask
              (a yardstick only, never the route).
4. serve    - the bench_decode_serving model at full width (2 causal GQA
              attention layers, d_model 256, 4 heads, 2 kv heads, vocab 64,
              bf16, max_seqs 8, max_len 1024, KV block 16; random XAVIER
              weights from seed 42) served by ServingEngine: a warmup
              request, then 4 requests of 512 prompt tokens and 256 new
              tokens with 4 more submitted at the halfway mark. The kernel
              launch counts are zeroed just before and read just after; a
              new request then decodes 4 engine steps under
              torch.cuda.set_sync_debug_mode("error").
5. oracle   - the same model in fp32 with capture_logprobs: every captured
              row matches the full-recompute MultiLayerNetwork.output at its
              position within atol 2e-3.
6. decode_attention - the public contiguous-cache entry point
              serving.decode_attention (K6) driven over 64 growing cache
              lengths per layer at the served shape, counts zeroed before.
7. spec_serve - the same bf16 model with spec_decode=True, spec_draft=4,
              greedy: 8 requests of 512 prompt tokens, each a seeded 6-token
              motif tiled to length, 256 new tokens each; then the same
              prompts with spec off at K=1 and at the default chunking. K2
              must have launched and K1 not at all in the spec run; a new
              request then takes 4 spec steps, drafts verified, under
              torch.cuda.set_sync_debug_mode("error").
8. spec_oracle - the fp32 model with spec_decode=True and
              capture_logprobs: every captured row within atol 2e-3 of the
              full recompute, and the greedy stream equal to spec off
              (where they differ, the top-2 logprob gap there must be below
              1e-5, a tie).
9. int8_serve - kv_quant=True, quant_weights=True on the serve phase's
              model and traffic, and once more with spec_decode=True: tokens
              per second, KV bytes per token against the float pool, K1/K2
              launches, greedy agreement with the float serve; and on the
              oracle's prompts in fp32, max |logprob difference| against the
              float full recompute. Fails on a count mismatch or a
              non-finite row only (int8 exactness is held by the kernel
              phase and the CPU tests).

Then the kernels line (K1, K2, K6), the card's name and power limit as
nvidia-smi gives them, and finally {"ok": true, "device": {...}}. Exits
non-zero without a result when CUDA is not available or the package is not
beside this file.
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
SPEC_DRAFT, MOTIF = 4, 6


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
               visible=None, Q=None):
    """Random q, pool and block table on the card: every slot maps the
    blocks its queries can see onto a shuffled set of physical blocks and
    the rest of its row onto the trash block (index NB). Q None gives K1's
    q (S, H, D); a Q gives K2's q (S, Q, H, D), query i at visible + i."""
    dev = "cuda"
    g = torch.Generator().manual_seed(seed)
    H, L = Hk * G, bps * bs
    extra = 0 if Q is None else Q - 1
    NB = S * bps + 3
    if visible is None:
        visible = [1, L - extra] + [
            int(torch.randint(1, L - extra + 1, (1,), generator=g))
            for _ in range(S - 2)]
    perm = torch.randperm(NB, generator=g)
    bt = torch.full((S, bps), NB, dtype=torch.int32)
    used = 0
    for s in range(S):
        nblk = -(-(visible[s] + extra) // bs)
        bt[s, :nblk] = perm[used:used + nblk].to(torch.int32)
        used += nblk
    shape = (NB + 1, bs, Hk, D)
    qshape = (S, H, D) if Q is None else (S, Q, H, D)
    q = torch.randn(qshape, generator=g).to(dev, dtype)
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


# sweep kinds: (q dtype, pool int8?) and the tolerance against the plain
# version; the served int8 pool meets bf16 queries ("int8_bf16q")
SWEEP = {"float32": ("float32", False, 1e-4),
         "bfloat16": ("bfloat16", False, 2e-2),
         "int8": ("float32", True, 1e-4),
         "int8_bf16q": ("bfloat16", True, 2e-2)}


def served_shape():
    """(S, Hk, G, D, bs, bps, visible) of the serve: 8 slots at ~768
    visible positions."""
    return (MAX_SEQS, KV_HEADS, HEADS // KV_HEADS, D_MODEL // HEADS, 16,
            MAX_LEN // 16, [MAX_LEN * 3 // 4 - 3 * s for s in range(MAX_SEQS)])


def phase_kernel(torch):
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    tol = {k: t for k, (_, _, t) in SWEEP.items()}
    worst = {}
    n_cases = 0
    for kind, (qt, quant, _) in SWEEP.items():
        dtype = getattr(torch, qt)
        for G in (1, 2, 4):
            for window in (0, 64):
                for bs in (8, 16):
                    args, sc = paged_case(torch, 6, 2, G, 64, bs, 12, window,
                                          dtype, quant, seed=n_cases)
                    out = da.flash_decode_attention_paged(*args, **sc)
                    ref = da.decode_attention_dense_paged(*args, **sc)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    if not math.isfinite(err) or err > tol[kind]:
                        fail(f"kernel vs plain: {kind} G={G} window={window} "
                             f"bs={bs}: max abs err {err} > {tol[kind]}")
                    worst[kind] = max(worst.get(kind, 0.0), err)
                    n_cases += 1
    # the served shape, with the bf16 pool of the float serve and the int8
    # pool of the int8 serve, bf16 queries both
    S, Hk, G, D, bs, bps, visible = served_shape()
    served = {}
    for kind in ("bfloat16", "int8_bf16q"):
        a, sc = paged_case(torch, S, Hk, G, D, bs, bps, 0, torch.bfloat16,
                           SWEEP[kind][1], seed=1234, visible=visible)
        out = da.flash_decode_attention_paged(*a, **sc)
        ref = da.decode_attention_dense_paged(*a, **sc)
        served[kind] = (out.float() - ref.float()).abs().max().item()
        if not served[kind] <= tol[kind]:
            fail(f"kernel vs plain at the served shape, {kind}: "
                 f"{served[kind]} > {tol[kind]}")
        if kind == "bfloat16":
            args = a
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
           "served_max_abs_err": served, "ms": ms, "plain_ms": plain_ms,
           "kernel_only_ms": kernel_only_ms, "eager_ms": eager_ms,
           "eager_plain_ms": eager_plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "ops": ops}
    emit(res)
    return res


def spec_bound(S, Q, Hk, G, D, bs, bps, visible, elt):
    """Least work of one K2 call: q read, the K/V blocks any query can see
    read once, block table + lengths read, output written; QK and PV over
    every (query, visible position)."""
    blocks = sum(-(-(v + Q - 1) // bs) for v in visible)
    nbytes = (S * Q * Hk * G * D * elt * 2 + blocks * bs * Hk * D * elt * 2
              + S * bps * 4 + S * 4)
    ops = 4 * sum(v + i for v in visible for i in range(Q)) * Hk * G * D
    return nbytes, ops


def bound_of(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_spec(torch):
    """K2 against its plain version over the sweep, each row i against K1
    at visible + i, then timed at the served shape of the spec serve."""
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    tol = {k: t for k, (_, _, t) in SWEEP.items()}
    worst, worst_row = {}, {}
    n_cases = 0
    for kind, (qt, quant, _) in SWEEP.items():
        dtype = getattr(torch, qt)
        for Q in (2, 3, 5, 9):
            for G in (1, 2, 4):
                for window in (0, 64):
                    for bs in (8, 16):
                        args, sc = paged_case(torch, 6, 2, G, 64, bs, 12,
                                              window, dtype, quant,
                                              seed=5000 + n_cases, Q=Q)
                        out = da.flash_decode_attention_spec_paged(*args,
                                                                   **sc)
                        ref = da.decode_attention_dense_spec_paged(*args,
                                                                   **sc)
                        q, kp, vp, bt, vis, scale, w = args
                        rows = torch.stack([da.flash_decode_attention_paged(
                            q[:, i], kp, vp, bt, vis + i, scale, w, **sc)
                            for i in range(Q)], dim=1)
                        torch.cuda.synchronize()
                        err = (out.float() - ref.float()).abs().max().item()
                        row_err = (out.float() - rows.float()).abs().max() \
                            .item()
                        if not math.isfinite(err) or err > tol[kind] \
                                or not row_err <= tol[kind]:
                            fail(f"K2 vs plain / vs K1 rows: {kind} Q={Q} "
                                 f"G={G} window={window} bs={bs}: max abs "
                                 f"err {err}, {row_err} > {tol[kind]}")
                        worst[kind] = max(worst.get(kind, 0.0), err)
                        worst_row[kind] = max(worst_row.get(kind, 0.0),
                                              row_err)
                        n_cases += 1
    # the served shape at every Q the spec serve runs with spec_draft 4
    # (2, 3, 5), with the bf16 pool and the int8 pool, bf16 queries both;
    # timed at Q = 5 on the bf16 pool, and by Q beside it
    S, Hk, G, D, bs, bps, visible = served_shape()
    served, ms_by_q = {}, {}
    for Q in (2, 3, SPEC_DRAFT + 1):
        for kind in ("bfloat16", "int8_bf16q"):
            a, sc = paged_case(torch, S, Hk, G, D, bs, bps, 0,
                               torch.bfloat16, SWEEP[kind][1],
                               seed=4321 + Q, visible=visible, Q=Q)
            out = da.flash_decode_attention_spec_paged(*a, **sc)
            ref = da.decode_attention_dense_spec_paged(*a, **sc)
            err = (out.float() - ref.float()).abs().max().item()
            served[f"{kind}_Q{Q}"] = err
            if not err <= tol[kind]:
                fail(f"K2 vs plain at the served shape, {kind} Q={Q}: "
                     f"{err} > {tol[kind]}")
            if kind == "bfloat16":
                args = a
                ms_by_q[Q] = graph_ms(
                    torch, lambda: da.flash_decode_attention_spec_paged(*a))
    Q = SPEC_DRAFT + 1                 # args: the bf16 pool at this Q
    ms = ms_by_q[Q]
    plain_ms = graph_ms(torch,
                        lambda: da.decode_attention_dense_spec_paged(*args))
    kernel_only_ms = graph_ms(torch,
                              lambda: da.flash_decode_spec_partials(*args))
    eager_ms = time_ms(torch,
                       lambda: da.flash_decode_attention_spec_paged(*args))
    # K1 at the same pool, Q times: what verifying Q positions would cost
    # without the multi-query kernel
    q, kp, vp, bt, vis, scale, w = args
    k1_times_q_ms = graph_ms(torch, lambda: [
        da.flash_decode_attention_paged(q[:, i], kp, vp, bt, vis + i, scale,
                                        w) for i in range(Q)])
    nbytes, ops = spec_bound(S, Q, Hk, G, D, bs, bps, visible, 2)
    bound_ms, bound_by = bound_of(nbytes, ops)
    res = {"phase": "kernel_spec", "cases": n_cases,
           "max_abs_err": worst, "max_abs_err_vs_k1_rows": worst_row,
           "tolerance": tol, "served_shape": {
               "S": S, "Q": Q, "H": Hk * G, "Hk": Hk, "D": D, "bs": bs,
               "bps": bps, "visible": visible, "dtype": "bfloat16"},
           "served_max_abs_err": served, "ms": ms, "ms_by_q": ms_by_q,
           "plain_ms": plain_ms, "kernel_only_ms": kernel_only_ms,
           "eager_ms": eager_ms, "k1_times_q_ms": k1_times_q_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    emit(res)
    return res


def contiguous_case(torch, S, L, Hk, G, D, dtype, seed, visible=None):
    g = torch.Generator().manual_seed(seed)
    if visible is None:
        visible = [1, L] + [int(torch.randint(1, L + 1, (1,), generator=g))
                            for _ in range(S - 2)]
    q = torch.randn((S, Hk * G, D), generator=g).to("cuda", dtype)
    kc = torch.randn((S, L, Hk, D), generator=g).to("cuda", dtype)
    vc = torch.randn((S, L, Hk, D), generator=g).to("cuda", dtype)
    vis = torch.tensor(visible, dtype=torch.int32, device="cuda")
    return q, kc, vc, vis, 1.0 / math.sqrt(D)


def sdpa_call(torch, q, kc, vc, vis, scale):
    """torch's fused attention on the same contiguous cache: the library
    yardstick of K6 (boolean mask of the visible positions, grouped kv
    heads)."""
    S, H, D = q.shape
    L = kc.shape[1]
    mask = (torch.arange(L, device=q.device)[None, :]
            < vis[:, None])[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3),
        attn_mask=mask, scale=scale, enable_gqa=True)
    return out[:, :, 0, :]


def phase_kernel_contiguous(torch):
    """K6 against its plain version, then timed at the served shape beside
    scaled_dot_product_attention."""
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    worst, n_cases, plans = {}, 0, {}
    for kind in ("float32", "bfloat16"):
        dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
        for L, D in ((1024, 64), (320, 64), (300, 64), (1024, 128)):
            for G in (1, 2, 4):
                for window in (0, 64):
                    q, kc, vc, vis, scale = contiguous_case(
                        torch, 4, L, 2, G, D, dtype, seed=7000 + n_cases)
                    out = da.flash_decode_attention(q, kc, vc, vis, scale,
                                                    window)
                    ref = da.decode_attention_dense(q, kc, vc, vis, scale,
                                                    window)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    if not math.isfinite(err) or err > tol[kind]:
                        fail(f"K6 vs plain: {kind} L={L} D={D} G={G} "
                             f"window={window}: max abs err {err}")
                    worst[kind] = max(worst.get(kind, 0.0), err)
                    plans[f"L{L}_D{D}_G{G}"] = da.kernel_bkv(L, G, D)
                    n_cases += 1
    S, Hk, G, D, L = MAX_SEQS, KV_HEADS, HEADS // KV_HEADS, \
        D_MODEL // HEADS, MAX_LEN
    visible = [MAX_LEN * 3 // 4 - 3 * s for s in range(S)]
    q, kc, vc, vis, scale = contiguous_case(torch, S, L, Hk, G, D,
                                            torch.bfloat16, seed=99,
                                            visible=visible)
    out = da.flash_decode_attention(q, kc, vc, vis, scale)
    ref = da.decode_attention_dense(q, kc, vc, vis, scale)
    lib = sdpa_call(torch, q, kc, vc, vis, scale)
    served_err = (out.float() - ref.float()).abs().max().item()
    lib_err = (lib.float() - ref.float()).abs().max().item()
    if not served_err <= tol["bfloat16"]:
        fail(f"K6 vs plain at the served shape: {served_err}")
    ms = graph_ms(torch, lambda: da.flash_decode_attention(q, kc, vc, vis,
                                                           scale))
    plain_ms = graph_ms(torch, lambda: da.decode_attention_dense(
        q, kc, vc, vis, scale))
    partials = da.flash_decode_contiguous_partials
    kernel_only_ms = graph_ms(torch, lambda: partials(q, kc, vc, vis, scale))
    library_ms = graph_ms(torch, lambda: sdpa_call(torch, q, kc, vc, vis,
                                                   scale))
    eager_ms = time_ms(torch, lambda: da.flash_decode_attention(
        q, kc, vc, vis, scale))
    # least work: q read, the visible K/V positions read once, lengths
    # read, output written; QK and PV over the visible positions
    elt = 2
    nbytes = (S * Hk * G * D * elt * 2 + sum(visible) * Hk * D * elt * 2
              + S * 4)
    ops = 4 * sum(visible) * Hk * G * D
    bound_ms, bound_by = bound_of(nbytes, ops)
    res = {"phase": "kernel_contiguous", "cases": n_cases,
           "max_abs_err": worst, "tolerance": tol, "bkv_plans": plans,
           "served_shape": {"S": S, "L": L, "H": Hk * G, "Hk": Hk, "D": D,
                            "bkv": da.kernel_bkv(L, G, D),
                            "visible": visible, "dtype": "bfloat16"},
           "served_max_abs_err": served_err,
           "library_max_abs_err": lib_err, "ms": ms, "plain_ms": plain_ms,
           "kernel_only_ms": kernel_only_ms,
           "library_ms": library_ms, "eager_ms": eager_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    emit(res)
    return res


def phase_decode_attention(torch):
    """The public contiguous-cache entry point, serving.decode_attention:
    64 decode steps of both layers' shapes at the served width, the cache
    growing by one position a step, counts zeroed before and read after;
    the last step is held against the plain version."""
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    from deeplearning4j_tpu_torch.serving import decode_attention
    S, Hk, G, D, L = MAX_SEQS, KV_HEADS, HEADS // KV_HEADS, \
        D_MODEL // HEADS, MAX_LEN
    q, kc, vc, vis, scale = contiguous_case(
        torch, S, L, Hk, G, D, torch.bfloat16, seed=77,
        visible=[PROMPT - 5 * s for s in range(S)])
    torch.cuda.synchronize()
    da.flash_decode_attention.launches = 0             # main path starts
    for step in range(64):
        for _layer in range(2):
            out = decode_attention(q, kc, vc, vis + step, scale)
    torch.cuda.synchronize()
    launches = da.flash_decode_attention.launches      # main path ends
    ref = da.decode_attention_dense(q, kc, vc, vis + 63, scale)
    err = (out.float() - ref.float()).abs().max().item()
    if launches <= 0 or not err <= 2e-2:
        fail(f"serving.decode_attention: {launches} launches, err {err}")
    res = {"phase": "decode_attention", "calls": 128, "launches": launches,
           "max_abs_err": err}
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


KERNEL_WRAPPERS = ("flash_decode_attention_paged",
                   "flash_decode_attention_spec_paged",
                   "flash_decode_attention")


def reset_launches() -> None:
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    for name in KERNEL_WRAPPERS:
        getattr(da, name).launches = 0


def read_launches() -> dict:
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    return {name: getattr(da, name).launches for name in KERNEL_WRAPPERS}


def new_engine(torch, net, **kw):
    from deeplearning4j_tpu_torch.serving import ServingEngine
    return ServingEngine(net, max_seqs=MAX_SEQS, max_len=MAX_LEN,
                         dtype=torch.bfloat16, max_new_tokens_cap=NEW_TOKENS,
                         device="cuda", **kw)


def serve_traffic(torch, np, eng):
    """The serve phase's traffic: a warmup request, then WAVE requests of
    PROMPT random tokens and NEW_TOKENS new tokens, WAVE more submitted at
    the halfway mark. Kernel launch counts are zeroed just before and read
    just after. Returns (results, wall seconds, launches, rng)."""
    from deeplearning4j_tpu_torch.serving import Request
    rng = np.random.RandomState(0)

    def prompt():
        return rng.randint(0, VOCAB, PROMPT).tolist()

    eng.generate([Request(prompt(),
                          max_new_tokens=max(2, 2 * eng.decode_chunk))])
    torch.cuda.synchronize()
    eng.metrics.reset()
    reset_launches()                                   # main path starts
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
    launches = read_launches()                         # main path ends
    results = [f.get(timeout=0) for f in futs]
    check_results(results, MAX_SEQS * NEW_TOKENS, eng)
    return results, wall, launches, rng


def check_results(results, expected: int, eng) -> None:
    total = sum(len(r.tokens) for r in results)
    if total != expected:
        fail(f"served {total} tokens, expected {expected}")
    if any(not 0 <= t < VOCAB for r in results for t in r.tokens):
        fail("generated token ids outside the vocabulary")
    if eng.stats()["nonfinite_chunks"]:
        fail("a decode step produced non-finite logprobs")


def phase_serve(torch, np):
    net = build_net(torch, "float32")
    eng = new_engine(torch, net)
    results, wall, launches, rng = serve_traffic(torch, np, eng)
    total = sum(len(r.tokens) for r in results)
    k1 = launches["flash_decode_attention_paged"]
    if k1 <= 0:
        fail("the serve ran no flash_decode_attention_paged launch")
    st = eng.stats()
    res = {"phase": "serve", "tokens": total, "wall_s": wall,
           "tokens_per_s": total / wall,
           "host_syncs": st["host_syncs"],
           "host_syncs_per_token": st["host_syncs_per_token"],
           "mean_ttft_s": float(np.mean([r.ttft_s for r in results])),
           "decode_chunk": st["decode_chunk"],
           "resident_seqs_max": st["resident_seqs_max"],
           "flash_decode_launches": k1, "launches": launches,
           "launches_per_token": k1 / total,
           "kv_bytes_per_token": eng.decoder.cache.bytes_per_position}
    res["sync_free_steps"] = sync_free_steps(
        torch, eng, rng.randint(0, VOCAB, 64).tolist())
    res["decode_profile"] = profile_decode(torch, eng, rng)
    emit(res)
    res["streams"] = [r.tokens for r in results]
    return res


def motif_prompts(np, n: int, length: int, seed: int):
    """Repetitive prompts: a seeded 6-token motif tiled to `length` (the
    recipe of bench.py's speculative-decoding A/B), one motif each."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, VOCAB, MOTIF).tolist() * length)[:length]
            for _ in range(n)]


def phase_spec_serve(torch, np):
    """Speculative decoding at full width, bf16, greedy, against the same
    prompts with spec off (K=1, and the default chunked, overlapped drain)
    in the same call."""
    from deeplearning4j_tpu_torch.serving import Request
    net = build_net(torch, "float32")
    prompts = motif_prompts(np, MAX_SEQS, PROMPT, seed=2)

    def run(**kw):
        eng = new_engine(torch, net, **kw)
        eng.generate([Request(prompts[0][:64], max_new_tokens=16)])
        torch.cuda.synchronize()
        eng.metrics.reset()
        reset_launches()                               # main path starts
        t0 = time.perf_counter()
        results = eng.generate([Request(p, max_new_tokens=NEW_TOKENS)
                                for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()                     # main path ends
        check_results(results, MAX_SEQS * NEW_TOKENS, eng)
        st = eng.stats()
        return eng, [r.tokens for r in results], {
            "tokens_per_s": MAX_SEQS * NEW_TOKENS / wall, "wall_s": wall,
            "host_syncs": st["host_syncs"],
            "host_syncs_per_token": st["host_syncs_per_token"],
            "mean_ttft_s": float(np.mean([r.ttft_s for r in results])),
            "launches": launches}

    eng_on, on, res_on = run(spec_decode=True, spec_draft=SPEC_DRAFT)
    eng_off1, off1, res_off1 = run(decode_chunk=1, overlap=False)
    _, off8, res_off8 = run()
    k1 = res_on["launches"]["flash_decode_attention_paged"]
    k2 = res_on["launches"]["flash_decode_attention_spec_paged"]
    if k2 <= 0 or k1 != 0:
        fail(f"spec serve: K2 launches {k2} (must be > 0), K1 launches {k1} "
             "(must be 0: every decode step verifies through K2)")
    st = eng_on.stats()
    draft_len = eng_on.metrics.get("serving.spec_draft_len")
    res = {"phase": "spec_serve", "tokens": MAX_SEQS * NEW_TOKENS,
           "spec_steps": k2 // len(eng_on.decoder.attn_idx),
           "slot_steps_with_draft": draft_len.count,
           "mean_draft_len": draft_len.sum / max(1, draft_len.count),
           "spec_draft": SPEC_DRAFT, "spec": res_on,
           "spec_off_k1": res_off1, "spec_off_default": res_off8,
           "spec_accept_rate": st["spec_accept_rate"],
           "spec_tokens_accepted": st["spec_tokens_accepted"],
           "spec_tokens_rejected": st["spec_tokens_rejected"],
           "k2_launches": k2, "k1_launches": k1,
           "requests_identical_to_spec_off_k1": sum(
               a == b for a, b in zip(on, off1)),
           "requests_identical_to_spec_off_default": sum(
               a == b for a, b in zip(on, off8)),
           "speedup_vs_k1": res_on["tokens_per_s"] / res_off1["tokens_per_s"],
           "speedup_vs_default": res_on["tokens_per_s"]
           / res_off8["tokens_per_s"]}
    res["sync_free_steps"] = sync_free_steps(
        torch, eng_on, motif_prompts(np, 1, 64, seed=9)[0])

    def make_prompt(rng):
        return motif_prompts(np, 1, 32, int(rng.randint(1 << 30)))[0]
    res["decode_profile"] = profile_decode(
        torch, eng_on, np.random.RandomState(5), make_prompt)
    res["decode_profile_spec_off_k1"] = profile_decode(
        torch, eng_off1, np.random.RandomState(5), make_prompt)
    emit(res)
    return res


def first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def oracle_rows(torch, np, net, prompt, result):
    """Max abs difference of a result's captured rows from the full
    recompute of `net` at the same positions."""
    full = list(prompt) + result.tokens
    x = torch.nn.functional.one_hot(torch.tensor(full), VOCAB).T[None]
    probs = net.output(x.float())[0]                          # (V, T)
    ref = torch.log(probs.clamp(min=1e-30)).cpu().numpy()
    if len(result.logprobs) != len(result.tokens):
        fail("captured logprob rows do not match generated tokens")
    worst = 0.0
    for i, lp in enumerate(result.logprobs):
        if not np.isfinite(lp).all():
            fail("a captured logprob row is not finite")
        worst = max(worst, float(np.abs(lp - ref[:, len(prompt) - 1 + i])
                                 .max()))
    return worst


def phase_spec_oracle(torch, np):
    """fp32 spec decode with capture_logprobs against the full recompute,
    and its greedy stream against spec off."""
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine
    net = build_net(torch, "float32")
    prompts = motif_prompts(np, 4, 128, seed=3)
    runs = {}
    for spec in (True, False):
        eng = ServingEngine(net, max_seqs=4, max_len=MAX_LEN,
                            capture_logprobs=True, spec_decode=spec,
                            spec_draft=SPEC_DRAFT, device="cuda")
        runs[spec] = (eng, eng.generate([Request(p, max_new_tokens=64)
                                         for p in prompts]))
    worst, rows, diverged = 0.0, 0, []
    for p, r_on, r_off in zip(prompts, runs[True][1], runs[False][1]):
        worst = max(worst, oracle_rows(torch, np, net, p, r_on))
        rows += len(r_on.logprobs)
        d = first_divergence(r_on.tokens, r_off.tokens)
        if d is not None:
            top2 = np.sort(r_off.logprobs[d])[-2:]
            gap = float(top2[1] - top2[0])
            diverged.append({"position": d, "top2_gap": gap})
            if not gap < 1e-5:
                fail(f"spec stream diverges from spec off at generated "
                     f"token {d} with a top-2 logprob gap of {gap} (not a "
                     "tie)")
    if not worst <= 2e-3:
        fail(f"spec decode vs full recompute: max abs err {worst} > 2e-3")
    st = runs[True][0].stats()
    res = {"phase": "spec_oracle", "rows": rows, "max_abs_err": worst,
           "atol": 2e-3, "divergences": diverged,
           "spec_tokens_accepted": st["spec_tokens_accepted"],
           "spec_accept_rate": st["spec_accept_rate"]}
    emit(res)
    return res


def phase_int8_serve(torch, np, serve):
    """kv_quant + quant_weights on the serve phase's model and traffic,
    then with spec decode added; and the int8 accuracy on the oracle's
    prompts in fp32."""
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine
    net = build_net(torch, "float32")
    float_bpt = serve["kv_bytes_per_token"]
    out = {"phase": "int8_serve", "float_kv_bytes_per_token": float_bpt}
    for name, kw in (("int8", {}),
                     ("int8_spec", {"spec_decode": True,
                                    "spec_draft": SPEC_DRAFT})):
        eng = new_engine(torch, net, kv_quant=True, quant_weights=True, **kw)
        results, wall, launches, _ = serve_traffic(torch, np, eng)
        cache = eng.decoder.cache
        bpt = cache.bytes_per_position \
            + cache.block_overhead_bytes / cache.block_size
        agree = [first_divergence(r.tokens, f) for r, f in
                 zip(results, serve["streams"])]
        st = eng.stats()
        out[name] = {
            "tokens_per_s": MAX_SEQS * NEW_TOKENS / wall, "wall_s": wall,
            "host_syncs_per_token": st["host_syncs_per_token"],
            "kv_bytes_per_token": bpt, "kv_ratio_vs_float": bpt / float_bpt,
            "launches": launches,
            "requests_identical_to_float": sum(d is None for d in agree),
            "mean_agreeing_prefix": float(np.mean(
                [NEW_TOKENS if d is None else d for d in agree])),
            "spec_accept_rate": st["spec_accept_rate"]}
    eng = ServingEngine(net, max_seqs=2, max_len=MAX_LEN,
                        capture_logprobs=True, kv_quant=True,
                        quant_weights=True, device="cuda")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, VOCAB, 128).tolist() for _ in range(2)]
    results = eng.generate([Request(p, max_new_tokens=64) for p in prompts])
    check_results(results, 128, eng)
    out["fp32_max_abs_logprob_diff_vs_float_recompute"] = max(
        oracle_rows(torch, np, net, p, r) for p, r in zip(prompts, results))
    emit(out)
    return out


def profile_decode(torch, eng, rng, make_prompt=None) -> dict:
    """Device busy share and the top kernels over a decode-dominated serve
    (8 requests of 32 prompt tokens and 64 new tokens, random unless
    `make_prompt` draws them), from torch.profiler; None where the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.serving import Request
    new = min(64, NEW_TOKENS)
    if make_prompt is None:
        def make_prompt(r):
            return r.randint(0, VOCAB, 32).tolist()
    reqs = [Request(make_prompt(rng), max_new_tokens=new)
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
    # device operations (kernels and copies) the host issued, per token:
    # what a host-bound serve pays for
    n_ops = sum(r[2] for r in rows)
    rows.sort(reverse=True)
    return {"wall_s": wall, "tokens": MAX_SEQS * new,
            "device_ops": n_ops, "device_ops_per_token":
            n_ops / (MAX_SEQS * new),
            "device_busy_s": busy_s if rows else None,
            "device_idle_share": 1 - busy_s / wall if rows else None,
            "top_device": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                           for us, k, n in rows[:8]]}


def sync_free_steps(torch, eng, tokens, steps: int = 4) -> dict:
    """Submit one request of `tokens` (shorter than a prefill chunk) and
    run the step that admits and prefills it (syncs allowed), then `steps`
    scheduler steps with CUDA sync debugging set to raise on any host sync:
    only the step's readback, a wait on its CUDA event, may block. The
    request's budget keeps it from retiring inside them. Returns the tokens
    those steps generated and, on a spec engine, how many slot-steps
    verified a draft; fails if they generated nothing or, with spec, never
    verified a draft."""
    from deeplearning4j_tpu_torch.serving import Request
    fut = eng.submit(Request(tokens, max_new_tokens=NEW_TOKENS))
    eng.step()
    drafts = eng.metrics.get("serving.spec_draft_len") \
        if eng.spec_decode else None
    n0, d0 = eng.tokens_out, drafts.count if drafts else 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(steps):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = {"steps": steps, "tokens": eng.tokens_out - n0}
    if drafts:
        out["draft_steps"] = drafts.count - d0
    eng.drain()
    fut.get(timeout=60)
    if out["tokens"] <= 0 or out.get("draft_steps", 1) <= 0:
        fail(f"the sync-free steps generated {out}")
    return out


# ------------------------------------------------------------------ oracle
def phase_oracle(torch, np):
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine
    net = build_net(torch, "float32")
    eng = ServingEngine(net, max_seqs=2, max_len=MAX_LEN,
                        capture_logprobs=True, device="cuda")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, VOCAB, 128).tolist() for _ in range(2)]
    results = eng.generate([Request(p, max_new_tokens=64) for p in prompts])
    worst = max(oracle_rows(torch, np, net, p, r)
                for p, r in zip(prompts, results))
    rows = sum(len(r.logprobs) for r in results)
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
    # K1, K2 and K6 are one source: the Q-query kernel, K6 on its view
    built = build.build(sorted({da.SOURCE}))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": list(KERNEL_WRAPPERS),
          "sources": {s: {"seconds": b["seconds"],
                          "ptxas": [ln.strip() for ln in b["log"].splitlines()
                                    if "registers" in ln or "smem" in ln]}
                      for s, b in built.items()}})

    kern = phase_kernel(torch)
    kspec = phase_kernel_spec(torch)
    kcont = phase_kernel_contiguous(torch)
    serve = phase_serve(torch, np)
    oracle = phase_oracle(torch, np)
    dattn = phase_decode_attention(torch)
    spec = phase_spec_serve(torch, np)
    spec_oracle = phase_spec_oracle(torch, np)
    phase_int8_serve(torch, np, serve)
    src = "deeplearning4j_tpu_torch/ops/csrc/flash_decode_paged.cu"
    emit({"kernels": [{
        "name": "flash_decode_attention_paged", "route": "cuda",
        "source": src,
        "replaces": "deeplearning4j_tpu/ops/decode_attention.py:281",
        "launches": serve["flash_decode_launches"],
        "max_abs_err": max(max(kern["max_abs_err"].values()),
                           max(kern["served_max_abs_err"].values())),
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None, "kernel_only_ms": kern["kernel_only_ms"],
        "oracle_max_abs_err": oracle["max_abs_err"]}, {
        "name": "flash_decode_attention_spec_paged", "route": "cuda",
        "source": src,
        "replaces": "deeplearning4j_tpu/ops/decode_attention.py:480",
        "launches": spec["k2_launches"],
        "max_abs_err": max(max(kspec["max_abs_err"].values()),
                           max(kspec["served_max_abs_err"].values())),
        "ms": kspec["ms"], "plain_ms": kspec["plain_ms"],
        "bound_ms": kspec["bound_ms"], "bound_by": kspec["bound_by"],
        "library_ms": None, "kernel_only_ms": kspec["kernel_only_ms"],
        "oracle_max_abs_err": spec_oracle["max_abs_err"]}, {
        "name": "flash_decode_attention", "route": "cuda",
        "source": src,
        "replaces": "deeplearning4j_tpu/ops/decode_attention.py:180",
        "launches": dattn["launches"],
        "max_abs_err": max(max(kcont["max_abs_err"].values()),
                           kcont["served_max_abs_err"]),
        "ms": kcont["ms"], "plain_ms": kcont["plain_ms"],
        "bound_ms": kcont["bound_ms"], "bound_by": kcont["bound_by"],
        "library_ms": kcont["library_ms"],
        "kernel_only_ms": kcont["kernel_only_ms"]}]})
    for line in smi:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
