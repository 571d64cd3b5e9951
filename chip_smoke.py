#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line; any failure exits non-zero:

1. device   - CUDA present with compute capability (9, 0).
2. build    - compile every CUDA kernel of the paths from the checkout's
              sources (one nvcc per source, all started together). For
              each wgmma kernel of flash_attention_sm90.cu (K3 and K5's dq
              pass at head dims 16 to 256, K5's dk/dv pass and K4 at
              16/32/64/128, the wide dk/dv pass and K4's wide instance at
              192/256): registers, spill bytes and static shared memory from
              the -Xptxas -v log, its dynamic shared memory, and the HGMMA,
              UTMALDG, atomic and reduction (RED*, UBLKRED, UTMAREDG)
              instructions in the SASS (cuobjdump -sass); fails if a kernel
              has no HGMMA or no UTMALDG, has an atomic, has a reduction (K3,
              K5) or none (K4, whose dq reductions, all UTMAREDG, are the only
              ones allowed), or spills at D 64. The same for K10's bf16 kernel
              at each load path, K7's cluster forward and cluster backward
              sweep at H 64/128/256 and K7's bf16 dRW kernel, with their
              UTMASTG, UBLKCP, cluster-barrier, LDGSTS and STAS (st.async)
              counts and the clusters the card holds at once; fails on no
              HGMMA, an atomic or a reduction, or a spill at a main-path
              shape (K7 at H 256, the dRW kernel). And K1/K2's twelve
              instances (q dtype x pool dtype x 16-byte rows): registers,
              spills, HMMA, LDSM, LDGSTS, atomics and reductions; fails when
              a tensor-core instance has no HMMA, a 16-byte-row instance no
              LDGSTS, an instance no atomic (its ticket) or a reduction, or
              a served instance spills.
2a. kernel_conv1x1 - K10 (the 1x1 conv with per-channel sums) against its
              plain version: fp32 and bf16, B 1/3/256, channels drawn from
              {8, 64, 256, 1024, 2048}, P 1/16/49/81/196/200/784, one case
              with channel means far above their spread; y against the
              plain version in the same dtype, the sums against the fp64
              plain sums; every bf16 load path of x must have run (TMA at
              P 784/200/16, cp.async at P 196, bulk copies of whole images
              at P 49/1, 2-byte loads at P 81);
              conv1x1_bn_act through K10 at stride 1 and 2
              against the unfused plain composition in fp64. Then each
              distinct ResNet50 shape at b256 in bf16 timed by CUDA events
              and by CUDA-graph replay beside the plain version and
              torch.matmul(w, x3) (cuBLAS, the product without the sums: a
              yardstick only), with its bound and load path; per-step sums
              over the 36 calls.
2b. train_resnet50 - zoo ResNet50 as the JAX bench trains it (bench.py
              bench_resnet50: 224x224x3, 1000 classes, batch 256, bf16
              compute over fp32 params, RmsProp(0.1, 0.96), l1 1e-7, l2
              5e-5, N(0, 0.5) init, seed 42, _synth data with
              RandomState(0)) through ComputationGraph:
              fit_on_device(steps=5, sync=False) after a warm step
              (images/s, ms/step, peak memory, model FLOPs from the layer
              shapes and their share of 989 TFLOP/s; exactly 36 K10
              launches a step), two fit(x, y) steps (36 each), output()
              (none); every loss finite; a profile of two steps.
2c. resnet_oracle - ResNet50 at full width, batch 8: gradient_and_score
              through K10 in fp32 and in bf16 compute, and the unfused
              route (no K10) in each, held against the unfused route in
              fp64 on the card: loss within 1e-5 (fp32); the gradient's
              norm-wise and median per-tensor errors within twice the
              unfused route's in the same dtype (at this init a 2^-24
              perturbation of the input moves single fp64 gradients by
              per cents, reported beside them).
2d. kernel_threshold - K11 (threshold encoding with a residual) against
              its plain version, bit for bit (NaN by its bit pattern):
              fp32, bf16 and fp64, n 1/127/128/1000/4097/2^20+3 and
              25,583,592 (the flat ResNet50 gradient), t 1e-3/1e-5/0.37,
              residual zero and non-zero, per dtype a case with entries at
              +-t, one ulp either side, NaN, +-inf and -0.0, and lists of
              views at offsets that leave the update and the residual
              aligned alike or not (the 16-byte path with scalar heads, and
              the scalar path); every message in {-t, 0, t}; n 0 launches
              nothing. Then fp32 timed by CUDA events: the flat gradient,
              and a step's encode of ResNet50's 214 parameter tensors
              (views into one flat buffer) as one list call and as 214
              one-tensor calls (host loop, and by CUDA-graph replay), both
              bit for bit equal to the plain version, beside it and the
              bound.
2e. train_parallel_resnet50 - the JAX bench's config 5 (bench.py
              bench_parallel_wrapper): the ResNet50 of 2b through
              ParallelWrapper on make_mesh(1) in SHARED_GRADIENTS with
              threshold 1e-3: fit_on_device(steps=5, sync=False) after a
              warm step (images/s, ms/step and its ratio to 2b's, peak
              memory, the share of elements sent in a captured step;
              exactly one K11 launch (over the 214 parameter tensors)
              and 36 K10 launches a step; a profile of two steps); two
              fit(x, y)
              steps in AVERAGING (no K11), two in CUSTOM with
              EncodedGradientsAccumulator(1e-3) and two
              ComputationGraph.fit steps with set_gradients_accumulator
              (one K11 launch a step over 25,583,592 elements each); every
              loss finite.
2f. parallel_oracle - K11 on the captured step's per-tensor updates and
              residuals, one list call, bitwise against the plain version;
              then an fp64 MLP
              and an fp64 graph with a BatchNormalization at workers 2 and
              4 on the card repeated in the mesh: replicas bitwise
              identical after every SHARED_GRADIENTS and CUSTOM step and
              every AVERAGING window, K11 launches = replicas a
              SHARED_GRADIENTS step and a CUSTOM step, and
              on the MLP CUSTOM with a BasicGradientsAccumulator and
              Sgd(0.1) within 1e-10 of one fit_batch of the whole batch.
3. kernel_lstm_scan - K7 (the Graves-LSTM scan, forward and backward)
              against its plain versions: fp32 and bf16, H 32/64/256/512
              (and 200, zero-padded to 208 in the wrappers),
              B 1/3/65/8192, T 1/7/100, zero and non-zero state and
              peepholes, a non-zero cs cotangent in every other case; per
              time step relative errors with a floor, and in bf16 each
              chain against the fp64 plain chain within twice the bf16
              plain chain's own error. Each case's forward must take the
              variant `scan_fwd_variant` names (bf16 H 64/128/256 the
              cluster kernel, the rest the tile kernel; bf16 H 128 cases
              added for the cluster kernel), and so must each case's
              backward sweep (`scan_bwd_variant`, the same rule); every
              variant must have run. A GravesLSTM and an LSTM layer of
              H 1536, whose K7 tile does not fit in shared memory, step
              through K8 and K9 (launches counted) against the CPU. Then
              the char-RNN layer (T 100, B 8192, H 256, bf16; the cluster
              forward and backward) timed beside
              the plain versions and torch.nn.LSTM (cuDNN, a yardstick
              only). At T 100, B 8192 and H 64, 128 and 256 the cluster
              backward must give bitwise-equal dxw, dRW, dh0, dc0 and
              peephole sums in two calls, and is timed whole and as its
              sweep and its dRW kernel apart, beside cuDNN's backward at
              the same H and the bounds.
4. kernel_lstm_gates - K8 (peephole cell) and K9 (plain cell), forward
              and backward, against their plain versions, on the 16-byte
              path and (H 100 in bf16, gates at an odd element offset in
              both dtypes) the scalar path, each of which must have run;
              K8's peephole gradients in the peepholes' dtype and its
              backward bitwise equal over two calls; then timed at (B
              8192, H 256, bf16), forward and backward apart, K9 beside
              PyTorch's fused LSTM cell (aten._thnn_fused_lstm_cell and
              its backward, gates permuted; a yardstick only).
5. train_lstm - the zoo TextGenerationLSTM at the bench's width
              (bench.py bench_graves_lstm: GravesLSTM(256) x 2 +
              RnnOutputLayer(47), tBPTT 50, RmsProp(0.01), l2 1e-3,
              batch 8192, T 100, bf16 compute over fp32 params, seed 42,
              the bench's data): fit_on_device(steps=5, sync=False) after
              a warm step (tokens/s, ms/step, peak memory; exactly 2 K7
              forward + 2 backward launches a step, every forward and
              backward on the cluster kernels), two tBPTT fit(x, y)
              calls (2 segments each), a masked fit_batch (K8 on every
              step) and the same stack with LSTM layers, masked (K9).
6. lstm_oracle - gradient_and_score of the stack through the kernels
              against the plain versions in fp32 and fp64 (every gradient
              within twice the fp32 plain path's own error against fp64,
              loss 1e-5), then in bf16 compute unmasked (K7) and masked
              (K8).
7. generate - rnn_time_step on the bf16 stack, batch 32: a 50-character
              prime, then 100 greedy single-character steps (2 K7
              launches a call); in fp32 the stream at steps 1, 50 and 150
              against output() of the prefix within 1e-4.
8. kernel_flash - K3 (flash-attention forward; bf16 on the wgmma kernel of
              flash_attention_sm90.cu, fp32 on flash_attention.cu) against
              flash_fwd_plain:
              fp32 and bf16, head dims 32/64/128, T 1/63/64/65/200/1000
              (and head dims 8 and 48 at T 1024, zero-padded to 16 and 64
              in the wrappers; head dims 160, 192 and 256 at T 31/33/200,
              causal and windowed, on the CUDA-core kernels in both dtypes,
              160 zero-padded to 192),
              causal on/off, window 0/17/256, no key mask or a random one
              with a fully masked batch row, kv heads 4 and 2 (GQA) of 4;
              then the training shape (B 4, H 4, T 8192, D 64, bf16,
              causal), timed (CUDA events) beside the plain version and
              scaled_dot_product_attention (a yardstick only), with its
              TFLOP/s and share of the bound; two calls there must give
              bitwise-equal o and L. Each case holds the max abs error
              and, per 64-row tile along T, the error relative to the
              tile's own reference.
9. kernel_flash_bwd - K4 (fused backward) and K5 (two-pass backward; bf16
              on the wgmma kernels of flash_attention_sm90.cu, fp32 on
              flash_attention.cu) against flash_bwd_plain over the same
              sweep, K4 against K5, with a non-zero lse cotangent in every
              other case; then the training shape, timed beside the plain
              version and the backward of scaled_dot_product_attention,
              with TFLOP/s and bound shares; two K5 calls there must give
              bitwise-equal dq, dk and dv, two K4 calls bitwise-equal dk
              and dv (K4's dq is summed by reductions in L2, in no fixed
              order).
10. train   - the bench's long-context stack (bench.py
              bench_attention_longcontext: 2 causal SelfAttentionLayer(256,
              4 heads, block 512) + RnnOutputLayer(64), bf16 compute over
              fp32 params, Sgd(1e-3), XAVIER, seed 42; batch 4, T 8192, the
              bench's own data) trained through MultiLayerNetwork:
              fit_on_device(steps=5, sync=False) after a warm step (tokens
              per second, ms per step, peak memory, K3/K4 launches per
              step), two fit(x, y) steps, fit_on_device(steps=5) under
              configure(bwd="two_pass") timed the same way (K5 launches,
              K4 none), and one output(); every loss finite, peak memory
              under 2 GiB; a profile of two fused steps, in which the
              wgmma K4 kernel must appear and the old wmma one must not.
11. train_oracle - the same stack in fp32: one gradient_and_score through
              the kernels, held against the dense plain versions on the
              card in fp64 (the fp32 dense path is reported beside it);
              loss and every gradient within 1e-4 relative. Then in bf16
              compute, as it trains (the tensor-core kernels): kernels and
              dense plain versions on the same inputs, each against fp64;
              losses within 1e-4 of each other, every gradient of the
              kernel path within twice the dense path's own error.
11a. flash_head_dims - K3, K4 and K5 at B*H 16, bf16, causal, D 128 to 512
              at T 8192 and D 384, 512 and 1024 at T 1024: CUDA-event times
              beside scaled_dot_product_attention forward and backward,
              bounds, the source each took (bf16 K3, K4 and K5 at D 128 to 512
              on the wgmma kernels, above 512 on the CUDA-core kernels, bf16
              widened); K3 above 128 against the plain version; K3 and K5
              two calls bitwise equal, and K4's dk and dv too; above D 128
              K4's dk and dv bitwise equal to K5's (the same tiles, q-tile
              order and products); K3, K4 and K5 at D 192, 256, 384, 512,
              640 and 1024, T 1024, masked, with a non-zero lse cotangent,
              in bf16 and fp32 against the plain versions, each on the
              source _route names. A head-dim-256 stack
              (SelfAttentionLayer(512, 2 heads, block 256) +
              RnnOutputLayer(16), T 1024, batch 2): fp32 gradient_and_score
              through the kernels against the dense plain versions in fp64
              (1e-4), two bf16 fit steps under the fused backward (1 K3 + 1 K4
              each) and two under two_pass (1 K3 + 2 K5 each); the same bf16
              steps on a head-dim-512 stack; all on flash_attention_sm90.cu
              and none on flash_attention.cu.
12. kernel  - each kernel against its plain PyTorch version on the card,
              then timed at the served shape (device time by CUDA-graph
              replay, with the merge in the launch and with it off; the
              eager call; the plain version):
              K1 (paged decode): fp32, bf16, and an int8 pool with fp32
              and with bf16 queries; head dims 64/128; GQA groups 1/2/4;
              windows 0/64; block sizes 8/16/32; ragged visible lengths;
              shuffled block tables with trash entries; each case's
              partials (merge off) against paged_partials_plain at the same
              plan, and two calls bit for bit; then the served shape with
              the bf16 pool and with the int8 pool (bf16 queries, as the
              serves run): one launch a call, the plan, each pool timed.
              K2 (multi-query paged decode, "kernel_spec"): the same sweep
              with Q = 2/3/5/9 queries per slot, and each row i of K2
              against K1 at visible + i on the same pool; then the served
              shape at Q = 2/3/5 with both pools, timed in full at Q 5.
              K6 (contiguous split-K decode with its merge in the launch,
              "kernel_contiguous"): fp32 and bf16, cache lengths 1024,
              320 and 300 (ragged last partitions), head dims 64 and 128,
              GQA groups 1/2/4, windows 0/64, with each case's partition
              plan; with the merge off, the partials against the plain
              split of the same plan; then the served shape: the call
              (merge in), the kernel with the merge off, launches a call,
              the eager call, beside torch's
              scaled_dot_product_attention with a boolean mask (a
              yardstick only, never the route).
13. serve   - the bench_decode_serving model at full width (2 causal GQA
              attention layers, d_model 256, 4 heads, 2 kv heads, vocab 64,
              bf16, max_seqs 8, max_len 1024, KV block 16; random XAVIER
              weights from seed 42) served by ServingEngine: a warmup
              request, then 4 requests of 512 prompt tokens and 256 new
              tokens with 4 more submitted at the halfway mark. The kernel
              launch counts are zeroed just before and read just after; a
              new request then decodes 4 engine steps under
              torch.cuda.set_sync_debug_mode("error").
14. oracle  - the same model in fp32 with capture_logprobs: every captured
              row matches the full-recompute MultiLayerNetwork.output at its
              position within atol 2e-3.
15. decode_attention - the public contiguous-cache entry point
              serving.decode_attention (K6) driven over 64 growing cache
              lengths per layer at the served shape, counts zeroed before.
16. spec_serve - the same bf16 model with spec_decode=True, spec_draft=4,
              greedy: 8 requests of 512 prompt tokens, each a seeded 6-token
              motif tiled to length, 256 new tokens each; then the same
              prompts with spec off at K=1 and at the default chunking. K2
              must have launched and K1 not at all in the spec run; a new
              request then takes 4 spec steps, drafts verified, under
              torch.cuda.set_sync_debug_mode("error").
17. spec_oracle - the fp32 model with spec_decode=True and
              capture_logprobs: every captured row within atol 2e-3 of the
              full recompute, and the greedy stream equal to spec off
              (where they differ, the top-2 logprob gap there must be below
              1e-5, a tie).
18. int8_serve - kv_quant=True, quant_weights=True on the serve phase's
              model and traffic, and once more with spec_decode=True: tokens
              per second, KV bytes per token against the float pool, K1/K2
              launches, greedy agreement with the float serve; and on the
              oracle's prompts in fp32, max |logprob difference| against the
              float full recompute. Fails on a count mismatch or a
              non-finite row only (int8 exactness is held by the kernel
              phase and the CPU tests).
19. kv_pressure - the serve phase's model and traffic stepped
              synchronously (the overlapped drain can livelock when every
              admission preempts) on a 200-block pool that wave 2
              overflows, with kv_evict="lru": preemption by recompute, by
              synchronous swap, and by asynchronous swap through a host
              pool of 1.5 requests into a disk tier under tempfile; the
              last again on the int8 pool. Each mode preempts at least 4
              times; swap and int8 resumes give the unpressured run's
              tokens; the disk tier demotes and promotes; K1 launches
              equal 2 x the decode steps, which cover every resumed
              request's positions. Half the pool timed device->host and
              back as the engine moves it and over the bare link. fp32
              twins of recompute and of swap through disk with
              capture_logprobs: a divergence from the unpressured stream
              only at a top-2 gap < 1e-5, rows within 2e-3 of the full
              recompute. A second turn extending the first turn's prompt
              and output hits the radix tree (prefix_radix, radix_ttl),
              whose idle iterations then drain it; a prefix store saved at
              shutdown restores 512 tokens into a fresh engine; both give
              a cold run's tokens (the same gap rule) and rows within
              2e-3. Then spec_decode on the serve traffic with the
              asynchronous swap through the disk tier: the unpressured spec
              run's tokens, K2 launched and K1 not at all, counts zeroed
              just before the window. The spill directories are removed at
              the end. Preemptions by mode, swap bytes, GB/s, preempt stall,
              tokens/s against unpressured, host syncs per token, disk
              demotions and radix hit blocks, beside the card's name and
              power limit.

Then the kernels line (K1-K11), the card's name and power limit as
nvidia-smi gives them, and finally {"ok": true, "device": {...}}. Exits
non-zero without a result when CUDA is not available or the package is not
beside this file.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
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


PAGED_BS, PAGED_D = (8, 16, 32), (64, 128)


def paged_check(torch, da, fn, parts_fn, args, sc, tol, what):
    """One K1 or K2 case: the call against the plain version, its
    partials (merge off) against the plain split of the same plan, and a
    second call bit for bit. Returns (output, err, partials err)."""
    out = fn(*args, **sc)
    again = fn(*args, **sc)
    ref = (da.decode_attention_dense_paged if fn is
           da.flash_decode_attention_paged else
           da.decode_attention_dense_spec_paged)(*args, **sc)
    parts = parts_fn(*args, **sc)
    bs, D = args[1].shape[1], args[1].shape[3]
    plan = da.paged_partition(bs, D, args[0].element_size(),
                              args[1].element_size())
    pref = da.paged_partials_plain(*args, **sc, plan=plan)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    perr = max(max_err(a, b) for a, b in zip(parts, pref))
    if not (math.isfinite(err) and err <= tol and perr <= tol):
        fail(f"{what}: max abs err {err}, partials {perr} > {tol}")
    if not torch.equal(out, again):
        fail(f"{what}: two calls on the same inputs differ")
    return out, err, perr


def paged_plan(da, lib, S, Hk, bs, bps, D, q_elt, kv_elt, visible, Q=1):
    """K1/K2's plan for one call: blocks per partition, partitions per
    (slot, kv head), CTAs launched and CTAs with work, shared memory per
    CTA (the wrapper's rule and the kernel's own count, which must
    agree)."""
    bpp = da.paged_partition(bs, D, q_elt, kv_elt)
    smem = da.paged_smem_bytes(bs, bpp, D, q_elt, kv_elt)
    smem_kernel = lib.dl4j_flash_decode_paged_smem(bs, bpp, D, q_elt, kv_elt)
    if smem != smem_kernel:
        fail(f"K1/K2 shared memory: wrapper {smem} B, kernel {smem_kernel} B")
    P, np_ = bpp * bs, -(-bps // bpp)
    busy = sum(Hk * -(-min(v + Q - 1, bps * bs) // P) for v in visible)
    return {"blocks_per_partition": bpp, "positions": P, "partitions": np_,
            "ctas": S * Hk * np_, "busy_ctas": busy, "smem": smem}


def paged_bound(S, Q, Hk, G, D, bs, bps, visible, q_elt, kv_elt):
    """Least work of one K1 (Q = 1) or K2 call: q read and the output
    written in q's dtype, the K/V blocks any query can see read once in
    the pool's (with two fp32 scales a block and kv head for an int8
    pool), block table and lengths read; QK and PV over every (query,
    visible position), on the tensor cores for 2-byte queries."""
    blocks = sum(-(-(v + Q - 1) // bs) for v in visible)
    nbytes = (S * Q * Hk * G * D * q_elt * 2
              + blocks * bs * Hk * D * kv_elt * 2
              + (blocks * Hk * 8 if kv_elt == 1 else 0)
              + S * bps * 4 + S * 4)
    ops = 4 * sum(v + i for v in visible for i in range(Q)) * Hk * G * D
    rate = BF16_OPS_PER_S if q_elt == 2 else FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return nbytes, ops, max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def paged_timed(torch, da, lib, Q, kind, seed):
    """The served shape with the bf16 pool or the int8 pool (bf16 queries,
    as the serves run): the call against the plain version, then the call
    (merge in) and the kernel with the merge off by CUDA-graph replay, the
    eager call, the plain version, launches a call, the plan and the
    bound."""
    S, Hk, G, D, bs, bps, visible = served_shape()
    quant = SWEEP[kind][1]
    a, sc = paged_case(torch, S, Hk, G, D, bs, bps, 0, torch.bfloat16, quant,
                       seed=seed, visible=visible,
                       Q=None if Q == 1 else Q)
    k1 = Q == 1
    fn = da.flash_decode_attention_paged if k1 \
        else da.flash_decode_attention_spec_paged
    parts = da.flash_decode_partials if k1 else da.flash_decode_spec_partials
    plain = da.decode_attention_dense_paged if k1 \
        else da.decode_attention_dense_spec_paged
    _, err, perr = paged_check(
        torch, da, fn, parts, a, sc, SWEEP[kind][2],
        f"K{1 if k1 else 2} at the served shape, {kind} Q={Q}")
    torch.cuda.synchronize()
    before = fn.launches
    fn(*a, **sc)
    if fn.launches - before != 1:
        fail(f"K{1 if k1 else 2}: {fn.launches - before} launches a call")
    kv_elt = a[1].element_size()
    nbytes, ops, bound_ms, bound_by = paged_bound(S, Q, Hk, G, D, bs, bps,
                                                  visible, 2, kv_elt)
    return {"max_abs_err": err, "partials_max_abs_err": perr,
            "ms": graph_ms(torch, lambda: fn(*a, **sc)),
            "kernel_only_ms": graph_ms(torch, lambda: parts(*a, **sc)),
            "eager_ms": time_ms(torch, lambda: fn(*a, **sc)),
            "plain_ms": graph_ms(torch, lambda: plain(*a, **sc)),
            "eager_plain_ms": time_ms(torch, lambda: plain(*a, **sc),
                                      iters=50),
            "launches_per_call": 1,
            "plan": paged_plan(da, lib, S, Hk, bs, bps, D, 2, kv_elt,
                               visible, Q),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops}, a


def phase_kernel(torch):
    """K1 against its plain version over the sweep (each case's partials
    with the merge off against the plain split of the same plan, and two
    calls bit for bit), then timed at the served shape with the bf16 and
    the int8 pool."""
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    lib = da._library()
    tol = {k: t for k, (_, _, t) in SWEEP.items()}
    worst, worst_p = {}, {}
    n_cases = 0
    for kind, (qt, quant, _) in SWEEP.items():
        dtype = getattr(torch, qt)
        for D in PAGED_D:
            for G in (1, 2, 4):
                for window in (0, 64):
                    for bs in PAGED_BS:
                        args, sc = paged_case(torch, 6, 2, G, D, bs, 12,
                                              window, dtype, quant,
                                              seed=n_cases)
                        _, err, perr = paged_check(
                            torch, da, da.flash_decode_attention_paged,
                            da.flash_decode_partials, args, sc, tol[kind],
                            f"kernel vs plain: {kind} D={D} G={G} "
                            f"window={window} bs={bs}")
                        worst[kind] = max(worst.get(kind, 0.0), err)
                        worst_p[kind] = max(worst_p.get(kind, 0.0), perr)
                        n_cases += 1
    S, Hk, G, D, bs, bps, visible = served_shape()
    timed = {}
    for kind in ("bfloat16", "int8_bf16q"):
        timed[kind], a = paged_timed(torch, da, lib, 1, kind, seed=1234)
    bf = timed["bfloat16"]
    res = {"phase": "kernel", "cases": n_cases,
           "max_abs_err": worst, "partials_max_abs_err": worst_p,
           "tolerance": tol, "served_shape": {
               "S": S, "H": Hk * G, "Hk": Hk, "D": D, "bs": bs, "bps": bps,
               "visible": visible, "dtype": "bfloat16"},
           "served_max_abs_err": {k: v["max_abs_err"]
                                  for k, v in timed.items()},
           "timed": timed}
    res.update({k: bf[k] for k in (
        "ms", "plain_ms", "kernel_only_ms", "eager_ms", "eager_plain_ms",
        "bound_ms", "bound_by", "bytes", "ops", "plan")})
    emit(res)
    return res


def phase_kernel_spec(torch):
    """K2 against its plain version over the sweep, each row i against K1
    at visible + i, the partials (merge off) against the plain split of
    the same plan and two calls bit for bit; then timed at the served
    shape of the spec serve with the bf16 and the int8 pool."""
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    lib = da._library()
    tol = {k: t for k, (_, _, t) in SWEEP.items()}
    worst, worst_row, worst_p = {}, {}, {}
    n_cases = 0
    for kind, (qt, quant, _) in SWEEP.items():
        dtype = getattr(torch, qt)
        for Q in (2, 3, 5, 9):
            for D in PAGED_D:
                for G in (1, 2, 4):
                    for window in (0, 64):
                        for bs in PAGED_BS:
                            args, sc = paged_case(
                                torch, 6, 2, G, D, bs, 12, window, dtype,
                                quant, seed=5000 + n_cases, Q=Q)
                            what = (f"K2 vs plain: {kind} Q={Q} D={D} G={G} "
                                    f"window={window} bs={bs}")
                            out, err, perr = paged_check(
                                torch, da,
                                da.flash_decode_attention_spec_paged,
                                da.flash_decode_spec_partials, args, sc,
                                tol[kind], what)
                            q, kp, vp, bt, vis, scale, w = args
                            rows = torch.stack([
                                da.flash_decode_attention_paged(
                                    q[:, i], kp, vp, bt, vis + i, scale, w,
                                    **sc) for i in range(Q)], dim=1)
                            row_err = (out.float() - rows.float()).abs() \
                                .max().item()
                            if not row_err <= tol[kind]:
                                fail(f"{what}: rows vs K1 {row_err}")
                            worst[kind] = max(worst.get(kind, 0.0), err)
                            worst_p[kind] = max(worst_p.get(kind, 0.0), perr)
                            worst_row[kind] = max(worst_row.get(kind, 0.0),
                                                  row_err)
                            n_cases += 1
    # the served shape at every Q the spec serve runs with spec_draft 4
    # (2, 3, 5), with the bf16 pool and the int8 pool, bf16 queries both;
    # timed at each Q on the bf16 pool, and in full at Q = 5 on both
    S, Hk, G, D, bs, bps, visible = served_shape()
    Q = SPEC_DRAFT + 1
    served, ms_by_q, timed = {}, {}, {}
    for q_ in (2, 3, Q):
        for kind in ("bfloat16", "int8_bf16q"):
            if q_ == Q:
                timed[kind], a = paged_timed(torch, da, lib, Q, kind,
                                             seed=4321 + Q)
                served[f"{kind}_Q{q_}"] = timed[kind]["max_abs_err"]
                if kind == "bfloat16":
                    args = a
                    ms_by_q[q_] = timed[kind]["ms"]
                continue
            a, sc = paged_case(torch, S, Hk, G, D, bs, bps, 0,
                               torch.bfloat16, SWEEP[kind][1],
                               seed=4321 + q_, visible=visible, Q=q_)
            _, served[f"{kind}_Q{q_}"], _ = paged_check(
                torch, da, da.flash_decode_attention_spec_paged,
                da.flash_decode_spec_partials, a, sc, tol[kind],
                f"K2 at the served shape, {kind} Q={q_}")
            if kind == "bfloat16":
                ms_by_q[q_] = graph_ms(
                    torch, lambda: da.flash_decode_attention_spec_paged(*a))
    # K1 at the same pool, Q times: what verifying Q positions would cost
    # without the multi-query kernel
    q, kp, vp, bt, vis, scale, w = args
    k1_times_q_ms = graph_ms(torch, lambda: [
        da.flash_decode_attention_paged(q[:, i], kp, vp, bt, vis + i, scale,
                                        w) for i in range(Q)])
    bf = timed["bfloat16"]
    res = {"phase": "kernel_spec", "cases": n_cases,
           "max_abs_err": worst, "max_abs_err_vs_k1_rows": worst_row,
           "partials_max_abs_err": worst_p,
           "tolerance": tol, "served_shape": {
               "S": S, "Q": Q, "H": Hk * G, "Hk": Hk, "D": D, "bs": bs,
               "bps": bps, "visible": visible, "dtype": "bfloat16"},
           "served_max_abs_err": served, "ms_by_q": ms_by_q,
           "k1_times_q_ms": k1_times_q_ms, "timed": timed}
    res.update({k: bf[k] for k in (
        "ms", "plain_ms", "kernel_only_ms", "eager_ms", "eager_plain_ms",
        "bound_ms", "bound_by", "bytes", "ops", "plan")})
    emit(res)
    return res


def bound_of(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


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


def contiguous_plan(da, lib, S, L, Hk, G, D, elt, visible, window=0):
    """K6's partition plan for one call: positions per CTA, partitions per
    (slot, kv head), CTAs launched and CTAs with visible positions, shared
    memory per CTA (the wrapper's rule and the kernel's own count, which
    must agree)."""
    P = da.contiguous_partition(G, D, elt)
    smem = da.contiguous_smem_bytes(G, D, P, elt)
    smem_kernel = lib.dl4j_flash_decode_contiguous_smem(G, D, P, elt)
    if smem != smem_kernel:
        fail(f"K6 shared memory: wrapper {smem} B, kernel {smem_kernel} B")
    busy = 0
    for v in visible:
        hi, lo = min(v, L), max(0, v - window) if window else 0
        busy += Hk * ((-(-hi // P) - lo // P) if hi > lo else 0)
    np_ = -(-L // P)
    return {"P": P, "partitions": np_, "ctas": S * Hk * np_,
            "busy_ctas": busy, "smem": smem}


def phase_kernel_contiguous(torch):
    """K6 against its plain version, its partials (merge off) against the
    plain split of the same plan, then timed at the served shape beside
    scaled_dot_product_attention."""
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    lib = da._contiguous_library()
    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    worst, worst_p, n_cases, plans = {}, {}, 0, {}
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
                    parts = da.flash_decode_contiguous_partials(
                        q, kc, vc, vis, scale, window)
                    plan = contiguous_plan(da, lib, 4, L, 2, G, D,
                                           q.element_size(), vis.tolist(),
                                           window)
                    pref = da.contiguous_partials_plain(
                        q, kc, vc, vis, scale, window, plan["P"])
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    perr = max(max_err(a, b) for a, b in zip(parts, pref))
                    if not (err <= tol[kind] and perr <= tol[kind]):
                        fail(f"K6 vs plain: {kind} L={L} D={D} G={G} "
                             f"window={window}: max abs err {err}, "
                             f"partials {perr}")
                    worst[kind] = max(worst.get(kind, 0.0), err)
                    worst_p[kind] = max(worst_p.get(kind, 0.0), perr)
                    plans[f"{kind}_L{L}_D{D}_G{G}"] = {
                        k: plan[k] for k in ("P", "partitions", "smem")}
                    n_cases += 1
    S, Hk, G, D, L = MAX_SEQS, KV_HEADS, HEADS // KV_HEADS, \
        D_MODEL // HEADS, MAX_LEN
    visible = [MAX_LEN * 3 // 4 - 3 * s for s in range(S)]
    q, kc, vc, vis, scale = contiguous_case(torch, S, L, Hk, G, D,
                                            torch.bfloat16, seed=99,
                                            visible=visible)
    out = da.flash_decode_attention(q, kc, vc, vis, scale)
    ref = da.decode_attention_dense(q, kc, vc, vis, scale)
    lib_out = sdpa_call(torch, q, kc, vc, vis, scale)
    served_err = (out.float() - ref.float()).abs().max().item()
    lib_err = (lib_out.float() - ref.float()).abs().max().item()
    if not served_err <= tol["bfloat16"]:
        fail(f"K6 vs plain at the served shape: {served_err}")
    torch.cuda.synchronize()
    before = da.flash_decode_attention.launches
    da.flash_decode_attention(q, kc, vc, vis, scale)
    launches_per_call = da.flash_decode_attention.launches - before
    if launches_per_call != 1:
        fail(f"K6: {launches_per_call} launches a call, expected 1")
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
           "max_abs_err": worst, "partials_max_abs_err": worst_p,
           "tolerance": tol, "plans": plans,
           "served_shape": {"S": S, "L": L, "H": Hk * G, "Hk": Hk, "D": D,
                            "visible": visible, "dtype": "bfloat16"},
           "served_plan": contiguous_plan(da, lib, S, L, Hk, G, D, elt,
                                          visible),
           "served_max_abs_err": served_err,
           "library_max_abs_err": lib_err, "ms": ms, "plain_ms": plain_ms,
           "kernel_only_ms": kernel_only_ms,
           "launches_per_call": launches_per_call,
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


# -------------------------------------------------------------- kv pressure
# wave 1 (4 requests of 48 blocks of 16 positions) and 8 blocks more
PRESSURE_BLOCKS = 4 * (PROMPT + NEW_TOKENS) // 16 \
    + (PROMPT + NEW_TOKENS) // 16 // 6


def spill_bytes(kv_elt: int, positions: int = PROMPT + NEW_TOKENS) -> int:
    """A host-pool cap of one and a half requests' KV blocks (16 positions
    a block, both layers; an int8 block adds its fp32 scales): one victim
    stays in pinned memory, the next demotes the older one to disk."""
    per_block = 16 * 2 * KV_HEADS * (D_MODEL // HEADS) * 2 * kv_elt \
        + (2 * KV_HEADS * 4 * 2 if kv_elt == 1 else 0)
    return per_block * -(-positions // 16) * 3 // 2


def resumed_positions(results) -> list:
    """Per preempted result: the positions it decoded after its last
    resume (the resumed-token count is on its swap_in / resume prefill
    event)."""
    out = []
    for r in results:
        resumes = [e["resumed_tokens"] for e in r.timeline
                   if "resumed_tokens" in e]
        if resumes:
            out.append(len(r.tokens) - resumes[-1])
    return out


def pressured_serve(torch, np, net, **kw):
    """serve_traffic on a pool that wave 2 overflows, stepped
    synchronously (the overlapped drain can livelock under preemption);
    returns (engine, results, wall, launches, summary)."""
    eng = new_engine(torch, net, overlap=False, **kw)
    results, wall, launches, _ = serve_traffic(torch, np, eng)
    st = eng.stats()
    steps = eng.metrics.get("serving.chunk_k").sum
    stall = eng.metrics.get("serving.kv.preempt_stall_ms")
    k1 = launches["flash_decode_attention_paged"]
    k2 = launches["flash_decode_attention_spec_paged"]
    resumed = resumed_positions(results)
    n_layers = len(eng.decoder.attn_idx)
    if eng.spec_decode:
        if k2 <= 0 or k1 != 0:
            fail(f"kv_pressure spec: K2 launches {k2} (must be > 0), K1 "
                 f"launches {k1} (must be 0: every decode step verifies "
                 "through K2)")
    elif k1 != n_layers * steps:
        fail(f"kv_pressure: {k1} K1 launches for {steps} decode steps of "
             f"{n_layers} layers")
    elif resumed and k1 < n_layers * max(resumed):
        fail(f"kv_pressure: {k1} K1 launches cannot cover {max(resumed)} "
             "resumed positions")
    summary = {
        "tokens_per_s": MAX_SEQS * NEW_TOKENS / wall, "wall_s": wall,
        "host_syncs": st["host_syncs"],
        "host_syncs_per_token": st["host_syncs_per_token"],
        "preemptions": st["kv_preemptions"],
        "by_mode": {"recompute": st["kv_evictions_recompute"],
                    "swap": st["kv_evictions_swap"]},
        "swap_out_bytes": st["kv_swap_out_bytes"],
        "swap_in_bytes": st["kv_swap_in_bytes"],
        "harvests": st["kv_swap_harvests"],
        "disk_demotions": st["kv_disk_demotions"],
        "disk_promotions": st["kv_disk_promotions"],
        "measured_swap_gbps": st["kv_measured_swap_gbps"],
        "preempt_stall_ms": {"count": stall.count,
                             "mean": stall.sum / max(1, stall.count),
                             "p50": stall.quantile(0.5),
                             "max": stall.quantile(1.0)},
        "decode_steps": k2 // n_layers if eng.spec_decode else steps,
        "k1_launches": k1, "k2_launches": k2,
        "resumed_requests": len(resumed),
        "resumed_positions": sum(resumed),
        "max_resumed_positions": max(resumed, default=0)}
    return eng, results, wall, launches, summary


def fp32_pressure_oracle(torch, np, net, mode: str, disk_dir=None) -> dict:
    """The fp32 model with capture_logprobs on 4 requests of 128 prompt
    tokens and 64 new ones, on a pool that holds two: the stream against
    the unpressured run (a divergence only at a top-2 gap < 1e-5) and
    every captured row against the full recompute (2e-3)."""
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, VOCAB, 128).tolist() for _ in range(4)]
    runs = {}
    for name, kw in (("unpressured", {}),
                     ("pressured", dict(
                         kv_blocks=2 * 12 + 6, kv_evict="lru",
                         kv_evict_mode=mode, kv_swap_async=True,
                         kv_swap_bytes=spill_bytes(4, 192) if disk_dir
                         else 1 << 30, kv_disk=disk_dir))):
        eng = ServingEngine(net, max_seqs=4, max_len=MAX_LEN,
                            capture_logprobs=True, device="cuda", **kw)
        runs[name] = (eng, eng.generate([Request(p, max_new_tokens=64)
                                         for p in prompts]))
    worst, diverged = 0.0, []
    for p, r_p, r_u in zip(prompts, runs["pressured"][1],
                           runs["unpressured"][1]):
        worst = max(worst, oracle_rows(torch, np, net, p, r_p))
        d = first_divergence(r_p.tokens, r_u.tokens)
        if d is not None:
            top2 = np.sort(r_u.logprobs[d])[-2:]
            gap = float(top2[1] - top2[0])
            diverged.append({"position": d, "top2_gap": gap})
            if not gap < 1e-5:
                fail(f"kv_pressure fp32 {mode}: the stream diverges from the "
                     f"unpressured run at token {d}, top-2 gap {gap}")
    if not worst <= 2e-3:
        fail(f"kv_pressure fp32 {mode}: max abs err {worst} > 2e-3")
    st = runs["pressured"][0].stats()
    if st["kv_preemptions"] < 1:
        fail(f"kv_pressure fp32 {mode}: nothing was preempted")
    return {"preemptions": st["kv_preemptions"], "max_abs_err": worst,
            "atol": 2e-3, "divergences": diverged,
            "disk_demotions": st["kv_disk_demotions"],
            "disk_promotions": st["kv_disk_promotions"]}


def swap_bandwidth(torch, eng) -> dict:
    """Half the pool's blocks moved as the engine moves a victim: gather +
    device->host copy into fresh pinned memory + wait, and restore +
    synchronize, by the host clock (the second of two rounds); then the
    link alone: the gathered blocks copied into preallocated pinned
    memory and back, by CUDA events (mean of 5); the host time of each of
    four pinned allocations of those sizes; and the host time of one
    upload of those block ids as the engine makes it (`block_index`) and
    through a fresh pinned buffer, each behind ~10 ms of queued device
    work (an upload that waited for the stream would take that long)."""
    from deeplearning4j_tpu_torch.serving import kv_cache as kvc
    cache = eng.decoder.cache
    blocks = list(range(cache.num_blocks // 2))
    nbytes = len(blocks) * cache.block_bytes
    out = {"bytes": nbytes}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = [kvc.host_value(p)
                for p in kvc.gather_blocks_host(cache.state, blocks)]
        t1 = time.perf_counter()
        kvc.restore_blocks(cache.state, blocks, host[0], host[1])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out["d2h_gbps"] = nbytes / (t1 - t0) / 1e9
        out["h2d_gbps"] = nbytes / (t2 - t1) / 1e9
    dev = kvc.gather_blocks(cache.state, blocks)
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in dev]
    for name, copy in (("link_d2h_gbps", lambda: [
            h.copy_(d, non_blocking=True) for h, d in zip(pinned, dev)]),
                       ("link_h2d_gbps", lambda: [
            d.copy_(h, non_blocking=True) for h, d in zip(pinned, dev)])):
        out[name] = nbytes / (time_ms(torch, copy, iters=5, warmup=2)
                              * 1e-3) / 1e9
    fresh, out["pinned_alloc_ms"] = [], []
    for t in dev * 2:        # the caching host allocator may serve some
        t0 = time.perf_counter()
        fresh.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
        out["pinned_alloc_ms"].append((time.perf_counter() - t0) * 1e3)
    cuda = cache.state.k.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(20_000_000)
    torch.cuda.synchronize()
    out["queued_work_ms"] = (time.perf_counter() - t0) * 1e3
    for name, upload in (
            ("index_upload_ms", lambda: kvc.block_index(blocks, cuda)),
            ("index_upload_pinned_ms", lambda: torch.tensor(
                blocks).pin_memory().to(cuda, non_blocking=True))):
        torch.cuda._sleep(20_000_000)
        t0 = time.perf_counter()
        upload()
        out[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    return out


def radix_store_leg(torch, np, net, spill) -> dict:
    """fp32: a second turn extending the first turn's prompt and output
    hits the radix tree; a store saved at shutdown (under the directory
    `spill`) restores blocks into a fresh engine; both give a cold run's
    tokens (or diverge only at a top-2 gap < 1e-5) with rows within 2e-3
    of the full recompute."""
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine
    rng = np.random.RandomState(6)
    turn1 = rng.randint(0, VOCAB, PROMPT).tolist()

    def engine(**kw):
        return ServingEngine(net, max_seqs=2, max_len=MAX_LEN,
                             capture_logprobs=True, device="cuda", **kw)

    def check(name, prompt, res, cold):
        err = oracle_rows(torch, np, net, prompt, res)
        d = first_divergence(res.tokens, cold.tokens)
        gap = None
        if d is not None:
            top2 = np.sort(cold.logprobs[d])[-2:]
            gap = float(top2[1] - top2[0])
            if not gap < 1e-5:
                fail(f"kv_pressure {name}: diverges from the cold run at "
                     f"token {d}, top-2 gap {gap}")
        if not err <= 2e-3:
            fail(f"kv_pressure {name}: max abs err {err} > 2e-3")
        return {"identical_to_cold": d is None, "top2_gap": gap,
                "max_abs_err": err}

    out = {}
    eng = engine(prefix_radix=True, radix_ttl=64)
    r1 = eng.generate([Request(turn1, max_new_tokens=64)])[0]
    turn2 = turn1 + r1.tokens + rng.randint(0, VOCAB, 8).tolist()
    reset_launches()
    r2 = eng.generate([Request(turn2, max_new_tokens=64)])[0]
    k1 = read_launches()["flash_decode_attention_paged"]
    cold2 = engine().generate([Request(turn2, max_new_tokens=64)])[0]
    st = eng.stats()
    bs = eng.decoder.cache.block_size
    if r2.shared_prefix_tokens < PROMPT - bs:
        fail(f"kv_pressure radix: turn 2 shared {r2.shared_prefix_tokens} "
             "tokens")
    for _ in range(66):                 # idle iterations past the TTL
        eng.step()
    drained = eng.stats()
    if drained["kv_blocks_cached"] or not drained["kv_ttl_expired_blocks"]:
        fail(f"kv_pressure radix: the TTL drained nothing ({drained})")
    out["radix"] = {"hit_blocks": r2.shared_prefix_tokens // bs,
                    "shared_tokens": r2.shared_prefix_tokens,
                    "blocks_cached": st["kv_blocks_cached"],
                    "ttl_expired_blocks": drained["kv_ttl_expired_blocks"],
                    "k1_launches": k1, **check("radix", turn2, r2, cold2)}
    path = os.path.join(spill, "prefixes.npz")
    e1 = engine(prefix_store=path)
    e1.generate([Request(turn1, max_new_tokens=8)])
    e1.shutdown()
    e2 = engine(prefix_store=path)
    reset_launches()
    r3 = e2.generate([Request(turn1 + [1, 2, 3], max_new_tokens=64)])[0]
    k1 = read_launches()["flash_decode_attention_paged"]
    cold3 = engine().generate([Request(turn1 + [1, 2, 3],
                                       max_new_tokens=64)])[0]
    st = e2.stats()
    if st["prefix_store_hits"] < 1:
        fail("kv_pressure store: the restarted engine restored nothing")
    out["store"] = {"loaded_blocks": e2.prefix_store.n_entries,
                    "restored_tokens": st["prefix_store_tokens"],
                    "file_bytes": os.path.getsize(path),
                    "k1_launches": k1, **check("store", turn1 + [1, 2, 3], r3, cold3)}
    return out


def phase_kv_pressure(torch, np, smi):
    """Serving under KV pressure: the serve phase's model and traffic on a
    pool wave 2 overflows, preempting by recompute, by synchronous swap,
    and by asynchronous swap through a small host pool into a disk tier;
    the same on the int8 pool; the fp32 oracle of recompute and swap; the
    radix tree and the persistent prefix store."""
    import shutil
    import tempfile
    net = build_net(torch, "float32")
    spill = tempfile.mkdtemp()
    try:
        out = kv_pressure_runs(torch, np, smi, net, spill)
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    emit(out)
    return out


def kv_pressure_runs(torch, np, smi, net, spill) -> dict:
    """phase_kv_pressure's runs, spilling under the directory `spill`."""
    ref_eng = new_engine(torch, net, overlap=False)
    ref, ref_wall, _, _ = serve_traffic(torch, np, ref_eng)
    ref_tokens = [r.tokens for r in ref]
    out = {"phase": "kv_pressure", "card": smi,
           "kv_blocks": PRESSURE_BLOCKS,
           "unpressured": {"tokens_per_s": MAX_SEQS * NEW_TOKENS / ref_wall,
                           "host_syncs_per_token":
                           ref_eng.stats()["host_syncs_per_token"]}}
    configs = (
        ("recompute", dict(kv_evict_mode="recompute")),
        ("swap_sync", dict(kv_evict_mode="swap", kv_swap_async=False,
                           kv_swap_bytes=1 << 30)),
        ("swap_async_disk", dict(kv_evict_mode="swap", kv_swap_async=True,
                                 kv_swap_bytes=spill_bytes(2),
                                 kv_disk=os.path.join(spill, "bf16"))))
    for name, kw in configs:
        eng, res, _, _, summary = pressured_serve(
            torch, np, net, kv_blocks=PRESSURE_BLOCKS, kv_evict="lru", **kw)
        toks = [r.tokens for r in res]
        summary["requests_identical_to_unpressured"] = sum(
            a == b for a, b in zip(toks, ref_tokens))
        mode = kw["kv_evict_mode"]
        if summary["by_mode"][mode] < 4:
            fail(f"kv_pressure {name}: {summary['by_mode'][mode]} "
                 f"preemptions by {mode}, expected at least 4")
        if mode == "swap" and toks != ref_tokens:
            fail(f"kv_pressure {name}: swap-resumed tokens differ from the "
                 "unpressured run")
        if name == "swap_async_disk" and not (
                summary["disk_demotions"] >= 1
                and summary["disk_promotions"] >= 1):
            fail(f"kv_pressure {name}: no disk round trip ({summary})")
        out[name] = summary
        if name == "swap_sync":
            out["swap_bandwidth"] = swap_bandwidth(torch, eng)
    q_ref = new_engine(torch, net, overlap=False, kv_quant=True)
    q_ref_res, q_wall, _, _ = serve_traffic(torch, np, q_ref)
    _, q_res, _, _, q_sum = pressured_serve(
        torch, np, net, kv_quant=True, kv_blocks=PRESSURE_BLOCKS,
        kv_evict="lru", kv_evict_mode="swap", kv_swap_async=True,
        kv_swap_bytes=spill_bytes(1), kv_disk=os.path.join(spill, "int8"))
    if [r.tokens for r in q_res] != [r.tokens for r in q_ref_res]:
        fail("kv_pressure int8: swap-resumed tokens differ from the "
             "unpressured int8 run")
    if q_sum["by_mode"]["swap"] < 4 or q_sum["disk_promotions"] < 1:
        fail(f"kv_pressure int8: {q_sum}")
    q_sum["unpressured_tokens_per_s"] = MAX_SEQS * NEW_TOKENS / q_wall
    out["int8_swap_async_disk"] = q_sum
    out["fp32_oracle"] = {
        "recompute": fp32_pressure_oracle(torch, np, net, "recompute"),
        "swap_async_disk": fp32_pressure_oracle(
            torch, np, net, "swap", os.path.join(spill, "fp32"))}
    out.update(radix_store_leg(torch, np, net, spill))
    s_ref_eng = new_engine(torch, net, overlap=False, spec_decode=True,
                           spec_draft=SPEC_DRAFT)
    s_ref, s_wall, _, _ = serve_traffic(torch, np, s_ref_eng)
    _, s_res, _, _, s_sum = pressured_serve(
        torch, np, net, spec_decode=True, spec_draft=SPEC_DRAFT,
        kv_blocks=PRESSURE_BLOCKS, kv_evict="lru", kv_evict_mode="swap",
        kv_swap_async=True, kv_swap_bytes=spill_bytes(2),
        kv_disk=os.path.join(spill, "spec"))
    if [r.tokens for r in s_res] != [r.tokens for r in s_ref]:
        fail("kv_pressure spec: swap-resumed tokens differ from the "
             "unpressured spec run")
    if s_sum["by_mode"]["swap"] < 4 or s_sum["disk_promotions"] < 1:
        fail(f"kv_pressure spec: {s_sum}")
    s_sum["unpressured_tokens_per_s"] = MAX_SEQS * NEW_TOKENS / s_wall
    out["spec_swap_async_disk"] = s_sum
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


# ---------------------------------------------------------------- training
BF16_OPS_PER_S = 989e12              # H100 SXM bf16 dense, NVIDIA data sheet
TF32_OPS_PER_S = 495e12              # H100 SXM tf32 dense, NVIDIA data sheet
TRAIN_B, TRAIN_T, TRAIN_D_MODEL, TRAIN_HEADS, TRAIN_CLASSES = 4, 8192, 256, \
    4, 64
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Beside the absolute limit, each 64-row tile along T (all batches, heads
# and head dims together) holds ||out - ref|| / ||ref|| under this, so rows
# whose values are far below the absolute limit (late causal rows at T =
# 8192 sit near 1e-2) are held to their own scale. A tile whose reference
# RMS is under FLASH_REF_FLOOR is measured against the floor instead: there
# the reference is what is left of terms that cancel (dq and dk of a query
# with one visible key are exactly 0 and come out as rounding noise).
FLASH_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
FLASH_REF_FLOOR = {"float32": 5e-2, "bfloat16": 1e-3}
FLASH_BWD_DESIGN_PRODUCTS = {"fused": 5, "two_pass": 7}
# train_oracle's bf16 step (see its docstring).
BF16_ORACLE_LOSS_TOL, BF16_ORACLE_FACTOR, BF16_ORACLE_FLOOR = 1e-4, 2.0, 1e-3


def flash_case(torch, B, H, Hk, T, D, dtype, masked, seed):
    """Random q, k, v, dO (and a (B, T) key mask whose first row masks
    every key) on the card. v and dO are drawn at half scale so the
    outputs stay below 4, where one bf16 ulp (2**-6) is under the bf16
    tolerance: the kernel and the plain version round the same fp32
    values to bf16 and may land one ulp apart."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, T, D, generator=g).to("cuda", dtype)
    k = torch.randn(B, Hk, T, D, generator=g).to("cuda", dtype)
    v = (0.5 * torch.randn(B, Hk, T, D, generator=g)).to("cuda", dtype)
    do = (0.5 * torch.randn(B, H, T, D, generator=g)).to("cuda", dtype)
    mask = None
    if masked:
        mask = (torch.rand(B, T, generator=g) > 0.3).float()
        mask[0] = 0.0
        mask = mask.to("cuda")
    return q, k, v, do, mask


def visible_pairs(T, causal, window):
    """(query, key) pairs one head sees (no key mask)."""
    if causal and window:
        return sum(min(window, t + 1) for t in range(T))
    if causal:
        return T * (T + 1) // 2
    if window:
        return sum(min(T, t + window) - max(0, t - window + 1)
                   for t in range(T))
    return T * T


def flash_bound(kind, B, H, T, D, elt, pairs):
    """(bytes, ops, ms, bound_by) of one call at the least work: each input
    read once, each output written once; products over the visible pairs
    at the bf16 tensor-core rate (TF32 for fp32 inputs). The forward: q k v
    read, o written (elt bytes), L written (fp32); 2 products (S, PV). The
    backward: q k v dO read, dq dk dv written, L and D_i read; 5 products
    (S, dV, dP, dQ, dK). K4 and K5 compute the same function, so they share
    this bound; K5's split recomputes S and dP in its second pass (7
    products), which is its design's cost, not the function's work, and is
    reported apart (FLASH_BWD_DESIGN_PRODUCTS)."""
    n = B * H * T * D * elt
    rows = B * H * T * 4
    if kind == "fwd":
        nbytes, prods = 4 * n + rows, 2
    else:
        nbytes, prods = 7 * n + 2 * rows, 5
    ops = 2 * prods * pairs * D * B * H
    rate = BF16_OPS_PER_S if elt == 2 else TF32_OPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
    return nbytes, ops, max(t_b, t_o) * 1e3, \
        ("bytes" if t_b >= t_o else "operations")


def event_ms(torch, fn, iters: int = 5) -> float:
    """Mean device time of one call of a long-running `fn`: CUDA events
    around `iters` back-to-back calls after one warm call."""
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


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


def tile_rel_err(torch, a, ref, floor: float, tile: int = 64) -> float:
    """Largest ||a - ref|| / max(||ref||, floor * sqrt(n)) over `tile`-row
    tiles along T of (B, H, T, D) tensors, n the elements of the tile."""
    B, H, T, D = ref.shape
    if not ref.numel():
        return 0.0
    e2 = (a.double() - ref.double()).pow(2).sum((0, 1, 3))
    r2 = ref.double().pow(2).sum((0, 1, 3))
    pad = (-T) % tile
    e2 = torch.nn.functional.pad(e2, (0, pad)).view(-1, tile).sum(1)
    r2 = torch.nn.functional.pad(r2, (0, pad)).view(-1, tile).sum(1)
    rows = torch.full((T + pad,), float(B * H * D), dtype=torch.float64,
                      device=ref.device)
    rows[T:] = 0
    n = rows.view(-1, tile).sum(1)
    return (e2 / torch.maximum(r2, floor ** 2 * n)).sqrt().max().item()


def lse_err(torch, l, ref) -> float:
    """|L - L_ref| over rows with a visible key (both NEG_INF elsewhere)."""
    if not l.numel():
        return 0.0
    vis = ref > -1e29
    if not torch.equal(vis, l > -1e29):
        return float("inf")
    return (l - ref).abs().masked_fill(~vis, 0).max().item()


def flash_sweep():
    """(dtype, D, T, causal, window, masked) of the kernel sweeps; head
    dims 8, 48, 160, 320 and 600 are zero-padded to 16, 64, 192, 384 and
    640 inside the wrappers. The wide head dims run at T around the
    32-row tiles of the CUDA-core kernels: bf16 K3, K4 and K5 at 160 to
    512 on the wgmma kernels, every bf16 kernel above on the CUDA-core
    kernels widened to fp32, fp32 on those at every D (above 512 the
    kernels that stream the head dim in chunks)."""
    for dt in ("float32", "bfloat16"):
        for D in (32, 64, 128):
            for T in (1, 63, 64, 65, 200, 1000):
                for causal in (False, True):
                    for window in (0, 17, 256):
                        for masked in (False, True):
                            yield dt, D, T, causal, window, masked
        for D in (8, 48):
            for masked in (False, True):
                yield dt, D, 1024, True, 0, masked
        for D in FLASH_WIDE_D:
            for T in (31, 33, 200):
                for causal, window in ((False, 0), (True, 0), (True, 17),
                                       (False, 17)):
                    for masked in (False, True):
                        yield dt, D, T, causal, window, masked


# head dims above 128 (320 pads to 384, 600 to 640), and the timings: (D,
# T) at B*H 16, the training T up to D 512, T 1024 at D 384, 512 and 1024
FLASH_WIDE_D = (160, 192, 256, 320, 512, 600)
FLASH_TIMED = ((128, TRAIN_T), (192, TRAIN_T), (256, TRAIN_T), (384, 1024),
               (384, TRAIN_T), (512, 1024), (512, TRAIN_T), (1024, 1024))
# flash_head_dims holds K3, K4 and K5 against the plain versions at these
# head dims (T 1024, B*H 16, a random key mask, both dtypes)
FLASH_CHECKED_D, FLASH_CHECKED_T = (192, 256, 384, 512, 640, 1024), 1024
# the stacks of flash_head_dims: SelfAttentionLayer(d_model, 2 heads,
# causal, block 256) + RnnOutputLayer, T 1024, batch 2; d_model 512 (head
# dim 256) and WIDE512_D_MODEL (head dim 512)
WIDE_B, WIDE_T, WIDE_D_MODEL, WIDE_HEADS, WIDE_BLOCK, WIDE_CLASSES = \
    2, 1024, 512, 2, 256, 16
WIDE512_D_MODEL = 1024


def train_shape_case(torch, seed):
    return flash_case(torch, TRAIN_B, TRAIN_HEADS, TRAIN_HEADS, TRAIN_T,
                      TRAIN_D_MODEL // TRAIN_HEADS, torch.bfloat16, False,
                      seed)



# ------------------------------------------------ the wgmma kernels' build
SM90_KINDS = {"flash_fwd_sm90_kernel": 0, "flash_dq_sm90_kernel": 1,
              "flash_dkv_sm90_kernel": 2, "flash_bwd_fused_sm90_kernel": 3,
              "flash_dkv_wide_sm90_kernel": 2,
              "flash_bwd_fused_wide_sm90_kernel": 3,
              "flash_fwd_split_sm90_kernel": 0,
              "flash_dq_split_sm90_kernel": 1,
              "flash_dkv_split_sm90_kernel": 2,
              "flash_bwd_fused_split_sm90_kernel": 3}


def sm90_instances(fa):
    """(kernel, D) of every wgmma flash instance: K3 and K5's dq pass up
    to D 256, K5's dk/dv pass and K4 up to D 128, the wide dk/dv pass and
    K4's wide instance at 192/256, and the split K3, dq and dk/dv passes
    and K4's split instance at 384/512."""
    for D in fa.HEAD_DIMS:
        split = "_split" if D > 256 else ""
        yield f"flash_fwd{split}_sm90_kernel", D
        yield f"flash_dq{split}_sm90_kernel", D
        wide = split or ("_wide" if D > 128 else "")
        yield f"flash_dkv{wide}_sm90_kernel", D
        yield f"flash_bwd_fused{wide}_sm90_kernel", D
# K4 sums dq across CTAs by TMA reductions in L2, and only K4 may
SM90_REDUCING = ("flash_bwd_fused_sm90_kernel",
                 "flash_bwd_fused_wide_sm90_kernel",
                 "flash_bwd_fused_split_sm90_kernel")
ATOMIC_OPS = ("ATOM", "ATOMS", "ATOMG")
REDUCE_OPS = ("UBLKRED", "UTMAREDG")          # and every RED* (RED, REDG)


def sm90_kernel_key(name: str):
    """(kernel, D) of a mangled sm90 flash kernel name, else None."""
    m = re.search(r"(flash_(?:fwd|dq|dkv|dkv_wide|bwd_fused|bwd_fused_wide"
                  r"|fwd_split|dq_split|dkv_split|bwd_fused_split)"
                  r"_sm90_kernel)"
                  r"ILi(\d+)EE", name)
    return (m.group(1), int(m.group(2))) if m else None


def new_kernel_key(name: str):
    """(kernel, template argument) of a mangled name of the later slices'
    kernels: K10's conv1x1_sm90<path, G> ("path.G"), K7's
    scan_fwd_cluster<H> and scan_bwd_cluster<H>, and K7's dRW kernel
    drw_sm90 (argument "bf16"), else None."""
    m = re.search(r"(conv1x1_sm90)ILi(\d)ELi(\d)EE", name)
    if m:
        return m.group(1), f"{m.group(2)}.{m.group(3)}"
    m = re.search(r"(drw_sm90)E", name)
    if m:
        return m.group(1), "bf16"
    m = re.search(r"(scan_(?:fwd|bwd)_cluster)ILi(\d+)EE", name)
    return (m.group(1), int(m.group(2))) if m else None


def ptxas_kernels(log: str, kernel_key=sm90_kernel_key) -> dict:
    """Registers, spill bytes and static shared memory of each kernel that
    `kernel_key` names from nvcc's -Xptxas -v log, with the warnings ptxas
    gave for it."""
    out, cur, notes = {}, None, []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            key = kernel_key(m.group(1))
            cur = None if key is None else f"{key[0]}<{key[1]}>"
            if cur:
                out[cur] = {"warnings": []}
            continue
        if "Performance" in ln or "setmaxnreg" in ln:
            notes.append(ln)        # ptxas names the function it concerns
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[cur]["stack_frame"] = int(m.group(1))
            out[cur]["spill_stores"] = int(m.group(2))
            out[cur]["spill_loads"] = int(m.group(3))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[cur]["static_smem"] = int(sm.group(1)) if sm else 0
    for ln in notes:
        key = kernel_key(ln)
        if key and f"{key[0]}<{key[1]}>" in out:
            out[f"{key[0]}<{key[1]}>"]["warnings"].append(
                re.sub(r"'\S+'", "", ln).strip()[:160])
    return out


def cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy the triton package ships."""
    import shutil
    path = shutil.which("cuobjdump")
    if path is None and os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        path = "/usr/local/cuda/bin/cuobjdump"
    if path is None:
        try:
            import triton
            cand = os.path.join(os.path.dirname(triton.__file__), "backends",
                                "nvidia", "bin", "cuobjdump")
            path = cand if os.path.exists(cand) else None
        except ImportError:
            path = None
    if path is None:
        fail("no cuobjdump (CUDA toolkit or triton) to read the SASS")
    return path


# TMA stores, bulk copies (into a peer's shared memory), cluster barriers,
# cp.async and st.async (stores into a peer's shared memory that complete
# on its mbarrier), counted for the later slices' kernels
NEW_OPS = ("UTMASTG", "UBLKCP", "UCGABAR_ARV", "UCGABAR_WAIT", "LDGSTS",
           "STAS")


def sass_counts(lib_path: str, kernel_key=sm90_kernel_key,
                ops=NEW_OPS) -> dict:
    """HGMMA, UTMALDG, atomic and reduction instructions (and `ops`) of
    each kernel that `kernel_key` names in the SASS of the built library
    (the reductions by name too)."""
    sass = subprocess.run([cuobjdump(), "-sass", lib_path],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr[-2000:]}")
    out, cur = {}, None
    for ln in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            key = kernel_key(m.group(1))
            cur = None if key is None else f"{key[0]}<{key[1]}>"
            if cur:
                out[cur] = {"HGMMA": 0, "UTMALDG": 0, "atomic": 0,
                            "reduction": 0, "reduction_ops": {}}
                if kernel_key is not sm90_kernel_key:
                    out[cur].update(dict.fromkeys(ops, 0))
            continue
        if cur is None:
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     ln)
        if not m:
            continue
        op = m.group(1).split(".")[0]
        if op in ("HGMMA", "UTMALDG") or op in out[cur]:
            out[cur][op] += 1
        elif op in ATOMIC_OPS:
            out[cur]["atomic"] += 1
        elif op.startswith("RED") or op in REDUCE_OPS:
            out[cur]["reduction"] += 1
            full = m.group(1)
            ops = out[cur]["reduction_ops"]
            ops[full] = ops.get(full, 0) + 1
    return out


def sm90_build_report(built: dict) -> dict:
    """Per sm90 kernel: registers, spills, shared memory (static from
    ptxas, dynamic from the library) and the SASS counts. Fails when a
    kernel has no HGMMA or no UTMALDG, holds an atomic, holds a reduction
    where none belongs (K3, K5), none where its dq needs them (K4) or one
    that is not a TMA reduction (UTMAREDG), or spills at D 64. The D
    192/256 instances (K3, K5's dq pass, the wide dk/dv pass and K4's wide
    instance) and the D 384/512 split instances (K3, K5's dq and dk/dv
    passes, K4's split instance) report their registers and spills."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    b = built[fa.SM90_SOURCE]
    lib = fa._library(fa.SM90_SOURCE)
    regs, sass = ptxas_kernels(b["log"]), sass_counts(b["path"])
    report = {}
    for kern, D in sm90_instances(fa):
        key = f"{kern}<{D}>"
        if key not in sass or key not in regs:
            fail(f"{key}: not in the built library (ptxas "
                 f"{sorted(regs)}, sass {sorted(sass)})")
        r = dict(regs[key], **sass[key])
        r["dynamic_smem"] = lib.dl4j_flash_sm90_smem(SM90_KINDS[kern], D)
        report[key] = r
        if not (r["HGMMA"] > 0 and r["UTMALDG"] > 0):
            fail(f"{key}: {r['HGMMA']} HGMMA and {r['UTMALDG']} UTMALDG "
                 "instructions in its SASS")
        if r["atomic"]:
            fail(f"{key}: {r['atomic']} atomic instructions in its SASS")
        if bool(r["reduction"]) != (kern in SM90_REDUCING) or any(
                not op.startswith("UTMAREDG") for op in r["reduction_ops"]):
            fail(f"{key}: {r['reduction']} reduction instructions in "
                 f"its SASS ({r['reduction_ops']})")
        if D == 64 and r.get("spill_stores", 1) != 0:
            fail(f"{key}: {r.get('spill_stores')} bytes of spill stores")
    return report


# K10's load paths as (path code, G) of conv1x1_sm90<path, G>, and the
# instances ResNet50's shapes run: P 784, 16, 196 (G 4) and 49 (bulk)
K10_INSTANCES = ("0.8", "1.8", "2.8", "2.4", "2.2", "3.1", "4.1")
K10_MAIN = ("0.8", "1.8", "2.4", "4.1")
K7_CLUSTER_H = (64, 128, 256)


def new_build_report(built: dict) -> dict:
    """K10's bf16 kernel (each load path), K7's cluster forward and
    backward sweep (each H) and K7's bf16 dRW kernel: registers, spills,
    shared memory (dynamic from the library), SASS counts of HGMMA,
    UTMALDG, UTMASTG, UBLKCP, cluster barriers, cp.async (LDGSTS),
    st.async (STAS), atomics and reductions, and the clusters the card
    holds at once. Fails when a kernel has no HGMMA, holds an atomic or a
    reduction, or spills at a shape of the main path (K10's four ResNet50
    paths, K7 at H 256, the dRW kernel)."""
    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    from deeplearning4j_tpu_torch.ops import lstm_scan_fused as ts
    report = {}
    for source, lib, names in (
            (cf.SOURCE, cf._library(),
             [f"conv1x1_sm90<{k}>" for k in K10_INSTANCES]),
            (ts.SM90_SOURCE, ts._cluster_library(),
             [f"scan_fwd_cluster<{h}>" for h in K7_CLUSTER_H]),
            (ts.BWD_SM90_SOURCE, ts._bwd_library(),
             [f"scan_bwd_cluster<{h}>" for h in K7_CLUSTER_H]
             + ["drw_sm90<bf16>"])):
        b = built[source]
        regs = ptxas_kernels(b["log"], new_kernel_key)
        sass = sass_counts(b["path"], new_kernel_key)
        for key in names:
            if key not in sass or key not in regs:
                fail(f"{key}: not in the built library (ptxas "
                     f"{sorted(regs)}, sass {sorted(sass)})")
            r = dict(regs[key], **sass[key])
            arg = key[key.index("<") + 1:-1]
            if key.startswith("conv1x1"):
                r["dynamic_smem"] = lib.dl4j_conv1x1_smem(2, int(arg[0]))
                main = arg in K10_MAIN
            elif key.startswith("drw_sm90"):
                main = True
            elif key.startswith("scan_fwd"):
                r["dynamic_smem"] = lib.dl4j_lstm_scan_fwd_cluster_smem(
                    int(arg))
                r["active_clusters"] = lib.dl4j_lstm_scan_fwd_clusters(
                    int(arg))
                main = int(arg) == LSTM_H
            else:
                r["dynamic_smem"] = lib.dl4j_lstm_scan_bwd_cluster_smem(
                    int(arg))
                r["active_clusters"] = lib.dl4j_lstm_scan_bwd_clusters(
                    int(arg))
                main = int(arg) == LSTM_H
            report[key] = r
            if not r["HGMMA"]:
                fail(f"{key}: no HGMMA in its SASS")
            if r["atomic"] or r["reduction"]:
                fail(f"{key}: {r['atomic']} atomic and {r['reduction']} "
                     "reduction instructions in its SASS")
            if main and r.get("spill_stores", 1) != 0:
                fail(f"{key}: {r.get('spill_stores')} bytes of spill stores "
                     "at a shape of the main path")
    return report


# K8/K9's and K11's instances on the main paths (bf16 cells on 16-byte
# rows, fp32 encoding): no spill, and 16-byte loads and stores
GATES_ENCODE_MAIN = ("gates_fwd_kernel<bf16.8.1>", "gates_fwd_kernel<bf16.8.0>",
                     "gates_bwd_kernel<bf16.8.8.1>",
                     "gates_bwd_kernel<bf16.8.8.0>",
                     "threshold_encode_kernel<f32.f32>")
_SASS_DTYPE = {"13__nv_bfloat16": "bf16", "f": "f32", "d": "f64"}


def gates_encode_kernel_key(name: str):
    """(kernel, template arguments) of a mangled K8/K9 or K11 kernel name:
    gates_fwd_kernel<dtype.V.peep>, gates_bwd_kernel<dtype.V.CV.peep>,
    threshold_encode_kernel<dtype.compute dtype>, else None."""
    m = re.search(r"(gates_(?:fwd|bwd)_kernel)I(13__nv_bfloat16|f)"
                  r"((?:Li\d+E)+)Lb([01])E", name)
    if m:
        ints = re.findall(r"Li(\d+)E", m.group(3))
        return m.group(1), ".".join([_SASS_DTYPE[m.group(2)], *ints,
                                     m.group(4)])
    m = re.search(r"(threshold_encode_kernel)I(13__nv_bfloat16|f|d)(f|d)E",
                  name)
    return (m.group(1), f"{_SASS_DTYPE[m.group(2)]}."
            f"{_SASS_DTYPE[m.group(3)]}") if m else None


def access_counts(lib_path: str, kernel_key) -> dict:
    """Global loads and stores of 16 bytes (LDG/STG .128) and narrower,
    and atomics, of each kernel that `kernel_key` names in the SASS."""
    sass = subprocess.run([cuobjdump(), "-sass", lib_path],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr[-2000:]}")
    out, cur = {}, None
    for ln in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            key = kernel_key(m.group(1))
            cur = None if key is None else f"{key[0]}<{key[1]}>"
            if cur:
                out[cur] = dict.fromkeys(("LDG.128", "LDG", "STG.128", "STG",
                                          "atomic"), 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)", ln)
        if cur is None or not m:
            continue
        full = m.group(1)
        op = full.split(".")[0]
        if op in ("LDG", "STG"):
            out[cur][op + (".128" if ".128" in full else "")] += 1
        elif op in ATOMIC_OPS or op.startswith("RED"):
            out[cur]["atomic"] += 1
    return out


def gates_encode_build_report(built: dict) -> dict:
    """K8/K9's (lstm_gates.cu) and K11's (threshold_encode.cu) instances:
    registers, spills, static shared memory, and SASS counts of 16-byte and
    narrower global loads and stores and of atomics. Fails when an
    instance of GATES_ENCODE_MAIN spills or moves no 16-byte vector, or
    when an atomic sits anywhere but K8's backward (its ticket)."""
    from deeplearning4j_tpu_torch.ops import lstm_gates as tg
    from deeplearning4j_tpu_torch.ops import threshold_encode as te
    report = {}
    for source in (tg.SOURCE, te.SOURCE):
        b = built[source]
        regs = ptxas_kernels(b["log"], gates_encode_kernel_key)
        counts = access_counts(b["path"], gates_encode_kernel_key)
        for key in sorted(regs):
            report[key] = dict(regs[key], **counts.get(key, {}))
    for key in GATES_ENCODE_MAIN:
        r = report.get(key)
        if r is None or r.get("spill_stores", 1) or not (
                r.get("LDG.128") and r.get("STG.128")):
            fail(f"{key}: missing, spilling or without 16-byte accesses: "
                 f"{r}")
    for key, r in report.items():
        if r.get("atomic") and not (key.startswith("gates_bwd_kernel")
                                    and key.endswith(".1>")):
            fail(f"{key}: {r['atomic']} atomics")
    return report


# K1/K2's instances flash_decode_paged_kernel<q, pool, vec> (dtype codes 0
# fp32, 1 fp16, 2 bf16, 3 int8; vec 1: 16-byte cp.async rows), and those of
# the served pools (bf16 and int8, bf16 queries); tensor-core products
# (HMMA), ldmatrix (LDSM) and cp.async (LDGSTS) counted
DECODE_OPS = ("HMMA", "LDSM", "LDGSTS")
K1_INSTANCES = tuple(f"{q}.{kv}.{v}" for q, kv in (
    (0, 0), (1, 1), (2, 2), (0, 3), (1, 3), (2, 3)) for v in (0, 1))
K1_MAIN = ("2.2.1", "2.3.1")


def decode_kernel_key(name: str):
    """(kernel, "q.pool.vec") of a mangled K1/K2 kernel name, else None."""
    m = re.search(r"(flash_decode_paged_kernel)ILi(\d)ELi(\d)ELb(\d)EE",
                  name)
    return (m.group(1), f"{m.group(2)}.{m.group(3)}.{m.group(4)}") \
        if m else None


def decode_build_report(built: dict) -> dict:
    """K1/K2's twelve instances: registers, spills and the SASS counts of
    HMMA, LDSM, LDGSTS, atomics and reductions. Fails when an instance is
    missing, a tensor-core instance (2-byte queries) has no HMMA, a
    16-byte-row instance no LDGSTS, an instance no atomic (its ticket) or
    a reduction, or a served instance spills."""
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    b = built[da.SOURCE]
    regs = ptxas_kernels(b["log"], decode_kernel_key)
    sass = sass_counts(b["path"], decode_kernel_key, DECODE_OPS)
    report = {}
    for inst in K1_INSTANCES:
        key = f"flash_decode_paged_kernel<{inst}>"
        if key not in sass or key not in regs:
            fail(f"{key}: not in the built library (ptxas {sorted(regs)}, "
                 f"sass {sorted(sass)})")
        r = report[key] = dict(regs[key], **sass[key])
        qc, _, vec = inst.split(".")
        if (qc != "0") != (r["HMMA"] > 0) or (vec == "1") != \
                (r["LDGSTS"] > 0) or not r["atomic"] or r["reduction"]:
            fail(f"{key}: {r['HMMA']} HMMA, {r['LDGSTS']} LDGSTS, "
                 f"{r['atomic']} atomic and {r['reduction']} reduction "
                 "instructions in its SASS")
        if inst in K1_MAIN and r.get("spill_stores", 1) != 0:
            fail(f"{key}: {r.get('spill_stores')} bytes of spill stores")
    return report


def phase_kernel_flash(torch):
    """K3 against flash_fwd_plain over the sweep (GQA Hk 4 and 2 of H 4),
    then at the training shape, timed beside the plain version and
    scaled_dot_product_attention (a yardstick, never the route)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    worst, worst_rel, n_cases = {}, {}, 0
    for dt, D, T, causal, window, masked in flash_sweep():
        for Hk in (4, 2):
            q, k, v, _, m = flash_case(torch, 2, 4, Hk, T, D,
                                       getattr(torch, dt), masked,
                                       seed=n_cases)
            o, l = fa.flash_attention_fwd_cuda(q, k, v, m, causal, None,
                                               window)
            ro, rl = fa.flash_fwd_plain(q, k, v, m, causal, None, window)
            torch.cuda.synchronize()
            err = max(max_err(o, ro), lse_err(torch, l, rl))
            rel = tile_rel_err(torch, o, ro, FLASH_REF_FLOOR[dt])
            if not (err <= FLASH_TOL[dt] and rel <= FLASH_REL_TOL[dt]):
                fail(f"K3 vs plain: {dt} D={D} T={T} causal={causal} "
                     f"window={window} masked={masked} Hk={Hk}: max abs "
                     f"err {err} (limit {FLASH_TOL[dt]}), tile rel err "
                     f"{rel} (limit {FLASH_REL_TOL[dt]})")
            worst[dt] = max(worst.get(dt, 0.0), err)
            worst_rel[dt] = max(worst_rel.get(dt, 0.0), rel)
            n_cases += 1
    q, k, v, _, _ = train_shape_case(torch, 4242)
    o, l = fa.flash_attention_fwd_cuda(q, k, v, None, True)
    ro, rl = fa.flash_fwd_plain(q, k, v, None, True)
    train_err = max(max_err(o, ro), lse_err(torch, l, rl))
    train_rel = tile_rel_err(torch, o, ro, FLASH_REF_FLOOR["bfloat16"])
    del ro, rl
    if not (train_err <= FLASH_TOL["bfloat16"]
            and train_rel <= FLASH_REL_TOL["bfloat16"]):
        fail(f"K3 vs plain at the training shape: max abs err {train_err}, "
             f"tile rel err {train_rel}")
    o2, l2 = fa.flash_attention_fwd_cuda(q, k, v, None, True)
    if not (torch.equal(o, o2) and torch.equal(l, l2)):
        fail("K3: two calls on the same inputs differ")
    del o2, l2
    ms = event_ms(torch, lambda: fa.flash_attention_fwd_cuda(q, k, v, None,
                                                             True))
    plain_ms = event_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, None,
                                                          True), iters=3)
    library_ms = event_ms(torch, lambda: torch.nn.functional
                          .scaled_dot_product_attention(q, k, v,
                                                        is_causal=True))
    B, H, T, D = q.shape
    nbytes, ops, bound_ms, bound_by = flash_bound(
        "fwd", B, H, T, D, 2, visible_pairs(T, True, 0))
    res = {"phase": "kernel_flash", "cases": n_cases, "max_abs_err": worst,
           "tile_rel_err": worst_rel, "tolerance": FLASH_TOL,
           "rel_tolerance": FLASH_REL_TOL, "ref_floor": FLASH_REF_FLOOR,
           "train_shape": {
               "B": B, "H": H, "T": T, "D": D, "causal": True,
               "dtype": "bfloat16"},
           "train_max_abs_err": train_err, "train_tile_rel_err": train_rel,
           "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "ops": ops,
           "tflops": ops / ms / 1e9, "bound_share": bound_ms / ms,
           "bitwise_repeat": True}
    emit(res)
    return res


def phase_kernel_flash_bwd(torch):
    """K4 and K5 against flash_bwd_plain over the sweep (full heads), K4
    against K5, with a non-zero dlse (the flash_attention_lse cotangent)
    in every other case; then the training shape, timed beside the plain
    version and the backward of scaled_dot_product_attention."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    worst, worst_rel, worst_45, n_cases = {}, {}, {}, 0
    for dt, D, T, causal, window, masked in flash_sweep():
        q, k, v, do, m = flash_case(torch, 2, 4, 4, T, D, getattr(torch, dt),
                                    masked, seed=9000 + n_cases)
        o, l = fa.flash_fwd_plain(q, k, v, m, causal, None, window)
        dlse = None if n_cases % 2 else 0.3 * torch.randn(
            l.shape, device="cuda", generator=torch.Generator(
                "cuda").manual_seed(n_cases))
        ref = fa.flash_bwd_plain(q, k, v, m, o, l, do, dlse, causal, None,
                                 window)
        got = {mode: fa.flash_attention_bwd_cuda(q, k, v, m, o, l, do, dlse,
                                                 causal, None, window, mode)
               for mode in fa.BWD_MODES}
        torch.cuda.synchronize()
        for mode, g in got.items():
            err = max(max_err(a, b) for a, b in zip(g, ref))
            rel = max(tile_rel_err(torch, a, b, FLASH_REF_FLOOR[dt])
                      for a, b in zip(g, ref))
            if not (err <= FLASH_TOL[dt] and rel <= FLASH_REL_TOL[dt]):
                fail(f"{mode} backward vs plain: {dt} D={D} T={T} "
                     f"causal={causal} window={window} masked={masked} "
                     f"dlse={dlse is not None}: max abs err {err}, tile "
                     f"rel err {rel}")
            key = f"{mode}_{dt}"
            worst[key] = max(worst.get(key, 0.0), err)
            worst_rel[key] = max(worst_rel.get(key, 0.0), rel)
        e45 = max(max_err(a, b) for a, b in zip(got["fused"],
                                                got["two_pass"]))
        if not e45 <= FLASH_TOL[dt]:
            fail(f"K4 vs K5: {dt} D={D} T={T}: {e45}")
        worst_45[dt] = max(worst_45.get(dt, 0.0), e45)
        n_cases += 1
    q, k, v, do, _ = train_shape_case(torch, 4343)
    o, l = fa.flash_attention_fwd_cuda(q, k, v, None, True)
    ref = fa.flash_bwd_plain(q, k, v, None, o, l, do, None, True)
    train_err, train_rel = {}, {}
    got = {}
    for mode in fa.BWD_MODES:
        g = got[mode] = fa.flash_attention_bwd_cuda(
            q, k, v, None, o, l, do, None, True, None, 0, mode)
        train_err[mode] = max(max_err(a, b) for a, b in zip(g, ref))
        train_rel[mode] = {
            n: tile_rel_err(torch, a, b, FLASH_REF_FLOOR["bfloat16"])
            for n, a, b in zip(("dq", "dk", "dv"), g, ref)}
        if not (train_err[mode] <= FLASH_TOL["bfloat16"]
                and max(train_rel[mode].values())
                <= FLASH_REL_TOL["bfloat16"]):
            fail(f"{mode} backward at the training shape: max abs err "
                 f"{train_err[mode]}, tile rel err {train_rel[mode]}")
    g2 = fa.flash_attention_bwd_cuda(q, k, v, None, o, l, do, None, True,
                                     None, 0, "two_pass")
    if not all(torch.equal(a, b) for a, b in zip(got["two_pass"], g2)):
        fail("K5: two calls on the same inputs give other dq, dk or dv")
    g4 = fa.flash_attention_bwd_cuda(q, k, v, None, o, l, do, None, True,
                                     None, 0, "fused")
    if not all(torch.equal(a, b) for a, b in zip(got["fused"][1:], g4[1:])):
        fail("K4: two calls on the same inputs give other dk or dv")
    repeat_dq_err = max_err(got["fused"][0], g4[0])
    del ref, g, g2, g4, got
    ms = {mode: event_ms(torch, lambda mode=mode: fa.flash_attention_bwd_cuda(
        q, k, v, None, o, l, do, None, True, None, 0, mode))
        for mode in fa.BWD_MODES}
    plain_ms = event_ms(torch, lambda: fa.flash_bwd_plain(
        q, k, v, None, o, l, do, None, True), iters=2)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr,
                                                           is_causal=True)
    library_ms = event_ms(torch, lambda: torch.autograd.grad(
        out, (qr, kr, vr), do, retain_graph=True))
    B, H, T, D = q.shape
    bounds = {mode: flash_bound(mode, B, H, T, D, 2,
                                visible_pairs(T, True, 0))
              for mode in fa.BWD_MODES}
    res = {"phase": "kernel_flash_bwd", "cases": n_cases,
           "max_abs_err": worst, "tile_rel_err": worst_rel,
           "max_abs_err_k4_vs_k5": worst_45, "tolerance": FLASH_TOL,
           "rel_tolerance": FLASH_REL_TOL, "ref_floor": FLASH_REF_FLOOR,
           "train_max_abs_err": train_err,
           "train_tile_rel_err": train_rel,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": {m: b[2] for m, b in bounds.items()},
           "bound_by": {m: b[3] for m, b in bounds.items()},
           "bytes": {m: b[0] for m, b in bounds.items()},
           "ops": {m: b[1] for m, b in bounds.items()},
           "design_ops": {m: b[1] * FLASH_BWD_DESIGN_PRODUCTS[m] // 5
                          for m, b in bounds.items()},
           "tflops": {m: bounds[m][1] / ms[m] / 1e9 for m in ms},
           "bound_share": {m: bounds[m][2] / ms[m] for m in ms},
           "bitwise_repeat": {"two_pass": True, "fused_dk_dv": True},
           "fused_repeat_dq_max_abs_err": repeat_dq_err}
    emit(res)
    return res


def build_train_net(torch, compute_dtype):
    """The bench's long-context stack (bench.py bench_attention_longcontext)
    at full width: 2 causal SelfAttentionLayer(256, 4 heads, block 512) +
    RnnOutputLayer(64, SOFTMAX), float32 params, Sgd(1e-3), XAVIER, seed
    42; `compute_dtype` "bfloat16" as the bench runs it, or None."""
    from deeplearning4j_tpu_torch import (Activation, InputType,
                                          MultiLayerNetwork,
                                          NeuralNetConfiguration,
                                          RnnOutputLayer, SelfAttentionLayer,
                                          WeightInit)
    from deeplearning4j_tpu_torch.nn.updater.updaters import Sgd
    b = (NeuralNetConfiguration.Builder().seed(42)
         .weight_init(WeightInit.XAVIER).updater(Sgd(learning_rate=1e-3))
         .compute_dtype(compute_dtype).list())
    for _ in range(2):
        b.layer(SelfAttentionLayer(n_out=TRAIN_D_MODEL, n_heads=TRAIN_HEADS,
                                   causal=True, block_size=512))
    b.layer(RnnOutputLayer(n_out=TRAIN_CLASSES,
                           activation=Activation.SOFTMAX))
    conf = b.set_input_type(InputType.recurrent(TRAIN_D_MODEL,
                                                TRAIN_T)).build()
    return MultiLayerNetwork(conf, device="cuda").init()


def train_data(np):
    """The bench's data: RandomState(0), x = rand(4, 256, 8192), y one-hot
    of randint(0, 64, (4, 8192)) as (4, 64, 8192)."""
    rng = np.random.RandomState(0)
    x = rng.rand(TRAIN_B, TRAIN_D_MODEL, TRAIN_T).astype(np.float32)
    y = np.eye(TRAIN_CLASSES, dtype=np.float32)[
        rng.randint(0, TRAIN_CLASSES, (TRAIN_B, TRAIN_T))].transpose(0, 2, 1)
    return x, y


def flash_launches(fa) -> dict:
    return {"K3": fa.flash_attention_fwd_cuda.launches,
            "K4": fa.flash_attention_bwd_cuda.fused_launches,
            "K5": fa.flash_attention_bwd_cuda.two_pass_launches}


def reset_flash_launches(fa) -> None:
    fa.flash_attention_fwd_cuda.launches = 0
    fa.flash_attention_bwd_cuda.fused_launches = 0
    fa.flash_attention_bwd_cuda.two_pass_launches = 0


def phase_train(torch, np):
    """fit_on_device(x, y, steps=5, sync=False) after one warm step, then
    two fit(x, y) steps, the same timed fit_on_device under
    configure(bwd="two_pass") after a warm step of its own, and one
    output() at T > block_size; launch counts zeroed just before each run
    and read just after. Every loss must be finite."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    net = build_train_net(torch, "bfloat16")
    x_np, y_np = train_data(np)
    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()
    steps = 5
    warm = net.fit_on_device(x, y, steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_flash_launches(fa)                           # main path starts
    t0 = time.perf_counter()
    losses = net.fit_on_device(x, y, steps=steps, sync=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_launches(fa)                      # main path ends
    peak = torch.cuda.max_memory_allocated()
    losses = losses.cpu().numpy().tolist()
    diverged = net._diverged_at
    reset_flash_launches(fa)
    t0 = time.perf_counter()
    fit_losses = []
    for _ in range(2):
        net.fit(x, y)
        fit_losses.append(net.score())
    fit_wall = time.perf_counter() - t0
    fit_launches = flash_launches(fa)
    prev = fa.configure(bwd="two_pass")
    try:
        net.fit_on_device(x, y, steps=1)               # warm step
        torch.cuda.synchronize()
        reset_flash_launches(fa)
        t0 = time.perf_counter()
        tp_losses = net.fit_on_device(x, y, steps=steps, sync=False)
        torch.cuda.synchronize()
        tp_wall = time.perf_counter() - t0
        tp_launches = flash_launches(fa)
        tp_losses = tp_losses.cpu().numpy().tolist()
    finally:
        fa.configure(bwd=prev[0])
    reset_flash_launches(fa)
    out = net.output(x)
    torch.cuda.synchronize()
    out_launches = flash_launches(fa)
    all_losses = list(warm) + losses + fit_losses + tp_losses
    if not all(math.isfinite(v) for v in all_losses) or diverged is not None:
        fail(f"non-finite training loss: {all_losses}")
    if launches != {"K3": 2 * steps, "K4": 2 * steps, "K5": 0}:
        fail(f"fit_on_device launches {launches}, expected 2 K3 + 2 K4 per "
             "step")
    if fit_launches != {"K3": 4, "K4": 4, "K5": 0}:
        fail(f"fit launches {fit_launches}")
    if tp_launches != {"K3": 2 * steps, "K4": 0, "K5": 4 * steps}:
        fail(f"two_pass launches {tp_launches}, expected 2 K3 + 2 + 2 K5 "
             "per step")
    if out_launches["K3"] != 2 or not bool(torch.isfinite(out).all()):
        fail(f"output(): {out_launches}, finite {bool(torch.isfinite(out).all())}")
    if not peak < 2 * 1024 ** 3:
        fail(f"peak memory {peak} B over the timed steps (limit 2 GiB)")
    tokens = TRAIN_B * TRAIN_T
    res = {"phase": "train", "config": {
               "layers": "2 x SelfAttentionLayer(256, 4 heads, causal, block "
                         "512) + RnnOutputLayer(64, SOFTMAX)",
               "batch": TRAIN_B, "T": TRAIN_T, "compute_dtype": "bfloat16",
               "params_dtype": "float32", "updater": "Sgd(1e-3)",
               "num_params": net.num_params()},
           "steps": steps, "wall_s": wall, "ms_per_step": wall / steps * 1e3,
           "tokens_per_s": tokens * steps / wall,
           "peak_bytes": peak, "peak_bytes_above_start": peak - base,
           "launches": launches, "launches_per_step": {
               k: v / steps for k, v in launches.items()},
           "losses": losses, "fit_losses": fit_losses,
           "fit_ms_per_step": fit_wall / 2 * 1e3,
           "two_pass": {"losses": tp_losses, "launches": tp_launches,
                        "steps": steps, "wall_s": tp_wall,
                        "ms_per_step": tp_wall / steps * 1e3,
                        "tokens_per_s": tokens * steps / tp_wall},
           "output_launches": out_launches}
    res["profile"] = prof = profile_train(
        torch, net, x, y, watch=("flash_bwd_fused_sm90_kernel",
                                 "flash_bwd_kv_tc_kernel"))
    seen = prof["watched_calls"]
    if prof["device_busy_s"] is not None and (
            seen["flash_bwd_fused_sm90_kernel"] != 4
            or seen["flash_bwd_kv_tc_kernel"]):
        fail(f"train profile: K4 kernels {seen}, expected 4 calls of the "
             "wgmma K4 in two steps and none of the wmma one")
    emit(res)
    return res


def profile_train(torch, net, x, y, watch=()) -> dict:
    """Device busy share and the top kernels over two fit_on_device steps,
    from torch.profiler; None where the profiler saw no device time. Each
    name in `watch` gets its calls over all device kernels whose name
    holds it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit_on_device(x, y, steps=2, sync=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us:
            rows.append((us, evt.key, evt.count))
    busy_s = sum(r[0] for r in rows) / 1e6
    rows.sort(reverse=True)
    seen = {w: sum(n for _, k, n in rows if w in k) for w in watch}
    return {"wall_s": wall, "steps": 2, "watched_calls": seen,
            "device_busy_s": busy_s if rows else None,
            "device_idle_share": 1 - busy_s / wall if rows else None,
            "top_device": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                           for us, k, n in rows[:8]]}


@contextlib.contextmanager
def plain_flash(fa, helpers):
    """Register the dense plain versions in the flash kernels' place for
    the calls inside the block."""
    helpers.register_helper("flash_attention_fwd")(fa.flash_fwd_plain)
    helpers.register_helper("flash_attention_bwd")(fa.flash_bwd_plain)
    try:
        yield
    finally:
        helpers.register_helper("flash_attention_fwd")(
            fa.flash_attention_fwd_cuda)
        helpers.register_helper("flash_attention_bwd")(
            fa.flash_attention_bwd_cuda)


def phase_train_oracle(torch, np):
    """The stack in float32 at full width: one gradient_and_score through
    the kernels, held against the same stack in float64 through the dense
    plain versions on the card (registered in the kernels' place for that
    call only), loss and every parameter gradient by max |diff| / max |ref|
    within 1e-4. The float64 dense path is the reference because the
    float32 one is not exact enough to be: at T = 8192 the second layer's
    w_q and w_k gradients are four orders of magnitude below the others
    and float32 attention (dense or kernel) resolves them to about 1e-4;
    the float32 dense path's own error against float64 is reported beside
    the kernels'.

    Then the stack as it trains, bf16 compute over the same float32
    params, where the bf16 inputs take the tensor-core (wmma) kernels: one
    gradient_and_score through them and one through the dense plain
    versions on the same inputs. Both are held against the float64
    gradient; the kernel path must agree with the plain path's loss within
    BF16_ORACLE_LOSS_TOL relative and come within BF16_ORACLE_FACTOR times
    the plain path's own error (or BF16_ORACLE_FLOOR) on every gradient."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import helpers
    from deeplearning4j_tpu_torch.util.flat_params import unflatten_params
    net = build_train_net(torch, None)
    d = json.loads(net.conf.to_json())
    d["global_conf"]["dtype"] = "float64"
    net64 = MultiLayerNetwork(MultiLayerConfiguration.from_dict(d),
                              device="cuda").init(params=net.params_tree)
    x_np, y_np = train_data(np)
    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()
    reset_flash_launches(fa)
    g_k, s_k = net.gradient_and_score(x, y)
    launches = flash_launches(fa)
    if launches["K3"] != 2 or launches["K4"] != 2:
        fail(f"train_oracle: the kernel pass launched {launches}")
    with plain_flash(fa, helpers):
        g_ref, s_ref = net64.gradient_and_score(x.double(), y.double())
        g_p32, s_p32 = net.gradient_and_score(x, y)
    torch.cuda.synchronize()
    if flash_launches(fa) != launches:
        fail("train_oracle: a dense pass launched a kernel")

    def rel_errs(g):
        out = {}
        for i, (gg, gr) in enumerate(zip(
                unflatten_params(net64.params_tree, g.double()),
                unflatten_params(net64.params_tree, g_ref))):
            for name in sorted(gr):
                out[f"{i}.{name}"] = max_err(gg[name], gr[name]) / max(
                    gr[name].abs().max().item(), 1e-300)
        return out
    rel, rel_p32 = rel_errs(g_k), rel_errs(g_p32)
    loss_rel = abs(s_k - s_ref) / max(abs(s_ref), 1e-300)
    worst = max(rel.values())
    if not (math.isfinite(s_k) and loss_rel <= 1e-4 and worst <= 1e-4):
        fail(f"train_oracle: loss rel {loss_rel}, grad rel {rel}")

    net_b = build_train_net(torch, "bfloat16")
    if not torch.equal(net_b.params(), net.params()):
        fail("train_oracle: the bf16 stack was built with other params")
    reset_flash_launches(fa)
    g_bk, s_bk = net_b.gradient_and_score(x, y)
    b_launches = flash_launches(fa)
    if b_launches["K3"] != 2 or b_launches["K4"] != 2:
        fail(f"train_oracle: the bf16 kernel pass launched {b_launches}")
    with plain_flash(fa, helpers):
        g_bp, s_bp = net_b.gradient_and_score(x, y)
    torch.cuda.synchronize()
    if flash_launches(fa) != b_launches:
        fail("train_oracle: the bf16 dense pass launched a kernel")
    rel_bk, rel_bp = rel_errs(g_bk), rel_errs(g_bp)
    b_loss_rel = abs(s_bk - s_bp) / max(abs(s_bp), 1e-300)
    b_bad = {n: (rel_bk[n], rel_bp[n]) for n in rel_bk
             if not rel_bk[n] <= max(BF16_ORACLE_FACTOR * rel_bp[n],
                                     BF16_ORACLE_FLOOR)}
    if not (math.isfinite(s_bk) and b_loss_rel <= BF16_ORACLE_LOSS_TOL) \
            or b_bad:
        fail(f"train_oracle bf16: loss rel {b_loss_rel}, gradients (kernel "
             f"rel err, plain rel err) past the limit: {b_bad}")
    res = {"phase": "train_oracle", "loss_kernels": s_k,
           "loss_dense_fp64": s_ref, "loss_rel_err": loss_rel,
           "grad_rel_err": rel, "max_grad_rel_err": worst,
           "tolerance": 1e-4, "dense_fp32": {
               "loss_rel_err": abs(s_p32 - s_ref) / max(abs(s_ref), 1e-300),
               "grad_rel_err": rel_p32,
               "max_grad_rel_err": max(rel_p32.values())},
           "launches": launches, "bf16": {
               "loss_kernels": s_bk, "loss_dense": s_bp,
               "loss_rel_err_vs_dense": b_loss_rel,
               "grad_rel_err_kernels": rel_bk, "grad_rel_err_dense": rel_bp,
               "loss_tolerance": BF16_ORACLE_LOSS_TOL,
               "factor": BF16_ORACLE_FACTOR, "floor": BF16_ORACLE_FLOOR,
               "launches": b_launches}}
    emit(res)
    return res


def build_wide_net(torch, compute_dtype, d_model=WIDE_D_MODEL):
    """One causal SelfAttentionLayer(d_model, 2 heads: head dim d_model / 2,
    block 256) + RnnOutputLayer(16, SOFTMAX), Sgd(1e-3), XAVIER, seed 7, on
    the card; at T 1024 > block it runs flash attention."""
    from deeplearning4j_tpu_torch import (Activation, InputType,
                                          MultiLayerNetwork,
                                          NeuralNetConfiguration,
                                          RnnOutputLayer, SelfAttentionLayer,
                                          WeightInit)
    from deeplearning4j_tpu_torch.nn.updater.updaters import Sgd
    b = (NeuralNetConfiguration.Builder().seed(7)
         .weight_init(WeightInit.XAVIER).updater(Sgd(learning_rate=1e-3))
         .compute_dtype(compute_dtype).list())
    b.layer(SelfAttentionLayer(n_out=d_model, n_heads=WIDE_HEADS,
                               causal=True, block_size=WIDE_BLOCK))
    b.layer(RnnOutputLayer(n_out=WIDE_CLASSES,
                           activation=Activation.SOFTMAX))
    conf = b.set_input_type(InputType.recurrent(64, WIDE_T)).build()
    return MultiLayerNetwork(conf, device="cuda").init()


def phase_flash_head_dims(torch, np):
    """K3, K4 and K5 at head dims above 128: bf16 K3, K4 and K5 at D 192 to
    512 on the wgmma kernels (at 384 and 512 the split kernels),
    everything else on the CUDA-core kernels (bf16 widened to fp32; above
    512 the kernels that stream the head dim in chunks). At B*H 16, causal,
    bf16, each (D, T) of FLASH_TIMED: CUDA-
    event times beside scaled_dot_product_attention forward and backward (a
    yardstick, never the route), bounds, the source each call took, K3
    against the plain version, two calls of K3 and K5 bit for bit, and on
    the wgmma kernels K4's dk and dv (above D 128 also equal to K5's, bit
    for bit). At each D of FLASH_CHECKED_D (T 1024, random key mask, bf16
    and fp32): K3, K4 and K5 against the plain versions, the backward from
    the plain forward's o and L with a non-zero lse cotangent, with the
    source of each. Then a head-dim-256 SelfAttentionLayer stack at T 1024
    > block 256: one gradient_and_score through the kernels in fp32 against
    the dense plain versions in fp64 (loss and every gradient within 1e-4
    relative, as train_oracle), two bf16 fit steps under the fused backward
    (1 K3 + 1 K4 a step) and two under two_pass (1 K3 + 2 K5 a step), all
    on the wgmma kernels and none on flash_attention.cu, every loss finite;
    and the same bf16 fit steps on a head-dim-512 stack (d_model
    WIDE512_D_MODEL), also only on the wgmma kernels."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import helpers
    from deeplearning4j_tpu_torch.util.flat_params import unflatten_params

    def routes():
        return (dict(fa.flash_attention_fwd_cuda.route_launches),
                dict(fa.flash_attention_bwd_cuda.route_launches))

    def took(before, dtype, D, kinds):
        """fail unless the calls since `before` were one a kind in
        `kinds`, each on the source _route names"""
        want = ({}, {})
        for kind in kinds:
            d = want[kind != "fwd"]
            src = fa._route(dtype, kind, fa._kernel_head_dim(D))
            d[src] = d.get(src, 0) + 1
        now = routes()
        got = tuple({k: v - b[k] for k, v in n.items() if v != b[k]}
                    for n, b in zip(now, before))
        if got != want:
            fail(f"flash_head_dims D={D} {dtype}: launches by source "
                 f"{got}, expected {want}")
        return {"fwd": want[0], "bwd": want[1]}

    timed = {}
    for D, T in FLASH_TIMED:
        q, k, v, do, _ = flash_case(torch, TRAIN_B, TRAIN_HEADS, TRAIN_HEADS,
                                    T, D, torch.bfloat16, False,
                                    seed=4545 + D)
        before = routes()
        o, l = fa.flash_attention_fwd_cuda(q, k, v, None, True)
        g = [fa.flash_attention_bwd_cuda(q, k, v, None, o, l, do, None, True,
                                         None, 0, mode)
             for mode in fa.BWD_MODES]
        row = {"source": took(before, torch.bfloat16, D,
                              ("fwd",) + fa.BWD_MODES)}
        # K3 and K5 hold no atomic: two calls give the same bits
        o2, l2 = fa.flash_attention_fwd_cuda(q, k, v, None, True)
        g2 = fa.flash_attention_bwd_cuda(q, k, v, None, o, l, do, None, True,
                                         None, 0, "two_pass")
        if not (torch.equal(o, o2) and torch.equal(l, l2) and all(
                torch.equal(a, b) for a, b in zip(g[1], g2))):
            fail(f"flash_head_dims D={D}: K3 or K5 differs between two "
                 "calls on the same inputs")
        row["bitwise_repeat"] = ["K3", "K5"]
        if D <= fa.SM90_MAX_D:
            # the wgmma K4 sums dk and dv in one CTA: two calls give the
            # same bits, and above D 128 the bits of K5's dk/dv pass (the
            # wide pass at 192/256, the split pass at 384/512)
            g4 = fa.flash_attention_bwd_cuda(q, k, v, None, o, l, do, None,
                                             True, None, 0, "fused")
            if not all(torch.equal(a, b) for a, b in zip(g[0][1:], g4[1:])):
                fail(f"flash_head_dims D={D}: K4's dk or dv differs "
                     "between two calls on the same inputs")
            row["bitwise_repeat"].append("K4 dk, dv")
            row["k4_dk_dv_equal_k5"] = all(
                torch.equal(a, b) for a, b in zip(g[0][1:], g[1][1:]))
            if D > 128 and not row["k4_dk_dv_equal_k5"]:
                fail(f"flash_head_dims D={D}: K4's dk or dv differs from "
                     "K5's at the same inputs")
            # K4's dq (summed by reduce-adds across the CTAs) against K5's
            # dq pass, which the plain version holds at T 1024
            row["k4_dq_vs_k5"] = [max_err(g[0][0], g[1][0]), tile_rel_err(
                torch, g[0][0], g[1][0], FLASH_REF_FLOOR["bfloat16"])]
            if not (row["k4_dq_vs_k5"][0] <= FLASH_TOL["bfloat16"] and
                    row["k4_dq_vs_k5"][1] <= FLASH_REL_TOL["bfloat16"]):
                fail(f"flash_head_dims D={D}, T={T}: K4's dq vs K5's: max "
                     "abs err, tile rel err "
                     f"{row['k4_dq_vs_k5']}")
            del g4
        del g, o2, l2, g2
        if D > 128:
            ro, rl = fa.flash_fwd_plain(q, k, v, None, True)
            row["max_abs_err"] = max(max_err(o, ro), lse_err(torch, l, rl))
            row["tile_rel_err"] = tile_rel_err(torch, o, ro,
                                               FLASH_REF_FLOOR["bfloat16"])
            del ro, rl
            if not (row["max_abs_err"] <= FLASH_TOL["bfloat16"]
                    and row["tile_rel_err"] <= FLASH_REL_TOL["bfloat16"]):
                fail(f"flash_head_dims: K3 at D={D}, T={T}: {row}")
        row["ms"] = {"K3": event_ms(torch, lambda: fa.flash_attention_fwd_cuda(
            q, k, v, None, True))}
        for mode, name in (("fused", "K4"), ("two_pass", "K5")):
            row["ms"][name] = event_ms(
                torch, lambda mode=mode: fa.flash_attention_bwd_cuda(
                    q, k, v, None, o, l, do, None, True, None, 0, mode))
        row["library_ms"] = {"fwd": event_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True))}
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True)
        row["library_ms"]["bwd"] = event_ms(torch, lambda: torch.autograd.grad(
            out, (qr, kr, vr), do, retain_graph=True))
        pairs = visible_pairs(T, True, 0)
        for kind, name in (("fwd", "K3"), ("fused", "K4")):
            b = flash_bound(kind, TRAIN_B, TRAIN_HEADS, T, D, 2, pairs)
            row.setdefault("bound_ms", {})[name] = b[2]
            row.setdefault("bound_by", {})[name] = b[3]
            row.setdefault("ops", {})[name] = b[1]
        row["bound_ms"]["K5"] = row["bound_ms"]["K4"]
        row["bound_by"]["K5"] = row["bound_by"]["K4"]
        row["tflops"] = {n: row["ops"][n if n != "K5" else "K4"] / ms / 1e9
                         for n, ms in row["ms"].items()}
        timed[f"D={D}" if T == TRAIN_T else f"D={D},T={T}"] = row
        del q, k, v, do, o, l, qr, kr, vr, out
    # K3, K4 and K5 against the plain versions, the backward from the
    # plain forward's o and L
    checked = {}
    for D in FLASH_CHECKED_D:
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            q, k, v, do, m = flash_case(torch, TRAIN_B, TRAIN_HEADS,
                                        TRAIN_HEADS, FLASH_CHECKED_T, D,
                                        dtype, True, seed=4747 + D)
            before = routes()
            o, l = fa.flash_attention_fwd_cuda(q, k, v, m, True)
            ro, rl = fa.flash_fwd_plain(q, k, v, m, True)
            dlse = 0.3 * torch.randn(rl.shape, device="cuda",
                                     generator=torch.Generator(
                                         "cuda").manual_seed(D))
            ref = fa.flash_bwd_plain(q, k, v, m, ro, rl, do, dlse, True)
            err = {"K3": max(max_err(o, ro), lse_err(torch, l, rl))}
            rel = {"K3": tile_rel_err(torch, o, ro, FLASH_REF_FLOOR[dt])}
            for mode, name in (("fused", "K4"), ("two_pass", "K5")):
                g = fa.flash_attention_bwd_cuda(q, k, v, m, ro, rl, do, dlse,
                                                True, None, 0, mode)
                err[name] = max(max_err(a, b) for a, b in zip(g, ref))
                rel[name] = max(tile_rel_err(torch, a, b, FLASH_REF_FLOOR[dt])
                                for a, b in zip(g, ref))
            torch.cuda.synchronize()
            c = checked.setdefault(f"D={D}", {})[dt] = {
                "max_abs_err": err, "tile_rel_err": rel,
                "source": took(before, dtype, D, ("fwd",) + fa.BWD_MODES)}
            if not (max(err.values()) <= FLASH_TOL[dt]
                    and max(rel.values()) <= FLASH_REL_TOL[dt]):
                fail(f"flash_head_dims: D {D}, T {FLASH_CHECKED_T}, {dt}: "
                     f"{c}")
            del q, k, v, do, m, o, l, ro, rl, dlse, ref, g
    # the head-dim-256 stack
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(WIDE_B, 64, WIDE_T).astype(
        np.float32)).cuda()
    y = torch.from_numpy(np.eye(WIDE_CLASSES, dtype=np.float32)[
        rng.randint(0, WIDE_CLASSES, (WIDE_B, WIDE_T))].transpose(
            0, 2, 1).copy()).cuda()
    net = build_wide_net(torch, None)
    d = json.loads(net.conf.to_json())
    d["global_conf"]["dtype"] = "float64"
    net64 = MultiLayerNetwork(MultiLayerConfiguration.from_dict(d),
                              device="cuda").init(params=net.params_tree)
    reset_flash_launches(fa)
    g_k, s_k = net.gradient_and_score(x, y)
    launches = flash_launches(fa)
    with plain_flash(fa, helpers):
        g_ref, s_ref = net64.gradient_and_score(x.double(), y.double())
    torch.cuda.synchronize()
    if launches != {"K3": 1, "K4": 1, "K5": 0} or \
            flash_launches(fa) != launches:
        fail(f"flash_head_dims: the fp32 pass launched {launches}, then "
             f"{flash_launches(fa)} with the plain versions")
    rel = {}
    for i, (gg, gr) in enumerate(zip(
            unflatten_params(net64.params_tree, g_k.double()),
            unflatten_params(net64.params_tree, g_ref))):
        for name in sorted(gr):
            rel[f"{i}.{name}"] = max_err(gg[name], gr[name]) / max(
                gr[name].abs().max().item(), 1e-300)
    loss_rel = abs(s_k - s_ref) / max(abs(s_ref), 1e-300)
    if not (math.isfinite(s_k) and loss_rel <= 1e-4
            and max(rel.values()) <= 1e-4):
        fail(f"flash_head_dims: head-dim-256 stack loss rel {loss_rel}, "
             f"grad rel {rel}")
    # two bf16 fit steps a schedule on each stack; each schedule must take
    # only the wgmma kernels (2 calls a direction), at head dim 256 and at
    # 512, none flash_attention.cu
    fits = {}
    sources = {"fwd": {fa.SM90_SOURCE: 2}, "bwd": {fa.SM90_SOURCE: 2}}
    for d_model in (WIDE_D_MODEL, WIDE512_D_MODEL):
        head_dim = d_model // WIDE_HEADS
        for mode, want in (("fused", {"K3": 2, "K4": 2, "K5": 0}),
                           ("two_pass", {"K3": 2, "K4": 0, "K5": 4})):
            prev = fa.configure(bwd=mode)
            try:
                net_b = build_wide_net(torch, "bfloat16", d_model)
                reset_flash_launches(fa)
                before = routes()
                losses = []
                for _ in range(2):
                    net_b.fit(x, y)
                    losses.append(net_b.score())
                torch.cuda.synchronize()
            finally:
                fa.configure(bwd=prev[0])
            b_launches = flash_launches(fa)
            wide_routes = took(before, torch.bfloat16, head_dim,
                               ("fwd", mode, "fwd", mode))
            if b_launches != want or not all(math.isfinite(v)
                                             for v in losses) \
                    or wide_routes != sources:
                fail(f"flash_head_dims: bf16 fit at head dim {head_dim} "
                     f"({mode}) launched {b_launches} on {wide_routes} "
                     f"(expected {sources}), losses {losses}")
            fits[f"head_dim={head_dim} {mode}"] = {
                "losses": losses, "launches": b_launches,
                "routes": wide_routes}
            del net_b
    res = {"phase": "flash_head_dims",
           "shape": {"B": TRAIN_B, "H": TRAIN_HEADS, "T": TRAIN_T,
                     "causal": True, "dtype": "bfloat16"},
           "timed": timed, "checked": checked,
           "stack": {"layer": f"SelfAttentionLayer({WIDE_D_MODEL}, "
                              f"{WIDE_HEADS} heads, block {WIDE_BLOCK})",
                     "T": WIDE_T, "B": WIDE_B, "head_dim": 256,
                     "head_dim_512_layer": f"SelfAttentionLayer("
                                           f"{WIDE512_D_MODEL}, {WIDE_HEADS} "
                                           "heads)",
                     "loss_rel_err": loss_rel, "grad_rel_err": rel,
                     "max_grad_rel_err": max(rel.values()),
                     "tolerance": 1e-4, "launches": launches,
                     "bf16_fits": fits}}
    emit(res)
    return res


# ------------------------------------------------------------- LSTM slice
# The char-RNN of bench.py bench_graves_lstm (zoo TextGenerationLSTM:
# GravesLSTM(256) x 2 + RnnOutputLayer(47), tBPTT 50, RmsProp(0.01), l2
# 1e-3, XAVIER) at batch 8192, T 100, bf16 compute over fp32 params.
LSTM_VOCAB, LSTM_B, LSTM_T, LSTM_H = 47, 8192, 100, 256
GEN_B, GEN_PRIME, GEN_STEPS = 32, 50, 100
# K7 sweep limits: per time step, ||kernel - plain|| / max(||plain||,
# floor * sqrt(n)) (the whole tensor for dRW and the peephole gradients);
# the floor keeps steps whose reference is rounding noise (a zero state
# and zero cotangent give exact zeros) from dividing by ~0. bf16 rounding
# flips of h and c propagate through the recurrence, so bf16 is also held
# against the fp64 plain version: the kernel's error there within
# LSTM_FP64_FACTOR times the bf16 plain version's own (or the floor).
LSTM_REL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LSTM_REF_FLOOR = {"float32": 1e-3, "bfloat16": 1e-2}
LSTM_FP64_FACTOR = 2.0
# K8/K9: one rounding to the storage dtype; fp32 transcendentals may
# differ in the last bits, bf16 by one ulp (2**-8 relative).
GATES_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# lstm_oracle: loss within 1e-5 relative of the fp64 plain path (fp32) or
# of the plain path in the same compute dtype (bf16: BF16_ORACLE_LOSS_TOL),
# every gradient within LSTM_FP64_FACTOR times the plain path's own error
# against fp64 (max |diff| / max |ref|), or the floor where that error is
# smaller; the fp32 floor sits below every fp32 plain error (~3e-7).
LSTM_ORACLE_LOSS_TOL = 1e-5
ORACLE_GRAD_FLOOR = {"fp32": 1e-7, "bf16": BF16_ORACLE_FLOOR}
# K8/K9 operations per (row, column): forward 5 transcendentals + 12
# flops, backward 5 + 30, each counted as one fp32 operation.
GATES_OPS = {"fwd": 17, "bwd": 35}
SCAN_NAMES = ("ys", "cs")
SCAN_GRADS = ("dxw", "drw", "dpi", "dpf", "dpo", "dh0", "dc0")


def rel_err(torch, a, ref, floor: float) -> float:
    """||a - ref|| / max(||ref||, floor * sqrt(n)) in float64."""
    if not ref.numel():
        return 0.0
    e = (a.double() - ref.double()).norm().item()
    r = ref.double().norm().item()
    return e / max(r, floor * math.sqrt(ref.numel()))


def step_rel_err(torch, a, ref, floor: float) -> float:
    """The largest rel_err over the time steps (dim 0) of (T, ...)
    tensors."""
    if not ref.numel():
        return 0.0
    d = (a.double() - ref.double()).flatten(1)
    r = ref.double().flatten(1)
    n = r.shape[1]
    e2, r2 = d.pow(2).sum(1), r.pow(2).sum(1)
    return (e2 / torch.clamp(r2, min=floor ** 2 * n)).sqrt().max().item()


def scan_case(torch, T, B, H, dtype, state, dcs_on, seed):
    """Random K7 inputs and cotangents on the card in `dtype` (drawn in
    fp32 by a CUDA generator): xw ~ 0.5 N(0, 1), rw ~ N(0, 1/H),
    peepholes ~ 0.1 N(0, 1) and h0/c0 ~ 0.5 N(0, 1) when `state`, else
    zeros; dys ~ N(0, 1), dcs likewise when `dcs_on`, else zeros."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(
            dtype)

    def z(*shape):
        return torch.zeros(*shape, dtype=dtype, device="cuda")
    ins = [r(T, B, 4 * H, scale=0.5), r(H, 4 * H, scale=H ** -0.5)]
    ins += [r(H, scale=0.1) if state else z(H) for _ in range(3)]
    ins += [r(B, H, scale=0.5) if state else z(B, H) for _ in range(2)]
    cots = [r(T, B, H), r(T, B, H) if dcs_on else z(T, B, H)]
    return ins, cots


def scan_sweep():
    """(dtype, H, B, T, state, dcs) of the K7 sweep; H 200 is zero-padded
    to 208 inside the wrappers. In bf16, H 64, 128 and 256 take the
    cluster forward, the others the tile kernel."""
    n = 0
    for dt in ("float32", "bfloat16"):
        for H in (32, 64, 256, 512):
            for B in (1, 3, 65, 8192):
                for T in (1, 7, 100):
                    for state in (False, True):
                        yield dt, H, B, T, state, n % 2 == 1
                        n += 1
        for B in (3, 65):
            for T in (7, 100):
                yield dt, 200, B, T, True, n % 2 == 1
                n += 1
    # the cluster forward's third width (bf16 H 64 and 256 are above)
    for B in (3, 65):
        for T in (7, 100):
            yield "bfloat16", 128, B, T, True, n % 2 == 1
            n += 1


def lstm_oversized(torch, ts, tg) -> dict:
    """An unmasked GravesLSTM and LSTM layer of H 1536, whose K7 tile does
    not fit in shared memory in fp32 or bf16 (`scan_fits`): on the card
    each steps through its gate kernel (K8, K9; T forward + T backward
    launches, no K7), held in fp32 against the same layer on the CPU
    (output and parameter gradients, rel err 1e-4)."""
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (
        LSTM, GravesLSTM)
    H, n_in, B, T = 1536, 16, 4, 6
    if ts.scan_fits(H, torch.float32, "cuda") \
            or ts.scan_fits(H, torch.bfloat16, "cuda"):
        fail(f"kernel_lstm_scan: H {H} fits a K7 tile; pick a wider H")
    out = {"H": H, "B": B, "T": T}
    for cls, k in ((GravesLSTM, "K8"), (LSTM, "K9")):
        layer = cls(n_in=n_in, n_out=H)
        gen = torch.Generator().manual_seed(5)
        p_cpu = layer.init_params(gen, InputType.recurrent(n_in),
                                  torch.float32, "cpu")
        x = torch.randn(B, n_in, T, generator=gen)
        cot = torch.randn(B, H, T, generator=gen)
        runs = {}
        for dev in ("cuda", "cpu"):
            p = {n: v.to(dev).requires_grad_(True) for n, v in p_cpu.items()}
            reset_lstm_launches(ts, tg)
            o, _, _ = layer.forward(p, {}, x.to(dev))
            grads = torch.autograd.grad(o, list(p.values()), cot.to(dev))
            runs[dev] = ((o,) + grads, lstm_launches(ts, tg))
        launches = runs["cuda"][1]
        expect = {n: (T if n.startswith(k) else 0) for n in launches}
        err = max(rel_err(torch, a.cpu(), b, 1e-3)
                  for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
        if launches != expect or not err <= 1e-4:
            fail(f"kernel_lstm_scan: {cls.__name__}({H}) launches "
                 f"{launches} (expected {expect}), rel err {err}")
        out[cls.__name__] = {"launches": launches, "rel_err": err}
    return out


def scan_run(torch, ts, ins, cots, kernel, dtype=None):
    """K7 forward then backward on the inputs (cast to `dtype` if given),
    through the kernels or the plain versions: {output name: tensor}."""
    a = [t if dtype is None else t.to(dtype) for t in ins]
    dys, dcs = (t if dtype is None else t.to(dtype) for t in cots)
    fwd = ts.graves_lstm_scan_fwd_cuda if kernel else \
        ts.graves_lstm_scan_plain
    bwd = ts.graves_lstm_scan_bwd_cuda if kernel else \
        ts.graves_lstm_scan_bwd_plain
    ys, cs = fwd(*a)
    grads = bwd(*a, ys, cs, dys, dcs)
    return dict(zip(SCAN_NAMES + SCAN_GRADS, (ys, cs) + tuple(grads)))


def step_err(torch, name, a, ref, floor):
    """Per time step for the (T, ...) outputs ys, cs and dxw, else over
    the whole tensor."""
    fn = step_rel_err if name in ("ys", "cs", "dxw") else rel_err
    return fn(torch, a, ref, floor)


def compare_scan(torch, kern, plain, dt):
    """{name: (relative err, max abs err)} of kernel against plain."""
    return {n: (step_err(torch, n, kern[n], plain[n], LSTM_REF_FLOOR[dt]),
                max_err(kern[n], plain[n]))
            for n in SCAN_NAMES + SCAN_GRADS}


def scan_bound(T, B, H, elt, kind):
    """(bytes, ops, ms, bound_by) of one K7 call: each input read once,
    each output written once; the forward's gate product, and in the
    backward the gate recompute, dh_prev and dRW products, at the bf16
    tensor-core rate (fp32 CUDA-core rate for fp32)."""
    n_h, n_g = T * B * H, T * B * 4 * H
    small = elt * (4 * H * H + 3 * H)                 # rw, peepholes
    if kind == "fwd":
        nbytes = elt * (n_g + 2 * n_h + 2 * B * H) + small
        prods = 1
    else:                  # xw, ys, cs, dys, dcs, h0, c0 in; dxw, dh0, dc0,
        nbytes = elt * (2 * n_g + 4 * n_h + 4 * B * H) + small \
            + 4 * (4 * H * H + 3 * H)                 # fp32 dRW, dp out
        prods = 3
    ops = 2 * prods * T * B * H * 4 * H
    rate = BF16_OPS_PER_S if elt == 2 else FP32_OPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
    return nbytes, ops, max(t_b, t_o) * 1e3, \
        ("bytes" if t_b >= t_o else "operations")


def k7_bwd_bounds(T, B, H):
    """(bytes, ops, ms, bound_by) of K7's bf16 backward sweep alone (the
    function's reads and writes without dRW; the gate-recompute and dh
    products) and of its dRW pass alone (h_prev and dxw read, fp32 dRW
    written; one product)."""
    n_h, n_g = T * B * H, T * B * 4 * H
    out = {}
    for part, nbytes, prods in (
            ("sweep", 2 * (2 * n_g + 4 * n_h + 4 * B * H + 4 * H * H + 3 * H)
             + 4 * 3 * H, 2),
            ("drw", 2 * (n_h + n_g) + 4 * 4 * H * H, 1)):
        ops = 2 * prods * T * B * H * 4 * H
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
        out[part] = (nbytes, ops, max(t_b, t_o) * 1e3,
                     "bytes" if t_b >= t_o else "operations")
    return out


def k7_bwd_parts(torch, ts, H):
    """K7's bf16 backward at T 100, B 8192 and H (the cluster variant):
    two calls bitwise equal (dxw, dRW, dh0, dc0 and the peephole sums);
    CUDA-event times of the whole backward, of the cluster sweep and of
    the dRW kernel (and its chunk sum) apart, beside torch.nn.LSTM's
    (cuDNN) backward at the same H and the bounds."""
    a, (dys, dcs) = scan_case(torch, LSTM_T, LSTM_B, H, torch.bfloat16,
                              True, True, seed=4300 + H)
    ys, cs = ts.graves_lstm_scan_fwd_cuda(*a)
    n0 = dict(ts.graves_lstm_scan_bwd_cuda.variant_launches)
    g1 = ts.graves_lstm_scan_bwd_cuda(*a, ys, cs, dys, dcs)
    g2 = ts.graves_lstm_scan_bwd_cuda(*a, ys, cs, dys, dcs)
    torch.cuda.synchronize()
    if ts.graves_lstm_scan_bwd_cuda.variant_launches["cluster"] != \
            n0["cluster"] + 2:
        fail(f"kernel_lstm_scan: H={H} did not take the cluster backward")
    if not all(torch.equal(x, y) for x, y in zip(g1, g2)):
        fail(f"kernel_lstm_scan: two cluster backward calls at H={H} "
             "differ")
    lib = ts._bwd_library()
    T, B = LSTM_T, LSTM_B
    st = torch.cuda.current_stream().cuda_stream
    dxw, dh0, dc0 = (torch.empty_like(t) for t in (g1[0], g1[5], g1[6]))
    dp = torch.empty((-(-B // 128), 3, H), dtype=torch.float32,
                     device="cuda")
    ins = [t.data_ptr() for t in a] + [ys.data_ptr(), cs.data_ptr(),
                                       dys.data_ptr(), dcs.data_ptr()]
    sweep = [*ins, dxw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
             dp.data_ptr(), T, B, H, st]
    chunks = lib.dl4j_lstm_drw_chunks(T, B, H)
    slab = torch.empty((chunks, H, 4 * H), dtype=torch.float32,
                       device="cuda")
    drw = [a[5].data_ptr(), ys.data_ptr(), g1[0].data_ptr(),
           slab.data_ptr(), T, B, H, chunks, st]
    ms = {"bwd": event_ms(torch, lambda: ts.graves_lstm_scan_bwd_cuda(
              *a, ys, cs, dys, dcs)),
          "sweep": event_ms(torch, lambda: lib.dl4j_lstm_scan_bwd_cluster(
              *sweep)),
          "drw": event_ms(torch, lambda: lib.dl4j_lstm_drw_sm90(*drw)),
          "drw_chunk_sum": event_ms(torch, lambda: ts.reduce_drw_partials(
              slab))}
    lstm = torch.nn.LSTM(H, H).to("cuda", torch.bfloat16)
    lstm.flatten_parameters()
    xin = torch.randn(T, B, H, device="cuda", dtype=torch.bfloat16,
                      requires_grad=True)
    f = event_ms(torch, lambda: lstm(xin)[0])
    fb = event_ms(torch, lambda: lstm(xin)[0].backward(dys))
    bound = scan_bound(T, B, H, 2, "bwd")
    parts = k7_bwd_bounds(T, B, H)
    return {"ms": ms, "library_ms": fb - f, "chunks": chunks,
            "bitwise_repeat": True,
            "active_clusters": lib.dl4j_lstm_scan_bwd_clusters(H),
            "bound_ms": bound[2], "bound_by": bound[3], "bytes": bound[0],
            "part_bound_ms": {k: v[2] for k, v in parts.items()},
            "part_bound_by": {k: v[3] for k, v in parts.items()}}


def phase_kernel_lstm_scan(torch):
    """K7 (forward and backward) against its plain versions over the sweep
    (fp32/bf16, H 32/64/256/512, B 1/3/65/8192, T 1/7/100, zero and
    non-zero state and peepholes, a non-zero dcs in every other case);
    bf16 also against the fp64 plain chain; each case's forward and
    backward on the variant the rule names, and every variant run. Then
    the char-RNN layer shape (T 100, B 8192, H 256, bf16) timed with CUDA
    events beside the plain versions and torch.nn.LSTM (cuDNN) forward
    and backward, a yardstick only (it adds the input projection and has
    no peepholes); and the cluster backward at T 100, B 8192, H 64, 128
    and 256: bitwise repeatable, timed whole and as its sweep and dRW
    kernels, beside cuDNN's backward at the same H (k7_bwd_parts)."""
    from deeplearning4j_tpu_torch.ops import lstm_scan_fused as ts
    worst = {dt: {} for dt in LSTM_REL_TOL}
    worst_abs = {dt: {} for dt in LSTM_REL_TOL}
    fp64_ratio = {}
    n_cases = 0
    variants, bwd_variants = {}, {}
    ts.graves_lstm_scan_fwd_cuda.variant_launches = dict.fromkeys(
        ts.FWD_VARIANTS, 0)
    ts.graves_lstm_scan_bwd_cuda.variant_launches = dict.fromkeys(
        ts.BWD_VARIANTS, 0)
    for dt, H, B, T, state, dcs_on in scan_sweep():
        dtype = getattr(torch, dt)
        ins, cots = scan_case(torch, T, B, H, dtype, state, dcs_on,
                              seed=n_cases)
        before = dict(ts.graves_lstm_scan_fwd_cuda.variant_launches)
        before_b = dict(ts.graves_lstm_scan_bwd_cuda.variant_launches)
        kern = scan_run(torch, ts, ins, cots, True)
        took = [v for v, n in ts.graves_lstm_scan_fwd_cuda
                .variant_launches.items() if n != before[v]]
        if took != [ts.scan_fwd_variant(H, dtype)]:
            fail(f"kernel_lstm_scan {dt} H={H}: the forward took {took}, "
                 f"the rule says {ts.scan_fwd_variant(H, dtype)}")
        variants.setdefault(f"{dt} H={H}", took[0])
        took_b = [v for v, n in ts.graves_lstm_scan_bwd_cuda
                  .variant_launches.items() if n != before_b[v]]
        if took_b != [ts.scan_bwd_variant(H, dtype)]:
            fail(f"kernel_lstm_scan {dt} H={H}: the backward took {took_b}, "
                 f"the rule says {ts.scan_bwd_variant(H, dtype)}")
        bwd_variants.setdefault(f"{dt} H={H}", took_b[0])
        # the plain backward on the kernel's ys/cs, so it checks the
        # backward alone
        pys, pcs = ts.graves_lstm_scan_plain(*ins)
        plain = dict(zip(SCAN_GRADS, ts.graves_lstm_scan_bwd_plain(
            *ins, kern["ys"], kern["cs"], *cots)), ys=pys, cs=pcs)
        errs = compare_scan(torch, kern, plain, dt)
        del plain, pys, pcs
        torch.cuda.synchronize()
        case = f"{dt} H={H} B={B} T={T} state={state} dcs={dcs_on}"
        for name, (rel, ab) in errs.items():
            if not (math.isfinite(rel) and rel <= LSTM_REL_TOL[dt]):
                fail(f"kernel_lstm_scan {case}: {name} rel err {rel} > "
                     f"{LSTM_REL_TOL[dt]} (max abs {ab})")
            worst[dt][name] = max(worst[dt].get(name, 0.0), rel)
            worst_abs[dt][name] = max(worst_abs[dt].get(name, 0.0), ab)
        if dt == "bfloat16":
            # each chain end to end (its own forward feeds its backward)
            # against the fp64 plain chain on the same bf16 inputs
            floor = LSTM_REF_FLOOR[dt]
            ref = scan_run(torch, ts, ins, cots, False, torch.float64)
            ek = {n: step_err(torch, n, kern[n], ref[n], floor)
                  for n in ref}
            del kern
            pb = scan_run(torch, ts, ins, cots, False)
            ep = {n: step_err(torch, n, pb[n], ref[n], floor) for n in ref}
            del pb, ref
            for name in ek:
                if not ek[name] <= LSTM_FP64_FACTOR * max(ep[name], floor):
                    fail(f"kernel_lstm_scan {case}: {name} err vs fp64 "
                         f"{ek[name]} > {LSTM_FP64_FACTOR} x bf16 plain's "
                         f"{ep[name]}")
                fp64_ratio[name] = max(fp64_ratio.get(name, 0.0),
                                       ek[name] / max(ep[name], floor))
        del ins, cots
        n_cases += 1
    sweep_variants = dict(ts.graves_lstm_scan_fwd_cuda.variant_launches)
    if not all(sweep_variants.values()):
        fail(f"kernel_lstm_scan: a forward variant never ran in the sweep: "
             f"{sweep_variants}")
    sweep_bwd_variants = dict(ts.graves_lstm_scan_bwd_cuda.variant_launches)
    if not all(sweep_bwd_variants.values()):
        fail(f"kernel_lstm_scan: a backward variant never ran in the sweep: "
             f"{sweep_bwd_variants}")
    from deeplearning4j_tpu_torch.ops import lstm_gates as tg
    oversized = lstm_oversized(torch, ts, tg)
    # the layer shape of the char-RNN, on the cluster forward
    if ts.scan_fwd_variant(LSTM_H, torch.bfloat16) != "cluster":
        fail("kernel_lstm_scan: the char-RNN's H does not take the cluster "
             "forward")
    a, (dys, dcs) = scan_case(torch, LSTM_T, LSTM_B, LSTM_H,
                              torch.bfloat16, True, True, seed=4242)
    n_cluster = ts.graves_lstm_scan_fwd_cuda.variant_launches["cluster"]
    ys, cs = ts.graves_lstm_scan_fwd_cuda(*a)
    if ts.graves_lstm_scan_fwd_cuda.variant_launches["cluster"] != \
            n_cluster + 1:
        fail("kernel_lstm_scan: the char-RNN layer did not launch the "
             "cluster forward")
    ms = {"fwd": event_ms(torch, lambda: ts.graves_lstm_scan_fwd_cuda(*a)),
          "bwd": event_ms(torch, lambda: ts.graves_lstm_scan_bwd_cuda(
              *a, ys, cs, dys, dcs))}
    plain_ms = {"fwd": event_ms(torch, lambda: ts.graves_lstm_scan_plain(*a),
                                iters=2),
                "bwd": event_ms(torch, lambda: ts.graves_lstm_scan_bwd_plain(
                    *a, ys, cs, dys, dcs), iters=2)}
    lstm = torch.nn.LSTM(LSTM_H, LSTM_H).to("cuda", torch.bfloat16)
    xin = torch.randn(LSTM_T, LSTM_B, LSTM_H, device="cuda",
                      dtype=torch.bfloat16, requires_grad=True)

    def cudnn_fwd():
        return lstm(xin)[0]

    def cudnn_fwd_bwd():
        cudnn_fwd().backward(dys)
    library_fwd = event_ms(torch, cudnn_fwd)
    library_fwd_bwd = event_ms(torch, cudnn_fwd_bwd)
    del lstm, xin, a, ys, cs, dys, dcs
    bounds = {k: scan_bound(LSTM_T, LSTM_B, LSTM_H, 2, k)
              for k in ("fwd", "bwd")}
    bwd_parts = {f"H={H}": k7_bwd_parts(torch, ts, H) for H in K7_CLUSTER_H}
    res = {"phase": "kernel_lstm_scan", "cases": n_cases,
           "fwd_variant": variants, "sweep_variant_launches": sweep_variants,
           "bwd_variant": bwd_variants,
           "sweep_bwd_variant_launches": sweep_bwd_variants,
           "bwd_parts": bwd_parts,
           "active_clusters_h256":
               ts._cluster_library().dl4j_lstm_scan_fwd_clusters(LSTM_H),
           "rel_err": worst, "max_abs_err": worst_abs,
           "oversized_h": oversized,
           "tolerance": LSTM_REL_TOL, "floor": LSTM_REF_FLOOR,
           "bf16_vs_fp64_ratio": fp64_ratio, "factor": LSTM_FP64_FACTOR,
           "shape": {"T": LSTM_T, "B": LSTM_B, "H": LSTM_H,
                     "dtype": "bfloat16"},
           "ms": ms, "plain_ms": plain_ms,
           "library_ms": {"fwd": library_fwd,
                          "bwd": library_fwd_bwd - library_fwd,
                          "fwd_bwd": library_fwd_bwd},
           "library": "torch.nn.LSTM (cuDNN), input size 256, no peepholes",
           "bound_ms": {k: b[2] for k, b in bounds.items()},
           "bound_by": {k: b[3] for k, b in bounds.items()},
           "bytes": {k: b[0] for k, b in bounds.items()},
           "ops": {k: b[1] for k, b in bounds.items()},
           "tflops": {k: bounds[k][1] / ms[k] / 1e9 for k in ms}}
    emit(res)
    return res


def gates_case(torch, B, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (scale * torch.randn(
        *s, generator=g)).to("cuda", dtype)
    return (r(B, 4 * H), r(B, H, scale=0.5), r(H, scale=0.3),
            r(H, scale=0.3), r(H, scale=0.3), r(B, H), r(B, H))


def gates_calls(tg, peep, args):
    """(kernel forward, kernel backward, plain forward, plain backward)
    outputs of K8 (peep) or K9 on `args`."""
    gates, c, pi, pf, po, dc, dh = args
    if peep:
        return (tg.graves_gates_cuda(gates, c, pi, pf, po),
                tg.graves_gates_bwd_cuda(gates, c, pi, pf, po, dc, dh),
                tg.graves_gates_plain(gates, c, pi, pf, po),
                tg.graves_gates_bwd_plain(gates, c, pi, pf, po, dc, dh))
    return (tg.lstm_gates_cuda(gates, c),
            tg.lstm_gates_bwd_cuda(gates, c, dc, dh),
            tg.lstm_gates_plain(gates, c),
            tg.lstm_gates_bwd_plain(gates, c, dc, dh))


def gates_bound(B, H, elt, kind, peep):
    n = B * H
    if kind == "fwd":
        nbytes = elt * (4 * n + n + 2 * n) + (3 * elt * H if peep else 0)
    else:
        nbytes = elt * (4 * n + 3 * n + 4 * n + n) + \
            ((3 * elt + 3 * 4) * H if peep else 0)
    ops = GATES_OPS[kind] * n
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return nbytes, ops, max(t_b, t_o) * 1e3, \
        ("bytes" if t_b >= t_o else "operations")


def k9_library(torch, tg, gates, c, dc, dh) -> dict:
    """K9's function as PyTorch's fused LSTM cell (the CUDA kernel behind
    torch.nn.LSTMCell, `aten._thnn_fused_lstm_cell`: gate order i, f, g,
    o, so ours permuted, plus a zeroed second gate input; its backward
    `_thnn_fused_lstm_cell_backward_impl` reads the saved activations):
    CUDA-graph replay times, a yardstick only, and its largest difference
    from K9's plain version. Where the call fails, "ms" is null and the
    reason is kept."""
    H = c.shape[1]
    zi, zf, zo, zg = gates.split(H, 1)
    ig = torch.cat([zi, zf, zg, zo], 1).contiguous()
    hg = torch.zeros_like(ig)
    op = torch.ops.aten
    try:
        hy, cy, ws = op._thnn_fused_lstm_cell(ig, hg, c)
        ref_c, ref_h = tg.lstm_gates_plain(gates, c)
        err = max(max_err(cy, ref_c), max_err(hy, ref_h))
        ms = {"fwd": graph_ms(torch, lambda: op._thnn_fused_lstm_cell(
                  ig, hg, c)),
              "bwd": graph_ms(torch, lambda: op
                              ._thnn_fused_lstm_cell_backward_impl(
                                  dh, dc, c, cy, ws, False))}
    except (RuntimeError, NotImplementedError) as e:
        return {"ms": None, "call": "aten._thnn_fused_lstm_cell",
                "why_not": str(e)[:300]}
    return {"ms": ms, "call": "aten._thnn_fused_lstm_cell (+ backward_impl)",
            "max_abs_err_vs_plain": err}


def odd_gates(torch, args):
    """`args` with the gates moved to a view one element into an
    allocation of their own: not 16-byte aligned, so the kernels take
    their scalar path."""
    g = args[0]
    buf = torch.empty(g.numel() + 1, dtype=g.dtype, device=g.device)
    buf[1:].copy_(g.reshape(-1))
    return (buf[1:].view(g.shape),) + tuple(args[1:])


def phase_kernel_lstm_gates(torch):
    """K8 and K9 (forward and backward) against their plain versions: fp32
    and bf16, H 32/64/100/256/512, B 1/3/65/8192, and the gates at an odd
    element offset at H 100 and 256, B 3 and 8192; each output in the
    plain version's dtype (dpi/dpf/dpo in the peepholes'), and each
    wrapper's 16-byte and scalar paths both run (H 100 in bf16 and the odd
    gates take the scalar path). K8's backward gives the same bits in two
    calls (B 8192, H 256, bf16 and fp32). Then the char-RNN step shape (B
    8192, H 256, bf16), forward and backward apart, device time by
    CUDA-graph replay beside the plain versions and the bounds, and K9
    beside PyTorch's fused LSTM cell (k9_library). No single library call
    computes the peephole cell (K8): its library_ms is null."""
    from deeplearning4j_tpu_torch.ops import lstm_gates as tg
    wrappers = (tg.graves_gates_cuda, tg.graves_gates_bwd_cuda,
                tg.lstm_gates_cuda, tg.lstm_gates_bwd_cuda)
    for fn in wrappers:
        fn.path_launches = dict.fromkeys(tg.PATHS, 0)
    worst = {}
    worst_abs = {}
    n_cases = 0
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        todo = [(H, B, False) for H in (32, 64, 100, 256, 512)
                for B in (1, 3, 65, 8192)] + [
            (H, B, True) for H in (100, 256) for B in (3, 8192)]
        for H, B, odd in todo:
            args = gates_case(torch, B, H, dtype, seed=n_cases)
            if odd:
                args = odd_gates(torch, args)
            for peep, name in ((True, "graves_gates"),
                               (False, "lstm_gates")):
                kf, kb, pf_, pb = gates_calls(tg, peep, args)
                torch.cuda.synchronize()
                for i, (k, p) in enumerate(zip(kf + kb, pf_ + pb)):
                    e = rel_err(torch, k, p, 1e-3)
                    key = f"{name}_{dt}"
                    if not (math.isfinite(e) and e <= GATES_REL_TOL[dt]) \
                            or k.dtype != p.dtype or k.shape != p.shape:
                        fail(f"kernel_lstm_gates {name} {dt} H={H} "
                             f"B={B} odd={odd} output {i}: rel err {e} > "
                             f"{GATES_REL_TOL[dt]} or {k.dtype} "
                             f"{tuple(k.shape)} against {p.dtype} "
                             f"{tuple(p.shape)}")
                    worst[key] = max(worst.get(key, 0.0), e)
                    worst_abs[key] = max(worst_abs.get(key, 0.0),
                                         max_err(k, p))
            n_cases += 1
    paths = {fn.__name__: dict(fn.path_launches) for fn in wrappers}
    if any(0 in v.values() for v in paths.values()):
        fail(f"kernel_lstm_gates: a path never ran: {paths}")
    repeat = {}
    for dt in ("bfloat16", "float32"):
        g, c, pi, pf, po, dc, dh = gates_case(torch, LSTM_B, LSTM_H,
                                              getattr(torch, dt), seed=778)
        a = tg.graves_gates_bwd_cuda(g, c, pi, pf, po, dc, dh)
        b = tg.graves_gates_bwd_cuda(g, c, pi, pf, po, dc, dh)
        torch.cuda.synchronize()
        repeat[dt] = all(bits_equal(torch, x, y) for x, y in zip(a, b))
    if not all(repeat.values()):
        fail(f"kernel_lstm_gates: K8's backward differs between two calls "
             f"{repeat}")
    args = gates_case(torch, LSTM_B, LSTM_H, torch.bfloat16, seed=777)
    gates, c, pi, pf, po, dc, dh = args
    ms, plain_ms, bounds = {}, {}, {}
    for name, peep, fwd, bwd, pfwd, pbwd in (
            ("graves_gates", True,
             lambda: tg.graves_gates_cuda(gates, c, pi, pf, po),
             lambda: tg.graves_gates_bwd_cuda(gates, c, pi, pf, po, dc, dh),
             lambda: tg.graves_gates_plain(gates, c, pi, pf, po),
             lambda: tg.graves_gates_bwd_plain(gates, c, pi, pf, po, dc,
                                               dh)),
            ("lstm_gates", False,
             lambda: tg.lstm_gates_cuda(gates, c),
             lambda: tg.lstm_gates_bwd_cuda(gates, c, dc, dh),
             lambda: tg.lstm_gates_plain(gates, c),
             lambda: tg.lstm_gates_bwd_plain(gates, c, dc, dh))):
        ms[name] = {"fwd": graph_ms(torch, fwd), "bwd": graph_ms(torch, bwd)}
        plain_ms[name] = {"fwd": graph_ms(torch, pfwd),
                          "bwd": graph_ms(torch, pbwd)}
        bounds[name] = {k: gates_bound(LSTM_B, LSTM_H, 2, k, peep)
                        for k in ("fwd", "bwd")}
    library = k9_library(torch, tg, gates, c, dc, dh)
    res = {"phase": "kernel_lstm_gates", "cases": n_cases,
           "path_launches": paths, "k8_bwd_bitwise_repeat": repeat,
           "rel_err": worst, "max_abs_err": worst_abs,
           "tolerance": GATES_REL_TOL,
           "shape": {"B": LSTM_B, "H": LSTM_H, "dtype": "bfloat16"},
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": {n: {k: b[2] for k, b in v.items()}
                        for n, v in bounds.items()},
           "bound_by": {n: {k: b[3] for k, b in v.items()}
                        for n, v in bounds.items()},
           "bytes": {n: {k: b[0] for k, b in v.items()}
                     for n, v in bounds.items()},
           "library_ms": {"graves_gates": None,
                          "lstm_gates": library.pop("ms")},
           "library": library}
    emit(res)
    return res


def lstm_launches(ts, tg) -> dict:
    return {"K7_fwd": ts.graves_lstm_scan_fwd_cuda.launches,
            "K7_bwd": ts.graves_lstm_scan_bwd_cuda.launches,
            "K8_fwd": tg.graves_gates_cuda.launches,
            "K8_bwd": tg.graves_gates_bwd_cuda.launches,
            "K9_fwd": tg.lstm_gates_cuda.launches,
            "K9_bwd": tg.lstm_gates_bwd_cuda.launches}


def reset_lstm_launches(ts, tg) -> None:
    for fn in (ts.graves_lstm_scan_fwd_cuda, ts.graves_lstm_scan_bwd_cuda,
               tg.graves_gates_cuda, tg.graves_gates_bwd_cuda,
               tg.lstm_gates_cuda, tg.lstm_gates_bwd_cuda):
        fn.launches = 0
    for fn in (tg.graves_gates_cuda, tg.graves_gates_bwd_cuda,
               tg.lstm_gates_cuda, tg.lstm_gates_bwd_cuda):
        fn.path_launches = dict.fromkeys(tg.PATHS, 0)
    ts.graves_lstm_scan_fwd_cuda.variant_launches = dict.fromkeys(
        ts.FWD_VARIANTS, 0)
    ts.graves_lstm_scan_bwd_cuda.variant_launches = dict.fromkeys(
        ts.BWD_VARIANTS, 0)


def char_rnn(torch, compute_dtype, layer="GravesLSTM", dtype="float32"):
    """The zoo TextGenerationLSTM at full width, seed 42, on the card; with
    `layer` "LSTM" the same stack with plain LSTM layers."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        MultiLayerConfiguration
    conf = TextGenerationLSTM(total_unique_characters=LSTM_VOCAB, seed=42,
                              dtype=dtype,
                              compute_dtype=compute_dtype).conf()
    if layer != "GravesLSTM":
        d = json.loads(conf.to_json())
        for ld in d["layers"][:2]:
            ld["@class"], ld["peephole"] = layer, False
        conf = MultiLayerConfiguration.from_dict(d)
    return MultiLayerNetwork(conf, device="cuda").init()


def char_data(np, batch=None, T=None, seed=0):
    """bench.py bench_graves_lstm's data: one-hot characters from
    RandomState(seed), x (batch, 47, T), y the next character (default
    batch LSTM_B, T LSTM_T)."""
    batch, T = batch or LSTM_B, T or LSTM_T
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, LSTM_VOCAB, (batch, T))
    eye = np.eye(LSTM_VOCAB, dtype=np.float32)
    return (eye[idx].transpose(0, 2, 1).copy(),
            eye[np.roll(idx, -1, axis=1)].transpose(0, 2, 1).copy())


def char_mask(np, seed=1):
    """(LSTM_B, LSTM_T) float mask: example b keeps its first L_b steps,
    L_b drawn from RandomState(seed) in [1, LSTM_T]."""
    batch, T = LSTM_B, LSTM_T
    lengths = np.random.RandomState(seed).randint(1, T + 1, batch)
    return (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)


def phase_train_lstm(torch, np):
    """The char-RNN trained as bench.py trains it: a warm step, then
    fit_on_device(steps=5, sync=False) (tokens/s, ms/step, peak memory,
    K7 2 forward + 2 backward launches a step, every one on the cluster
    variants, K8/K9 none); two fit(x, y)
    calls under tBPTT 50 (2 segments, 2 optimizer steps and 4 + 4 K7
    launches each); one masked fit_batch (K8 on every step of each layer,
    forward and backward, K7 none); and the stack with LSTM layers, masked
    (K9 likewise). Every loss finite."""
    from deeplearning4j_tpu_torch.ops import lstm_gates as tg
    from deeplearning4j_tpu_torch.ops import lstm_scan_fused as ts
    net = char_rnn(torch, "bfloat16")
    x_np, y_np = char_data(np)
    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()
    steps = 5
    warm = net.fit_on_device(x, y, steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_lstm_launches(ts, tg)                        # main path starts
    t0 = time.perf_counter()
    losses = net.fit_on_device(x, y, steps=steps, sync=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lstm_launches(ts, tg)                   # main path ends
    fwd_variants = dict(ts.graves_lstm_scan_fwd_cuda.variant_launches)
    bwd_variants = dict(ts.graves_lstm_scan_bwd_cuda.variant_launches)
    peak = torch.cuda.max_memory_allocated()
    losses = losses.cpu().numpy().tolist()
    diverged = net._diverged_at
    expect = {"K7_fwd": 2 * steps, "K7_bwd": 2 * steps, "K8_fwd": 0,
              "K8_bwd": 0, "K9_fwd": 0, "K9_bwd": 0}
    if launches != expect:
        fail(f"train_lstm fit_on_device launches {launches}, expected "
             f"{expect}")
    if fwd_variants != {"cluster": 2 * steps, "tile": 0}:
        fail(f"train_lstm: K7 forward variants {fwd_variants}, expected "
             "every launch on the cluster kernel")
    if bwd_variants != {"cluster": 2 * steps, "tile": 0}:
        fail(f"train_lstm: K7 backward variants {bwd_variants}, expected "
             "every launch on the cluster sweep")
    profile = profile_train(torch, net, x, y)
    fit_losses, fit_launches = [], []
    t0 = time.perf_counter()
    for _ in range(2):
        reset_lstm_launches(ts, tg)
        step0 = net._step
        net.fit(x, y)
        fit_losses.append(net.score())
        fit_launches.append(lstm_launches(ts, tg))
        if net._step - step0 != 2:
            fail(f"train_lstm fit: {net._step - step0} optimizer steps, "
                 "expected 2 tBPTT segments")
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    seg = {"K7_fwd": 4, "K7_bwd": 4, "K8_fwd": 0, "K8_bwd": 0, "K9_fwd": 0,
           "K9_bwd": 0}
    if any(f != seg for f in fit_launches):
        fail(f"train_lstm fit launches {fit_launches}, expected {seg}")
    m = torch.from_numpy(char_mask(np)).cuda()
    masked = {}
    for layer, key in (("GravesLSTM", "K8"), ("LSTM", "K9")):
        mnet = net if layer == "GravesLSTM" else char_rnn(
            torch, "bfloat16", layer)
        reset_lstm_launches(ts, tg)
        t0 = time.perf_counter()
        mnet.fit_batch(x, y, m, m)
        loss = mnet.score()
        torch.cuda.synchronize()
        got = lstm_launches(ts, tg)
        want = {k: 0 for k in got}
        want.update({f"{key}_fwd": 2 * LSTM_T, f"{key}_bwd": 2 * LSTM_T})
        if got != want:
            fail(f"train_lstm masked {layer}: launches {got}, expected "
                 f"{want}")
        wrap = (tg.graves_gates_cuda, tg.graves_gates_bwd_cuda) \
            if key == "K8" else (tg.lstm_gates_cuda, tg.lstm_gates_bwd_cuda)
        masked[layer] = {"loss": loss, "launches": got,
                         "path_launches": {
                             f"{key}_{d}": dict(fn.path_launches)
                             for d, fn in zip(("fwd", "bwd"), wrap)},
                         "ms": (time.perf_counter() - t0) * 1e3}
        del mnet
    all_losses = list(warm) + losses + fit_losses + [
        v["loss"] for v in masked.values()]
    if not all(math.isfinite(v) for v in all_losses) or diverged is not None:
        fail(f"train_lstm: non-finite loss {all_losses}")
    tokens = LSTM_B * LSTM_T
    res = {"phase": "train_lstm", "config": {
               "model": "TextGenerationLSTM: 2 x GravesLSTM(256) + "
                        "RnnOutputLayer(47, MCXENT softmax), tBPTT 50/50",
               "batch": LSTM_B, "T": LSTM_T, "compute_dtype": "bfloat16",
               "params_dtype": "float32", "updater": "RmsProp(0.01), l2 1e-3",
               "num_params": net.num_params()},
           "steps": steps, "wall_s": wall, "ms_per_step": wall / steps * 1e3,
           "tokens_per_s": tokens * steps / wall, "peak_bytes": peak,
           "peak_bytes_above_start": peak - base, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "k7_fwd_variant_launches": fwd_variants,
           "k7_bwd_variant_launches": bwd_variants,
           "losses": losses, "profile": profile,
           "fit": {"losses": fit_losses, "launches": fit_launches,
                   "ms_per_step": fit_wall / 4 * 1e3},
           "masked": masked}
    emit(res)
    return res


@contextlib.contextmanager
def plain_lstm(ts, tg, helpers):
    """Register the plain versions in the LSTM kernels' place for the
    calls inside the block."""
    names = {"graves_lstm_scan_fwd": (ts.graves_lstm_scan_plain,
                                      ts.graves_lstm_scan_fwd_cuda),
             "graves_lstm_scan_bwd": (ts.graves_lstm_scan_bwd_plain,
                                      ts.graves_lstm_scan_bwd_cuda),
             "graves_gates_fwd": (tg.graves_gates_plain,
                                  tg.graves_gates_cuda),
             "graves_gates_bwd": (tg.graves_gates_bwd_plain,
                                  tg.graves_gates_bwd_cuda),
             "lstm_gates_fwd": (tg.lstm_gates_plain, tg.lstm_gates_cuda),
             "lstm_gates_bwd": (tg.lstm_gates_bwd_plain,
                                tg.lstm_gates_bwd_cuda)}
    for name, (plain, _) in names.items():
        helpers.register_helper(name)(plain)
    try:
        yield
    finally:
        for name, (_, kernel) in names.items():
            helpers.register_helper(name)(kernel)


def phase_lstm_oracle(torch, np):
    """The zoo stack in fp32 at full width: one gradient_and_score through
    the kernels and through the plain versions (registered in the kernels'
    place) in fp32 and in fp64 on the same params and data. Every
    gradient of the kernel path within LSTM_FP64_FACTOR times the fp32
    plain path's own error against fp64 (max |diff| / max |ref| per
    parameter, ORACLE_GRAD_FLOOR below it), the loss within 1e-5 relative
    of fp64. Then the same in bf16 compute, unmasked (K7) and masked (K8):
    kernel and plain paths in bf16 against fp64, losses within
    BF16_ORACLE_LOSS_TOL of each other."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.ops import helpers
    from deeplearning4j_tpu_torch.ops import lstm_gates as tg
    from deeplearning4j_tpu_torch.ops import lstm_scan_fused as ts
    from deeplearning4j_tpu_torch.util.flat_params import unflatten_params
    net = char_rnn(torch, None)
    d = json.loads(net.conf.to_json())
    d["global_conf"]["dtype"] = "float64"
    net64 = MultiLayerNetwork(MultiLayerConfiguration.from_dict(d),
                              device="cuda").init(params=net.params_tree)
    x_np, y_np = char_data(np)
    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()
    m = torch.from_numpy(char_mask(np)).cuda()

    def rel_errs(g, g_ref):
        out = {}
        for i, (gg, gr) in enumerate(zip(
                unflatten_params(net64.params_tree, g.double()),
                unflatten_params(net64.params_tree, g_ref))):
            for name in sorted(gr):
                out[f"{i}.{name}"] = max_err(gg[name], gr[name]) / max(
                    gr[name].abs().max().item(), 1e-300)
        return out

    def check(label, knet, mask, loss_ref_plain):
        fm = lm = mask
        floor = ORACLE_GRAD_FLOOR["bf16" if loss_ref_plain else "fp32"]
        reset_lstm_launches(ts, tg)
        g_k, s_k = knet.gradient_and_score(x, y, fm, lm)
        launches = lstm_launches(ts, tg)
        with plain_lstm(ts, tg, helpers):
            g_ref, s_ref = net64.gradient_and_score(
                x.double(), y.double(), None if mask is None
                else mask.double(), None if mask is None else mask.double())
            g_p, s_p = knet.gradient_and_score(x, y, fm, lm)
        torch.cuda.synchronize()
        if lstm_launches(ts, tg) != launches:
            fail(f"lstm_oracle {label}: a plain pass launched a kernel")
        want = {k: 0 for k in launches}
        n = 2 if mask is None else 2 * LSTM_T
        key = "K7" if mask is None else "K8"
        want.update({f"{key}_fwd": n, f"{key}_bwd": n})
        if launches != want:
            fail(f"lstm_oracle {label}: launches {launches}, expected "
                 f"{want}")
        rel_k, rel_p = rel_errs(g_k, g_ref), rel_errs(g_p, g_ref)
        bad = {n: (rel_k[n], rel_p[n]) for n in rel_k
               if not rel_k[n] <= LSTM_FP64_FACTOR * max(rel_p[n], floor)}
        if loss_ref_plain:
            loss_rel = abs(s_k - s_p) / max(abs(s_p), 1e-300)
            tol = BF16_ORACLE_LOSS_TOL
        else:
            loss_rel = abs(s_k - s_ref) / max(abs(s_ref), 1e-300)
            tol = LSTM_ORACLE_LOSS_TOL
        if not (math.isfinite(s_k) and loss_rel <= tol) or bad:
            fail(f"lstm_oracle {label}: loss rel {loss_rel} (limit {tol}), "
                 f"gradients (kernel rel err, plain rel err) past the "
                 f"limit: {bad}")
        return {"loss_kernels": s_k, "loss_plain": s_p, "loss_fp64": s_ref,
                "loss_rel_err": loss_rel, "loss_tolerance": tol,
                "grad_rel_err_kernels": rel_k, "grad_rel_err_plain": rel_p,
                "max_ratio": max(rel_k[n] / max(rel_p[n], floor)
                                 for n in rel_k),
                "floor": floor, "launches": launches}

    res = {"phase": "lstm_oracle", "factor": LSTM_FP64_FACTOR,
           "fp32": check("fp32", net, None, False)}
    net_b = char_rnn(torch, "bfloat16")
    if not torch.equal(net_b.params(), net.params()):
        fail("lstm_oracle: the bf16 stack was built with other params")
    res["bf16"] = check("bf16", net_b, None, True)
    res["bf16_masked"] = check("bf16 masked", net_b, m, True)
    emit(res)
    return res


def phase_generate(torch, np):
    """rnn_time_step on the bf16 char-RNN, batch 32: prime on 50
    characters, then 100 greedy single-character steps (K7 launches 2 a
    call); then in fp32, the streamed output at steps 1, 50 and 150
    against output() of the whole prefix, within 1e-4."""
    from deeplearning4j_tpu_torch.ops import lstm_gates as tg
    from deeplearning4j_tpu_torch.ops import lstm_scan_fused as ts
    x_np, _ = char_data(np, batch=GEN_B, T=GEN_PRIME + GEN_STEPS, seed=5)
    prime = torch.from_numpy(x_np[:, :, :GEN_PRIME]).cuda()
    eye = torch.eye(LSTM_VOCAB, device="cuda")

    def stream(net, steps):
        """(outputs of every call, launches): the prime call, then greedy
        steps feeding back the argmax."""
        reset_lstm_launches(ts, tg)
        out = net.rnn_time_step(prime)
        outs = [out]
        nxt = eye[out[:, :, -1].argmax(1)]
        for _ in range(steps):
            o = net.rnn_time_step(nxt)
            outs.append(o)
            nxt = eye[o.argmax(1)]
        torch.cuda.synchronize()
        return outs, lstm_launches(ts, tg)

    net = char_rnn(torch, "bfloat16")
    t0 = time.perf_counter()
    outs, launches = stream(net, GEN_STEPS)
    wall = time.perf_counter() - t0
    calls = 1 + GEN_STEPS
    if launches["K7_fwd"] != 2 * calls or launches["K7_bwd"] != 0:
        fail(f"generate: launches {launches}, expected 2 K7 per call")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        fail("generate: non-finite output")
    # fp32: one character a call from the first, against output() of the
    # prefix fed so far
    net32 = char_rnn(torch, None)
    seq = torch.from_numpy(x_np).cuda()
    errs = {}
    for t in range(GEN_PRIME + GEN_STEPS):
        o = net32.rnn_time_step(seq[:, :, t])
        if t + 1 in (1, 50, 150):
            ref = net32.output(seq[:, :, :t + 1])[:, :, -1]
            errs[t + 1] = max_err(o, ref)
    if not all(e <= 1e-4 for e in errs.values()):
        fail(f"generate: streamed vs output() max abs err {errs} > 1e-4")
    res = {"phase": "generate", "batch": GEN_B, "prime": GEN_PRIME,
           "steps": GEN_STEPS, "wall_s": wall,
           "ms_per_step": wall / calls * 1e3, "launches": launches,
           "fp32_stream_vs_output_max_abs_err": errs, "tolerance": 1e-4}
    emit(res)
    return res


# ------------------------------------------------------------ ResNet slice
# The JAX bench's headline (bench.py bench_resnet50): zoo ResNet50 at
# 224x224x3, 1000 classes, batch 256, bf16 compute over fp32 params,
# RmsProp(0.1, 0.96), l1 1e-7, l2 5e-5, N(0, 0.5) init, seed 42, data from
# bench.py _synth with RandomState(0). Its 36 1x1 conv -> BN pairs run K10.
RESNET_B, RESNET_CLASSES, RESNET_ORACLE_B = 256, 1000, 8
RESNET_PAIRS = 36
# K10 sweep: y against the plain version in the same dtype, by max |diff|
# over max |ref| (bf16: a sum taken in another order may round one ulp,
# 2^-8, the other way; fp32: fp32 accumulation against the plain fp64 one
# over up to 2048 terms); the sums against the fp64 plain sums, by max
# |diff| over the channels, sum(y) relative to max sqrt(sum(y^2)) and
# sum(y^2) relative to max sum(y^2) (the scale of y's own error: bf16
# sums come from the fp32 accumulators over up to 200,704 columns, fp32
# ones in fp64 from y's fp32 accumulators).
CONV_Y_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
CONV_SUM_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
# resnet_oracle: each route against the unfused route in fp64 on the same
# inputs. At the N(0, 0.5) init the gradient is ill-conditioned: in fp64 a
# 2^-24 relative perturbation of the input alone moves single weight
# gradients by several per cent (the phase measures it), so no fp32 route
# meets 1e-4 per tensor. The loss is held to 1e-5 relative; the gradient
# as a whole (norm-wise relative error, and the median over tensors of the
# per-tensor max |diff| / max |ref|) within RESNET_FACTOR times the error
# of the unfused route in the same compute dtype. The conv biases that
# feed a BatchNormalization have a true gradient of zero (the batch mean
# removes them) and are left out of the per-tensor errors. The bf16 loss
# within RESNET_FACTOR times the unfused bf16 route's loss error or 5e-2
# relative: one loss value is a single draw of a route's bf16 rounding
# noise, and the fp64 loss moves ~6x a relative input perturbation (the
# phase reports it), so bf16's 2^-8 rounding moves it by per cents.
RESNET_FACTOR, RESNET_BF16_LOSS_FLOOR = 2.0, 5e-2
RESNET_LOSS_TOL = 1e-5


def resnet_net(compute_dtype, dtype="float32"):
    from deeplearning4j_tpu_torch.models import ResNet50
    return ResNet50(num_labels=RESNET_CLASSES, seed=42, dtype=dtype,
                    compute_dtype=compute_dtype).init(device="cuda")


def resnet_data(torch, np, batch):
    """bench.py _synth(RandomState(0), batch, 1000, 3, 224, 224): x =
    rand(batch, 3, 224, 224) in fp32, y one-hot of randint(0, 1000)."""
    rng = np.random.RandomState(0)
    x = rng.rand(batch, 3, 224, 224).astype(np.float32)
    y = np.eye(RESNET_CLASSES, dtype=np.float32)[
        rng.randint(0, RESNET_CLASSES, batch)]
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def resnet_pair_shapes(conf, batch):
    """{(B, C_in, C_out, P): calls} of K10 in one ResNet50 training step,
    from the configuration: every fusable conv's input and output types,
    P after the stride."""
    from deeplearning4j_tpu_torch import ComputationGraph
    net = ComputationGraph(conf, device="cpu")
    in_types = conf.node_input_types()
    shapes = {}
    for name in net._conv_bn_fusable():
        it = in_types[name][0]
        conv = conf.nodes[name].conf
        ot = conv.get_output_type(it)
        key = (batch, it.channels, conv.n_out, ot.height * ot.width)
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def resnet_model_flops(conf, batch) -> float:
    """Model FLOPs of one training step: 3 x the forward's convolution and
    dense products (2 multiply-adds per weight use), from the layer
    shapes; normalization, pooling and elementwise work left out."""
    from deeplearning4j_tpu_torch import ConvolutionLayer, OutputLayer
    in_types = conf.node_input_types()
    fwd = 0
    for name, node in conf.nodes.items():
        layer = node.conf
        if isinstance(layer, ConvolutionLayer):
            it = in_types[name][0]
            ot = layer.get_output_type(it)
            kh, kw = layer.kernel_size
            fwd += 2 * batch * ot.height * ot.width * layer.n_out \
                * it.channels * kh * kw
        elif isinstance(layer, OutputLayer):
            fwd += 2 * batch * layer.n_in * layer.n_out
    return 3.0 * fwd


def conv_bound(B, C_in, C_out, P, elt):
    """(bytes, ops, ms, bound_by) of one K10 call: x and W read once, y
    written once, the two fp32 sums written; 2 B P C_in C_out operations
    at the tensor-core bf16 rate (CUDA-core fp32 rate for fp32)."""
    nbytes = elt * (B * C_in * P + C_in * C_out + B * C_out * P) \
        + 2 * 4 * C_out
    ops = 2 * B * P * C_in * C_out
    rate = BF16_OPS_PER_S if elt == 2 else FP32_OPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
    return nbytes, ops, max(t_b, t_o) * 1e3, \
        ("bytes" if t_b >= t_o else "operations")


def conv_sweep():
    """(dtype, B, C_in, C_out, P, mean shift) of the K10 sweep: each P
    with B 1 and 3 and two channel pairs drawn (seed 0) from {8, 64, 256,
    1024, 2048}^2, B 256 at two ResNet50 shapes, one case whose channel
    means are far above their spread, and one at P 81 with C_out 44 (odd
    P, y's runs not 16-byte aligned: the 2-byte-load path)."""
    import random
    rnd = random.Random(0)
    widths = (8, 64, 256, 1024, 2048)
    for dt in ("float32", "bfloat16"):
        for P in (1, 16, 49, 196, 200, 784):
            for B in (1, 3):
                for _ in range(2):
                    yield dt, B, rnd.choice(widths), rnd.choice(widths), P, 0
        yield dt, 256, 64, 256, 784, 0
        yield dt, 256, 1024, 2048, 16, 0
        yield dt, 3, 256, 64, 196, 30.0
        # odd P past the bulk path (C_out % 8 != 0): 2-byte loads
        yield dt, 3, 24, 44, 81, 0


def conv_errs(torch, x3, w):
    """(y err, sum err, sum-of-squares err, y max abs err) of K10 on (x3,
    w): y against the plain version in x3's dtype, the sums against the
    fp64 plain sums."""
    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    y, s1, s2 = cf.conv1x1_stats_cuda(x3, w)
    py = cf.conv1x1_stats_plain(x3, w)[0]
    _, r1, r2 = cf.conv1x1_stats_plain(x3.double(), w.double())
    torch.cuda.synchronize()
    e_y = max_err(y, py) / max(py.float().abs().max().item(), 1e-30)
    scale = max(r2.max().item(), 1e-300)
    e1 = (s1.double() - r1).abs().max().item() / math.sqrt(scale)
    e2 = (s2.double() - r2).abs().max().item() / scale
    return e_y, e1, e2, max_err(y, py)


def phase_kernel_conv1x1(torch):
    """K10 against its plain version over the sweep (fp32 and bf16, B
    1/3/256, channels from {8, 64, 256, 1024, 2048}, P 1/16/49/81/196/200/
    784, a large channel mean); conv1x1_bn_act through K10 at stride 1 and 2
    against the unfused plain composition; then every distinct ResNet50
    shape at b256 in bf16 timed by CUDA events beside the plain version
    and torch.matmul(w, x3) (cuBLAS: the product without the sums, a
    yardstick only), with its bound."""
    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    g = torch.Generator(device="cuda").manual_seed(0)
    worst, worst_abs = {}, {}
    n_cases = 0
    cf.conv1x1_stats_cuda.path_launches = dict.fromkeys(cf.LOAD_PATHS, 0)
    for dt, B, C_in, C_out, P, shift in conv_sweep():
        dtype = getattr(torch, dt)
        x3 = (torch.randn(B, C_in, P, generator=g, device="cuda")
              + shift).to(dtype)
        w = (torch.randn(C_out, C_in, generator=g, device="cuda")
             * C_in ** -0.5).to(dtype)
        *errs, abs_y = conv_errs(torch, x3, w)
        worst_abs[dt] = max(worst_abs.get(dt, 0.0), abs_y)
        case = f"{dt} B={B} C_in={C_in} C_out={C_out} P={P} shift={shift}"
        for name, e, tol in zip(("y", "sum", "sum_sq"), errs,
                                (CONV_Y_TOL[dt], CONV_SUM_TOL[dt],
                                 CONV_SUM_TOL[dt])):
            if not (math.isfinite(e) and e <= tol):
                fail(f"kernel_conv1x1 {case}: {name} err {e} > {tol}")
            worst[f"{name}_{dt}"] = max(worst.get(f"{name}_{dt}", 0.0), e)
        n_cases += 1
    # the bf16 sweep ran x's loads by TMA (P 784, 200, 16) and without (P
    # 196 by cp.async, P 49 and 1 by bulk copies of whole images, P 81 at
    # C_out 44 by 2-byte loads)
    sweep_paths = dict(cf.conv1x1_stats_cuda.path_launches)
    if not all(sweep_paths.values()):
        fail(f"kernel_conv1x1: a load path never ran in the sweep: "
             f"{sweep_paths}")
    # the fused op through K10, strides 1 and 2, against the unfused plain
    # composition (out by max |diff| / max |ref|, mean and var likewise)
    fused_err = {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for stride, relu in ((1, True), (2, False)):
            x = torch.randn(3, 64, 14, 14, generator=g, device="cuda"
                            ).to(dtype)
            w = (torch.randn(32, 64, generator=g, device="cuda") / 8
                 ).to(dtype)
            gb = [(torch.randn(32, generator=g, device="cuda") * 0.1
                   + (1.0 if i == 0 else 0.0)).to(dtype) for i in range(3)]
            out = cf.conv1x1_bn_act(x, w, *gb, 1e-5, relu, stride)
            ref = cf.conv1x1_bn_act_plain(x.double(), w.double(),
                                          *(t.double() for t in gb), 1e-5,
                                          relu, stride)
            torch.cuda.synchronize()
            e = max(max_err(a, b) / max(b.abs().max().item(), 1e-30)
                    for a, b in zip(out, ref))
            fused_err[f"{dt}_stride{stride}"] = e
            if not e <= (1e-5 if dt == "float32" else 2e-2):
                fail(f"kernel_conv1x1: conv1x1_bn_act {dt} stride {stride} "
                     f"vs the plain composition: {e}")
    # every distinct shape of one ResNet50 training step, bf16, timed
    from deeplearning4j_tpu_torch.models import ResNet50
    shapes = resnet_pair_shapes(ResNet50(num_labels=RESNET_CLASSES).conf(),
                                RESNET_B)
    timed = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "graph_ms": 0.0, "library_graph_ms": 0.0, "bytes": 0,
              "ops": 0}
    for (B, C_in, C_out, P), calls in sorted(shapes.items()):
        x3 = torch.randn(B, C_in, P, generator=g, device="cuda",
                         dtype=torch.bfloat16)
        w = (torch.randn(C_out, C_in, generator=g, device="cuda")
             * C_in ** -0.5).to(torch.bfloat16)
        e_y, e1, e2, _ = conv_errs(torch, x3, w)
        if not (e_y <= CONV_Y_TOL["bfloat16"]
                and max(e1, e2) <= CONV_SUM_TOL["bfloat16"]):
            fail(f"kernel_conv1x1 at the ResNet50 shape {(B, C_in, C_out, P)}"
                 f": errs {e_y, e1, e2}")
        ms = event_ms(torch, lambda: cf.conv1x1_stats_cuda(x3, w), iters=10)
        plain_ms = event_ms(torch, lambda: cf.conv1x1_stats_plain(x3, w),
                            iters=3)
        library_ms = event_ms(torch, lambda: torch.matmul(w, x3), iters=10)
        # device time without the host's dispatch: the wrapper (kernel and
        # its torch sum of the partials) and cuBLAS, each by graph replay
        k_graph = graph_ms(torch, lambda: cf.conv1x1_stats_cuda(x3, w),
                           reps=10, iters=10)
        l_graph = graph_ms(torch, lambda: torch.matmul(w, x3), reps=10,
                           iters=10)
        nbytes, ops, bound_ms, bound_by = conv_bound(B, C_in, C_out, P, 2)
        timed.append({"B": B, "C_in": C_in, "C_out": C_out, "P": P,
                      "path": cf.conv1x1_load_path(P, C_in, C_out),
                      "calls_per_step": calls, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "graph_ms": k_graph,
                      "library_graph_ms": l_graph, "bound_ms": bound_ms,
                      "bound_by": bound_by, "y_err": e_y,
                      "sum_err": max(e1, e2)})
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("library_ms", library_ms), ("bound_ms", bound_ms),
                     ("graph_ms", k_graph), ("library_graph_ms", l_graph),
                     ("bytes", nbytes), ("ops", ops)):
            totals[k] += calls * v
        del x3, w
    if sum(shapes.values()) != RESNET_PAIRS:
        fail(f"ResNet50 has {sum(shapes.values())} fusable pairs, expected "
             f"{RESNET_PAIRS}")
    t_b = totals["bytes"] / HBM_BYTES_PER_S
    t_o = totals["ops"] / BF16_OPS_PER_S
    res = {"phase": "kernel_conv1x1", "cases": n_cases, "max_err": worst,
           "max_abs_err_y": worst_abs,
           "tolerance": {"y": CONV_Y_TOL, "sums": CONV_SUM_TOL},
           "fused_op_err": fused_err, "sweep_path_launches": sweep_paths,
           "shapes": timed,
           "per_step": totals | {"bound_by": "bytes" if t_b >= t_o
                                 else "operations"},
           "library": "torch.matmul(w, x3) (cuBLAS): the product alone, "
                      "without the sums"}
    emit(res)
    return res


def phase_train_resnet50(torch, np):
    """fit_on_device(steps=5, sync=False) after one warm step (images/s,
    ms/step, peak memory, model FLOPs and their share of 989 TFLOP/s,
    exactly 36 K10 launches a step), two fit(x, y) steps (36 each), one
    output() (no K10: inference uses the running statistics); every loss
    finite. Then a profile of two steps: top kernels and idle share."""
    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    net = resnet_net("bfloat16")
    x, y = resnet_data(torch, np, RESNET_B)
    steps = 5
    warm = net.fit_on_device(x, y, steps=1).tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cf.conv1x1_stats_cuda.launches = 0                 # main path starts
    t0 = time.perf_counter()
    losses = net.fit_on_device(x, y, steps=steps, sync=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cf.conv1x1_stats_cuda.launches          # main path ends
    peak = torch.cuda.max_memory_allocated()
    losses = losses.cpu().numpy().tolist()
    diverged = net._diverged_at
    cf.conv1x1_stats_cuda.launches = 0
    fit_losses = []
    for _ in range(2):
        net.fit(x, y)
        fit_losses.append(net.score())
    fit_launches = cf.conv1x1_stats_cuda.launches
    cf.conv1x1_stats_cuda.launches = 0
    out = net.output(x[:32])
    torch.cuda.synchronize()
    out_launches = cf.conv1x1_stats_cuda.launches
    all_losses = warm + losses + fit_losses
    if not all(math.isfinite(v) for v in all_losses) or diverged is not None:
        fail(f"train_resnet50: non-finite loss {all_losses}")
    if launches != RESNET_PAIRS * steps:
        fail(f"train_resnet50: {launches} K10 launches in {steps} steps, "
             f"expected {RESNET_PAIRS} a step")
    if fit_launches != 2 * RESNET_PAIRS or out_launches != 0:
        fail(f"train_resnet50: fit launched K10 {fit_launches} times "
             f"(expected {2 * RESNET_PAIRS}), output() {out_launches}")
    if not bool(torch.isfinite(out).all()):
        fail("train_resnet50: output() is not finite")
    if not peak < 80e9:
        fail(f"train_resnet50: peak memory {peak} B")
    flops = resnet_model_flops(net.conf, RESNET_B)
    ms_step = wall / steps * 1e3
    res = {"phase": "train_resnet50", "config": {
               "model": "zoo ResNet50 (ComputationGraph, 175 nodes)",
               "input": [3, 224, 224], "classes": RESNET_CLASSES,
               "batch": RESNET_B, "compute_dtype": "bfloat16",
               "params_dtype": "float32", "updater": "RmsProp(0.1, 0.96)",
               "l1": 1e-7, "l2": 5e-5, "init": "N(0, 0.5)",
               "num_params": net.num_params(), "fused_pairs": RESNET_PAIRS},
           "steps": steps, "wall_s": wall, "ms_per_step": ms_step,
           "images_per_s": RESNET_B * steps / wall,
           "model_flops_per_step": flops,
           "model_tflops": flops / ms_step / 1e9,
           "bf16_peak_share": flops / (ms_step / 1e3) / BF16_OPS_PER_S,
           "peak_bytes": peak, "peak_bytes_above_start": peak - base,
           "launches": launches, "launches_per_step": launches / steps,
           "losses": losses, "warm_loss": warm, "fit_losses": fit_losses,
           "fit_launches": fit_launches, "output_launches": out_launches}
    res["profile"] = profile_train(torch, net, x, y)
    emit(res)
    return res


def grad_errs(net, g, g_ref) -> dict:
    """{"norm": ||g - ref|| / ||ref||, "median", "max": over the tensors of
    max |diff| / max |ref|, "tensors": the per-tensor errors} in float64,
    the conv biases that feed a BatchNormalization left out of the
    per-tensor errors."""
    from deeplearning4j_tpu_torch.util.flat_params import unflatten_params
    pre_bn = set(net._conv_bn_fusable()) | {
        n for n, node in net.conf.nodes.items()
        if any(type(net.conf.nodes[c].conf).__name__ == "BatchNormalization"
               for c in net.conf.nodes if n in net.conf.nodes[c].inputs)}
    per = {}
    for name, gg, gr in zip(net.layer_names,
                            unflatten_params(net.params_tree, g.double()),
                            unflatten_params(net.params_tree,
                                             g_ref.double())):
        for k in sorted(gr):
            if k == "b" and name in pre_bn:
                continue
            per[f"{name}.{k}"] = max_err(gg[k], gr[k]) / max(
                gr[k].abs().max().item(), 1e-300)
    vals = sorted(per.values())
    return {"norm": ((g.double() - g_ref.double()).norm()
                     / g_ref.double().norm()).item(),
            "median": vals[len(vals) // 2], "max": vals[-1], "tensors": per}


def phase_resnet_oracle(torch, np):
    """ResNet50 at full width, batch 8 at 224x224, each gradient_and_score
    held against the unfused route (the plain layers, no K10) in fp64 on
    the card. fp32: the fused route (36 K10 launches) and the unfused fp32
    route; bf16 compute over the same params: fused and unfused. The loss
    within 1e-5 relative (fp32); the gradient's norm-wise
    and median per-tensor errors within RESNET_FACTOR times the unfused
    route's in the same dtype. The fp64 route's own sensitivity, to a
    2^-24 relative perturbation of the input, is reported beside them.
    (bf16 loss: within RESNET_FACTOR times the unfused bf16 loss error or
    RESNET_BF16_LOSS_FLOOR.)"""
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf.graph_configuration import \
        ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    net = resnet_net(None)
    d = json.loads(net.conf.to_json())
    d["global_conf"]["dtype"] = "float64"
    net64 = ComputationGraph(ComputationGraphConfiguration.from_dict(d),
                             device="cuda").init(params=net.params_tree)
    x, y = resnet_data(torch, np, RESNET_ORACLE_B)

    def unfused(n):
        n._fusable = {}             # the plain layers: no pair takes K10
        return n
    cf.conv1x1_stats_cuda.launches = 0
    g_k, s_k = net.gradient_and_score(x, y)
    launches = cf.conv1x1_stats_cuda.launches
    unfused(net64)
    g_ref, s_ref = net64.gradient_and_score(x.double(), y.double())
    gen = torch.Generator(device="cuda").manual_seed(1)
    xp = x.double() * (1 + 2.0 ** -24 * torch.randn(
        x.shape, generator=gen, device="cuda", dtype=torch.float64))
    g_pert, s_pert = net64.gradient_and_score(xp, y.double())
    del net64
    net_u = unfused(resnet_net(None))
    if not torch.equal(net_u.params(), net.params()):
        fail("resnet_oracle: the unfused net was built with other params")
    g_u, s_u = net_u.gradient_and_score(x, y)
    del net_u
    net_b = resnet_net("bfloat16")
    cf.conv1x1_stats_cuda.launches = 0
    g_bk, s_bk = net_b.gradient_and_score(x, y)
    b_launches = cf.conv1x1_stats_cuda.launches
    g_bu, s_bu = unfused(net_b).gradient_and_score(x, y)
    torch.cuda.synchronize()
    if launches != RESNET_PAIRS or b_launches != RESNET_PAIRS \
            or cf.conv1x1_stats_cuda.launches != b_launches:
        fail(f"resnet_oracle: K10 launches {launches} (fp32), {b_launches}"
             f" (bf16), {cf.conv1x1_stats_cuda.launches} after the unfused "
             f"pass; expected {RESNET_PAIRS}, {RESNET_PAIRS}, no more")
    errs = {k: grad_errs(net, g, g_ref) for k, g in (
        ("fp32_fused", g_k), ("fp32_unfused", g_u), ("bf16_fused", g_bk),
        ("bf16_unfused", g_bu), ("fp64_perturbed", g_pert))}
    loss = {k: abs(s - s_ref) / abs(s_ref) for k, s in (
        ("fp32_fused", s_k), ("fp32_unfused", s_u), ("bf16_fused", s_bk),
        ("bf16_unfused", s_bu), ("fp64_perturbed", s_pert))}
    bad = []
    for dt in ("fp32", "bf16"):
        f, u = errs[f"{dt}_fused"], errs[f"{dt}_unfused"]
        for m in ("norm", "median"):
            if not f[m] <= RESNET_FACTOR * u[m]:
                bad.append(f"{dt} {m} error {f[m]} > {RESNET_FACTOR} x "
                           f"unfused {u[m]}")
    if not loss["fp32_fused"] <= RESNET_LOSS_TOL:
        bad.append(f"fp32 loss rel {loss['fp32_fused']}")
    if not loss["bf16_fused"] <= max(RESNET_FACTOR * loss["bf16_unfused"],
                                     RESNET_BF16_LOSS_FLOOR):
        bad.append(f"bf16 loss rel {loss['bf16_fused']}")
    if not all(math.isfinite(s) for s in (s_k, s_bk)):
        bad.append(f"non-finite loss: {s_k}, {s_bk}")
    res = {"phase": "resnet_oracle", "batch": RESNET_ORACLE_B,
           "loss_fp64": s_ref, "loss": {"fp32_fused": s_k, "bf16_fused": s_bk},
           "loss_rel_err": loss,
           "grad_err": {k: {m: v[m] for m in ("norm", "median", "max")}
                        for k, v in errs.items()},
           "worst_tensors": {k: sorted(v["tensors"].items(),
                                       key=lambda kv: -kv[1])[:3]
                             for k, v in errs.items()},
           "fp32_tensors_over_1e-4": {
               k: sum(e > 1e-4 for e in errs[k]["tensors"].values())
               for k in ("fp32_fused", "fp32_unfused", "fp64_perturbed")},
           "tensors": len(errs["fp32_fused"]["tensors"]),
           "launches": {"fp32": launches, "bf16": b_launches},
           "tolerance": {"loss": RESNET_LOSS_TOL, "factor": RESNET_FACTOR,
                         "bf16_loss_floor": RESNET_BF16_LOSS_FLOOR}}
    emit(res)
    if bad:
        fail(f"resnet_oracle: {bad}")
    return res


# ------------------------------------------------------ gradient sharing
# The JAX bench's config 5 (bench.py bench_parallel_wrapper): the
# ResNet50 above (b256, bf16 over fp32) through ParallelWrapper in
# SHARED_GRADIENTS with threshold 1e-3 on make_mesh(1). K11 encodes every
# parameter tensor's update in one launch per replica per step.
PW_THRESHOLD = 1e-3
THRESH_NS = (1, 127, 128, 1000, 4097, 2 ** 20 + 3, 25_583_592)
THRESH_TS = (1e-3, 1e-5, 0.37)
_BITS = {2: "int16", 4: "int32", 8: "int64"}


def bits_equal(torch, a, b) -> bool:
    """a and b equal bit for bit (NaN by its bit pattern)."""
    it = getattr(torch, _BITS[a.element_size()])
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(a.view(it), b.view(it))


def threshold_case(torch, n, dtype, t, residual, g):
    """(update, residual) on the card: N(0, (1.5 t)^2) updates, residuals
    N(0, (0.5 t)^2) or zero."""
    u = (torch.randn(n, generator=g, device="cuda") * (1.5 * t)).to(dtype)
    r = (torch.randn(n, generator=g, device="cuda") * (0.5 * t)).to(dtype) \
        if residual else torch.zeros(n, dtype=dtype, device="cuda")
    return u, r


def threshold_edges(torch, dtype, t, n, g):
    """A case of n elements whose first entries are +-t (t in the dtype),
    one ulp either side of +-t, NaN, +-inf and -0.0, over a residual of
    -0.0 (so acc is the entry itself); the rest as threshold_case."""
    from deeplearning4j_tpu_torch.ops.threshold_encode import threshold_in
    tv = threshold_in(t, dtype)
    tt = torch.tensor([tv], dtype=dtype)
    up = torch.nextafter(tt, torch.tensor([math.inf], dtype=dtype)).item()
    down = torch.nextafter(tt, torch.tensor([0.0], dtype=dtype)).item()
    edges = torch.tensor([tv, -tv, up, -up, down, -down, math.nan, math.inf,
                          -math.inf, -0.0], dtype=torch.float64).to(dtype)
    u, r = threshold_case(torch, n, dtype, t, True, g)
    u[:len(edges)] = edges.cuda()
    r[:len(edges)] = -0.0
    return u, r


def resnet_leaf_shapes(net):
    """The shapes of ResNet50's parameter tensors, in the flat order."""
    from deeplearning4j_tpu_torch.util.flat_params import tree_leaves
    return [tuple(t.shape) for t in tree_leaves(net.params_tree)]


def threshold_views(torch, n, dtype, t, offsets, g):
    """(update, residual) of n elements as views `offsets` elements into
    allocations of their own (threshold_case's values)."""
    pair = threshold_case(torch, n, dtype, t, True, g)
    out = []
    for a, o in zip(pair, offsets):
        buf = torch.empty(n + o, dtype=dtype, device="cuda")
        buf[o:].copy_(a)
        out.append(buf[o:])
    return out


def phase_kernel_threshold(torch):
    """K11 against threshold_encode_plain on the card, bitwise: fp32, bf16
    and fp64, n in THRESH_NS, t in THRESH_TS, residual zero and non-zero,
    per dtype an edge case (+-t, one ulp either side, NaN, +-inf, -0.0)
    and one list call over views at offsets (update, residual) (0, 0),
    (1, 1), (3, 3) (the 16-byte path, scalar heads and tails) and (1, 2),
    (0, 1) (scalar) for n 1, 127, 4097 and 2^20 + 3; every message in {-t,
    0, t}; n 0 launches nothing. Then timed by CUDA events in fp32: the
    flat ResNet50 gradient (25,583,592 elements), and one step's encode of
    ResNet50's 214 parameter tensors (views into one flat buffer) as one
    list call and as 214 one-tensor calls (the host loop, and its device
    time by CUDA-graph replay), both bit for bit equal to the plain
    version, beside it and the bound."""
    from deeplearning4j_tpu_torch.ops import threshold_encode as te
    k11 = te.threshold_encode_list_cuda
    g = torch.Generator(device="cuda").manual_seed(0)
    cases, bad = 0, []
    sent = {}
    for dt in ("float32", "bfloat16", "float64"):
        dtype = getattr(torch, dt)
        todo = [(n, t, res, False) for n in THRESH_NS for t in THRESH_TS
                for res in (False, True)] + [(4097, 1e-3, True, True)]
        for n, t, res, edge in todo:
            u, r = threshold_edges(torch, dtype, t, n, g) if edge else \
                threshold_case(torch, n, dtype, t, res, g)
            m, nr = te.threshold_encode_cuda(u, r, t)
            pm, pr = te.threshold_encode_plain(u, r, t)
            tv = te.threshold_in(t, dtype)
            torch.cuda.synchronize()
            ok = bits_equal(torch, m, pm) and bits_equal(torch, nr, pr) \
                and bool(((m == tv) | (m == -tv) | (m == 0)).all())
            if edge:
                want = [tv, -tv, tv, -tv, 0.0, 0.0, 0.0, tv, -tv, 0.0]
                ok = ok and m[:10].double().cpu().tolist() == want \
                    and bool(torch.isnan(nr[6])) \
                    and nr[7].item() == math.inf \
                    and bool(torch.signbit(nr[9])) \
                    and not bool(torch.signbit(m[9]))
            if not ok:
                bad.append(f"{dt} n={n} t={t} residual={res} edge={edge}")
            if n == THRESH_NS[-1] and res and not edge:
                sent[f"{dt}_t{t}"] = (m != 0).sum().item() / n
            cases += 1
            del u, r, m, nr, pm, pr
        pairs = [threshold_views(torch, n, dtype, 1e-3, offs, g)
                 for n in (1, 127, 4097, 2 ** 20 + 3)
                 for offs in ((0, 0), (1, 1), (3, 3), (1, 2), (0, 1))]
        before = k11.launches
        ms, nrs = k11([u for u, _ in pairs], [r for _, r in pairs], 1e-3)
        pms, prs = te.threshold_encode_list_plain(
            [u for u, _ in pairs], [r for _, r in pairs], 1e-3)
        torch.cuda.synchronize()
        if k11.launches != before + 1 or not all(
                bits_equal(torch, a, b) for a, b in zip(ms + nrs, pms + prs)):
            bad.append(f"{dt} list of views at offsets")
        cases += len(pairs)
        del pairs, ms, nrs, pms, prs
    before = k11.launches
    e = torch.zeros(0, device="cuda")
    empty = te.threshold_encode_cuda(e, e, 1e-3)
    if k11.launches != before or empty[0].numel():
        bad.append("n = 0 launched or returned elements")
    if bad:
        fail(f"kernel_threshold: K11 differs from its plain version: {bad}")
    # timing, fp32: the flat gradient, then the step's parameter tensors
    from deeplearning4j_tpu_torch.models import ResNet50
    shapes = resnet_leaf_shapes(ResNet50(num_labels=RESNET_CLASSES).init(
        device="cpu"))
    n = sum(math.prod(s) for s in shapes)
    if n != THRESH_NS[-1]:
        fail(f"kernel_threshold: ResNet50 has {n} params, expected "
             f"{THRESH_NS[-1]}")
    u, r = threshold_case(torch, n, torch.float32, PW_THRESHOLD, True, g)
    flat_ms = event_ms(torch, lambda: te.threshold_encode_cuda(
        u, r, PW_THRESHOLD), iters=50)
    flat_plain_ms = event_ms(torch, lambda: te.threshold_encode_plain(
        u, r, PW_THRESHOLD), iters=10)
    sizes = [math.prod(s) for s in shapes]
    us = [a.view(s) for a, s in zip(torch.split(u, sizes), shapes)]
    rs = [a.view(s) for a, s in zip(torch.split(r, sizes), shapes)]

    def one_list():
        return k11(us, rs, PW_THRESHOLD)

    def per_tensor():
        out = [te.threshold_encode_cuda(a, b, PW_THRESHOLD)
               for a, b in zip(us, rs)]
        return [m for m, _ in out], [e for _, e in out]
    pms, prs = te.threshold_encode_list_plain(us, rs, PW_THRESHOLD)
    before = k11.launches
    for call, want in ((one_list, 1), (per_tensor, len(shapes))):
        ms, nrs = call()
        torch.cuda.synchronize()
        if not all(bits_equal(torch, a, b)
                   for a, b in zip(ms + nrs, pms + prs)):
            fail(f"kernel_threshold: the step's tensors by {call.__name__} "
                 "differ from the plain version")
        if k11.launches - before != want:
            fail(f"kernel_threshold: {call.__name__} made "
                 f"{k11.launches - before} launches, expected {want}")
        before = k11.launches
    del pms, prs, ms, nrs
    step_ms = event_ms(torch, one_list, iters=20)
    step_graph_ms = graph_ms(torch, one_list, reps=2, iters=10)
    tensor_ms = event_ms(torch, per_tensor, iters=20)
    tensor_graph_ms = graph_ms(torch, per_tensor, reps=2, iters=10)
    step_plain_ms = event_ms(torch, lambda: te.threshold_encode_list_plain(
        us, rs, PW_THRESHOLD), iters=5)
    # bytes bound it: update and residual read, message and residual
    # written; a few operations an element, far below the card's rate
    bound_ms = 4 * n * 4 / HBM_BYTES_PER_S * 1e3
    del u, r, us, rs
    res = {"phase": "kernel_threshold", "cases": cases,
           "comparison": "bitwise (NaN by bit pattern)",
           "sent_share_at_25583592": sent, "leaves": len(shapes),
           "elements": n, "flat_ms": flat_ms, "flat_plain_ms": flat_plain_ms,
           "ms": step_ms, "graph_ms": step_graph_ms,
           "per_tensor_ms": tensor_ms, "per_tensor_graph_ms": tensor_graph_ms,
           "plain_ms": step_plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes",
           "per": f"one ResNet50 step: {len(shapes)} fp32 parameter "
                  f"tensors, threshold {PW_THRESHOLD}: ms / graph_ms one "
                  "list call (one launch), per_tensor_* one call a tensor; "
                  "flat_*: one call on the flat gradient"}
    emit(res)
    return res


def resnet_wrapper(net, mode, acc=None):
    """bench_parallel_wrapper's wrapper: `mode` on make_mesh(1), threshold
    PW_THRESHOLD, `acc` the accumulator of CUSTOM."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
    b = (ParallelWrapper.Builder(net).mesh(make_mesh(1)).training_mode(mode)
         .gradients_threshold(PW_THRESHOLD))
    return (b.gradients_accumulator(acc) if acc is not None else b).build()


def capture_shared_step(torch, pw, x, y):
    """One SHARED_GRADIENTS step's per-tensor updates and residuals of
    replica 0, as the wrapper's next step would encode them (no step
    taken)."""
    from deeplearning4j_tpu_torch.nn.multilayer import _compute_updates
    from deeplearning4j_tpu_torch.util.flat_params import tree_leaves
    net = pw.model
    _, _, grads = pw._replica_grads(0, pw._prepare(x, y, None, None))
    with torch.no_grad():
        upds, _ = _compute_updates(net.layers, net._updaters, grads,
                                   pw._opt[0], pw._params[0], pw._host_step)
    return tree_leaves(upds), tree_leaves(pw._residual[0])


def phase_train_parallel_resnet50(torch, np, train_resnet):
    """bench_parallel_wrapper at full width: ResNet50 (as train_resnet50)
    through ParallelWrapper on make_mesh(1) in SHARED_GRADIENTS, threshold
    1e-3. fit_on_device(steps=5, sync=False) after a warm step: images/s,
    ms/step and its ratio to train_resnet50's, peak memory, exactly one
    K11 launch (over the parameter tensors) and 36 K10 launches a step, the share
    of elements sent (from one captured step), a profile of two steps
    (top kernels, idle share). Then two fit(x, y) steps in
    AVERAGING (no K11), two in CUSTOM with EncodedGradientsAccumulator(1e-3)
    (one K11 launch a step over the 25,583,592-element flat gradient), and
    two ComputationGraph.fit steps with the accumulator set (one each).
    Every loss finite. Returns the captured step for parallel_oracle."""
    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    from deeplearning4j_tpu_torch.ops import threshold_encode as te
    from deeplearning4j_tpu_torch.parallel import (
        EncodedGradientsAccumulator, TrainingMode)
    k10, k11 = cf.conv1x1_stats_cuda, te.threshold_encode_list_cuda
    net = resnet_net("bfloat16")
    x, y = resnet_data(torch, np, RESNET_B)
    leaves = len(resnet_leaf_shapes(net))
    n_params = net.num_params()
    pw = resnet_wrapper(net, TrainingMode.SHARED_GRADIENTS)
    steps = 5
    warm = pw.fit_on_device(x, y, steps=1).tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    k10.launches = k11.launches = 0                    # main path starts
    t0 = time.perf_counter()
    losses = pw.fit_on_device(x, y, steps=steps, sync=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K10": k10.launches, "K11": k11.launches}  # main path ends
    peak = torch.cuda.max_memory_allocated()
    losses = losses.cpu().numpy().tolist()
    upds, resid = capture_shared_step(torch, pw, x, y)
    with torch.no_grad():
        sent = sum(int((te.threshold_encode_plain(u, r, PW_THRESHOLD)[0]
                        != 0).sum()) for u, r in zip(upds, resid))
    profile = profile_train(torch, pw, x, y)
    del pw
    short = {}
    for mode, acc in ((TrainingMode.AVERAGING, None),
                      (TrainingMode.CUSTOM,
                       EncodedGradientsAccumulator(threshold=PW_THRESHOLD))):
        w = resnet_wrapper(net, mode, acc)
        k10.launches = k11.launches = 0
        ls = []
        for _ in range(2):
            w.fit(x, y)
            ls.append(w.score())
        short[mode] = {"losses": ls, "K10": k10.launches,
                       "K11": k11.launches}
        if acc is not None:
            short[mode]["residual_elements"] = acc._residuals[0].numel()
        del w
    acc = EncodedGradientsAccumulator(threshold=PW_THRESHOLD)
    net.set_gradients_accumulator(acc)
    k10.launches = k11.launches = 0
    ls = []
    for _ in range(2):
        net.fit(x, y)
        ls.append(net.score())
    net.set_gradients_accumulator(None)
    short["graph_accumulator"] = {"losses": ls, "K10": k10.launches,
                                  "K11": k11.launches,
                                  "residual_elements":
                                      acc._residuals[0].numel()}
    all_losses = warm + losses + [v for s in short.values()
                                  for v in s["losses"]]
    if not all(math.isfinite(v) for v in all_losses):
        fail(f"train_parallel_resnet50: non-finite loss {all_losses}")
    if launches != {"K10": RESNET_PAIRS * steps, "K11": steps}:
        fail(f"train_parallel_resnet50: launches {launches} in {steps} "
             f"steps, expected {RESNET_PAIRS} K10 and 1 K11 (over {leaves} "
             "tensors) a step")
    want = {TrainingMode.AVERAGING: (2 * RESNET_PAIRS, 0, None),
            TrainingMode.CUSTOM: (2 * RESNET_PAIRS, 2, n_params),
            "graph_accumulator": (2 * RESNET_PAIRS, 2, n_params)}
    for k, (w10, w11, elems) in want.items():
        s = short[k]
        if (s["K10"], s["K11"], s.get("residual_elements")) != \
                (w10, w11, elems):
            fail(f"train_parallel_resnet50 {k}: {s}, expected K10 {w10}, "
                 f"K11 {w11}, residual of {elems}")
    if not peak < 80e9:
        fail(f"train_parallel_resnet50: peak memory {peak} B")
    ms_step = wall / steps * 1e3
    res = {"phase": "train_parallel_resnet50", "config": {
               "model": "zoo ResNet50 (ComputationGraph)",
               "batch": RESNET_B, "compute_dtype": "bfloat16",
               "params_dtype": "float32", "wrapper": "ParallelWrapper",
               "mode": "shared_gradients", "threshold": PW_THRESHOLD,
               "mesh": "make_mesh(1)", "num_params": n_params,
               "param_tensors": leaves},
           "steps": steps, "wall_s": wall, "ms_per_step": ms_step,
           "images_per_s": RESNET_B * steps / wall,
           "plain_ms_per_step": train_resnet["ms_per_step"],
           "wrapper_over_plain": ms_step / train_resnet["ms_per_step"],
           "peak_bytes": peak, "peak_bytes_above_start": peak - base,
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "sent_share_per_step": sent / n_params,
           "losses": losses, "warm_loss": warm, "short_runs": short,
           "profile": profile}
    emit(res)
    return res, (upds, resid)


def small_nets(torch):
    """(name, builder) of the oracle's fp64 nets on the card: an MLP
    (Dense(8, tanh) + softmax Output(3)) and a graph with a
    BatchNormalization (Dense(8) -> BN -> Output(3)), Adam(0.05)."""
    from deeplearning4j_tpu_torch import (Activation, ComputationGraph,
                                          BatchNormalization, DenseLayer,
                                          InputType, MultiLayerNetwork,
                                          NeuralNetConfiguration,
                                          OutputLayer, WeightInit)
    from deeplearning4j_tpu_torch.nn.updater.updaters import Adam

    def builder():
        return (NeuralNetConfiguration.Builder().seed(3)
                .weight_init(WeightInit.XAVIER).activation(Activation.TANH)
                .updater(Adam(learning_rate=0.05)).dtype("float64"))

    def mlp():
        conf = (builder().list().layer(DenseLayer(n_out=8))
                .layer(OutputLayer(n_out=3, activation=Activation.SOFTMAX))
                .set_input_type(InputType.feed_forward(5)).build())
        return MultiLayerNetwork(conf, device="cuda").init()

    def graph():
        g = builder().graph_builder()
        (g.add_inputs("in").add_layer("d1", DenseLayer(n_out=8), "in")
          .add_layer("bn", BatchNormalization(), "d1")
          .add_layer("out", OutputLayer(n_out=3,
                                        activation=Activation.SOFTMAX), "bn")
          .set_outputs("out").set_input_types(InputType.feed_forward(5)))
        return ComputationGraph(g.build(), device="cuda").init()
    return (("mlp", mlp), ("graph", graph))


def replicas_identical(torch, pw, opt: bool) -> bool:
    from deeplearning4j_tpu_torch.util.flat_params import flatten_params
    trees = [pw._params] + ([pw._opt] if opt else [])
    return all(bits_equal(torch, flatten_params(t[r]), flatten_params(t[0]))
               for t in trees for r in range(1, pw.workers))


def phase_parallel_oracle(torch, np, capture):
    """K11 on the captured full-width step's per-tensor updates and
    residuals, one list call, bitwise against the plain version. Then the
    fp64 MLP and graph of small_nets at workers 2 and 4 on the card
    repeated in the mesh: replicas bitwise identical after every
    SHARED_GRADIENTS and CUSTOM step and after every AVERAGING window; K11
    launches = replicas a SHARED_GRADIENTS step and a CUSTOM step;
    on the MLP, CUSTOM with a BasicGradientsAccumulator and Sgd(0.1)
    within 1e-10 of one fit_batch of the whole batch."""
    from deeplearning4j_tpu_torch.nn.updater.updaters import Sgd
    from deeplearning4j_tpu_torch.ops import threshold_encode as te
    from deeplearning4j_tpu_torch.parallel import (
        BasicGradientsAccumulator, EncodedGradientsAccumulator, Mesh,
        ParallelWrapper, TrainingMode)
    upds, resid = capture
    bad = []
    k11 = te.threshold_encode_list_cuda
    with torch.no_grad():
        before = k11.launches
        ms, nrs = k11(upds, resid, PW_THRESHOLD)
        if k11.launches != before + 1:
            bad.append(f"captured step: {k11.launches - before} launches")
        pms, prs = te.threshold_encode_list_plain(upds, resid, PW_THRESHOLD)
        for i, u in enumerate(upds):
            if not (bits_equal(torch, ms[i], pms[i])
                    and bits_equal(torch, nrs[i], prs[i])):
                bad.append(f"captured tensor {i} {tuple(u.shape)}")
        del ms, nrs, pms, prs
    captured = len(upds)
    del upds, resid, capture
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 5)).cuda()
    y = torch.from_numpy(np.eye(3)[rng.randint(0, 3, 16)]).cuda()
    runs = {}
    for name, make in small_nets(torch):
        for R in (2, 4):
            mesh = Mesh((torch.device("cuda", 0),) * R)
            for mode, steps in ((TrainingMode.SHARED_GRADIENTS, 3),
                                (TrainingMode.CUSTOM, 2),
                                (TrainingMode.AVERAGING, 4)):
                net = make()
                acc = EncodedGradientsAccumulator(parties=R) \
                    if mode == TrainingMode.CUSTOM else None
                pw = ParallelWrapper(net, mesh=mesh, training_mode=mode,
                                     accumulator=acc, averaging_frequency=2)
                per_step, same, losses = [], [], []
                for s in range(steps):
                    k11.launches = 0
                    pw.fit(x, y)
                    per_step.append(k11.launches)
                    losses.append(pw.score())
                    if mode != TrainingMode.AVERAGING or (s + 1) % 2 == 0:
                        same.append(replicas_identical(
                            torch, pw, mode != TrainingMode.SHARED_GRADIENTS))
                want = {TrainingMode.SHARED_GRADIENTS: R,
                        TrainingMode.CUSTOM: R,
                        TrainingMode.AVERAGING: 0}[mode]
                key = f"{name}_R{R}_{mode}"
                runs[key] = {"k11_per_step": per_step, "identical": same,
                             "losses": losses}
                if not all(same) or any(p != want for p in per_step) \
                        or not all(math.isfinite(v) for v in losses):
                    bad.append(f"{key}: {runs[key]}, expected {want} K11 "
                               "a step")
    # CUSTOM + BasicGradientsAccumulator + plain SGD == one whole-batch
    # step, on the MLP: the graph's BatchNormalization normalizes each
    # shard by its own statistics, so its shards' mean gradient differs
    sgd_err = {}
    for name, make in small_nets(torch)[:1]:
        a, b = make(), make()
        for n in (a, b):
            n._updaters = [Sgd(learning_rate=0.1) for _ in n.layers]
            n._opt_state = [u.init(p) for u, p in zip(n._updaters,
                                                      n.params_tree)]
        pw = ParallelWrapper(a, mesh=Mesh((torch.device("cuda", 0),) * 4),
                             training_mode=TrainingMode.CUSTOM,
                             accumulator=BasicGradientsAccumulator())
        err = 0.0
        for _ in range(2):
            pw.fit(x, y)
            b.fit_batch(x, y)
            err = max(err, (a.params() - b.params()).abs().max().item())
        sgd_err[name] = err
        if not err <= 1e-10:
            bad.append(f"{name} CUSTOM + Basic + Sgd vs fit_batch: {err}")
    res = {"phase": "parallel_oracle", "captured_tensors": captured,
           "captured_bitwise": not any(b.startswith("captured") for b in bad),
           "runs": runs, "custom_sgd_max_abs_err": sgd_err,
           "tolerance": {"captured": "bitwise", "custom_sgd": 1e-10}}
    emit(res)
    if bad:
        fail(f"parallel_oracle: {bad}")
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
    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import lstm_gates as tg
    from deeplearning4j_tpu_torch.ops import lstm_scan_fused as ts
    t0 = time.perf_counter()
    from deeplearning4j_tpu_torch.ops import threshold_encode as te
    # K1 and K2 are one source (the Q-query paged kernel), K6 a second;
    # fp32 K3-K5 a third, bf16 K3-K5 (wgmma) a fourth; K7 a fifth, its
    # cluster forward a sixth and its cluster backward with the bf16 dRW
    # a seventh, K8 and K9 an eighth, K10 a ninth, K11 a tenth. One nvcc
    # each, started together.
    built = build.build(sorted({*da.SOURCES, *fa.SOURCES, *ts.SOURCES,
                                tg.SOURCE, cf.SOURCE, te.SOURCE}))
    sm90 = sm90_build_report(built)
    new_kernels = new_build_report(built)
    decode_kernels = decode_build_report(built)
    gates_encode = gates_encode_build_report(built)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sm90_kernels": sm90, "k10_k7_kernels": new_kernels,
          "k1_k2_kernels": decode_kernels, "k8_k9_k11_kernels": gates_encode,
          "kernels": list(KERNEL_WRAPPERS) + [
              "flash_attention_fwd_cuda", "flash_attention_bwd_cuda",
              "graves_lstm_scan_fwd_cuda", "graves_lstm_scan_bwd_cuda",
              "graves_gates_cuda", "graves_gates_bwd_cuda",
              "lstm_gates_cuda", "lstm_gates_bwd_cuda",
              "conv1x1_stats_cuda", "threshold_encode_list_cuda"],
          "sources": {s: {"seconds": b["seconds"],
                          "ptxas": [ln.strip() for ln in b["log"].splitlines()
                                    if "registers" in ln or "smem" in ln]}
                      for s, b in built.items()}})

    kconv = phase_kernel_conv1x1(torch)
    train_resnet = phase_train_resnet50(torch, np)
    resnet_oracle = phase_resnet_oracle(torch, np)
    kthresh = phase_kernel_threshold(torch)
    train_pw, capture = phase_train_parallel_resnet50(torch, np, train_resnet)
    pw_oracle = phase_parallel_oracle(torch, np, capture)
    del capture
    klstm = phase_kernel_lstm_scan(torch)
    kgates = phase_kernel_lstm_gates(torch)
    train_lstm = phase_train_lstm(torch, np)
    lstm_oracle = phase_lstm_oracle(torch, np)
    gen = phase_generate(torch, np)
    kflash = phase_kernel_flash(torch)
    kflash_bwd = phase_kernel_flash_bwd(torch)
    train = phase_train(torch, np)
    train_oracle = phase_train_oracle(torch, np)
    wide = phase_flash_head_dims(torch, np)
    kern = phase_kernel(torch)
    kspec = phase_kernel_spec(torch)
    kcont = phase_kernel_contiguous(torch)
    serve = phase_serve(torch, np)
    oracle = phase_oracle(torch, np)
    dattn = phase_decode_attention(torch)
    spec = phase_spec_serve(torch, np)
    spec_oracle = phase_spec_oracle(torch, np)
    phase_int8_serve(torch, np, serve)
    kvp = phase_kv_pressure(torch, np, smi)
    src = "deeplearning4j_tpu_torch/ops/csrc/flash_decode_paged.cu"
    fsrc = "deeplearning4j_tpu_torch/ops/csrc/flash_attention.cu"
    f90 = "deeplearning4j_tpu_torch/ops/csrc/flash_attention_sm90.cu"
    lsrc = "deeplearning4j_tpu_torch/ops/csrc/lstm_scan.cu"
    lsrc90 = "deeplearning4j_tpu_torch/ops/csrc/lstm_scan_fwd_sm90.cu"
    lsrc90b = "deeplearning4j_tpu_torch/ops/csrc/lstm_scan_bwd_sm90.cu"
    gsrc = "deeplearning4j_tpu_torch/ops/csrc/lstm_gates.cu"
    csrc = "deeplearning4j_tpu_torch/ops/csrc/conv1x1_stats.cu"
    emit({"kernels": [{
        "name": "flash_decode_attention_paged", "route": "cuda",
        "source": src, "status": "redesigned, PR 12",
        "replaces": "deeplearning4j_tpu/ops/decode_attention.py:281",
        "launches": serve["flash_decode_launches"],
        "kv_pressure_launches": {
            k: v["k1_launches"] for k, v in kvp.items()
            if isinstance(v, dict) and "k1_launches" in v},
        "max_abs_err": max(max(kern["max_abs_err"].values()),
                           max(kern["served_max_abs_err"].values())),
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None, "kernel_only_ms": kern["kernel_only_ms"],
        "eager_ms": kern["eager_ms"], "plan": kern["plan"],
        "int8_pool": {k: kern["timed"]["int8_bf16q"][k] for k in (
            "ms", "kernel_only_ms", "eager_ms", "plain_ms", "bound_ms")},
        "oracle_max_abs_err": oracle["max_abs_err"]}, {
        "name": "flash_decode_attention_spec_paged", "route": "cuda",
        "source": src, "status": "redesigned, PR 12",
        "replaces": "deeplearning4j_tpu/ops/decode_attention.py:480",
        "launches": spec["k2_launches"],
        "max_abs_err": max(max(kspec["max_abs_err"].values()),
                           max(kspec["served_max_abs_err"].values())),
        "ms": kspec["ms"], "plain_ms": kspec["plain_ms"],
        "bound_ms": kspec["bound_ms"], "bound_by": kspec["bound_by"],
        "library_ms": None, "kernel_only_ms": kspec["kernel_only_ms"],
        "eager_ms": kspec["eager_ms"], "plan": kspec["plan"],
        "int8_pool": {k: kspec["timed"]["int8_bf16q"][k] for k in (
            "ms", "kernel_only_ms", "eager_ms", "plain_ms", "bound_ms")},
        "oracle_max_abs_err": spec_oracle["max_abs_err"]}, {
        "name": "flash_decode_attention", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/"
                  "flash_decode_contiguous.cu",
        "replaces": "deeplearning4j_tpu/ops/decode_attention.py:180",
        "launches": dattn["launches"],
        "max_abs_err": max(max(kcont["max_abs_err"].values()),
                           kcont["served_max_abs_err"]),
        "ms": kcont["ms"], "plain_ms": kcont["plain_ms"],
        "bound_ms": kcont["bound_ms"], "bound_by": kcont["bound_by"],
        "library_ms": kcont["library_ms"],
        "kernel_only_ms": kcont["kernel_only_ms"],
        "launches_per_call": kcont["launches_per_call"],
        "plan": kcont["served_plan"]}, {
        "name": "flash_attention_fwd", "route": "cuda", "source": f90,
        "fp32_source": fsrc,
        "replaces": "deeplearning4j_tpu/ops/flash_attention.py:448",
        "launches": train["launches"]["K3"],
        "max_abs_err": max(max(kflash["max_abs_err"].values()),
                           kflash["train_max_abs_err"]),
        "ms": kflash["ms"], "plain_ms": kflash["plain_ms"],
        "bound_ms": kflash["bound_ms"], "bound_by": kflash["bound_by"],
        "library_ms": kflash["library_ms"], "tflops": kflash["tflops"],
        "bound_share": kflash["bound_share"],
        "oracle_max_grad_rel_err": train_oracle["max_grad_rel_err"],
        "wide_head_dims": {d: {"ms": r["ms"]["K3"],
                               "library_ms": r["library_ms"]["fwd"],
                               "bound_ms": r["bound_ms"]["K3"],
                               "source": r["source"]}
                           for d, r in wide["timed"].items()}}] + [{
        "name": f"flash_attention_bwd_{mode}", "route": "cuda",
        "source": f90, "fp32_source": fsrc,
        "replaces": replaces,
        "launches": (train["launches"]["K4"] if mode == "fused"
                     else train["two_pass"]["launches"]["K5"]),
        "max_abs_err": max(
            kflash_bwd["max_abs_err"][f"{mode}_float32"],
            kflash_bwd["max_abs_err"][f"{mode}_bfloat16"],
            kflash_bwd["train_max_abs_err"][mode]),
        "ms": kflash_bwd["ms"][mode], "plain_ms": kflash_bwd["plain_ms"],
        "bound_ms": kflash_bwd["bound_ms"][mode],
        "bound_by": kflash_bwd["bound_by"][mode],
        "library_ms": kflash_bwd["library_ms"],
        "tflops": kflash_bwd["tflops"][mode],
        "bound_share": kflash_bwd["bound_share"][mode],
        "wide_head_dims": {
            d: {"ms": r["ms"]["K4" if mode == "fused" else "K5"],
                "library_ms": r["library_ms"]["bwd"],
                "bound_ms": r["bound_ms"]["K4"], "source": r["source"],
                "k4_dk_dv_equal_k5": r.get("k4_dk_dv_equal_k5")}
            for d, r in wide["timed"].items()}}
        for mode, replaces in (
            ("fused", "deeplearning4j_tpu/ops/flash_attention.py:349"),
            ("two_pass", "deeplearning4j_tpu/ops/flash_attention.py:262"))]
        + [{
        "name": f"graves_lstm_scan_{d}", "route": "cuda",
        "source": lsrc90 if d == "fwd" else lsrc90b,
        "replaces": f"deeplearning4j_tpu/ops/lstm_scan_fused.py:{line}",
        "launches": train_lstm["launches"][f"K7_{d}"],
        "max_abs_err": max(max(v.values())
                           for v in klstm["max_abs_err"].values()),
        "ms": klstm["ms"][d], "plain_ms": klstm["plain_ms"][d],
        "bound_ms": klstm["bound_ms"][d], "bound_by": klstm["bound_by"][d],
        "library_ms": klstm["library_ms"][d],
        "max_rel_err": {dt: max(v.values())
                        for dt, v in klstm["rel_err"].items()},
        "generate_launches": gen["launches"][f"K7_{d}"],
        "oracle_max_grad_ratio": lstm_oracle["fp32"]["max_ratio"]}
        | ({"variant_launches": train_lstm["k7_fwd_variant_launches"],
            "tile_source": lsrc,
            "sweep_variant_launches": klstm["sweep_variant_launches"]}
           if d == "fwd" else {
            "variant_launches": train_lstm["k7_bwd_variant_launches"],
            "tile_source": lsrc,
            "sweep_variant_launches": klstm["sweep_bwd_variant_launches"],
            "parts_ms": klstm["bwd_parts"][f"H={LSTM_H}"]["ms"],
            "part_bound_ms":
                klstm["bwd_parts"][f"H={LSTM_H}"]["part_bound_ms"]})
        for d, line in (("fwd", 411), ("bwd", 492))] + [{
        "name": name, "route": "cuda", "source": gsrc,
        "replaces": f"deeplearning4j_tpu/ops/pallas_kernels.py:{line}",
        "launches": sum(train_lstm["masked"][layer]["launches"][f"{k}_{d}"]
                        for d in ("fwd", "bwd")),
        "launches_fwd_bwd": [train_lstm["masked"][layer]["launches"][
            f"{k}_{d}"] for d in ("fwd", "bwd")],
        "max_abs_err": max(v for n, v in kgates["max_abs_err"].items()
                           if n.startswith(name)),
        "ms": kgates["ms"][name]["fwd"] + kgates["ms"][name]["bwd"],
        "plain_ms": kgates["plain_ms"][name]["fwd"]
        + kgates["plain_ms"][name]["bwd"],
        "bound_ms": kgates["bound_ms"][name]["fwd"]
        + kgates["bound_ms"][name]["bwd"],
        "bound_by": kgates["bound_by"][name]["bwd"],
        "library_ms": None if kgates["library_ms"][name] is None else
        sum(kgates["library_ms"][name].values()),
        "ms_fwd_bwd": [kgates["ms"][name]["fwd"],
                       kgates["ms"][name]["bwd"]],
        "bound_ms_fwd_bwd": [kgates["bound_ms"][name]["fwd"],
                             kgates["bound_ms"][name]["bwd"]],
        "status": "redesigned: 16-byte rows, backward in one launch"
        if k == "K8" else "K8's template without the peepholes",
        "path_launches": train_lstm["masked"][layer]["path_launches"]}
        for name, k, layer, line in (
            ("graves_gates", "K8", "GravesLSTM", 226),
            ("lstm_gates", "K9", "LSTM", 93))] + [{
        "name": "conv1x1_stats", "route": "cuda", "source": csrc,
        "replaces": "deeplearning4j_tpu/ops/conv_fused.py:68",
        "launches": train_resnet["launches"],
        "launches_per_step": train_resnet["launches_per_step"],
        "max_abs_err": max(kconv["max_abs_err_y"].values()),
        "max_rel_err": kconv["max_err"],
        "ms": kconv["per_step"]["ms"],
        "plain_ms": kconv["per_step"]["plain_ms"],
        "bound_ms": kconv["per_step"]["bound_ms"],
        "bound_by": kconv["per_step"]["bound_by"],
        "library_ms": kconv["per_step"]["library_ms"],
        "graph_ms": kconv["per_step"]["graph_ms"],
        "library_graph_ms": kconv["per_step"]["library_graph_ms"],
        "load_path_launches": kconv["sweep_path_launches"],
        "library": kconv["library"],
        "per": "one ResNet50 b256 bf16 training step: the 36 calls",
        "oracle_grad_norm_err": {k: v["norm"] for k, v in
                                 resnet_oracle["grad_err"].items()}}, {
        "name": "threshold_encode", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/threshold_encode.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:325",
        "launches": train_pw["launches"]["K11"],
        "launches_per_step": train_pw["launches_per_step"]["K11"],
        "max_abs_err": 0.0, "comparison": kthresh["comparison"],
        "ms": kthresh["ms"], "plain_ms": kthresh["plain_ms"],
        "bound_ms": kthresh["bound_ms"], "bound_by": kthresh["bound_by"],
        "library_ms": None, "graph_ms": kthresh["graph_ms"],
        "status": "redesigned: one launch a list of tensors",
        "per_tensor_ms": kthresh["per_tensor_ms"],
        "per_tensor_graph_ms": kthresh["per_tensor_graph_ms"],
        "flat_ms": kthresh["flat_ms"],
        "flat_plain_ms": kthresh["flat_plain_ms"], "per": kthresh["per"],
        "oracle_captured_bitwise": pw_oracle["captured_bitwise"]}]})
    for line in smi:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
