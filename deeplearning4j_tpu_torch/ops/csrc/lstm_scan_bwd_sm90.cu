// K7's backward in bf16 on Hopper (sm_90a): the reverse sweep on a thread-
// block cluster that keeps RW on chip, and the dRW product on wgmma with
// its sums in a fixed order.
//
// Replaces the reverse-scan backward of `graves_lstm_scan_pallas`
// (deeplearning4j_tpu/ops/lstm_scan_fused.py: `_make_bwd_kernel` :271,
// `_scan_bwd` :445, call :492) for bf16 storage. The sweep runs at a padded
// H of 64, 128 and 256 (lstm_scan.cu's tile sweep keeps every other H and
// fp32); the dRW kernel serves every bf16 H. Same layout and rounding
// points as lstm_scan.cu: xw, dxw (T, B, 4H) with gate order [i|f|o|g], rw
// (H, 4H), ys, cs, dys, dcs (T, B, H), h0, c0, dh0, dc0 (B, H); the gates
// are recomputed as xw + h_prev RW in fp32 (h_prev = ys[t-1], h0 at t = 0;
// c_prev likewise from cs and c0), dcs[t] is folded into the carried dc
// before the cell, the gate gradients round to bf16 before both products
// that use them (they are dxw), dh and dc round to bf16 every step, and
// dRW and the peephole sums are fp32.
//
// What bounds it on the H100, at the char-RNN layer (T 100, B 8192, H
// 256): bytes. The sweep must move 5.03 GB (xw, ys, cs, dys, dcs read, dxw
// written), 1.50 ms at 3.35 TB/s, against 859 GFLOP of gate-recompute and
// dh products (0.87 ms at 989 TFLOP/s); dRW reads ys and dxw once more
// (2.1 GB, 0.63 ms) for 429 GFLOP. lstm_scan.cu's tile sweep re-read all
// of RW (512 KB) from L2 in every CTA at every step, on wmma, and its dRW
// met through fp32 atomics.
//
// The sweep: a cluster of 8 CTAs owns 128 batch rows for the whole
// sequence; CTA k owns units [k U, k U + U), U = H / 8, and keeps their
// four gate columns of RW (H x 4U, 64 KB at H 256) in shared memory
// (lstm_sm90.cuh), read as two products:
//   - the gate recompute z = h_prev RW[:, slice] (m64 n4U, B MN-major),
//     h_prev loaded from ys straight into wgmma's register fragments (16
//     bytes a (row, peer block)); it hangs off the forward's outputs, not
//     off the chain, and runs while the warpgroup waits for its dh;
//   - the CTA's share of dh_prev = dgates RW[:, slice]^T (two products
//     m64 n(H/2) a step, one m64n64 at H 64; the same shared-memory bytes
//     read K-major), A being the gate gradients in the registers the cell left
//     them in.
// The slice's rows are permuted like its columns (row k holds RW's row (k
// / U) U + unit_of(k % U)), so the dh product hands each thread, for each
// peer, the partial sums of exactly the (row, unit) cells the thread at
// the same place in that peer owns: the exchange is a reduce-scatter of
// fp32 partials, thread to thread. Each thread stores its partials for
// peer j into j's receive slot of this CTA with `st.async` (16 bytes a
// store, completing as transaction bytes on j's mbarrier), and its own
// into its own slot; the owner then sums the 8 slots in rank order (a
// fixed order: dh repeats bit for bit) and rounds to bf16. No atomics.
// Only dh is on the serial chain: wait for the slots, sum, the cell (in
// turns of the two warpgroups, so one's cell overlaps the other's
// products and exchange), the dh product, the stores. The exchange moves
// 7/8 of 128 rows x H fp32 out of each CTA a step (112 KB at H 256, 4x
// the forward's bf16 h) and sets the step's pace.
//
// Slots are single-buffered: a producer writes its partials of step t
// into peer j only after j has read those of step t + 1, which j signals
// by one remote arrive on the producer's `free` mbarrier (7 a phase); j
// arms its own `full` mbarrier for the next phase (7 slots' bytes) before
// it signals. A thread's own slot is written and read by the same thread.
// Budget per CTA at H 256: RW 64 KB + slots 2 warpgroups x 8 x 8 KB +
// peephole partials 3 KB = 196 KB, 256 threads, one CTA an SM.
//
// dRW = sum over the T*B rows m of h_prev[m]^T dxw[m] (h_prev[m] = h0[m]
// for m < B, else ys[m - B]): one CTA per (128 x 128 output tile, chunk of
// rows), two consumer warpgroups of m64 n128 on wgmma with both operands
// MN-major from 128-byte-swizzled TMA boxes (h0 and ys through maps of
// their own, the K loop split at B), a producer warp keeping a 4-stage
// ring full. fp32 sums over 10^5 rows lose digits, so each 1024 rows start
// a fresh accumulator that is added into a running total. Each CTA writes
// its fp32 total to its chunk's slab; the caller sums the slabs in chunk
// order. No atomics: dRW repeats bit for bit.
#include "lstm_sm90.cuh"

namespace {

using namespace lstm90;

// ------------------------------------------------------------ the sweep
template <int H>
struct Cfg : Slice<H> {
  using S = Slice<H>;
  // one source's partials for a warpgroup: 128 threads x 4 A8 floats (64
  // rows x U units x fp32), as A8 chunks of 4 floats, thread-contiguous
  static constexpr int SLOT = 128 * 4 * S::A8 * 4;
  static constexpr int SLOT_OFF = S::RW_BYTES;        // slot[warpgroup][rank]
  static constexpr int DP_OFF = SLOT_OFF + 2 * CL * SLOT;  // [8 warps][3][U]
  static constexpr int BAR_OFF = DP_OFF + 8 * 3 * S::U * 4;
  static constexpr int SMEM = BAR_OFF + 4 * 8 + 1024;
  static_assert(SMEM <= 232448, "one CTA's shared memory");
};

// d (m64 x N, fp32) += A B over one k16 slice, A from registers (the
// m64k16 fragment: a[0] rows r, a[1] rows r + 8, columns 2 (l % 4) + {0,
// 1}; a[2], a[3] the same 8 columns further), B from shared memory,
// MN-major (TB = 1) or K-major (TB = 0).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc);

template <>
__device__ __forceinline__ void wgmma_rs<32, 1>(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#define DL4J_RS64(TB)                                                       \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                               \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                             \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, " #TB ";\n}\n"                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                     \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                     \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                 \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                 \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                 \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                 \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc))

template <>
__device__ __forceinline__ void wgmma_rs<64, 1>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int acc) {
  DL4J_RS64(1);
}
template <>
__device__ __forceinline__ void wgmma_rs<64, 0>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int acc) {
  DL4J_RS64(0);
}
#undef DL4J_RS64

#define DL4J_RS128(TB)                                                      \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                               \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                             \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                             \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                             \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                             \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                             \
      "%56, %57, %58, %59, %60, %61, %62, %63"                              \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, " #TB ";\n}\n"                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                     \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                     \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                 \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                 \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                 \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                 \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                 \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                 \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                 \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                 \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                 \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                 \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                 \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                 \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc))

template <>
__device__ __forceinline__ void wgmma_rs<128, 1>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
  DL4J_RS128(1);
}
template <>
__device__ __forceinline__ void wgmma_rs<128, 0>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
  DL4J_RS128(0);
}
#undef DL4J_RS128

// keep register operands of in-flight products alive (and unmoved) until
// after the wait
template <int N>
__device__ __forceinline__ void fence_words(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// 16 bytes of fp32 into a peer's shared memory (`dst`, `bar` from
// peer_addr), completing on its mbarrier as transaction bytes
__device__ __forceinline__ void store_to_peer(uint32_t dst, float4 v,
                                              uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
      " [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// one arrival on a peer's mbarrier (address from peer_addr), releasing
// this thread's earlier accesses at cluster scope
__device__ __forceinline__ void arrive_at_peer(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int H>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
scan_bwd_cluster(const bf16* __restrict__ xw, const bf16* __restrict__ rw,
                 const bf16* __restrict__ pi, const bf16* __restrict__ pf,
                 const bf16* __restrict__ po, const bf16* __restrict__ h0,
                 const bf16* __restrict__ c0, const bf16* __restrict__ ys,
                 const bf16* __restrict__ cs, const bf16* __restrict__ dys,
                 const bf16* __restrict__ dcs, bf16* __restrict__ dxw,
                 bf16* __restrict__ dh0, bf16* __restrict__ dc0,
                 float* __restrict__ dp_part, int T, int B) {
  using K = Cfg<H>;
  constexpr int U = K::U, N = K::N, A8 = K::A8, RB = K::RB;
  // columns of a dh product: two products a step (one at H 64), so that
  // the first's stores to the peers overlap the second's product
  constexpr int PN = H >= 128 ? H / 2 : H;
  constexpr int NG = H / PN;              // dh products a step
  constexpr int PG = PN / U;              // peers a product serves
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + K::BAR_OFF);  // [2]
  uint64_t* freed = full + 2;                                      // [2]
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int b0 = (blockIdx.x / CL) * BT;
  const int u0 = rank * U;
  const int w = tid >> 7, tw = tid & 127, lane = tw & 31;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&freed[i], CL - 1);
    }
    mbar_fence_init();
  }
  load_rw_slice<H, true>(sm, rw, u0);
  fence_async_smem();
  __syncthreads();
  // phase 0 of each warpgroup's slots: the partials of step T - 1
  if (tw == 0) mbar_expect_tx(&full[w], (CL - 1) * K::SLOT);
  cluster_sync();                  // every peer's mbarriers are initialized

  // this thread's rows rl and rl + 8 of the warpgroup's 64 and its 2 A8
  // units uq + 2 a + e (a < A8, e < 2): cell j = 4 a + 2 r + e
  const int rl = 16 * (tw >> 5) + (lane >> 2);
  const int q4 = lane & 3;
  const int uq = u0 + 2 * A8 * q4;
  long row[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = b0 + 64 * w + rl + 8 * r;
    live[r] = b < B;
    row[r] = live[r] ? b : 0;
  }
  float wi[A8][2], wf[A8][2], wo[A8][2];
  float dc[2][A8][2], sp[3][A8][2];
#pragma unroll
  for (int a = 0; a < A8; ++a)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = uq + 2 * a + e;
      wi[a][e] = __bfloat162float(pi[u]);
      wf[a][e] = __bfloat162float(pf[u]);
      wo[a][e] = __bfloat162float(po[u]);
#pragma unroll
      for (int r = 0; r < 2; ++r) dc[r][a][e] = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) sp[k][a][e] = 0.f;
    }
  // A8 words of (row r, the thread's units) of a (T, B, H) tensor
  auto load_units = [&](uint32_t (&x)[2][A8], const bf16* base) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (live[r])
        load_words<A8>(x[r], base + row[r] * H + uq);
      else
#pragma unroll
        for (int a = 0; a < A8; ++a) x[r][a] = 0u;
    }
  };
  // the sum of the 8 slots of a phase, in rank order, rounded to bf16
  unsigned char* slots = sm + K::SLOT_OFF + w * CL * K::SLOT;
  auto sum_slots = [&](float (&dh)[2][A8][2]) {
#pragma unroll
    for (int a = 0; a < A8; ++a) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int src = 0; src < CL; ++src) {
        const float4 v = *reinterpret_cast<const float4*>(
            slots + src * K::SLOT + (a * 128 + tw) * 16);
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      dh[0][a][0] = bf16_round(s.x), dh[0][a][1] = bf16_round(s.y);
      dh[1][a][0] = bf16_round(s.z), dh[1][a][1] = bf16_round(s.w);
    }
  };

  const uint32_t rw_s = smem_u32(sm);
  const uint32_t full_w = smem_u32(&full[w]), freed_w = smem_u32(&freed[w]);
  const uint32_t my_slot = smem_u32(slots + rank * K::SLOT) + tw * 16;
  // the two warpgroups take turns at the cell, warpgroup 0 first
  if (w == 1) named_arrive(TURN, 256);
  for (int t = T - 1; t >= 0; --t) {
    const int ph = T - 1 - t;        // this step's phase of the slots
    // this step's inputs of the cell, in flight during the recompute
    uint32_t xv[2][4][A8], cpw[2][A8], dyw[2][A8], dcw[2][A8];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (live[r])
          load_words<A8>(xv[r][g],
                         xw + ((long)t * B + row[r]) * 4 * H + g * H + uq);
        else
#pragma unroll
          for (int a = 0; a < A8; ++a) xv[r][g][a] = 0u;
      }
    }
    load_units(cpw, t > 0 ? cs + (long)(t - 1) * B * H : c0);
    load_units(dyw, dys + (long)t * B * H);
    load_units(dcw, dcs + (long)t * B * H);
    // the gate recompute: h_prev (K in the slice's row order, 16 bytes a
    // (row, peer block)) times the RW slice
    float acc[N / 2];
    {
      const bf16* hsrc = t > 0 ? ys + (long)(t - 1) * B * H : h0;
      uint32_t af[H / 16][4];
#pragma unroll
      for (int blk = 0; blk < CL; ++blk)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t x[A8];
          if (live[r])
            load_words<A8>(x, hsrc + row[r] * H + blk * U + 2 * A8 * q4);
          else
#pragma unroll
            for (int a = 0; a < A8; ++a) x[a] = 0u;
#pragma unroll
          for (int a = 0; a < A8; ++a) {
            const int c = blk * U + 8 * a;     // slice column of word a
            af[c >> 4][((c >> 3) & 1) * 2 + r] = x[a];
          }
        }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk)
        wgmma_rs<N, 1>(acc, af[kk],
                       gmma_desc(rw_s + kk * 16 * RB, H * RB, 8 * RB,
                                 swizzle_code(RB)),
                       kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_words(af);
    }
    // dh carried from step t + 1: the peers' partials (zero at T - 1)
    float dhc[2][A8][2];
    if (t < T - 1) {
      mbar_wait(&full[w], (ph - 1) & 1);
      sum_slots(dhc);
      // arm the next phase (the partials of step t), then tell the 7
      // producers their slots here are free
      if (tw == 0) mbar_expect_tx(&full[w], (CL - 1) * K::SLOT);
      named_sync(1 + w, 128);
      if (tw < CL - 1)
        arrive_at_peer(peer_addr(freed_w, (rank + 1 + tw) % CL));
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int a = 0; a < A8; ++a) dhc[r][a][0] = dhc[r][a][1] = 0.f;
    }

    // the cell, in registers: gate g of (row r, unit uq + 2 a + e) is
    // acc[4 (g A8 + a) + 2 r + e]; its gradient goes to the same place of
    // dg
    named_sync(TURN + w, 256);
    float dg[N / 2];
#pragma unroll
    for (int a = 0; a < A8; ++a)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 4 * a + 2 * r + e;
          auto z = [&](int g) {
            return acc[4 * (g * A8) + j] + bf_half(xv[r][g][a], e);
          };
          const float cp = bf_half(cpw[r][a], e);
          const float i = sigm(z(0) + cp * wi[a][e]);
          const float f = sigm(z(1) + cp * wf[a][e]);
          const float gg = tanhf(z(3));
          const float cn = f * cp + i * gg;
          const float o = sigm(z(2) + cn * wo[a][e]);
          const float tn = tanhf(cn);
          const float dh = bf_half(dyw[r][a], e) + dhc[r][a][e];
          const float dcin = dc[r][a][e] + bf_half(dcw[r][a], e);
          const float dzo = dh * tn * o * (1.f - o);
          const float dct = dcin + dh * o * (1.f - tn * tn) + dzo * wo[a][e];
          const float dzi = dct * gg * i * (1.f - i);
          const float dzf = dct * cp * f * (1.f - f);
          const float dzg = dct * i * (1.f - gg * gg);
          dc[r][a][e] = bf16_round(dct * f + dzi * wi[a][e] + dzf * wf[a][e]);
          sp[0][a][e] += dzi * cp;
          sp[1][a][e] += dzf * cp;
          sp[2][a][e] += dzo * cn;
          dg[4 * (0 * A8) + j] = dzi;
          dg[4 * (1 * A8) + j] = dzf;
          dg[4 * (2 * A8) + j] = dzo;
          dg[4 * (3 * A8) + j] = dzg;
        }
    if (w == 0 || t > 0) named_arrive(TURN + (w ^ 1), 256);
    // the rounded gate gradients: dxw[t], and the A fragments of the dh
    // product (slice column n = 8 i + 2 q + e is dg[4 i + 2 r + e])
    uint32_t ga[N / 16][4];
#pragma unroll
    for (int c = 0; c < N / 16; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          ga[c][2 * h + r] = pack_bf16(dg[4 * (2 * c + h) + 2 * r],
                                       dg[4 * (2 * c + h) + 2 * r + 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint32_t words[A8];
#pragma unroll
        for (int a = 0; a < A8; ++a) {
          const int i = g * A8 + a;        // accumulator column block
          words[a] = ga[i >> 1][2 * (i & 1) + r];
        }
        store_words<A8>(reinterpret_cast<unsigned char*>(
                            dxw + ((long)t * B + row[r]) * 4 * H + g * H + uq),
                        words);
      }
    }
    // the peers have read this warpgroup's slots of step t + 1
    if (t < T - 1) mbar_wait(&freed[w], (ph - 1) & 1);
    // dh_prev partials, PN columns (PG peers) a product, to each peer's
    // slot of this CTA (this CTA's own into its own slot)
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      float pacc[PN / 2];
      wg_fence();
#pragma unroll
      for (int c = 0; c < N / 16; ++c)
        wgmma_rs<PN, 0>(pacc, ga[c],
                        gmma_desc(rw_s + (16 * c / K::COLS) * H * RB +
                                      PN * gi * RB + (16 * c % K::COLS) * 2,
                                  16, 8 * RB, swizzle_code(RB)),
                        c > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(pacc);
#pragma unroll
      for (int pj = 0; pj < PG; ++pj) {
        const uint32_t peer = gi * PG + pj;
#pragma unroll
        for (int a = 0; a < A8; ++a) {
          const float* p = pacc + 4 * (pj * A8 + a);
          const float4 v = make_float4(p[0], p[1], p[2], p[3]);
          if (peer == rank)
            *reinterpret_cast<float4*>(slots + rank * K::SLOT +
                                       (a * 128 + tw) * 16) = v;
          else
            store_to_peer(peer_addr(my_slot + a * 128 * 16, peer), v,
                          peer_addr(full_w, peer));
        }
      }
    }
    fence_words(ga);
  }
  // dh0: the partials of step 0; dc0: the carry
  {
    float dh[2][A8][2];
    mbar_wait(&full[w], (T - 1) & 1);
    sum_slots(dh);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      uint32_t hw[A8], cw[A8];
#pragma unroll
      for (int a = 0; a < A8; ++a) {
        hw[a] = pack_bf16(dh[r][a][0], dh[r][a][1]);
        cw[a] = pack_bf16(dc[r][a][0], dc[r][a][1]);
      }
      store_words<A8>(reinterpret_cast<unsigned char*>(dh0 + row[r] * H + uq),
                      hw);
      store_words<A8>(reinterpret_cast<unsigned char*>(dc0 + row[r] * H + uq),
                      cw);
    }
  }
  // peephole sums of the cluster's rows: over the 8 lanes of a unit set
  // (butterfly), then over the 8 warps in order
  float* dps = reinterpret_cast<float*>(sm + K::DP_OFF);
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int a = 0; a < A8; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = sp[k][a][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4)
          dps[((tid >> 5) * 3 + k) * U + 2 * A8 * q4 + 2 * a + e] = v;
      }
  __syncthreads();
  for (int e = tid; e < 3 * U; e += NT) {
    const int k = e / U, u = e - k * U;
    float s = 0.f;
    for (int wp = 0; wp < 8; ++wp) s += dps[(wp * 3 + k) * U + u];
    dp_part[((long)(blockIdx.x / CL) * 3 + k) * H + u0 + u] = s;
  }
  cluster_sync();                  // no store is still on its way here
}

template <int H>
int launch_sweep(const void* const* in, void* dxw, void* dh0, void* dc0,
                 float* dp_part, int T, int B, cudaStream_t st) {
  using K = Cfg<H>;
  auto kern = scan_bwd_cluster<H>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long ctas = (long)((B + BT - 1) / BT) * CL;
  if (ctas > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const bf16* b[11];
  for (int i = 0; i < 11; ++i) b[i] = static_cast<const bf16*>(in[i]);
  kern<<<(unsigned)ctas, NT, K::SMEM, st>>>(
      b[0], b[1], b[2], b[3], b[4], b[5], b[6], b[7], b[8], b[9], b[10],
      static_cast<bf16*>(dxw), static_cast<bf16*>(dh0),
      static_cast<bf16*>(dc0), dp_part, T, B);
  return (int)cudaGetLastError();
}

template <int H>
int max_clusters() {
  using K = Cfg<H>;
  auto kern = scan_bwd_cluster<H>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * 64);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = K::SMEM;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// -------------------------------------------------------------------- dRW
constexpr int DT = 128;          // output tile (h rows x gate columns)
constexpr int DK = 64;           // rows of T*B a stage
constexpr int STAGES = 4;
constexpr int BOX = 64 * DK * 2;             // one 64-column box: 8 KB
constexpr int STAGE_BYTES = 4 * BOX;         // A: 2 boxes, B: 2 boxes
constexpr int FLUSH = 1024 / DK;             // stages a fresh accumulator
constexpr int DRW_NT = 288;      // 2 consumer warpgroups, a producer warp
constexpr int DRW_SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// d (m64 x 128, fp32) += A B over one k16 slice, both MN-major in shared
// memory (A's M and B's N contiguous)
__device__ __forceinline__ void wgmma_mn128(float (&d)[64], uint64_t a,
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// Steps of DK rows: s0 over h0 (rows [0, B) of T*B), then the rest over ys
// (rows [B, T*B)); step i reads h_prev rows 64 i of h0 (i < s0) or 64 (i -
// s0) of ys, and dxw rows 64 i or B + 64 (i - s0). Box rows past h0's B or
// ys's (T - 1) B are zero (TMA fills them), so a step that straddles B adds
// nothing for them.
__global__ void __launch_bounds__(DRW_NT, 1)
drw_sm90(const __grid_constant__ CUtensorMap th0,
         const __grid_constant__ CUtensorMap tys,
         const __grid_constant__ CUtensorMap tdx, float* __restrict__ slab,
         int H, int B, int s0, int steps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* fullb = reinterpret_cast<uint64_t*>(sm + STAGES * STAGE_BYTES);
  uint64_t* emptyb = fullb + STAGES;
  const int tid = threadIdx.x;
  const int tiles_n = (4 * H + DT - 1) / DT;
  const int nc = (blockIdx.x % tiles_n) * DT, hc = (blockIdx.x / tiles_n) * DT;
  const int z = blockIdx.y, nz = gridDim.y;
  const int i0 = (int)((long)z * steps / nz);
  const int i1 = (int)((long)(z + 1) * steps / nz);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&fullb[s], 1);
      mbar_init(&emptyb[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid >= 256) {
    // producer: one lane keeps the ring full
    if (tid == 256) {
      for (int it = 0; it < i1 - i0; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&emptyb[s], ((it / STAGES) - 1) & 1);
        unsigned char* st = sm + s * STAGE_BYTES;
        mbar_expect_tx(&fullb[s], STAGE_BYTES);
        const int i = i0 + it;
        const bool first = i < s0;
        const CUtensorMap* ta = first ? &th0 : &tys;
        const int arow = first ? DK * i : DK * (i - s0);
        const int brow = first ? DK * i : B + DK * (i - s0);
        tma_load_2d(st, ta, &fullb[s], hc, arow);
        tma_load_2d(st + BOX, ta, &fullb[s], hc + 64, arow);
        tma_load_2d(st + 2 * BOX, &tdx, &fullb[s], nc, brow);
        tma_load_2d(st + 3 * BOX, &tdx, &fullb[s], nc + 64, brow);
      }
    }
    return;
  }
  // consumer warpgroup w: output rows hc + 64 w .., all 128 columns
  const int w = tid >> 7;
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = 0.f;
  const int n_it = i1 - i0;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    mbar_wait(&fullb[s], (it / STAGES) & 1);
    const uint32_t a_s = smem_u32(sm + s * STAGE_BYTES + w * BOX);
    const uint32_t b_s = smem_u32(sm + s * STAGE_BYTES + 2 * BOX);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_mn128(acc, gmma_desc(a_s + kk * 2048, BOX, 1024, 1),
                  gmma_desc(b_s + kk * 2048, BOX, 1024, 1),
                  it % FLUSH != 0 || kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    if ((tid & 127) == 0) mbar_arrive(&emptyb[s]);
    if (it % FLUSH == FLUSH - 1 || it == n_it - 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }
  }
  // tot[4 i + 2 r + e]: row 16 warp + lane / 4 + 8 r, column 8 i + 2 (lane %
  // 4) + e of the warpgroup's 64 x 128
  const int lane = tid & 31, wq = (tid & 127) >> 5;
  float* out = slab + (long)z * H * 4 * H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = hc + 64 * w + 16 * wq + (lane >> 2) + 8 * r;
    if (h >= H) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = nc + 8 * i + 2 * (lane & 3);
      if (n < 4 * H)
        *reinterpret_cast<float2*>(out + (long)h * 4 * H + n) =
            make_float2(tot[4 * i + 2 * r], tot[4 * i + 2 * r + 1]);
    }
  }
}

int drw_tiles(int H) {
  return ((4 * H + DT - 1) / DT) * ((H + DT - 1) / DT);
}

int drw_steps(int T, int B, int* s0) {
  *s0 = (B + DK - 1) / DK;
  return *s0 + (int)(((long)(T - 1) * B + DK - 1) / DK);
}

}  // namespace

// The reverse sweep of a bf16 layer of H units (64, 128 or 256) on
// clusters of 8 CTAs: dxw, dh0, dc0 and the peephole partials dp_part
// (ceil(B / 128), 3, H) fp32, summed over dim 0 by the caller; `in` holds
// xw, rw, pi, pf, po, h0, c0, ys, cs, dys, dcs, every pointer 16-byte
// aligned and contiguous. Returns a cudaError_t code (0 on success),
// allocates nothing and does not synchronize.
extern "C" int dl4j_lstm_scan_bwd_cluster(
    const void* xw, const void* rw, const void* pi, const void* pf,
    const void* po, const void* h0, const void* c0, const void* ys,
    const void* cs, const void* dys, const void* dcs, void* dxw, void* dh0,
    void* dc0, void* dp_part, int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* in[11] = {xw, rw, pi, pf, po, h0, c0, ys, cs, dys, dcs};
  float* dp = static_cast<float*>(dp_part);
  if (H == 64) return launch_sweep<64>(in, dxw, dh0, dc0, dp, T, B, st);
  if (H == 128) return launch_sweep<128>(in, dxw, dh0, dc0, dp, T, B, st);
  if (H == 256) return launch_sweep<256>(in, dxw, dh0, dc0, dp, T, B, st);
  return (int)cudaErrorInvalidValue;
}

// Clusters of the sweep at H that the card holds at once, or minus a
// cudaError_t code.
extern "C" int dl4j_lstm_scan_bwd_clusters(int H) {
  if (H == 64) return max_clusters<64>();
  if (H == 128) return max_clusters<128>();
  if (H == 256) return max_clusters<256>();
  return -(int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA of the sweep at H (0 for another H).
extern "C" int dl4j_lstm_scan_bwd_cluster_smem(int H) {
  if (H == 64) return Cfg<64>::SMEM;
  if (H == 128) return Cfg<128>::SMEM;
  if (H == 256) return Cfg<256>::SMEM;
  return 0;
}

// Row chunks of the dRW kernel at this shape on this card: one CTA per
// (output tile, chunk) in one wave of the SMs. The slab holds (chunks, H,
// 4H) fp32.
extern "C" int dl4j_lstm_drw_chunks(int T, int B, int H) {
  if (T <= 0 || B <= 0 || H <= 0) return 1;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  int s0;
  const int steps = drw_steps(T, B, &s0);
  int z = sms / drw_tiles(H);
  if (z > steps) z = steps;
  return z < 1 ? 1 : z;
}

// dRW of a bf16 layer (H a multiple of 8): slab[z] = the sum over chunk z
// of the rows of h_prev^T dxw, fp32, for z < chunks; h0 (B, H), ys (T, B,
// H), dxw (T, B, 4H), 16-byte aligned and contiguous. Returns a cudaError_t
// code (or a tensor-map error), allocates nothing, does not synchronize.
extern "C" int dl4j_lstm_drw_sm90(const void* h0, const void* ys,
                                  const void* dxw, void* slab, int T, int B,
                                  int H, int chunks, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (H <= 0 || H % 8 != 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  int s0;
  const int steps = drw_steps(T, B, &s0);
  if (chunks > steps) return (int)cudaErrorInvalidValue;
  CUtensorMap th0, tys, tdx;
  const cuuint32_t box[2] = {64, DK};
  {
    const cuuint64_t dims[2] = {(cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[1] = {(cuuint64_t)H * 2};
    if (int err = make_map_bf16(&th0, h0, 2, dims, strides, box, 128))
      return err;
  }
  // T = 1: no ys rows (the map is never read)
  {
    const cuuint64_t dims[2] = {(cuuint64_t)H,
                                (cuuint64_t)(T > 1 ? (long)(T - 1) * B : 1)};
    const cuuint64_t strides[1] = {(cuuint64_t)H * 2};
    if (int err = make_map_bf16(&tys, T > 1 ? ys : h0, 2, dims, strides, box,
                                128))
      return err;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)4 * H, (cuuint64_t)T * B};
    const cuuint64_t strides[1] = {(cuuint64_t)H * 8};
    if (int err = make_map_bf16(&tdx, dxw, 2, dims, strides, box, 128))
      return err;
  }
  cudaError_t e = cudaFuncSetAttribute(
      drw_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, DRW_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(drw_tiles(H), chunks);
  drw_sm90<<<grid, DRW_NT, DRW_SMEM, static_cast<cudaStream_t>(stream)>>>(
      th0, tys, tdx, static_cast<float*>(slab), H, B, s0, steps);
  return (int)cudaGetLastError();
}

extern "C" const char* dl4j_lstm_scan_bwd_error_string(int code) {
  if (code == kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from libcuda";
  if (code == kBadMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
