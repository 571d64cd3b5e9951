// K7's forward, the whole-sequence Graves-LSTM scan, in bf16 on a thread-
// block cluster of Hopper (sm_90a) that keeps RW on chip.
//
// Replaces the forward of `graves_lstm_scan_pallas`
// (deeplearning4j_tpu/ops/lstm_scan_fused.py:379, `_make_fwd_kernel` :219,
// call :411) for bf16 storage at H 64, 128 and 256; lstm_scan.cu keeps the
// other widths, fp32 and the backward. Same layout and rounding points:
// xw (T, B, 4H) with gate order [i|f|o|g], rw (H, 4H), pi/pf/po (H,), h0,
// c0 (B, H), ys, cs (T, B, H), all bf16; the gates are xw + h RW in fp32,
// the cell runs in fp32, and h and c round to bf16 every step.
//
// What bounds it on the H100, at the char-RNN layer (T 100, B 8192, H
// 256): bytes. It must move 2.52 GB (xw read, ys and cs written), 0.75 ms
// at 3.35 TB/s, against 429.5 GFLOP of recurrent products (0.43 ms at 989
// TFLOP/s); the cell's five exponentials and five reciprocals per (row,
// unit) take ~0.57 ms of the SMs' special-function units. The tile kernel
// of lstm_scan.cu, whose RW (512 KB) fits no CTA, re-read all of RW from
// L2 at every step in every CTA.
//
// The design: a cluster of C = 8 CTAs owns a tile of BT = 128 batch rows
// for the whole sequence. CTA k owns hidden units [k U, k U + U), U = H /
// 8, and keeps their RW columns of all four gates, H x 4U bf16 (64 KB at H
// 256), in shared memory from the first step to the last: RW is read once
// per CTA. The slice's columns are laid out [i | f | o | g] of the same U
// units, so an m64n(4U) accumulator gives every thread the i, f, o and g
// pre-activations of the same (row, unit) pairs (wgmma hands a thread the
// same column offsets in every 8-column group): the peephole cell runs in
// registers, and c stays in the registers of the thread that owns it, as
// the bf16-rounded value the next step reads. Two warpgroups of 64 rows
// each are independent chains that take turns at the cell (two named
// barriers), so that one's cell runs while the other's products and
// exchange do: the cell's five exponentials and reciprocals (ex2, rcp on
// the special-function unit) are the larger part of a step. A step of
// warpgroup w:
//   - wait for its h rows of this step (mbarrier, below), then wgmma of
//     those rows of h (64 x H, K-major) by the RW slice (MN-major, 128- or
//     64-byte swizzle), fp32 accumulators;
//   - meanwhile, load the xw values of the next step into registers (the
//     same (row, unit) pairs, 4 bytes a load);
//   - in its turn, the cell: the new h of its rows and units into its own
//     next-h buffer, the new c into a c tile;
//   - one thread copies that h slice, 4 KB, into the same place in each of
//     the 7 peers' buffers (a bulk copy into distributed shared memory that
//     completes on the peer's mbarrier for that buffer and warpgroup), and
//     hands the h slice and the c tile to the TMA unit as ys[t] and cs[t]
//     (boxes of 8 units x 64 rows; rows past B are not written).
// h is double buffered per warpgroup, and kept in the core-matrix layout
// without swizzle (8 x 8 blocks of 128 contiguous bytes, K-blocks 1024
// bytes apart), where one CTA's units are one contiguous 64 x U block: one
// copy per peer, and each 8-unit block is a row-major (64 x 8) box. The mbarrier of (buffer, warpgroup) expects 7 copies a
// phase and is armed by its own CTA; a peer can only write a buffer again
// after it has received this CTA's h of the step between, which this CTA
// sends only once its products on that buffer are done, so no step needs
// a cluster-wide barrier. The last step sends nothing; a cluster barrier
// at the start (every mbarrier initialized) and at the end (no copy still
// in flight toward a CTA that exits) closes the sequence.
//
// Budget per CTA at H 256: RW 64 KB + h 4 x 32 KB + c 4 x 4 KB = 208 KB of
// shared memory, 256 threads, one CTA an SM; the H100 holds 15 such
// clusters at once (`dl4j_lstm_scan_fwd_clusters`), so B 8192 (64
// clusters) runs in five waves of the whole sequence.
#include "lstm_sm90.cuh"

namespace {

using namespace lstm90;

template <int H>
struct Cfg : Slice<H> {
  using S = Slice<H>;
  static constexpr int HT_BYTES = 64 * H * 2;      // a warpgroup's h tile
  static constexpr int SLICE = 64 * S::U * 2;      // one CTA's units of it
  static constexpr int H_OFF = S::RW_BYTES;        // h[buffer][warpgroup]
  static constexpr int C_OFF = H_OFF + 4 * HT_BYTES;  // c[parity][warpgroup]
  static constexpr int BAR_OFF = C_OFF + 4 * SLICE;
  static constexpr int SMEM = BAR_OFF + 4 * 8 + 1024;
  static_assert(SMEM <= 232448, "one CTA's shared memory");
};

// byte offset of (row r, unit k) in a 64-row h tile: core matrices of 8
// rows x 8 units, 128 bytes each, 8-row groups 128 bytes apart, 8-unit
// blocks 1024 bytes apart
__device__ __forceinline__ uint32_t h_off(int r, int k) {
  return (k >> 3) * 1024 + (r >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

template <int H>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
scan_fwd_cluster(const bf16* __restrict__ xw, const bf16* __restrict__ rw,
                 const bf16* __restrict__ pi, const bf16* __restrict__ pf,
                 const bf16* __restrict__ po, const bf16* __restrict__ h0,
                 const bf16* __restrict__ c0,
                 const __grid_constant__ CUtensorMap tys,
                 const __grid_constant__ CUtensorMap tcs, int T, int B) {
  using K = Cfg<H>;
  constexpr int U = K::U, N = K::N, A8 = U / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* hbar = reinterpret_cast<uint64_t*>(sm + K::BAR_OFF);  // [2][2]
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int b0 = (blockIdx.x / CL) * BT;
  const int u0 = rank * U;                       // this CTA's first unit
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&hbar[i], 1);
    mbar_fence_init();
  }
  // the RW slice, columns permuted (lstm_sm90.cuh)
  load_rw_slice<H, false>(sm, rw, u0);
  // h0 of the cluster's rows, all H units, into buffer 0 of each warpgroup
  for (int q = tid; q < BT * (H / 8); q += NT) {
    const int r = q / (H / 8), k = 8 * (q % (H / 8)), b = b0 + r;
    const uint4 v = b < B ? *reinterpret_cast<const uint4*>(h0 + (long)b * H +
                                                            k)
                          : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(sm + K::H_OFF + (r >> 6) * K::HT_BYTES +
                              h_off(r & 63, k)) = v;
  }
  fence_async_smem();
  __syncthreads();
  cluster_sync();                  // every peer's mbarriers are initialized

  // warpgroup w: rows b0 + 64 w ..; this thread's rows rl and rl + 8 of
  // the warpgroup's 64 and its 2 A8 units uq + 2 a + e (a < A8, e < 2)
  const int w = tid >> 7, tw = tid & 127, lane = tw & 31;
  const int rl = 16 * (tw >> 5) + (lane >> 2);
  const int uq = u0 + 2 * A8 * (lane & 3);
  long row[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = b0 + 64 * w + rl + 8 * r;
    live[r] = b < B;
    row[r] = live[r] ? b : 0;
  }
  // peepholes and c of the thread's units, fp32 (c as the rounded value)
  float wi[A8][2], wf[A8][2], wo[A8][2], c[2][A8][2];
#pragma unroll
  for (int a = 0; a < A8; ++a)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = uq + 2 * a + e;
      wi[a][e] = __bfloat162float(pi[u]);
      wf[a][e] = __bfloat162float(pf[u]);
      wo[a][e] = __bfloat162float(po[u]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        c[r][a][e] = live[r] ? __bfloat162float(c0[row[r] * H + u]) : 0.f;
    }
  // xw of a step: x[r][g] holds the thread's units of gate g, word a the
  // pair (2 a, 2 a + 1); one load of 4 A8 bytes
  auto load_x = [&](uint32_t (&x)[2][4][A8], int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bf16* src = xw + ((long)t * B + row[r]) * 4 * H + uq;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (live[r])
          load_words<A8>(x[r][g], src + g * H);
        else
#pragma unroll
          for (int a = 0; a < A8; ++a) x[r][g][a] = 0u;
      }
    }
  };
  uint32_t xc[2][4][A8];
  load_x(xc, 0);

  const uint32_t rw_s = smem_u32(sm);
  const uint32_t h_s = smem_u32(sm + K::H_OFF) + w * K::HT_BYTES;
  float acc[N / 2];
  // the two warpgroups take turns at the cell (named barriers TURN + w),
  // warpgroup 0 first, so that one's cell runs while the other's products
  // and exchange do
  if (w == 1) named_arrive(TURN, 256);
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1, nb = buf ^ 1;
    if (t > 0) mbar_wait(&hbar[2 * buf + w], ((t - 1) >> 1) & 1);
    const uint32_t ha = h_s + buf * 2 * K::HT_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk)
      wgmma_tn<N>(acc, gmma_desc(ha + kk * 2048, 1024, 128, kNoSwizzle),
                  gmma_desc(rw_s + kk * 16 * K::RB, H * K::RB, 8 * K::RB,
                            swizzle_code(K::RB)),
                  kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);

    // the cell, in registers: gate g of (row r, unit uq + 2 a + e) is
    // acc[4 (g A8 + a) + 2 r + e], here with j = 4 a + 2 r + e; two passes
    // over the thread's cells (c, then o and h), so that its independent
    // cells overlap
    named_sync(TURN + w, 256);
    constexpr int NJ = 4 * A8;
    auto z = [&](int g, int j) {
      const int a = j >> 2, r = (j >> 1) & 1, e = j & 1;
      return acc[4 * (g * A8 + a) + 2 * r + e] +
             __uint_as_float((xc[r][g][a] << (e ? 0 : 16)) & 0xffff0000u);
    };
    float cn[NJ], hv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int a = j >> 2, r = (j >> 1) & 1, e = j & 1;
      const float cp = c[r][a][e];
      const float i = sigm(z(0, j) + cp * wi[a][e]);
      const float f = sigm(z(1, j) + cp * wf[a][e]);
      cn[j] = f * cp + i * tanhf(z(3, j));
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int a = j >> 2, e = j & 1;
      hv[j] = sigm(z(2, j) + cn[j] * wo[a][e]) * tanhf(cn[j]);
    }
    if (w == 0 || t + 1 < T) named_arrive(TURN + (w ^ 1), 256);
    // xw of the next step, in flight during the exchange, the wait and
    // the products
    if (t + 1 < T) load_x(xc, t + 1);
    // the new h into the next-h buffer (the CTA's slice of it, which is
    // also ys[t]), the new c into the c tile: 4 A8 bytes a row
    unsigned char* hn = sm + K::H_OFF + (2 * nb + w) * K::HT_BYTES;
    unsigned char* cb = sm + K::C_OFF + (2 * buf + w) * K::SLICE;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t hw[A8], cw[A8];
#pragma unroll
      for (int a = 0; a < A8; ++a) {
        const int j = 4 * a + 2 * r;
        cw[a] = pack_bf16(cn[j], cn[j + 1]);
        hw[a] = pack_bf16(hv[j], hv[j + 1]);
        c[r][a][0] = __uint_as_float(cw[a] << 16);
        c[r][a][1] = __uint_as_float(cw[a] & 0xffff0000u);
      }
      store_words<A8>(hn + h_off(rl + 8 * r, uq), hw);
      store_words<A8>(cb + h_off(rl + 8 * r, uq - u0), cw);
    }
    fence_async_smem();
    // the last step's stores (bulk groups of lanes 8..) have read
    if (tw >= 8 && tw < 8 + A8) bulk_wait_read<0>();
    named_sync(1 + w, 128);
    if (tw < 32) {
      // warp 0: lane p < 8 sends h of the next step to peer rank + p
      // (lane 0 arms this CTA's own mbarrier), lanes 8 + a store ys[t]
      // and cs[t] of 8 units (rows past B are not written)
      const uint32_t src = smem_u32(hn) + (u0 / 8) * 1024;
      if (t + 1 < T && tw < CL) {
        uint64_t* bar = &hbar[2 * nb + w];
        if (tw == 0) {
          mbar_expect_tx(bar, (CL - 1) * K::SLICE);
        } else {
          const uint32_t peer = (rank + tw) % CL;
          copy_to_peer(peer_addr(src, peer), src, K::SLICE,
                       peer_addr(smem_u32(bar), peer));
        }
      }
      if (tw >= 8 && tw < 8 + A8) {
        const int a = tw - 8, b = b0 + 64 * w;
        tma_store_3d(&tys, hn + (u0 / 8 + a) * 1024, u0 + 8 * a, b, t);
        tma_store_3d(&tcs, cb + a * 1024, u0 + 8 * a, b, t);
        bulk_commit();
      }
    }
  }
  if (tw >= 8 && tw < 8 + A8) bulk_wait_read<0>();
  cluster_sync();                  // no copy is still on its way here
}

template <int H>
int launch(const void* xw, const void* rw, const void* pi, const void* pf,
           const void* po, const void* h0, const void* c0, void* ys,
           void* cs, int T, int B, cudaStream_t st) {
  using K = Cfg<H>;
  auto kern = scan_fwd_cluster<H>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long ctas = (long)((B + BT - 1) / BT) * CL;
  if (ctas > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  // ys and cs as (H, B, T) maps of (8 units x 64 rows) boxes, unswizzled:
  // the core-matrix layout of the h and c tiles
  CUtensorMap tys, tcs;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)H * 2, (cuuint64_t)B * H * 2};
  const cuuint32_t box[3] = {8, 64, 1};
  if (int err = make_map_bf16(&tys, ys, 3, dims, strides, box, 0)) return err;
  if (int err = make_map_bf16(&tcs, cs, 3, dims, strides, box, 0)) return err;
  const bf16* b[7] = {
      static_cast<const bf16*>(xw), static_cast<const bf16*>(rw),
      static_cast<const bf16*>(pi), static_cast<const bf16*>(pf),
      static_cast<const bf16*>(po), static_cast<const bf16*>(h0),
      static_cast<const bf16*>(c0)};
  kern<<<(unsigned)ctas, NT, K::SMEM, st>>>(b[0], b[1], b[2], b[3], b[4],
                                            b[5], b[6], tys, tcs, T, B);
  return (int)cudaGetLastError();
}

template <int H>
int max_clusters() {
  using K = Cfg<H>;
  auto kern = scan_fwd_cluster<H>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e != cudaSuccess) return -(int)e;
  // the cluster size is the kernel's own (__cluster_dims__)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * 64);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = K::SMEM;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

// The forward scan of a bf16 layer of H units (64, 128 or 256) on
// clusters of 8 CTAs; every pointer 16-byte aligned and contiguous.
// Returns a cudaError_t code (0 on success), allocates nothing and does
// not synchronize.
extern "C" int dl4j_lstm_scan_fwd_cluster(const void* xw, const void* rw,
                                          const void* pi, const void* pf,
                                          const void* po, const void* h0,
                                          const void* c0, void* ys, void* cs,
                                          int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H == 64) return launch<64>(xw, rw, pi, pf, po, h0, c0, ys, cs, T, B, st);
  if (H == 128)
    return launch<128>(xw, rw, pi, pf, po, h0, c0, ys, cs, T, B, st);
  if (H == 256)
    return launch<256>(xw, rw, pi, pf, po, h0, c0, ys, cs, T, B, st);
  return (int)cudaErrorInvalidValue;
}

// Clusters of the kernel at H that the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t code.
extern "C" int dl4j_lstm_scan_fwd_clusters(int H) {
  if (H == 64) return max_clusters<64>();
  if (H == 128) return max_clusters<128>();
  if (H == 256) return max_clusters<256>();
  return -(int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA of the kernel at H (0 for another H).
extern "C" int dl4j_lstm_scan_fwd_cluster_smem(int H) {
  if (H == 64) return Cfg<64>::SMEM;
  if (H == 128) return Cfg<128>::SMEM;
  if (H == 256) return Cfg<256>::SMEM;
  return 0;
}

extern "C" const char* dl4j_lstm_scan_fwd_cluster_error_string(int code) {
  if (code == kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from libcuda";
  if (code == kBadMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
