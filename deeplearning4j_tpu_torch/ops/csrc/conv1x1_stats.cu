// The 1x1 convolution with per-channel batch statistics for Hopper
// (sm_90a), K10: y = W x plus, in the same pass, sum(y) and sum(y * y) per
// output channel, the forward half of the fused 1x1-conv + BatchNorm of
// ResNet's bottleneck blocks.
//
// Replaces `conv1x1_stats_pallas` (deeplearning4j_tpu/ops/conv_fused.py:68;
// body `_conv1x1_stats_kernel` :45). The TPU kernel walks its grid in order
// and keeps the two sums in VMEM from one step to the next; blocks here run
// in no order, so each block writes its own partial sums and the caller adds
// the partials (a torch sum over the column tiles, in a fixed order: the
// result is the same from run to run).
//
// Layout: x (B, C_in, P) with P = H * W of NCHW after any stride, W (C_out,
// C_in), y (B, C_out, P) in x's dtype. The product runs over the N = B * P
// columns of all images (column j is image j / P, position j % P), so a
// small P (16 at ResNet50's last stage) still fills a tile. Partials (tiles,
// 2, C_out): row 0 the sum of y and row 1 the sum of y^2 over one column
// tile, taken from the fp32 accumulators before y is rounded (the JAX
// kernel's order).
//
// What bounds it on the H100: bytes at most of ResNet50's shapes. A 1x1
// convolution does 2 C_in C_out flops per column and moves 2 (C_in + C_out)
// bytes per column in bf16: with C_in = C_out = 256 that is 256 flops a
// byte, under the card's 295, and the P 784 and 196 shapes are far lower;
// the P 49 and 16 shapes with C_in, C_out >= 512 are bound by operations.
// Over one b256 training step the 36 calls move 1.97 GB (0.59 ms at 3.35
// TB/s) against 0.26 TFLOP (0.26 ms at 989 TFLOP/s).
//
// bf16 design (conv1x1_sm90): a 128-channel x 128-column output tile per
// CTA, so x is read C_out / 128 times (from L2 after the first: the CTAs of
// one column tile are neighbours in the grid). Two consumer warpgroups of
// 64 channels each run wgmma m64n128k16 with A = the W tile (K-major,
// 128-byte swizzle) and B = the x tile (MN-major: 64 rows of K, 128 columns
// as two 64-column boxes), fp32 accumulators in registers. Two producer
// warps keep a three-stage ring of (W, x) tiles of 64 K in flight, a
// "full" and an "empty" mbarrier per stage. W always comes by TMA (its row
// stride C_in * 2 bytes is 16-aligned; the wrapper pads C_in to a multiple
// of 8), and zero-fill past C_in and C_out. x comes by one of five load
// paths, chosen by the wrapper from P and the channels before the launch
// (x's rows are P * 2 bytes apart, so a TMA map, whose strides are
// 16-byte multiples, exists only for P % 8 == 0):
//   - kTmaImage (P % 8 == 0, P > 64: ResNet50's P 784): a tile is 128
//     positions of one image, two TMA boxes of the 3-D map (P, C_in, B);
//   - kTmaImages (P 16, 32 or 64: P 16): a tile is 128 / P whole images,
//     one box (P, 64, 128 / P) of the same map, rows of 2 P bytes swizzled
//     at 2 P, one image after the other (B's column blocks 64 rows
//     apart, the MN-major layout at a 32- or 64-byte swizzle);
//   - kCpAsync (P even otherwise: P 196): cp.async of G = 8, 4 or 2
//     positions (16, 8 or 4 bytes: the largest that P divides), zero-filled
//     past C_in and N, tracked by cp.async.mbarrier.arrive;
//   - kBulk (P odd, P <= 128, C_in and C_out multiples of 8: P 49): a tile
//     is 128 / P whole images; rows [k0, k0 + 64) of one image are one
//     16-byte-aligned run of x, so thread 0 keeps two stages of those runs
//     in flight by 1-D bulk copies (the TMA unit, no registers), and the
//     producer warps convert each stage into the swizzled tile in shared
//     memory; y[b, m0:m0 + 128, :] is one aligned run as well, gathered
//     from the staged tile and written 16 bytes at a time (2-byte loads
//     of x and stores of y, the path below, left P 49 far from its
//     bound);
//   - kLdSt (other odd P): pairs of 2-byte loads into registers, stored as
//     4 bytes into the swizzled tile; y by 2-byte stores.
// The epilogue takes the sums per channel from the accumulators (over the
// valid columns, reduced over the lane quad that holds a channel's row:
// each channel of the tile has one owner quad, so one partial per CTA with
// no atomics), rounds y to bf16 into shared memory (rows padded to 272
// bytes), and writes it with stores of G positions (16 bytes where P % 8
// == 0). Two CTAs fit on an SM (96-97 KB of shared memory, 96 registers a
// thread), so one's epilogue overlaps the other's loads. What is left is
// the tiles' size: each 128 x 128 x 64 step reads 32 KB for 2 MFLOP, 64
// flops a byte of L2, which holds the P 16 and 49 shapes to about a third
// of the tensor rate, and the prologue and epilogue of a CTA that the
// small-K shapes (C_in 64) cannot hide.
//
// fp32 (conv1x1_f32, unchanged since its port): 64 x 64 output tile, 4 x 4
// outputs a thread, fp32 FMAs on the CUDA cores (the product accumulates in
// fp32, where the JAX kernel uses its fp64 accumulator under x64),
// statistics summed in fp64 from the fp32 accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;
typedef __nv_bfloat16 bf16;

// --------------------------------------------------------------- bf16 path
enum LoadPath {
  kTmaImage = 0, kTmaImages = 1, kCpAsync = 2, kLdSt = 3, kBulk = 4
};

constexpr int BM = 128, BN = 128, BK = 64;    // output tile, K step
constexpr int NC = 256;                       // two consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;          // W tile, 16 KB
constexpr int BOX_BYTES = BK * 64 * 2;        // one 64-column x box, 8 KB
constexpr int B_BYTES = 2 * BOX_BYTES;        // x tile
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int LDY = 2 * BN + 16;              // y staging row, bytes
constexpr int RAW_BYTES = BK * BN * 2;        // kBulk: 128 / P images of P
constexpr int NP = 64;                        // two producer warps
constexpr int NT90 = NC + NP;

// Per path: stages of the (W, x) ring (three; two on kBulk, whose ring of
// two raw stages sits beside it), shared memory (the rings, mbarriers):
// two CTAs an SM on every path.
template <int PATH>
struct Path {
  static constexpr int STAGES = PATH == kBulk ? 2 : 3;
  static constexpr int RAWS = PATH == kBulk ? 2 : 0;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = RING + RAWS * RAW_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 2 * RAWS) * 8 + 1024;
  static_assert(BM * LDY <= RING, "y staging reuses the ring");
  static_assert(2 * (SMEM + 1024) <= 233472, "two CTAs an SM");
};

// Columns of the tile: kTmaImage takes positions [p0, p0 + BN) of image
// img, kBulk tpi = 128 / P whole images from column j0, the other paths
// flat columns [j0, j0 + BN) of the N = B * P.
struct Tile {
  int img, p0;      // kTmaImage
  int j0;           // the other paths (N < 2^31, checked at the launch)
  int lim;          // valid columns, from the first
};

template <int PATH>
__device__ __forceinline__ Tile tile_of(int nt, int P, int B, int tpi) {
  Tile t;
  if constexpr (PATH == kTmaImage) {
    t.img = nt / tpi;
    t.p0 = (nt - t.img * tpi) * BN;
    t.j0 = 0;
    t.lim = min(BN, P - t.p0);
  } else {
    const int cols = PATH == kBulk ? tpi * P : BN;
    t.img = t.p0 = 0;
    t.j0 = nt * cols;
    t.lim = min(cols, B * P - t.j0);
  }
  return t;
}

// element offset of (row 0 of) tile column c in a (B, C, P) tensor
template <int PATH>
__device__ __forceinline__ long col_offset(const Tile& t, int c, int C,
                                           int P) {
  if constexpr (PATH == kTmaImage) {
    return (long)t.img * C * P + t.p0 + c;
  } else {
    const int j = t.j0 + c, b = j / P;
    return (long)b * C * P + (j - b * P);
  }
}

// byte offset of (k row, column c) in the swizzled x tile (two boxes of 64
// columns, 128-byte rows)
__device__ __forceinline__ uint32_t x_tile_off(int k, int c) {
  return (c >> 6) * BOX_BYTES + k * 128 +
         ((((c & 63) >> 3) ^ (k & 7)) << 4) + (c & 7) * 2;
}

// The producer warps' part of stage kt: W by TMA (thread 0, with the
// stage's transaction bytes), x by the load path (not kBulk's).
template <int PATH, int G>
__device__ __forceinline__ void produce(
    const CUtensorMap& tw, const CUtensorMap& tx, const bf16* __restrict__ x,
    unsigned char* stage, uint64_t* full, int kt, int m0, const Tile& t,
    int C_in, int P, int B, int pt) {
  const int k0 = kt * BK;
  unsigned char* xs = stage + A_BYTES;
  if constexpr (PATH == kTmaImage) {
    // a second box wholly past P is not loaded: its columns are never
    // stored or summed
    const bool second = t.p0 + 64 < P;
    mbar_expect_tx(full, A_BYTES + (second ? 2 : 1) * BOX_BYTES);
    tma_load_2d(stage, &tw, full, k0, m0);
    tma_load_3d(xs, &tx, full, t.p0, k0, t.img);
    if (second) tma_load_3d(xs + BOX_BYTES, &tx, full, t.p0 + 64, k0, t.img);
  } else if constexpr (PATH == kTmaImages) {
    // one box of 128 / P images (zero past B)
    mbar_expect_tx(full, A_BYTES + B_BYTES);
    tma_load_2d(stage, &tw, full, k0, m0);
    tma_load_3d(xs, &tx, full, 0, k0, t.j0 / P);
  } else {
    if (pt == 0) {
      mbar_expect_tx(full, A_BYTES);
      tma_load_2d(stage, &tw, full, k0, m0);
    }
    const uint32_t xs32 = smem_u32(xs);
    if constexpr (PATH == kCpAsync) {
      // thread pt: columns [G c, G c + G) of rows r0 + (NP / CPR) i
      constexpr int CPR = BN / G, RS = NP / CPR;
      static_assert(NP % CPR == 0, "whole rows per pass");
      const int cc = pt % CPR, r0 = pt / CPR;
      const bool ok = cc * G < t.lim;
      const bf16* src = x + (ok ? col_offset<PATH>(t, cc * G, C_in, P) : 0);
#pragma unroll 8
      for (int r = r0; r < BK; r += RS) {
        const int k = k0 + r;
        const bool live = ok && k < C_in;
        cp_async<2 * G>(xs32 + x_tile_off(r, cc * G),
                        src + (live ? (long)k * P : 0), live ? 2 * G : 0);
      }
      cp_async_arrive(full);
    } else {
      // thread pt: the column pair [2 pt, 2 pt + 2) of every row, in
      // batches of 16 rows (32 loads in flight)
      static_assert(2 * NP == BN, "a column pair per producer thread");
      const int c = 2 * pt;
      const bool ok0 = c < t.lim, ok1 = c + 1 < t.lim;
      const bf16* s0 = x + (ok0 ? col_offset<PATH>(t, c, C_in, P) : 0);
      const bf16* s1 = x + (ok1 ? col_offset<PATH>(t, c + 1, C_in, P) : 0);
      const unsigned short* u0 = reinterpret_cast<const unsigned short*>(s0);
      const unsigned short* u1 = reinterpret_cast<const unsigned short*>(s1);
      for (int rb = 0; rb < BK; rb += 16) {
        uint32_t v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int k = k0 + rb + i;
          const unsigned short a =
              ok0 && k < C_in ? __ldg(u0 + (long)k * P) : 0;
          const unsigned short b =
              ok1 && k < C_in ? __ldg(u1 + (long)k * P) : 0;
          v[i] = (uint32_t)a | ((uint32_t)b << 16);
        }
#pragma unroll
        for (int i = 0; i < 16; ++i)
          *reinterpret_cast<uint32_t*>(xs + x_tile_off(rb + i, c)) = v[i];
      }
      fence_async_smem();
      mbar_arrive(full);
    }
  }
}

// kBulk's producer warps over the whole K loop. Thread 0 keeps two stages
// of raw image blocks in flight: for each image of the tile, rows
// [k0, k0 + 64) of x[b] are one contiguous run of 64 P elements, 16-byte
// aligned (C_in % 8 == 0), so one 1-D bulk copy each. Every
// thread then converts its column pair of each raw stage into the
// swizzled x tile (shared to shared) and the W tile comes by TMA.
__device__ __forceinline__ void produce_bulk(
    const CUtensorMap& tw, const bf16* __restrict__ x, unsigned char* sm,
    uint64_t* full, uint64_t* empty, uint64_t* raw_full, uint64_t* raw_empty,
    int m0, const Tile& t, int C_in, int P, int B, int KT, int pt) {
  constexpr int STAGES = Path<kBulk>::STAGES, RAWS = Path<kBulk>::RAWS;
  unsigned char* raw = sm + Path<kBulk>::RING;
  const int b_first = t.j0 / P;
  const int nimg = min(B - 1, (t.j0 + t.lim - 1) / P) - b_first + 1;
  auto issue = [&](int kt) {
    const int r = kt % RAWS, k0 = kt * BK;
    const uint32_t bytes = min(BK, C_in - k0) * P * 2;
    mbar_expect_tx(&raw_full[r], nimg * bytes);
    for (int i = 0; i < nimg; ++i)
      bulk_load(raw + r * RAW_BYTES + i * (BK * P * 2),
                x + ((long)(b_first + i) * C_in + k0) * P, bytes,
                &raw_full[r]);
  };
  if (pt == 0)
    for (int kt = 0; kt < min(RAWS, KT); ++kt) issue(kt);
  // this thread: the 8 columns [c8, c8 + 8) (one 16-byte chunk of a
  // swizzled row) of rows r0 + 4 i
  static_assert(NP == 4 * (BN / 8), "16 chunks a row, 4 rows a pass");
  const int c8 = 8 * (pt & 15), r0 = pt >> 4;
  int off[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = t.j0 + c8 + e, b = j / P;
    off[e] = c8 + e < t.lim ? (b - b_first) * (BK * P * 2) + (j - b * P) * 2
                            : -1;
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES, r = kt % RAWS;
    unsigned char* stage = sm + s * STAGE_BYTES;
    mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
    if (pt == 0) {
      mbar_expect_tx(&full[s], A_BYTES);
      tma_load_2d(stage, &tw, &full[s], kt * BK, m0);
    }
    mbar_wait(&raw_full[r], (kt / RAWS) & 1);
    const int rows = min(BK, C_in - kt * BK);
    const unsigned char* rb = raw + r * RAW_BYTES;
    unsigned char* xs = stage + A_BYTES;
#pragma unroll 4
    for (int k = r0; k < BK; k += 4) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (k < rows) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (off[e] >= 0)
            w[e >> 1] |= (uint32_t)*reinterpret_cast<const unsigned short*>(
                             rb + off[e] + k * P * 2)
                         << (16 * (e & 1));
      }
      *reinterpret_cast<uint4*>(xs + x_tile_off(k, c8)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    fence_async_smem();
    mbar_arrive(&full[s]);
    mbar_arrive(&raw_empty[r]);
    if (pt == 0 && kt + RAWS < KT) {
      mbar_wait(&raw_empty[r], (kt / RAWS) & 1);   // every thread converted
      issue(kt + RAWS);
    }
  }
}

// y, G positions at a time, from the tile staged in shared memory (LDY
// byte rows). A thread keeps one chunk of 8 columns (c8, fixed since NC is
// a multiple of BN / 8) over rows tid / 16 + 16 i, so the chunk's offsets
// in y are worked out once.
template <int PATH, int G>
__device__ __forceinline__ void store_y(const unsigned char* ys,
                                        bf16* __restrict__ y, const Tile& t,
                                        int m0, int C_out, int P, int tid) {
  static_assert(NC % (BN / 8) == 0, "a fixed chunk per thread");
  const int c8 = 8 * (tid % (BN / 8));
  if (c8 >= t.lim) return;
  long off[8 / G];
#pragma unroll
  for (int g = 0; g < 8; g += G)
    off[g / G] = c8 + g < t.lim ? col_offset<PATH>(t, c8 + g, C_out, P) : -1;
  const int rows = min(BM, C_out - m0);
  for (int row = tid / (BN / 8); row < rows; row += NC / (BN / 8)) {
    const unsigned char* src = ys + row * LDY + 2 * c8;
    bf16* yr = y + (long)(m0 + row) * P;
#pragma unroll
    for (int g = 0; g < 8; g += G) {
      if (off[g / G] < 0) break;
      bf16* dst = yr + off[g / G];
      if constexpr (G == 8)
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(src);
      else if constexpr (G == 4)
        *reinterpret_cast<uint2*>(dst) =
            *reinterpret_cast<const uint2*>(src + 2 * g);
      else if constexpr (G == 2)
        *reinterpret_cast<uint32_t*>(dst) =
            *reinterpret_cast<const uint32_t*>(src + 2 * g);
      else
        *reinterpret_cast<unsigned short*>(dst) =
            *reinterpret_cast<const unsigned short*>(src + 2 * g);
    }
  }
}

// G: positions per load and store (8 on the TMA paths, 1 at odd P).
template <int PATH, int G>
__global__ void __launch_bounds__(NT90, 2)
conv1x1_sm90(const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap tx,
             const bf16* __restrict__ x, bf16* __restrict__ y,
             float* __restrict__ part, int C_in, int C_out, int P, int B,
             int tpi) {
  constexpr int STAGES = Path<PATH>::STAGES, RAWS = Path<PATH>::RAWS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Path<PATH>::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* raw_full = empty + STAGES;       // kBulk only
  uint64_t* raw_empty = raw_full + RAWS;
  const int tid = threadIdx.x;
  // the CTAs of one column tile are neighbours: x is read from memory once
  // and from L2 by the other channel tiles
  const int mtiles = (C_out + BM - 1) / BM;
  const int nt = blockIdx.x / mtiles, m0 = (blockIdx.x - nt * mtiles) * BM;
  const int KT = (C_in + BK - 1) / BK;
  const Tile t = tile_of<PATH>(nt, P, B, tpi);
  if (tid == 0) {
    constexpr bool tma = PATH == kTmaImage || PATH == kTmaImages;
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], tma ? 1 : 1 + NP);
      mbar_init(&empty[s], NC);
    }
    for (int r = 0; r < RAWS; ++r) {   // kBulk only
      mbar_init(&raw_full[r], 1);
      mbar_init(&raw_empty[r], NP);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NC) {
    // the producer warps; on the TMA paths one thread issues every load
    const int pt = tid - NC;
    if constexpr (PATH == kBulk) {
      produce_bulk(tw, x, sm, full, empty, raw_full, raw_empty, m0, t, C_in,
                   P, B, KT, pt);
    } else {
      if ((PATH == kTmaImage || PATH == kTmaImages) && pt != 0) return;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        produce<PATH, G>(tw, tx, x, sm + s * STAGE_BYTES, &full[s], kt, m0,
                         t, C_in, P, B, pt);
      }
    }
    return;
  }

  // consumer warpgroup wg: channels m0 + 64 wg ..; this thread's rows r0
  // and r0 + 8 of the tile, columns 8 i + cq + {0, 1}
  const int wg = tid >> 7, tw_ = tid & 127, lane = tw_ & 31;
  const int r0 = 64 * wg + 16 * (tw_ >> 5) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t base = smem_u32(sm);
  // the x tile: rows of xrb bytes swizzled at xrb, column blocks of xrb / 2
  // 64 rows apart (two 64-column boxes; 128 / P images of P at kTmaImages)
  const uint32_t xrb = PATH == kTmaImages ? 2 * P : 128;
  const uint64_t xlayout = swizzle_code(xrb);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    if constexpr (PATH >= kCpAsync) fence_async_smem();
    const uint32_t a = base + s * STAGE_BYTES + 64 * wg * 128;
    const uint32_t b = base + s * STAGE_BYTES + A_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_tn<BN>(acc, gmma_desc(a + 32 * kk, 16, 1024, swizzle_code(128)),
                   gmma_desc(b + kk * 16 * xrb, 64 * xrb, 8 * xrb, xlayout),
                   (kt | kk) != 0);
    wg_commit();
    wg_wait<1>();
    fence_regs(acc);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wg_wait<0>();
  fence_regs(acc);

  // statistics of the valid columns, from the unrounded accumulators
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int col = 8 * (e >> 2) + cq + (e & 1);
    const float v = col < t.lim ? acc[e] : 0.f;
    s1[(e >> 1) & 1] += v;
    s2[(e >> 1) & 1] += v * v;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], 1);
    s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], 1);
    s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], 2);
    s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], 2);
    const int co = m0 + r0 + 8 * r;
    if ((lane & 3) == 0 && co < C_out) {
      part[(nt * 2L) * C_out + co] = s1[r];
      part[(nt * 2L + 1) * C_out + co] = s2[r];
    }
  }
  // y through shared memory: the ring is free once both warpgroups' last
  // products are done (every stage was consumed)
  named_sync(1, NC);
#pragma unroll
  for (int e = 0; e < 64; e += 2) {
    const int row = r0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + cq;
    *reinterpret_cast<uint32_t*>(sm + row * LDY + 2 * col) =
        pack_bf16(acc[e], acc[e + 1]);
  }
  named_sync(1, NC);
  if constexpr (PATH == kBulk) {
    // whole images: y[b, m0:m0 + 128, :] is one run of 128 P elements,
    // 16-byte aligned (C_out % 8 == 0); 8 of them gathered from the staged
    // tile (channel e / P, column i P + e % P) and written as 16 bytes
    const int nimg = t.lim / P, run = min(BM, C_out - m0) * P / 8;
    const long y0 = ((long)(t.j0 / P) * C_out + m0) * P;
    for (int q = tid; q < nimg * run; q += NC) {
      const int im = q / run, e0 = 8 * (q - im * run);
      int co = e0 / P, p = e0 - co * P;
      uint32_t w[4];
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const uint32_t v = *reinterpret_cast<const unsigned short*>(
            sm + co * LDY + 2 * (im * P + p));
        w[h >> 1] = (h & 1) ? (w[h >> 1] | (v << 16)) : v;
        if (++p == P) p = 0, ++co;
      }
      *reinterpret_cast<uint4*>(y + y0 + (long)im * C_out * P + e0) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    store_y<PATH, G>(sm, y, t, m0, C_out, P, tid);
  }
}

// --------------------------------------------------------------- fp32 path
constexpr int NT = 256;                 // threads per block
constexpr int FM = 64, FN = 64, FK = 16;
constexpr int LDF = FN + 1;             // floats
constexpr int F32_SMEM =
    FM * LDF > FK * (FM + FN) ? FM * LDF : FK * (FM + FN);
static_assert(NT % FN == 0 && NT % FK == 0,
              "the epilogue gives each of 64 rows four threads, and a "
              "thread keeps one column of each tile");

// The block's output tile, fp32 in shared memory (ld LDF), to y and to the
// block's row of fp64 partial sums. A thread stores one column; four
// threads share a row of the statistics and add their sums by shuffles.
__device__ void epilogue_f32(const float* cs, float* __restrict__ y,
                             double* __restrict__ part, int co0, long j0,
                             int C_out, int P, long N) {
  const int tid = threadIdx.x, c = tid % FN;
  const long j = j0 + c;
  float* ycol = y + (j / P) * (long)C_out * P + j % P;
  if (j < N)
    for (int r = tid / FN; r < FM; r += NT / FN)
      if (co0 + r < C_out) ycol[(long)(co0 + r) * P] = cs[r * LDF + c];
  const int r = tid >> 2, q = tid & 3;   // 64 rows x 4 threads
  double s1 = 0, s2 = 0;
  for (int cc = q; cc < FN && j0 + cc < N; cc += 4) {
    const double v = cs[r * LDF + cc];
    s1 += v;
    s2 += v * v;
  }
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
  if (q == 0 && co0 + r < C_out) {
    part[(blockIdx.x * 2L) * C_out + co0 + r] = s1;
    part[(blockIdx.x * 2L + 1) * C_out + co0 + r] = s2;
  }
}

__global__ void __launch_bounds__(NT)
conv1x1_f32(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ y, double* __restrict__ part, int C_in,
            int C_out, int P, long N) {
  __shared__ __align__(16) float smem[F32_SMEM];
  float* As = smem;                                  // FK x FM: W^T tile
  float* Bs = smem + FK * FM;                        // FK x FN: x tile
  float* Cs = smem;                                  // FM x LDF, after
  const int co0 = blockIdx.y * FM, tid = threadIdx.x;
  const long j0 = (long)blockIdx.x * FN;
  const int tx = tid & 15, ty = tid >> 4;
  // this thread's column of W (k offset ka, rows ra + 16i) and of x
  // (column cb, rows rb + 4i)
  const int ka = tid % FK, ra = tid / FK, cb = tid % FN, rb = tid / FN;
  const long jb = j0 + cb;
  const bool col_ok = jb < N;
  const float* xcol = x + (jb / P) * (long)C_in * P + jb % P;
  constexpr int NA = FM * FK / NT, NB = FK * FN / NT;
  float va[NA], vb[NB];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int co = co0 + ra + i * (NT / FK), k = k0 + ka;
      va[i] = (co < C_out && k < C_in) ? w[(long)co * C_in + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int k = k0 + rb + i * (NT / FN);
      vb[i] = (col_ok && k < C_in) ? xcol[(long)k * P] : 0.f;
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < C_in; k0 += FK) {
#pragma unroll
    for (int i = 0; i < NA; ++i) As[ka * FM + ra + i * (NT / FK)] = va[i];
#pragma unroll
    for (int i = 0; i < NB; ++i) Bs[(rb + i * (NT / FN)) * FN + cb] = vb[i];
    __syncthreads();
    if (k0 + FK < C_in) load(k0 + FK);   // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * FM + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = Bs[kk * FN + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Cs[(ty * 4 + i) * LDF + tx * 4 + j] = acc[i][j];
  __syncthreads();
  epilogue_f32(Cs, y, part, co0, j0, C_out, P, N);
}

// ----------------------------------------------------------------- launch
// Whether `path` can load x at this P, C_in and C_out (the wrapper's
// rule, checked here).
bool path_ok(int path, int P, int C_in, int C_out) {
  switch (path) {
    case kTmaImage: return P % 8 == 0 && P > 64;
    case kTmaImages: return P == 16 || P == 32 || P == 64;
    case kCpAsync: return P % 2 == 0;
    case kLdSt: return true;
    case kBulk:   // whole images a tile, x's and y's runs 16-byte aligned
      return P % 2 == 1 && P <= BN && C_in % 8 == 0 && C_out % 8 == 0;
  }
  return false;
}

// positions per cp.async and per y store on each path
int granule(int path, int P) {
  if (path == kTmaImage || path == kTmaImages || P % 8 == 0) return 8;
  if (path == kLdSt || path == kBulk) return 1;
  return P % 4 == 0 ? 4 : 2;
}

// tiles of the N columns; tiles per image (kTmaImage) or images per tile
// (kBulk)
long column_tiles(int path, int B, int P) {
  if (path == kTmaImage) return (long)B * ((P + BN - 1) / BN);
  if (path == kBulk) return (B + BN / P - 1) / (BN / P);
  return ((long)B * P + BN - 1) / BN;
}
int tile_arg(int path, int P) {
  return path == kBulk ? BN / P : (P + BN - 1) / BN;
}

template <int PATH, int G>
int launch_sm90(const CUtensorMap& mw, const CUtensorMap& mx, const bf16* x,
                bf16* y, float* part, int B, int C_in, int C_out, int P,
                cudaStream_t st) {
  auto kern = conv1x1_sm90<PATH, G>;
  constexpr int smem = Path<PATH>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long ctas = (long)((C_out + BM - 1) / BM) * column_tiles(PATH, B, P);
  if (ctas > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)ctas, NT90, smem, st>>>(
      mw, mx, x, y, part, C_in, C_out, P, B, tile_arg(PATH, P));
  return (int)cudaGetLastError();
}

// w (C_out, ldw) with ldw = C_in rounded up to 8 (the wrapper pads it).
int launch_bf16(const void* x, const void* w, void* y, float* part, int B,
                int C_in, int ldw, int C_out, int P, int path,
                cudaStream_t st) {
  if (!path_ok(path, P, C_in, C_out) || ldw % 8 != 0 || ldw < C_in ||
      (long)B * P > 0x7fffffffL - BN)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mw, mx;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)ldw, (cuuint64_t)C_out};
    const cuuint64_t strides[1] = {(cuuint64_t)ldw * 2};
    const cuuint32_t box[2] = {BK, BM};
    if (int err = make_map_bf16(&mw, w, 2, dims, strides, box, 128))
      return err;
  }
  mx = mw;                          // unused on the cp.async / ld-st paths
  if (path == kTmaImage) {
    const cuuint64_t dims[3] = {(cuuint64_t)P, (cuuint64_t)C_in,
                                (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)P * 2,
                                   (cuuint64_t)C_in * P * 2};
    const cuuint32_t box[3] = {64, BK, 1};
    if (int err = make_map_bf16(&mx, x, 3, dims, strides, box, 128))
      return err;
  } else if (path == kTmaImages) {
    const cuuint64_t dims[3] = {(cuuint64_t)P, (cuuint64_t)C_in,
                                (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)P * 2,
                                   (cuuint64_t)C_in * P * 2};
    const cuuint32_t box[3] = {(cuuint32_t)P, BK, (cuuint32_t)(BN / P)};
    if (int err = make_map_bf16(&mx, x, 3, dims, strides, box, 2 * P))
      return err;
  }
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
#define DL4J_K10(PATH, G) \
  launch_sm90<PATH, G>(mw, mx, xb, yb, part, B, C_in, C_out, P, st)
  switch (path) {
    case kTmaImage: return DL4J_K10(kTmaImage, 8);
    case kTmaImages: return DL4J_K10(kTmaImages, 8);
    case kLdSt: return DL4J_K10(kLdSt, 1);
    case kBulk: return DL4J_K10(kBulk, 1);
  }
  switch (granule(path, P)) {
    case 8: return DL4J_K10(kCpAsync, 8);
    case 4: return DL4J_K10(kCpAsync, 4);
    default: return DL4J_K10(kCpAsync, 2);
  }
#undef DL4J_K10
}

}  // namespace

// Column tiles of one call (the rows of its partials) for a dtype code (0
// float32, 2 bfloat16) and, in bf16, a load path; 0 for a dtype without a
// kernel or a path that cannot load this P. The partials hold (tiles, 2,
// C_out) sums, fp64 for float32 inputs and fp32 for bfloat16.
extern "C" long dl4j_conv1x1_tiles(int B, int P, int C_in, int C_out,
                                   int dtype, int path) {
  if (B <= 0 || P <= 0) return 0;
  if (dtype == 0) return ((long)B * P + FN - 1) / FN;
  if (dtype == 2 && path_ok(path, P, C_in, C_out))
    return column_tiles(path, B, P);
  return 0;
}

// y = W x and the block partials of sum(y), sum(y^2). w is (C_out, ldw):
// ldw = C_in in float32, C_in rounded up to 8 (zero columns past C_in) in
// bfloat16. Returns a cudaError_t code, or kNoEncoder / kBadMap (0 on
// success); allocates nothing, does not synchronize.
extern "C" int dl4j_conv1x1_stats(const void* x, const void* w, void* y,
                                  void* part, int B, int C_in, int ldw,
                                  int C_out, int P, int dtype, int path,
                                  void* stream) {
  if (B <= 0 || P <= 0 || C_out <= 0) return 0;
  if (C_in <= 0) return (int)cudaErrorInvalidValue;
  const long N = (long)B * P;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2)
    return launch_bf16(x, w, y, static_cast<float*>(part), B, C_in, ldw,
                       C_out, P, path, st);
  if (dtype != 0 || ldw != C_in) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + FN - 1) / FN), (C_out + FM - 1) / FM);
  conv1x1_f32<<<grid, NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), static_cast<double*>(part), C_in, C_out, P, N);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the bf16 kernel's CTA on a load path (the fp32
// kernel's is static); 0 for a dtype without a kernel.
extern "C" int dl4j_conv1x1_smem(int dtype, int path) {
  if (dtype != 2) return 0;
  switch (path) {
    case kTmaImage: return Path<kTmaImage>::SMEM;
    case kTmaImages: return Path<kTmaImages>::SMEM;
    case kCpAsync: return Path<kCpAsync>::SMEM;
    case kLdSt: return Path<kLdSt>::SMEM;
    case kBulk: return Path<kBulk>::SMEM;
  }
  return 0;
}

extern "C" const char* dl4j_conv1x1_error_string(int code) {
  if (code == kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from libcuda";
  if (code == kBadMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
