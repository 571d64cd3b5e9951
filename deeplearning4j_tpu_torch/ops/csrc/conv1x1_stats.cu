// The 1x1 convolution with per-channel batch statistics for Hopper
// (sm_90a), K10: y = W x plus, in the same pass, sum(y) and sum(y * y) per
// output channel, the forward half of the fused 1x1-conv + BatchNorm of
// ResNet's bottleneck blocks.
//
// Replaces `conv1x1_stats_pallas` (deeplearning4j_tpu/ops/conv_fused.py:68;
// body `_conv1x1_stats_kernel` :45). The TPU kernel walks its grid in order
// and keeps the two sums in VMEM from one step to the next; blocks here run
// in no order, so each block writes its own partial sums and the caller adds
// the partials (a torch sum over a few thousand rows).
//
// Layout: x (B, C_in, P) with P = H * W of NCHW after any stride, W (C_out,
// C_in), y (B, C_out, P) in x's dtype. The product runs over the N = B * P
// columns of all images at once (column j is image j / P, position j % P),
// so a small P (16 at ResNet50's last stage) still fills a tile. Partials
// (tiles, 2, C_out) with tiles = ceil(N / p_tile): row 0 the sum of y and
// row 1 the sum of y^2 over one block's columns.
//
// Work split: one block per (tile of p_tile columns, tile of 64 output
// channels); it loops over C_in, staging a tile of W and a tile of x in
// shared memory, zero-filled past C_in, C_out and N, so columns past N
// add nothing and are never stored. Each thread loads the same column of
// x (and of W) at every K step, so its column offsets are computed once;
// the next K step's tiles are loaded into registers while the tensor
// cores work on the current one.
//   - bf16: 64 x 128 output tile, 8 warps of 32 x 32, the products on the
//     tensor cores (wmma 16x16x16, bf16 in, fp32 accumulators), K steps of
//     32; the statistics are summed in fp32 from the unrounded
//     accumulators, then y rounds to bf16 (the JAX kernel's order).
//   - fp32: 64 x 64 output tile, 4 x 4 outputs a thread, fp32 FMAs on the
//     CUDA cores (the product accumulates in fp32, where the JAX kernel
//     uses its fp64 accumulator under x64), statistics summed in fp64 from
//     the fp32 accumulators.
//
// What bounds it on the H100: bytes. At ResNet50's widths (C_in, C_out 64
// to 2048) a 1x1 convolution does 2 C_in C_out flops per column and moves
// 2 (C_in + C_out) bytes per column in bf16: with C_in = C_out = 256 that
// is 256 flops a byte, under the card's 295 bf16 flops per byte, and most
// pairs are lower. The design reads x and W once per block from memory
// (W tiles are shared through L2 by the blocks of one channel tile) and
// writes y once; the statistics cost no extra pass over y. This first
// version loads tiles with 2-byte loads and has no cp.async, TMA or wgmma
// yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;                 // threads per block

// bf16: 64 x 128 tile, K step 32, padded shared rows
constexpr int TM = 64, TN = 128, TK = 32;
constexpr int LDA = TK + 8;             // bf16 elements
constexpr int LDB = TN + 8;             // bf16 elements
constexpr int LDC = TN + 4;             // floats
constexpr int BF16_SMEM =
    TM * LDC * 4 > (TM * LDA + TK * LDB) * 2 ? TM * LDC * 4
                                              : (TM * LDA + TK * LDB) * 2;

// fp32: 64 x 64 tile, K step 16, 4 x 4 outputs a thread
constexpr int FM = 64, FN = 64, FK = 16;
constexpr int LDF = FN + 1;             // floats
constexpr int F32_SMEM =
    FM * LDF > FK * (FM + FN) ? FM * LDF : FK * (FM + FN);
static_assert(TM == 64 && FM == 64 && NT == 256 && NT % TN == 0 &&
                  NT % FN == 0 && NT % TK == 0 && NT % FK == 0,
              "the epilogue gives each of 64 rows four threads, and a "
              "thread keeps one column of each tile");

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// The block's output tile, fp32 in shared memory (ld ldc, TILE_N columns),
// to y (rounded to TY) and to the block's row of partial sums in TS. A
// thread stores one column (TILE_N divides NT); four threads share a row of
// the statistics and add their sums by shuffles.
template <typename TY, typename TS, int TILE_N>
__device__ void epilogue(const float* cs, int ldc, TY* __restrict__ y,
                         TS* __restrict__ part, int co0, long j0, int C_out,
                         int P, long N) {
  const int tid = threadIdx.x, c = tid % TILE_N;
  const long j = j0 + c;
  TY* ycol = y + (j / P) * (long)C_out * P + j % P;
  if (j < N)
    for (int r = tid / TILE_N; r < TM; r += NT / TILE_N)
      if (co0 + r < C_out) st(ycol + (long)(co0 + r) * P, cs[r * ldc + c]);
  const int r = tid >> 2, q = tid & 3;   // 64 rows x 4 threads
  TS s1 = 0, s2 = 0;
  for (int cc = q; cc < TILE_N && j0 + cc < N; cc += 4) {
    const TS v = static_cast<TS>(cs[r * ldc + cc]);
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
conv1x1_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             bf16* __restrict__ y, float* __restrict__ part, int C_in,
             int C_out, int P, long N) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[BF16_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);          // TM x LDA: W tile
  bf16* Bs = As + TM * LDA;                          // TK x LDB: x tile
  float* Cs = reinterpret_cast<float*>(smem);        // TM x LDC, after
  const int co0 = blockIdx.y * TM, tid = threadIdx.x, warp = tid >> 5;
  const long j0 = (long)blockIdx.x * TN;
  const int wm = warp >> 2, wn = warp & 3;           // 2 x 4 warps
  const bf16 zero = __float2bfloat16(0.f);
  // this thread's column of W (k offset ka, rows ra + 8i) and of x
  // (column cb, rows rb + 2i)
  const int ka = tid % TK, ra = tid / TK, cb = tid % TN, rb = tid / TN;
  const long jb = j0 + cb;
  const bool col_ok = jb < N;
  const bf16* xcol = x + (jb / P) * (long)C_in * P + jb % P;
  constexpr int NA = TM * TK / NT, NB = TK * TN / NT;
  bf16 va[NA], vb[NB];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int co = co0 + ra + i * (NT / TK), k = k0 + ka;
      va[i] = (co < C_out && k < C_in) ? w[(long)co * C_in + k] : zero;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int k = k0 + rb + i * (NT / TN);
      vb[i] = (col_ok && k < C_in) ? xcol[(long)k * P] : zero;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int k0 = 0; k0 < C_in; k0 += TK) {
#pragma unroll
    for (int i = 0; i < NA; ++i) As[(ra + i * (NT / TK)) * LDA + ka] = va[i];
#pragma unroll
    for (int i = 0; i < NB; ++i) Bs[(rb + i * (NT / TN)) * LDB + cb] = vb[i];
    __syncthreads();
    if (k0 + TK < C_in) load(k0 + TK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  epilogue<bf16, float, TN>(Cs, LDC, y, part, co0, j0, C_out, P, N);
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
  epilogue<float, double, FN>(Cs, LDF, y, part, co0, j0, C_out, P, N);
}

}  // namespace

// Columns of N = B * P per block for a dtype code (0 float32, 2 bfloat16);
// the partials hold (ceil(N / p_tile), 2, C_out) sums, fp64 for float32
// inputs and fp32 for bfloat16. 0 for a dtype without a kernel.
extern "C" int dl4j_conv1x1_p_tile(int dtype) {
  return dtype == 0 ? FN : dtype == 2 ? TN : 0;
}

// y = W x and the block partials of sum(y), sum(y^2). Returns a
// cudaError_t code (0 on success); allocates nothing, does not synchronize.
extern "C" int dl4j_conv1x1_stats(const void* x, const void* w, void* y,
                                  void* part, int B, int C_in, int C_out,
                                  int P, int dtype, void* stream) {
  if (B <= 0 || P <= 0 || C_out <= 0) return 0;
  if (C_in <= 0) return (int)cudaErrorInvalidValue;
  const long N = (long)B * P;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    const dim3 grid((unsigned)((N + TN - 1) / TN), (C_out + TM - 1) / TM);
    conv1x1_bf16<<<grid, NT, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), static_cast<float*>(part), C_in, C_out, P, N);
  } else if (dtype == 0) {
    const dim3 grid((unsigned)((N + FN - 1) / FN), (C_out + FM - 1) / FM);
    conv1x1_f32<<<grid, NT, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), static_cast<double*>(part), C_in, C_out, P,
        N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dl4j_conv1x1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
