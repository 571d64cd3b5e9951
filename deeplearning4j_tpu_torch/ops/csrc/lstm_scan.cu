// The whole-sequence Graves-LSTM scan for Hopper (sm_90a), forward and
// backward (K7), fp32 and bf16 storage with fp32 gate math.
//
// Replaces `graves_lstm_scan_pallas` of
// deeplearning4j_tpu/ops/lstm_scan_fused.py (:379): the forward
// `_make_fwd_kernel` (call :411) and the reverse-scan backward
// `_make_bwd_kernel` (call :492), which also sums dRW, the peephole
// gradients and dh0/dc0.
//
// Layout: xw, dxw (T, B, 4H) with gate order [i|f|o|g]; rw (H, 4H); ys, cs,
// dys, dcs (T, B, H); h0, c0, dh0, dc0 (B, H); pi/pf/po (H,). Every tensor
// has the storage dtype; the gate math runs in fp32 and h, c (and in the
// backward dh, dc and the gate gradients) round to the storage dtype at
// every step, at the places the JAX kernel rounds them. dRW and the
// peephole gradients are fp32.
//
// Forward: one CTA per tile of BT batch rows loops over all T, the TPU
// kernel's batch-major grid with the time axis as a loop inside the CTA.
// h and c of the tile stay in shared memory in the storage dtype (h double
// buffered: the step reads the old h while it writes the new one). rw does
// not fit in shared memory (512 KB in bf16 at H 256), so every step streams
// it from L2: in bf16 each warp takes 16-wide column blocks of H and, for
// every 16-deep slice of H, loads the four gate columns' rw fragments
// (wmma, straight from global memory) and applies them to all BT rows on
// the tensor cores, so each CTA reads rw once a step; in fp32 a thread
// takes one column j for 8 rows on the CUDA cores (fp32 products, no
// TF32). The four gate tiles of a column block land in a per-warp fp32
// staging area, where one lane holds the i, f, o and g of the same (row,
// column) for the peephole epilogue, which writes ys[t] and cs[t].
// BT is the largest of 64/32/16 (down to 8 in fp32) whose shared memory
// fits; at B 8192 and H 256 in bf16 that is 64, 128 CTAs for the 132 SMs.
//
// Backward: a reverse sweep per batch tile. Each step reloads h_prev from
// ys[t-1] (h0 at t = 0) into shared memory, recomputes the gates from (xw,
// h_prev, c_prev) with c_prev read from cs[t-1] (c0 at t = 0), as the JAX
// direct-prev map does, folds dcs[t] into the carried dc, writes dxw[t],
// keeps the rounded gate gradients of the tile in shared memory and forms
// dh_prev = dgates RW^T in the CTA (tensor cores for bf16). dh and dc are
// carried in the storage dtype in the dh0/dc0 outputs themselves (each
// row owned by one CTA; they hold dh0/dc0 when the sweep ends), which
// leaves the shared memory to h_prev and the gate gradients, so the tile
// is 64 rows at H 256 in bf16, 128 CTAs, one wave. Each CTA
// sums the peephole gradients of its rows in fixed order and writes one
// fp32 partial per column; the caller sums them over CTAs. In fp32, dRW =
// sum over the T*B rows of h_prev^T dgates is a second kernel in this
// source: a split-K reduction over the rows, 64 x 64 output tiles, fp32
// sums of 1024 rows at a time added into running totals, each CTA adding
// its tile into a zeroed fp32 dRW with fp32 atomics (the order of those
// additions varies from run to run). It reads the dxw the sweep wrote. In
// bf16, dRW is lstm_scan_bwd_sm90.cu's wgmma kernel (sums in a fixed
// order), which the wrapper launches after this sweep.
//
// What bounds it on the H100, at the char-RNN layer (T 100, B 8192, H 256,
// bf16): bytes. The forward moves 2.52 GB (xw read, ys and cs written),
// 0.75 ms at 3.35 TB/s, against 429.5 GFLOP of recurrent products, 0.43 ms
// at 989 TFLOP/s; the backward 5.03 GB (xw, ys, cs, dys, dcs read, dxw
// written, plus dRW's re-read of ys and dxw not counted) against 1288
// GFLOP (the gate recompute, dh and dRW products), 1.50 ms. What the design
// does about it: every step's gates, h and c stay on chip, and only the
// tensors the function must read or write cross device memory, apart from
// the dRW pass, which reads ys and dxw once more. It is far from the bound:
// rw is re-read from L2 by every CTA at every step, the loads are not
// pipelined, and wmma is not wgmma. The bf16 forward and backward sweep at
// H 64, 128 and 256 (the char-RNN's layer) run instead on clusters of 8
// CTAs that keep RW in shared memory (lstm_scan_fwd_sm90.cu,
// lstm_scan_bwd_sm90.cu); the wrapper chooses by H and dtype before the
// launch. This file keeps every other H and fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
namespace wm = nvcuda::wmma;

constexpr int NW = 8;                // warps per CTA
constexpr int NT = 32 * NW;
constexpr int R = 8;                 // fp32 path: rows per thread item
constexpr int STAGE = NW * 4 * 256;  // bf16 path: staging floats (4 tiles/warp)
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory of one CTA

typedef wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> FragA;
typedef wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> FragB;
typedef wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> FragBc;
typedef wm::fragment<wm::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
template <typename T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ float cvt<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 cvt<bf16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

// ------------------------------------------------------- the cell, fp32
// Forward: (c_new, h_new) from the pre-activations and c_prev.
__device__ __forceinline__ void cell_fwd(float gi, float gf, float go,
                                         float gg, float cp, float wi,
                                         float wf, float wo, float* cn,
                                         float* hn) {
  const float i = sigm(gi + cp * wi), f = sigm(gf + cp * wf);
  const float g = tanhf(gg);
  const float c = f * cp + i * g;
  const float o = sigm(go + c * wo);
  *cn = c;
  *hn = o * tanhf(c);
}

// Backward of one (row, column): the JAX `_scan_bwd` closed forms.
struct CellGrads {
  float dz[4];     // d(pre-activation) of i, f, o, g
  float dcprev;    // dc carried to the previous step
  float cn;        // c_new (for the dpo sum)
};

__device__ __forceinline__ CellGrads cell_bwd(float gi, float gf, float go,
                                              float gg, float cp, float wi,
                                              float wf, float wo, float dh,
                                              float dcin) {
  const float i = sigm(gi + cp * wi), f = sigm(gf + cp * wf);
  const float g = tanhf(gg);
  const float cn = f * cp + i * g;
  const float o = sigm(go + cn * wo);
  const float t = tanhf(cn);
  CellGrads r;
  r.dz[2] = dh * t * o * (1.f - o);
  const float dct = dcin + dh * o * (1.f - t * t) + r.dz[2] * wo;
  r.dz[0] = dct * g * i * (1.f - i);
  r.dz[1] = dct * cp * f * (1.f - f);
  r.dz[3] = dct * i * (1.f - g * g);
  r.dcprev = dct * f + r.dz[0] * wi + r.dz[1] * wf;
  r.cn = cn;
  return r;
}

// ------------------------------------------------------ shared memory sizes
__host__ __device__ constexpr int ld_h(int H, bool tc) { return tc ? H + 8 : H; }
__host__ __device__ constexpr int ld_g(int H, bool tc) {
  return tc ? 4 * H + 8 : 4 * H;
}

size_t fwd_smem(int bt, int H, bool tc) {
  const size_t elt = tc ? 2 : 4;
  return elt * (2 * (size_t)bt * ld_h(H, tc) + (size_t)bt * H) +
         (tc ? 4 * (size_t)STAGE : 0);
}

size_t bwd_smem(int bt, int H, bool tc) {
  const size_t elt = tc ? 2 : 4;
  const size_t owners = tc ? 2 : bt / R;   // peephole-sum owners per column
  return (tc ? 4 * (size_t)STAGE : 0) + 4 * 3 * owners * H +
         elt * ((size_t)bt * ld_h(H, tc) + (size_t)bt * ld_g(H, tc));
}

int pick_bt(int H, bool tc, bool bwd) {
  for (int bt = 64; bt >= (tc ? 16 : R); bt /= 2)
    if ((bwd ? bwd_smem(bt, H, tc) : fwd_smem(bt, H, tc)) <= SMEM_MAX)
      return bt;
  return 0;
}

// h and c of rows [b0, b0 + BT) into shared memory (zero past B).
template <typename TS>
__device__ void load_rows(TS* dst, int ldd, const TS* src, int b0, int B,
                          int H, int BT) {
  for (int e = threadIdx.x; e < BT * H; e += NT) {
    const int r = e / H, j = e - r * H, b = b0 + r;
    dst[r * ldd + j] = b < B ? src[(long)b * H + j] : cvt<TS>(0.f);
  }
}

// Zero rows [b0, min(B, b0 + BT)) of a (B, H) buffer.
template <typename TS>
__device__ void zero_rows(TS* dst, int b0, int B, int H, int BT) {
  for (int e = threadIdx.x; e < BT * H; e += NT)
    if (b0 + e / H < B) dst[(long)b0 * H + e] = cvt<TS>(0.f);
}

// The bf16 gate product of this warp's column block jb: acc[r][q] = rows
// 16r.. of h (shared, ld ldh) times the columns q*H + 16jb.. of rw, over
// all of H.
template <int RT>
__device__ __forceinline__ void gate_product_tc(FragC (&acc)[RT][4],
                                                const bf16* hs, int ldh,
                                                const bf16* rw, int H,
                                                int jb) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) wm::fill_fragment(acc[r][q], 0.f);
  const long ldr = 4L * H;
  for (int kk = 0; kk < H / 16; ++kk) {
    FragB bq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wm::load_matrix_sync(bq[q], rw + 16L * kk * ldr + q * H + 16 * jb,
                           (unsigned)ldr);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      FragA a;
      wm::load_matrix_sync(a, hs + 16 * r * ldh + 16 * kk, ldh);
#pragma unroll
      for (int q = 0; q < 4; ++q) wm::mma_sync(acc[r][q], a, bq[q], acc[r][q]);
    }
  }
}

// ------------------------------------------------------- forward, bf16
template <int RT>
__global__ void __launch_bounds__(NT, 1)
scan_fwd_tc(const bf16* __restrict__ xw, const bf16* __restrict__ rw,
            const bf16* __restrict__ pi, const bf16* __restrict__ pf,
            const bf16* __restrict__ po, const bf16* __restrict__ h0,
            const bf16* __restrict__ c0, bf16* __restrict__ ys,
            bf16* __restrict__ cs, int T, int B, int H) {
  constexpr int BT = 16 * RT;
  const int ldh = ld_h(H, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem) + warp * 4 * 256;
  bf16* hA = reinterpret_cast<bf16*>(smem + 4 * STAGE);
  bf16* hB = hA + BT * ldh;
  bf16* cS = hB + BT * ldh;                       // BT x H
  const int b0 = blockIdx.x * BT;
  load_rows(hA, ldh, h0, b0, B, H, BT);
  load_rows(cS, H, c0, b0, B, H, BT);
  __syncthreads();
  const int cc = lane & 15, half = lane >> 4;
  for (int t = 0; t < T; ++t) {
    const bf16* xt = xw + (long)t * B * 4 * H;
    for (int jb = warp; jb < H / 16; jb += NW) {
      FragC acc[RT][4];
      gate_product_tc<RT>(acc, hA, ldh, rw, H, jb);
      const int j = 16 * jb + cc;
      const float wi = ld(pi + j), wf = ld(pf + j), wo = ld(po + j);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wm::store_matrix_sync(stage + q * 256, acc[r][q], 16,
                                wm::mem_row_major);
        __syncwarp();
#pragma unroll 2
        for (int m = 0; m < 8; ++m) {
          const int rr = half + 2 * m, row = 16 * r + rr, b = b0 + row;
          float x[4] = {0.f, 0.f, 0.f, 0.f};
          if (b < B) {
            const bf16* xr = xt + (long)b * 4 * H + j;
#pragma unroll
            for (int q = 0; q < 4; ++q) x[q] = ld(xr + q * H);
          }
          const float* sg = stage + rr * 16 + cc;
          float cn, hn;
          cell_fwd(sg[0] + x[0], sg[256] + x[1], sg[512] + x[2],
                   sg[768] + x[3], ld(cS + row * H + j), wi, wf, wo, &cn,
                   &hn);
          const bf16 cr = cvt<bf16>(cn), hr = cvt<bf16>(hn);
          cS[row * H + j] = cr;
          hB[row * ldh + j] = hr;
          if (b < B) {
            const long o = ((long)t * B + b) * H + j;
            ys[o] = hr;
            cs[o] = cr;
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
    bf16* tmp = hA;
    hA = hB;
    hB = tmp;
  }
}

// ------------------------------------------------------- forward, fp32
template <int RG>
__global__ void __launch_bounds__(NT)
scan_fwd_f32(const float* __restrict__ xw, const float* __restrict__ rw,
             const float* __restrict__ pi, const float* __restrict__ pf,
             const float* __restrict__ po, const float* __restrict__ h0,
             const float* __restrict__ c0, float* __restrict__ ys,
             float* __restrict__ cs, int T, int B, int H) {
  constexpr int BT = RG * R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* hA = reinterpret_cast<float*>(smem);    // BT x H
  float* hB = hA + BT * H;
  float* cS = hB + BT * H;
  const int b0 = blockIdx.x * BT;
  load_rows(hA, H, h0, b0, B, H, BT);
  load_rows(cS, H, c0, b0, B, H, BT);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* xt = xw + (long)t * B * 4 * H;
    for (int it = threadIdx.x; it < RG * H; it += NT) {
      const int rg = it / H, j = it - rg * H;
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      const float* hr = hA + rg * R * H;
      for (int k = 0; k < H; ++k) {
        const float* wk = rw + (long)k * 4 * H + j;
        const float w0 = wk[0], w1 = wk[H], w2 = wk[2 * H], w3 = wk[3 * H];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = hr[r * H + k];
          acc[r][0] += hv * w0;
          acc[r][1] += hv * w1;
          acc[r][2] += hv * w2;
          acc[r][3] += hv * w3;
        }
      }
      const float wi = pi[j], wf = pf[j], wo = po[j];
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        const int row = rg * R + r, b = b0 + row;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (b < B) {
          const float* xr = xt + (long)b * 4 * H + j;
#pragma unroll
          for (int q = 0; q < 4; ++q) x[q] = xr[q * H];
        }
        float cn, hn;
        cell_fwd(acc[r][0] + x[0], acc[r][1] + x[1], acc[r][2] + x[2],
                 acc[r][3] + x[3], cS[row * H + j], wi, wf, wo, &cn, &hn);
        cS[row * H + j] = cn;
        hB[row * H + j] = hn;
        if (b < B) {
          const long o = ((long)t * B + b) * H + j;
          ys[o] = hn;
          cs[o] = cn;
        }
      }
    }
    __syncthreads();
    float* tmp = hA;
    hA = hB;
    hB = tmp;
  }
}

// ------------------------------------------------------ backward, bf16
template <int RT>
__global__ void __launch_bounds__(NT, 1)
scan_bwd_tc(const bf16* __restrict__ xw, const bf16* __restrict__ rw,
            const bf16* __restrict__ pi, const bf16* __restrict__ pf,
            const bf16* __restrict__ po, const bf16* __restrict__ h0,
            const bf16* __restrict__ c0, const bf16* __restrict__ ys,
            const bf16* __restrict__ cs, const bf16* __restrict__ dys,
            const bf16* __restrict__ dcs, bf16* __restrict__ dxw,
            bf16* __restrict__ dh0, bf16* __restrict__ dc0,
            float* __restrict__ dp_part, int T, int B, int H) {
  constexpr int BT = 16 * RT;
  const int ldh = ld_h(H, true), ldg = ld_g(H, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem) + warp * 4 * 256;
  float* dpS = reinterpret_cast<float*>(smem) + STAGE;   // 3 x 2 x H
  bf16* hp = reinterpret_cast<bf16*>(dpS + 6 * H);       // BT x ldh
  bf16* dG = hp + BT * ldh;                              // BT x ldg
  const int b0 = blockIdx.x * BT;
  zero_rows(dh0, b0, B, H, BT);                          // the dh carry
  zero_rows(dc0, b0, B, H, BT);                          // the dc carry
  for (int e = threadIdx.x; e < 6 * H; e += NT) dpS[e] = 0.f;
  // rows past B are never written and keep zero gate gradients
  for (int e = threadIdx.x; e < BT * ldg; e += NT) dG[e] = cvt<bf16>(0.f);
  const int cc = lane & 15, half = lane >> 4;
  const long ldr = 4L * H;
  for (int t = T - 1; t >= 0; --t) {
    const bf16* hsrc = t > 0 ? ys + (long)(t - 1) * B * H : h0;
    const bf16* csrc = t > 0 ? cs + (long)(t - 1) * B * H : c0;
    const long tb = (long)t * B;
    __syncthreads();
    load_rows(hp, ldh, hsrc, b0, B, H, BT);
    __syncthreads();
    for (int jb = warp; jb < H / 16; jb += NW) {
      FragC acc[RT][4];
      gate_product_tc<RT>(acc, hp, ldh, rw, H, jb);
      const int j = 16 * jb + cc;
      const float wi = ld(pi + j), wf = ld(pf + j), wo = ld(po + j);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wm::store_matrix_sync(stage + q * 256, acc[r][q], 16,
                                wm::mem_row_major);
        __syncwarp();
#pragma unroll 2
        for (int m = 0; m < 8; ++m) {
          const int rr = half + 2 * m, row = 16 * r + rr, b = b0 + row;
          if (b >= B) continue;      // a padded row has zero gradients
          const long e = (tb + b) * H + j;
          const bf16* xr = xw + (tb + b) * 4 * H + j;
          const float* sg = stage + rr * 16 + cc;
          const float cp = ld(csrc + (long)b * H + j);
          bf16* dcc = dc0 + (long)b * H + j;
          const CellGrads gr = cell_bwd(
              sg[0] + ld(xr), sg[256] + ld(xr + H), sg[512] + ld(xr + 2 * H),
              sg[768] + ld(xr + 3 * H), cp, wi, wf, wo,
              ld(dys + e) + ld(dh0 + (long)b * H + j), ld(dcc) + ld(dcs + e));
          bf16* dxr = dxw + (tb + b) * 4 * H + j;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bf16 v = cvt<bf16>(gr.dz[q]);
            dxr[q * H] = v;
            dG[row * ldg + q * H + j] = v;
          }
          *dcc = cvt<bf16>(gr.dcprev);
          s0 += gr.dz[0] * cp;
          s1 += gr.dz[1] * cp;
          s2 += gr.dz[2] * gr.cn;
        }
        __syncwarp();
      }
      dpS[(0 * 2 + half) * H + j] += s0;
      dpS[(1 * 2 + half) * H + j] += s1;
      dpS[(2 * 2 + half) * H + j] += s2;
    }
    __syncthreads();
    // dh_prev = dgates RW^T: rw read as the column-major (4H, H) RW^T
    for (int jb = warp; jb < H / 16; jb += NW) {
      FragC acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) wm::fill_fragment(acc[r], 0.f);
      for (int kk = 0; kk < 4 * H / 16; ++kk) {
        FragBc bt;
        wm::load_matrix_sync(bt, rw + 16L * jb * ldr + 16 * kk,
                             (unsigned)ldr);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          FragA a;
          wm::load_matrix_sync(a, dG + 16 * r * ldg + 16 * kk, ldg);
          wm::mma_sync(acc[r], a, bt, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        wm::store_matrix_sync(stage, acc[r], 16, wm::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int b = b0 + 16 * r + half + 2 * m;
          if (b < B)
            dh0[(long)b * H + 16 * jb + cc] =
                cvt<bf16>(stage[(half + 2 * m) * 16 + cc]);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * H; e += NT) {
    const int q = e / H, j = e - q * H;
    dp_part[((long)blockIdx.x * 3 + q) * H + j] =
        dpS[(q * 2) * H + j] + dpS[(q * 2 + 1) * H + j];
  }
}

// ------------------------------------------------------ backward, fp32
template <int RG>
__global__ void __launch_bounds__(NT)
scan_bwd_f32(const float* __restrict__ xw, const float* __restrict__ rw,
             const float* __restrict__ rwt, const float* __restrict__ pi,
             const float* __restrict__ pf, const float* __restrict__ po,
             const float* __restrict__ h0, const float* __restrict__ c0,
             const float* __restrict__ ys, const float* __restrict__ cs,
             const float* __restrict__ dys, const float* __restrict__ dcs,
             float* __restrict__ dxw, float* __restrict__ dh0,
             float* __restrict__ dc0, float* __restrict__ dp_part, int T,
             int B, int H) {
  constexpr int BT = RG * R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* dpS = reinterpret_cast<float*>(smem);   // 3 x RG x H
  float* hp = dpS + 3 * RG * H;                   // BT x H
  float* dG = hp + BT * H;                        // BT x 4H
  const int b0 = blockIdx.x * BT;
  zero_rows(dh0, b0, B, H, BT);                   // the dh carry
  zero_rows(dc0, b0, B, H, BT);                   // the dc carry
  for (int e = threadIdx.x; e < 3 * RG * H; e += NT) dpS[e] = 0.f;
  for (int e = threadIdx.x; e < BT * 4 * H; e += NT) dG[e] = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float* hsrc = t > 0 ? ys + (long)(t - 1) * B * H : h0;
    const float* csrc = t > 0 ? cs + (long)(t - 1) * B * H : c0;
    const long tb = (long)t * B;
    __syncthreads();
    load_rows(hp, H, hsrc, b0, B, H, BT);
    __syncthreads();
    for (int it = threadIdx.x; it < RG * H; it += NT) {
      const int rg = it / H, j = it - rg * H;
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      const float* hr = hp + rg * R * H;
      for (int k = 0; k < H; ++k) {
        const float* wk = rw + (long)k * 4 * H + j;
        const float w0 = wk[0], w1 = wk[H], w2 = wk[2 * H], w3 = wk[3 * H];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = hr[r * H + k];
          acc[r][0] += hv * w0;
          acc[r][1] += hv * w1;
          acc[r][2] += hv * w2;
          acc[r][3] += hv * w3;
        }
      }
      const float wi = pi[j], wf = pf[j], wo = po[j];
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        const int row = rg * R + r, b = b0 + row;
        if (b >= B) continue;
        const long e = (tb + b) * H + j;
        const float* xr = xw + (tb + b) * 4 * H + j;
        const float cp = csrc[(long)b * H + j];
        const CellGrads gr = cell_bwd(
            acc[r][0] + xr[0], acc[r][1] + xr[H], acc[r][2] + xr[2 * H],
            acc[r][3] + xr[3 * H], cp, wi, wf, wo,
            dys[e] + dh0[(long)b * H + j], dc0[(long)b * H + j] + dcs[e]);
        float* dxr = dxw + (tb + b) * 4 * H + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dxr[q * H] = gr.dz[q];
          dG[row * 4 * H + q * H + j] = gr.dz[q];
        }
        dc0[(long)b * H + j] = gr.dcprev;
        s0 += gr.dz[0] * cp;
        s1 += gr.dz[1] * cp;
        s2 += gr.dz[2] * gr.cn;
      }
      dpS[(0 * RG + rg) * H + j] += s0;
      dpS[(1 * RG + rg) * H + j] += s1;
      dpS[(2 * RG + rg) * H + j] += s2;
    }
    __syncthreads();
    // dh_prev = dgates RW^T, with rwt = RW^T (4H, H) row-major
    for (int it = threadIdx.x; it < RG * H; it += NT) {
      const int rg = it / H, j = it - rg * H;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const float* gr = dG + rg * R * 4 * H;
      for (int n = 0; n < 4 * H; ++n) {
        const float w = rwt[(long)n * H + j];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += gr[r * 4 * H + n] * w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (b0 + rg * R + r < B) dh0[(long)(b0 + rg * R + r) * H + j] = acc[r];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * H; e += NT) {
    const int q = e / H, j = e - q * H;
    float s = 0.f;
    for (int g = 0; g < RG; ++g) s += dpS[(q * RG + g) * H + j];
    dp_part[((long)blockIdx.x * 3 + q) * H + j] = s;
  }
}

// ------------------------------------------------------------------ dRW
// fp32 dRW (H, 4H) += h_prev^T dgates over rows [z * chunk, (z + 1) *
// chunk) of the T*B rows: row m's h_prev is h0[m] for m < B, else ys[m -
// B]; its dgates are dxw[m]. One CTA per output tile of dRW and row chunk z; DK
// rows at a time through shared memory. fp32 sums that run over ~10^5 rows
// lose digits, so the CTA sums INNER rows at a time into a fresh
// accumulator and adds each such partial into a running total; the totals
// of the chunks meet in dRW through fp32 atomics.
constexpr int DK = 32;       // rows per shared-memory step
constexpr int INNER = 1024;  // rows per partial sum

template <typename TS>
__device__ __forceinline__ const TS* hprev_at(const TS* h0, const TS* ys,
                                              long m, int B, int H,
                                              int col) {
  return m < B ? h0 + m * H + col : ys + (m - B) * H + col;
}

// fp32: 64 x 64 tiles on the CUDA cores, a 4 x 4 micro-tile a thread, the
// running total in registers.
constexpr int DT = 64;

__global__ void __launch_bounds__(NT)
drw_f32(const float* __restrict__ h0, const float* __restrict__ ys,
        const float* __restrict__ dxw, float* __restrict__ drw, int T, int B,
        int H, long chunk) {
  __shared__ float As[DK * DT];
  __shared__ float Bs[DK * DT];
  const int nc = blockIdx.x * DT, hc = blockIdx.y * DT;
  const long M = (long)T * B, m_lo = blockIdx.z * chunk;
  const long m_hi = m_lo + chunk < M ? m_lo + chunk : M;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {}, tot[4][4] = {};
  int n_in = 0;
  for (long m = m_lo; m < m_hi; m += DK) {
    __syncthreads();
    for (int e = threadIdx.x; e < DK * DT; e += NT) {
      const int r = e / DT, col = e - r * DT;
      const long mm = m + r;
      As[e] = mm < m_hi && hc + col < H
                  ? *hprev_at(h0, ys, mm, B, H, hc + col) : 0.f;
      Bs[e] = mm < m_hi && nc + col < 4 * H ? dxw[mm * 4 * H + nc + col]
                                            : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k * DT + ty + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = Bs[k * DT + tx + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] += a[i] * b[jj];
    }
    if (++n_in == INNER / DK) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          tot[i][jj] += acc[i][jj];
          acc[i][jj] = 0.f;
        }
      n_in = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int h = hc + ty + 16 * i, n = nc + tx + 16 * jj;
      if (h < H && n < 4 * H)
        atomicAdd(drw + (long)h * 4 * H + n, tot[i][jj] + acc[i][jj]);
    }
}

// ---------------------------------------------------------------- launch
template <typename K>
int prepare(K kern, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename K, typename... A>
int launch(K kern, int grid, size_t smem, cudaStream_t st, A... args) {
  int err = prepare(kern, smem);
  if (err) return err;
  kern<<<grid, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The sweep kernel for n = BT / 16 (bf16) or BT / R (fp32) row units.
template <typename TS>
int launch_fwd(const void* xw, const void* rw, const void* pi, const void* pf,
               const void* po, const void* h0, const void* c0, void* ys,
               void* cs, int T, int B, int H, cudaStream_t st) {
  constexpr bool tc = std::is_same<TS, bf16>::value;
  const int bt = pick_bt(H, tc, false);
  if (!bt) return (int)cudaErrorInvalidValue;
  const int grid = (B + bt - 1) / bt;
  const size_t smem = fwd_smem(bt, H, tc);
  const TS *x = static_cast<const TS*>(xw), *w = static_cast<const TS*>(rw);
  const TS *wi = static_cast<const TS*>(pi), *wf = static_cast<const TS*>(pf);
  const TS *wo = static_cast<const TS*>(po), *h = static_cast<const TS*>(h0);
  const TS* c = static_cast<const TS*>(c0);
  TS *y = static_cast<TS*>(ys), *cc = static_cast<TS*>(cs);
#define DL4J_FWD(KERN) \
  launch(KERN, grid, smem, st, x, w, wi, wf, wo, h, c, y, cc, T, B, H)
  if constexpr (tc) {
    switch (bt / 16) {
      case 4: return DL4J_FWD(scan_fwd_tc<4>);
      case 2: return DL4J_FWD(scan_fwd_tc<2>);
      default: return DL4J_FWD(scan_fwd_tc<1>);
    }
  } else {
    switch (bt / R) {
      case 8: return DL4J_FWD(scan_fwd_f32<8>);
      case 4: return DL4J_FWD(scan_fwd_f32<4>);
      case 2: return DL4J_FWD(scan_fwd_f32<2>);
      default: return DL4J_FWD(scan_fwd_f32<1>);
    }
  }
#undef DL4J_FWD
}

long drw_chunk(long M, int H, int tile, int* splits) {
  const long tiles =
      (long)((4 * H + tile - 1) / tile) * ((H + tile - 1) / tile);
  long s = (4 * 132 + tiles - 1) / tiles;
  const long max_s = (M + DK - 1) / DK;
  if (s > max_s) s = max_s;
  if (s < 1) s = 1;
  long chunk = (M + s - 1) / s;
  chunk = (chunk + DK - 1) / DK * DK;
  *splits = (int)((M + chunk - 1) / chunk);
  return chunk;
}

template <typename TS>
int launch_bwd(const void* xw, const void* rw, const void* rwt,
               const void* pi, const void* pf, const void* po,
               const void* h0, const void* c0, const void* ys,
               const void* cs, const void* dys, const void* dcs, void* dxw,
               void* dh0, void* dc0, float* dp_part, float* drw, int T,
               int B, int H, cudaStream_t st) {
  constexpr bool tc = std::is_same<TS, bf16>::value;
  const int bt = pick_bt(H, tc, true);
  if (!bt) return (int)cudaErrorInvalidValue;
  const int grid = (B + bt - 1) / bt;
  const size_t smem = bwd_smem(bt, H, tc);
  const TS *x = static_cast<const TS*>(xw), *w = static_cast<const TS*>(rw);
  const TS* wt = static_cast<const TS*>(rwt);
  const TS *wi = static_cast<const TS*>(pi), *wf = static_cast<const TS*>(pf);
  const TS *wo = static_cast<const TS*>(po), *h = static_cast<const TS*>(h0);
  const TS *c = static_cast<const TS*>(c0), *y = static_cast<const TS*>(ys);
  const TS *cc = static_cast<const TS*>(cs), *dy = static_cast<const TS*>(dys);
  const TS* dc = static_cast<const TS*>(dcs);
  TS *dx = static_cast<TS*>(dxw), *dh = static_cast<TS*>(dh0);
  TS* dcz = static_cast<TS*>(dc0);
  int err;
  if constexpr (tc) {
#define DL4J_BWD(N)                                                          \
  launch(scan_bwd_tc<N>, grid, smem, st, x, w, wi, wf, wo, h, c, y, cc, dy,  \
         dc, dx, dh, dcz, dp_part, T, B, H)
    switch (bt / 16) {
      case 4: err = DL4J_BWD(4); break;
      case 2: err = DL4J_BWD(2); break;
      default: err = DL4J_BWD(1);
    }
#undef DL4J_BWD
  } else {
#define DL4J_BWD(N)                                                          \
  launch(scan_bwd_f32<N>, grid, smem, st, x, w, wt, wi, wf, wo, h, c, y, cc, \
         dy, dc, dx, dh, dcz, dp_part, T, B, H)
    switch (bt / R) {
      case 8: err = DL4J_BWD(8); break;
      case 4: err = DL4J_BWD(4); break;
      case 2: err = DL4J_BWD(2); break;
      default: err = DL4J_BWD(1);
    }
#undef DL4J_BWD
  }
  if constexpr (tc) {
    return err;                 // bf16: dRW is lstm_scan_bwd_sm90.cu's
  } else {
    if (err) return err;
    int splits;
    const long chunk = drw_chunk((long)T * B, H, DT, &splits);
    dim3 g((4 * H + DT - 1) / DT, (H + DT - 1) / DT, splits);
    drw_f32<<<g, NT, 0, st>>>(h, y, dx, drw, T, B, H, chunk);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16. H must be a multiple of 16. They
// return a cudaError_t code (0 on success), allocate nothing and do not
// synchronize: the kernels launch on `stream`.

// Batch rows per CTA of the forward (bwd = 0) or the backward (bwd = 1)
// sweep at this H and dtype; 0 when not even 16 rows fit in shared memory.
// The backward's dp_part holds (ceil(B / tile), 3, H) floats.
extern "C" int dl4j_lstm_scan_tile(int H, int dtype, int bwd) {
  if (H <= 0 || H % 16 != 0 || (dtype != 0 && dtype != 2)) return 0;
  return pick_bt(H, dtype == 2, bwd != 0);
}

extern "C" int dl4j_lstm_scan_fwd(const void* xw, const void* rw,
                                  const void* pi, const void* pf,
                                  const void* po, const void* h0,
                                  const void* c0, void* ys, void* cs, int T,
                                  int B, int H, int dtype, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (H <= 0 || H % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(xw, rw, pi, pf, po, h0, c0, ys, cs, T, B, H, st);
  if (dtype == 2)
    return launch_fwd<bf16>(xw, rw, pi, pf, po, h0, c0, ys, cs, T, B, H, st);
  return (int)cudaErrorInvalidValue;
}

// The reverse sweep, then (fp32 only) dRW: `drw` (H, 4H) fp32 must be zero
// on entry; in bf16 it is not read (dRW is lstm_scan_bwd_sm90.cu's
// kernel). `rwt` is RW^T (4H, H), read by the fp32 sweep only.
extern "C" int dl4j_lstm_scan_bwd(const void* xw, const void* rw,
                                  const void* rwt, const void* pi,
                                  const void* pf, const void* po,
                                  const void* h0, const void* c0,
                                  const void* ys, const void* cs,
                                  const void* dys, const void* dcs, void* dxw,
                                  void* dh0, void* dc0, void* dp_part,
                                  void* drw, int T, int B, int H, int dtype,
                                  void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (H <= 0 || H % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dp = static_cast<float*>(dp_part);
  float* dr = static_cast<float*>(drw);
  if (dtype == 0)
    return launch_bwd<float>(xw, rw, rwt, pi, pf, po, h0, c0, ys, cs, dys,
                             dcs, dxw, dh0, dc0, dp, dr, T, B, H, st);
  if (dtype == 2)
    return launch_bwd<bf16>(xw, rw, rwt, pi, pf, po, h0, c0, ys, cs, dys,
                            dcs, dxw, dh0, dc0, dp, dr, T, B, H, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
