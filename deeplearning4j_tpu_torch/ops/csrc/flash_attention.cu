// Flash attention for Hopper (sm_90a) in fp32: the forward (K3), the fused
// backward (K4) and the two-pass backward (K5), on the CUDA cores (wmma
// and wgmma have no fp32 product short of TF32, whose ~3 decimal digits
// would miss the fp32 tolerance). Every bf16 kernel is
// flash_attention_sm90.cu's (wgmma, TMA).
//
// Replaces the Pallas kernels of deeplearning4j_tpu/ops/flash_attention.py:
//   - K3 `_call_fwd` (:448, body `_fwd_kernel` :123): online-softmax
//     forward, o and the row log-sum-exp L;
//   - K4 `_fused_bwd_kernel` (:349, bwd="fused"): one pass per key tile
//     giving dk, dv and dq;
//   - K5 `_dq_kernel` (:262) and `_dkv_kernel` (:301), bwd="two_pass".
// Layout: q (B*H, T, D), k/v (B*Hk, T, D) row-major; L and D_i (B*H, T)
// fp32; key mask (B, T) int32 or null. Query head h reads kv row
// b*Hk + h / (H/Hk) (GQA, forward only; the backward gets Hk == H).
//
// The TPU kernels walk a sequential grid with the accumulators in VMEM
// scratch carried across grid steps. Here a loop inside the CTA takes the
// place of the sequential axis, and nothing carries between CTAs:
//   - K3: one CTA per (64-row q tile, b*h); the loop runs over the 64-row
//     key tiles that causal/window leave visible (fully invalid tiles are
//     never visited, the counterpart of `_dispatch_tile` :201).
//   - K4: one CTA per (64-row key tile, b*h), looping over the q tiles
//     that can see it; dk/dv accumulate in the CTA. dq cannot (it sums
//     over key tiles, i.e. over CTAs), so each tile adds scale * dS K into
//     a zeroed fp32 (B*H, T, D) buffer with fp32 atomicAdd. This replaces
//     the JAX package's per-key-block dq partials; the order of the
//     additions varies from run to run, so dq is not deterministic in its
//     last bits.
//   - K5: the dq kernel is one CTA per q tile looping over key tiles, dq
//     accumulated in the CTA and written once (deterministic); the dk/dv
//     kernel is K4's kernel with the dq atomics compiled out (one
//     template, WITH_DQ = false).
// Every tile is recomputed from q, k and L: p = exp(scale q.k - L), masked
// before the exp (a row with L = NEG_INF has no visible key, and its p is
// 0 by the mask, never exp of an unmasked NEG_INF). Validity (keys past T,
// causal, window, key mask, and in the backward queries past T) is
// evaluated on edge tiles and under a key mask only; interior tiles skip
// it. Rows with no visible key give o = 0 and L = NEG_INF (:161-169).
//
// fp32 accuracy: the forward computes each score exactly as the backward
// recomputes it (dot, then times scale), and every long sum (o over key
// tiles, dk/dv over q tiles, dq over key tiles) adds one tile's partial
// sum at a time. On the training stack in fp32 this brings the gradients
// of the second layer's w_q/w_k, which are four orders of magnitude below
// the others, from 1.3e-4 to 2.8e-5 of a float64 reference (chip_smoke.py
// train_oracle).
//
// 256 threads as 16 x 16; a thread holds a 4 x 4 micro-tile of each 64 x
// 64 score tile (rows ty + 16 i, columns tx + 16 j) and a 4 x D/16
// micro-tile of each (64, D) accumulator. K and V tiles are staged
// transposed with a padded stride (65) and q-side tiles with stride D + 1,
// so the shared-memory reads of the inner loops are free of bank
// conflicts. At D = 128 a backward CTA needs ~166 KB of dynamic shared
// memory (above 48 KB it takes cudaFuncSetAttribute). At D 192 and 256
// the tiles are 32 x 32 (a 2 x 2 micro-tile a thread; ~109 and ~142 KB);
// these instances also run bf16 inputs of those head dims, which the
// wrapper widens to fp32 (the wgmma kernels stop at D 128). At D 384 and
// 512 the tiles are 16 x 16 (one score a thread), widened the same way.
//
// What bounds it on the H100, at the training shape in fp32 (B*H = 16, T
// = 8192, D = 64, causal, 33,558,528 visible pairs per head): operations,
// 5 products for K4 (343.6 GFLOP, 5.1 ms at 67 TFLOP/s of fp32 CUDA
// cores), while its q/k/v/dO/dq/dk/dv/L/D_i take 0.07 ms at 3.35 TB/s.
// What the design does about it: every score tile stays out of device
// memory, invisible tiles are skipped, and the inner loops read shared
// memory without bank conflicts.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int NT = 256;       // threads per CTA: 16 x 16

// Tiles at head dim D: 64 query rows by 64 keys up to D 128, 32 by 32 at D
// 192 and 256, where a 64-row backward CTA would need ~298 KB of shared
// memory (32 rows: ~142 KB), and 16 by 16 at D 384 and 512 (~104 KB for
// the forward, ~138 KB for the backward at D 512). A thread holds RA rows
// and RA key columns of a score tile (rows ty + 16 a, columns tx + 16 c).
template <int D>
struct Tile {
  static constexpr int RA = D > 256 ? 1 : D > 128 ? 2 : 4;
  static constexpr int BM = 16 * RA;   // query rows per tile
  static constexpr int BN = 16 * RA;   // key rows per tile
  static constexpr int KP = BN + 1;    // padded stride of transposed K/V
};


// max / sum over the 16 lanes (tx = 0..15) that share a score row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage a (BN, D) key-side tile transposed: dst[d * KP + c]; rows past T
// are zero.
template <int D>
__device__ __forceinline__ void stage_kv_t(float* dst, const float* src,
                                           int k_lo, int T) {
  constexpr int BN = Tile<D>::BN, KP = Tile<D>::KP;
  for (int e = threadIdx.x; e < BN * D; e += NT) {
    const int c = e / D, d = e - c * D, kj = k_lo + c;
    dst[d * KP + c] = kj < T ? src[(long)kj * D + d] : 0.f;
  }
}

// Stage a (BM, D) query-side tile row-major with stride D + 1; rows past T
// are zero.
template <int D>
__device__ __forceinline__ void stage_q(float* dst, const float* src, int q_lo,
                                        int T) {
  constexpr int BM = Tile<D>::BM;
  for (int e = threadIdx.x; e < BM * D; e += NT) {
    const int r = e / D, d = e - r * D, qi = q_lo + r;
    dst[r * (D + 1) + d] = qi < T ? src[(long)qi * D + d] : 0.f;
  }
}

template <int BN>
__device__ __forceinline__ void stage_key_ok(int* kms, const int* km, int b,
                                             int k_lo, int T) {
  for (int c = threadIdx.x; c < BN; c += blockDim.x) {
    const int kj = k_lo + c;
    kms[c] = kj < T && (km == nullptr || km[(long)b * T + kj] != 0);
  }
}

// ------------------------------------------------------------------ K3
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ km,
                 float* __restrict__ o, float* __restrict__ lse, int H, int Hk,
                 Geometry g, float scale) {
  constexpr int DC = D / 16;
  constexpr int RA = Tile<D>::RA, BM = Tile<D>::BM, BN = Tile<D>::BN;
  constexpr int KP = Tile<D>::KP;
  const int nq = gridDim.x;
  const int i = nq - 1 - blockIdx.x;     // the longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int kvrow = b * Hk + h / (H / Hk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int T = g.T, q_lo = i * BM;

  extern __shared__ float smem[];
  float* Qs = smem;                     // BM x (D+1)
  float* Kt = Qs + BM * (D + 1);        // D x KP
  float* Vt = Kt + D * KP;              // D x KP
  float* Ps = Vt + D * KP;              // BM x KP
  int* kms = reinterpret_cast<int*>(Ps + BM * KP);   // BN

  const float* qb = q + (long)bh * T * D;
  const float* kb = k + (long)kvrow * T * D;
  const float* vb = v + (long)kvrow * T * D;
  stage_q<D>(Qs, qb, q_lo, T);

  float acc[RA][DC], m[RA], l[RA], alpha[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    m[a] = DL4J_NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }
  int j0, j1;
  key_tiles<BM, BN>(g, q_lo, &j0, &j1);
  for (int j = j0; j < j1; ++j) {
    const int k_lo = j * BN;
    __syncthreads();                    // the last tile's readers are done
    stage_kv_t<D>(Kt, kb, k_lo, T);
    stage_kv_t<D>(Vt, vb, k_lo, T);
    stage_key_ok<BN>(kms, km, b, k_lo, T);
    __syncthreads();
    const bool masked = tile_masked<BM, BN>(g, q_lo, k_lo, km != nullptr);

    float s[RA][RA];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RA; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RA], kc[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) qa[a] = Qs[(ty + 16 * a) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < RA; ++c) kc[c] = Kt[d * KP + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < RA; ++c) s[a][c] += qa[a] * kc[c];
    }
    unsigned ok = (1u << (RA * RA)) - 1u;  // bit a*RA+c: pair visible
    if (masked) {
      ok = 0;
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < RA; ++c)
          if (visible(g, q_lo + ty + 16 * a, k_lo + tx + 16 * c,
                      kms[tx + 16 * c] != 0))
            ok |= 1u << (a * RA + c);
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      float mx = DL4J_NEG_INF;
#pragma unroll
      for (int c = 0; c < RA; ++c) {
        // scale after the dot, as the backward recomputes it: the two
        // passes then see the same scores to the last bit
        s[a][c] = ((ok >> (a * RA + c)) & 1u) ? s[a][c] * scale
                                             : DL4J_NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < RA; ++c) {
        const float p =
            ((ok >> (a * RA + c)) & 1u) ? expf(s[a][c] - m_new) : 0.f;
        Ps[(ty + 16 * a) * KP + tx + 16 * c] = p;
        rs += p;
      }
      alpha[a] = expf(m[a] - m_new);
      l[a] = l[a] * alpha[a] + row_sum(rs);
      m[a] = m_new;
    }
    __syncthreads();
    // this tile's p v in its own sum, then one rescaled add per tile: the
    // running sum takes T / 64 additions instead of T (fp32 error)
    float t[RA][DC];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int e = 0; e < DC; ++e) t[a][e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pa[RA], vd[DC];
#pragma unroll
      for (int a = 0; a < RA; ++a) pa[a] = Ps[(ty + 16 * a) * KP + c];
#pragma unroll
      for (int e = 0; e < DC; ++e) vd[e] = Vt[(tx + 16 * e) * KP + c];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int e = 0; e < DC; ++e) t[a][e] += pa[a] * vd[e];
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int e = 0; e < DC; ++e) acc[a][e] = acc[a][e] * alpha[a] + t[a][e];
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int qi = q_lo + ty + 16 * a;
    if (qi >= T) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
    float* orow = o + ((long)bh * T + qi) * D;
#pragma unroll
    for (int e = 0; e < DC; ++e) orow[tx + 16 * e] = acc[a][e] * inv;
    if (tx == 0)
      lse[(long)bh * T + qi] =
          l[a] > 0.f ? m[a] + logf(fmaxf(l[a], 1e-30f)) : DL4J_NEG_INF;
  }
}

// Scores of one (q tile, key tile) pair for the backward: p (masked) and
// ds = p * (dO.v - D_i), each thread's 4 x 4 micro-tile, written to Ps
// and dSs. Qs/dOs row-major (stride D+1), Kt/Vt transposed (stride KP).
template <int D>
__device__ __forceinline__ void bwd_scores(
    const float* Qs, const float* dOs, const float* Kt, const float* Vt,
    const float* Ls, const float* Dis, const int* kms, float* Ps, float* dSs,
    const Geometry& g, int q_lo, int k_lo, bool masked, float scale) {
  constexpr int RA = Tile<D>::RA, KP = Tile<D>::KP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[RA][RA], dp[RA][RA];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RA; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[RA], oa[RA], kc[RA], vc[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      qa[a] = Qs[(ty + 16 * a) * (D + 1) + d];
      oa[a] = dOs[(ty + 16 * a) * (D + 1) + d];
    }
#pragma unroll
    for (int c = 0; c < RA; ++c) {
      kc[c] = Kt[d * KP + tx + 16 * c];
      vc[c] = Vt[d * KP + tx + 16 * c];
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RA; ++c) {
        s[a][c] += qa[a] * kc[c];
        dp[a][c] += oa[a] * vc[c];
      }
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + 16 * a;
    const float L = Ls[r], Di = Dis[r];
#pragma unroll
    for (int c = 0; c < RA; ++c) {
      const int col = tx + 16 * c;
      const bool ok =
          !masked || visible(g, q_lo + r, k_lo + col, kms[col] != 0);
      const float p = ok ? expf(s[a][c] * scale - L) : 0.f;
      Ps[r * KP + col] = p;
      dSs[r * KP + col] = p * (dp[a][c] - Di);
    }
  }
}

// Stage L and D_i of a q tile (rows past T: 0; their pairs are masked).
template <int BM>
__device__ __forceinline__ void stage_rows(float* Ls, float* Dis,
                                           const float* lse, const float* di,
                                           long row0, int q_lo, int T) {
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    const int qi = q_lo + r;
    Ls[r] = qi < T ? lse[row0 + qi] : 0.f;
    Dis[r] = qi < T ? di[row0 + qi] : 0.f;
  }
}

// ------------------------------------------------ K4, and K5's dk/dv pass
template <int D, bool WITH_DQ>
__global__ void __launch_bounds__(NT)
flash_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ km,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dv, int H,
                    Geometry g, float scale) {
  constexpr int DC = D / 16;
  constexpr int RA = Tile<D>::RA, BM = Tile<D>::BM, BN = Tile<D>::BN;
  constexpr int KP = Tile<D>::KP;
  const int j = blockIdx.x;             // the most-visited key tiles first
  const int bh = blockIdx.y, b = bh / H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int T = g.T, k_lo = j * BN;

  extern __shared__ float smem[];
  float* Kt = smem;                     // D x KP
  float* Vt = Kt + D * KP;              // D x KP
  float* Qs = Vt + D * KP;              // BM x (D+1)
  float* dOs = Qs + BM * (D + 1);       // BM x (D+1)
  float* Ps = dOs + BM * (D + 1);       // BM x KP
  float* dSs = Ps + BM * KP;            // BM x KP
  float* Ls = dSs + BM * KP;            // BM
  float* Dis = Ls + BM;                 // BM
  int* kms = reinterpret_cast<int*>(Dis + BM);   // BN

  const long base = (long)bh * T * D;
  stage_kv_t<D>(Kt, k + base, k_lo, T);
  stage_kv_t<D>(Vt, v + base, k_lo, T);
  stage_key_ok<BN>(kms, km, b, k_lo, T);

  // dk/dv micro-tiles: key rows ty + 16 a, columns tx + 16 e
  float dk_acc[RA][DC], dv_acc[RA][DC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int e = 0; e < DC; ++e) dk_acc[a][e] = dv_acc[a][e] = 0.f;

  int i0, i1;
  query_tiles<BM, BN>(g, k_lo, &i0, &i1);
  for (int i = i0; i < i1; ++i) {
    const int q_lo = i * BM;
    __syncthreads();
    stage_q<D>(Qs, q + base, q_lo, T);
    stage_q<D>(dOs, dout + base, q_lo, T);
    stage_rows<BM>(Ls, Dis, lse, di, (long)bh * T, q_lo, T);
    __syncthreads();
    bwd_scores<D>(Qs, dOs, Kt, Vt, Ls, Dis, kms, Ps, dSs, g, q_lo, k_lo,
                  tile_masked<BM, BN>(g, q_lo, k_lo, km != nullptr), scale);
    __syncthreads();
    // dv += p^T dO, dk += ds^T q (scale applied at the end), this q tile's
    // terms summed on their own first, as in the forward
    float dk_t[RA][DC], dv_t[RA][DC];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int e = 0; e < DC; ++e) dk_t[a][e] = dv_t[a][e] = 0.f;
#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      float pa[RA], sa[RA], od[DC], qd[DC];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        pa[a] = Ps[r * KP + ty + 16 * a];
        sa[a] = dSs[r * KP + ty + 16 * a];
      }
#pragma unroll
      for (int e = 0; e < DC; ++e) {
        od[e] = dOs[r * (D + 1) + tx + 16 * e];
        qd[e] = Qs[r * (D + 1) + tx + 16 * e];
      }
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int e = 0; e < DC; ++e) {
          dv_t[a][e] += pa[a] * od[e];
          dk_t[a][e] += sa[a] * qd[e];
        }
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int e = 0; e < DC; ++e) {
        dk_acc[a][e] += dk_t[a][e];
        dv_acc[a][e] += dv_t[a][e];
      }
    if constexpr (WITH_DQ) {
      // dq[q rows ty + 16 a, columns tx + 16 e] += scale * ds k
      float dq_t[RA][DC];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int e = 0; e < DC; ++e) dq_t[a][e] = 0.f;
#pragma unroll 4
      for (int c = 0; c < BN; ++c) {
        float sa[RA], kd[DC];
#pragma unroll
        for (int a = 0; a < RA; ++a) sa[a] = dSs[(ty + 16 * a) * KP + c];
#pragma unroll
        for (int e = 0; e < DC; ++e) kd[e] = Kt[(tx + 16 * e) * KP + c];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int e = 0; e < DC; ++e) dq_t[a][e] += sa[a] * kd[e];
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int qi = q_lo + ty + 16 * a;
        if (qi >= T) continue;
        float* row = dq + base + (long)qi * D;
#pragma unroll
        for (int e = 0; e < DC; ++e)
          atomicAdd(row + tx + 16 * e, scale * dq_t[a][e]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int kj = k_lo + ty + 16 * a;
    if (kj >= T) continue;
#pragma unroll
    for (int e = 0; e < DC; ++e) {
      const long off = base + (long)kj * D + tx + 16 * e;
      dk[off] = scale * dk_acc[a][e];
      dv[off] = dv_acc[a][e];
    }
  }
}

// -------------------------------------------------------- K5's dq pass
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ km,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ dq,
                   int H, Geometry g, float scale) {
  constexpr int DC = D / 16;
  constexpr int RA = Tile<D>::RA, BM = Tile<D>::BM, BN = Tile<D>::BN;
  constexpr int KP = Tile<D>::KP;
  const int nq = gridDim.x;
  const int i = nq - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int T = g.T, q_lo = i * BM;

  extern __shared__ float smem[];
  float* Kt = smem;
  float* Vt = Kt + D * KP;
  float* Qs = Vt + D * KP;
  float* dOs = Qs + BM * (D + 1);
  float* Ps = dOs + BM * (D + 1);
  float* dSs = Ps + BM * KP;
  float* Ls = dSs + BM * KP;
  float* Dis = Ls + BM;
  int* kms = reinterpret_cast<int*>(Dis + BM);

  const long base = (long)bh * T * D;
  stage_q<D>(Qs, q + base, q_lo, T);
  stage_q<D>(dOs, dout + base, q_lo, T);
  stage_rows<BM>(Ls, Dis, lse, di, (long)bh * T, q_lo, T);

  float dq_acc[RA][DC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int e = 0; e < DC; ++e) dq_acc[a][e] = 0.f;

  int j0, j1;
  key_tiles<BM, BN>(g, q_lo, &j0, &j1);
  for (int j = j0; j < j1; ++j) {
    const int k_lo = j * BN;
    __syncthreads();
    stage_kv_t<D>(Kt, k + base, k_lo, T);
    stage_kv_t<D>(Vt, v + base, k_lo, T);
    stage_key_ok<BN>(kms, km, b, k_lo, T);
    __syncthreads();
    bwd_scores<D>(Qs, dOs, Kt, Vt, Ls, Dis, kms, Ps, dSs, g, q_lo, k_lo,
                  tile_masked<BM, BN>(g, q_lo, k_lo, km != nullptr), scale);
    __syncthreads();
    float dq_t[RA][DC];                  // this key tile's terms first
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int e = 0; e < DC; ++e) dq_t[a][e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float sa[RA], kd[DC];
#pragma unroll
      for (int a = 0; a < RA; ++a) sa[a] = dSs[(ty + 16 * a) * KP + c];
#pragma unroll
      for (int e = 0; e < DC; ++e) kd[e] = Kt[(tx + 16 * e) * KP + c];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int e = 0; e < DC; ++e) dq_t[a][e] += sa[a] * kd[e];
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int e = 0; e < DC; ++e) dq_acc[a][e] += dq_t[a][e];
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int qi = q_lo + ty + 16 * a;
    if (qi >= T) continue;
#pragma unroll
    for (int e = 0; e < DC; ++e)
      dq[base + (long)qi * D + tx + 16 * e] = scale * dq_acc[a][e];
  }
}

template <typename K>
int prepare(K kern, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <int D>
constexpr size_t fwd_smem() {
  constexpr int BM = Tile<D>::BM, BN = Tile<D>::BN, KP = Tile<D>::KP;
  return sizeof(float) * (BM * (D + 1) + 2 * D * KP + BM * KP) +
         sizeof(int) * BN;
}

template <int D>
constexpr size_t bwd_smem() {
  constexpr int BM = Tile<D>::BM, BN = Tile<D>::BN, KP = Tile<D>::KP;
  return sizeof(float) *
             (2 * D * KP + 2 * BM * (D + 1) + 2 * BM * KP + 2 * BM) +
         sizeof(int) * BN;
}

// fp32 inputs only (bf16 at D <= 128 is flash_attention_sm90.cu's).
template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* km,
               void* o, float* lse, int B, int H, int Hk, Geometry g,
               float scale, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<D>();
  auto kern = flash_fwd_kernel<D>;
  int err = prepare(kern, smem);
  if (err) return err;
  dim3 grid((g.T + Tile<D>::BM - 1) / Tile<D>::BM, B * H);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), km, static_cast<float*>(o), lse, H, Hk, g,
      scale);
  return (int)cudaGetLastError();
}

// The CUDA-core K4 (one kernel, dq through atomics) or K5 (the dq kernel,
// then the dk/dv kernel with the dq atomics compiled out).
template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const int* km,
               const void* dout, const float* lse, const float* di,
               float* dq, void* dk, void* dv, int B, int H, Geometry g,
               int two_pass, float scale, cudaStream_t st) {
  constexpr size_t smem = bwd_smem<D>();
  static_assert(smem <= 232448, "one CTA's shared memory");
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  float* dk_ = static_cast<float*>(dk);
  float* dv_ = static_cast<float*>(dv);
  dim3 grid_k((g.T + Tile<D>::BN - 1) / Tile<D>::BN, B * H);
  dim3 grid_q((g.T + Tile<D>::BM - 1) / Tile<D>::BM, B * H);
  int err;
  if (!two_pass) {
    auto kern = flash_bwd_kv_kernel<D, true>;
    if ((err = prepare(kern, smem))) return err;
    kern<<<grid_k, NT, smem, st>>>(q_, k_, v_, km, do_, lse, di, dq, dk_,
                                   dv_, H, g, scale);
    return (int)cudaGetLastError();
  }
  auto kq = flash_bwd_q_kernel<D>;
  if ((err = prepare(kq, smem))) return err;
  kq<<<grid_q, NT, smem, st>>>(q_, k_, v_, km, do_, lse, di, dq, H, g,
                               scale);
  if ((err = (int)cudaGetLastError())) return err;
  auto kkv = flash_bwd_kv_kernel<D, false>;
  if ((err = prepare(kkv, smem))) return err;
  kkv<<<grid_k, NT, smem, st>>>(q_, k_, v_, km, do_, lse, di, nullptr, dk_,
                                dv_, H, g, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype code 0 (float32) only: bf16 at D <= 128 runs on
// flash_attention_sm90.cu's kernels, and the wrapper widens bf16 at D 192
// to 512 to fp32 for these. Head dims 16, 32, 64, 128, 192, 256, 384,
// 512. Return
// a cudaError_t code (0 on success). They allocate nothing and do not
// synchronize: the kernels launch on `stream`.
#define DL4J_DISPATCH_D(FN, ...)                                   \
  {                                                                \
    if (D == 16) return FN<16>(__VA_ARGS__);                       \
    if (D == 32) return FN<32>(__VA_ARGS__);                       \
    if (D == 64) return FN<64>(__VA_ARGS__);                       \
    if (D == 128) return FN<128>(__VA_ARGS__);                     \
    if (D == 192) return FN<192>(__VA_ARGS__);                     \
    if (D == 256) return FN<256>(__VA_ARGS__);                     \
    if (D == 384) return FN<384>(__VA_ARGS__);                     \
    if (D == 512) return FN<512>(__VA_ARGS__);                     \
    return (int)cudaErrorInvalidValue;                             \
  }

extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const void* key_mask, void* o, void* lse,
                              int B, int H, int Hk, int T, int D, int causal,
                              int window, int dtype, float scale,
                              void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (Hk <= 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const Geometry g{T, causal, window};
  DL4J_DISPATCH_D(launch_fwd, q, k, v,
                  static_cast<const int*>(key_mask), o,
                  static_cast<float*>(lse), B, H, Hk, g, scale,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int dl4j_flash_bwd(const void* q, const void* k, const void* v,
                              const void* key_mask, const void* dout,
                              const void* lse, const void* di, void* dq,
                              void* dk, void* dv, int B, int H, int T, int D,
                              int causal, int window, int dtype, int two_pass,
                              float scale, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  const Geometry g{T, causal, window};
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  DL4J_DISPATCH_D(launch_bwd, q, k, v,
                  static_cast<const int*>(key_mask), dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(di), static_cast<float*>(dq), dk,
                  dv, B, H, g, two_pass, scale,
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* dl4j_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
