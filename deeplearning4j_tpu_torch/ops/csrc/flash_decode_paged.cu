// Paged split-K flash-decode attention for Hopper (sm_90a), with Q query
// positions per slot and the logaddexp merge in the same launch.
//
// Replaces two Pallas kernels of deeplearning4j_tpu/ops/decode_attention.py:
//   - K1 `flash_decode_attention_paged` (:281, body `_decode_kernel` :112,
//     merged by logaddexp after the pallas_call :389-394): one query per
//     slot, the Q = 1 case;
//   - K2 `flash_decode_attention_spec_paged` (:480, body
//     `_spec_decode_kernel` :428, merge :579-587): Q consecutive query
//     positions per slot (speculative verification); query i sits at
//     position vis - 1 + i and sees p < vis + i (and, with a window,
//     vis + i - 1 - p < window).
// Each slot's cache lives in fixed-size physical blocks of a pool
// (NB+1, bs, Hk, D), reached through its row of the block table. (K6, the
// contiguous cache, is flash_decode_contiguous.cu; the ticket and the merge
// are flash_decode_common.cuh's.)
//
// What bounds it on the H100: the bytes of the visible K/V blocks, read
// once (a few query rows per slot, ~Q*G FLOPs per byte). At the served
// shape (S 8, Hk 2, G 2, D 64, bs 16, ~760 visible, bf16) that is 3.1 MB,
// 0.94 us at 3.35 TB/s: less than one launch. So the real limit is latency:
// the chain of dependent trips to device memory (lengths, block table,
// K/V, partials) and the launches a call makes.
//
// What the design does about it:
//   - One launch a call. One CTA (128 threads) per (partition of `bpp`
//     whole logical blocks, kv head, slot); `bpp` is the caller's plan
//     (ops/decode_attention.py `paged_partition`: 64 positions where they
//     fit, halved until the CTA fits shared memory). The plan does not
//     depend on Q or G: query rows go through the CTA in chunks of 16, so
//     row i of a Q-query call does exactly the arithmetic of a Q = 1 call
//     at vis + i (the same partitions, the same order of every sum).
//   - A partition that no query row can see (wholly at or past vis + Q - 1,
//     or wholly behind the earliest query's window) returns before it reads
//     the block table, and takes no ticket. Block-table entries past the
//     slot's last visible block (the trash block) are never read.
//   - One round of loads: the CTA reads its partition's block-table entries
//     (and, for an int8 pool, each block's k_scale / v_scale once), then
//     issues every K and V row of the positions some row can see as 16-byte
//     cp.async copies into shared memory in the pool's own dtype, all in
//     flight before the first use; the other rows are zeros. Rows are
//     padded by 16 bytes, so ldmatrix's eight 16-byte rows and the int8
//     fragment loads hit distinct banks. A row whose byte length is not a
//     multiple of 16 (or an unaligned pool) takes element loads instead.
//   - bf16 / fp16 queries (a pool of their dtype, or int8): both products on
//     the tensor cores with mma.sync.m16n8k16 (fp32 accumulate). A chunk of
//     16 query rows is the A tile (K1's 2 rows waste the rest, which costs
//     nothing at this latency-bound size; wgmma needs 64 rows and does not
//     fit R = Q * G <= 36). Scores: B = K rows by ldmatrix; p V: A = p in
//     the query dtype, B = V by ldmatrix.trans. An int8 pool is converted
//     to the query dtype in the fragment loads (exact); k_scale multiplies
//     each key's score after the product, and v_scale is folded into that
//     key's p before p is rounded.
//   - fp32 queries (fp32 pool, or int8 with fp32 queries): fp32 products on
//     the CUDA cores, the same scale placement.
//   - Softmax statistics, the partials, L_p and the merge are fp32. Each
//     CTA writes its normalized partial o_p and L_p = m + log l to scratch
//     and takes a ticket on its (slot, kv head); the CTA that draws the
//     last ticket merges the partitions in partition order and writes the
//     output in q's dtype. With `merge` = 0 the kernel writes the partials
//     only (skipped partitions as (0, NEG_INF)), for timing and the tests.
// A row that sees no position gets zeros.
#include "flash_decode_common.cuh"

namespace {

using namespace dl4j_decode;

constexpr int NT = 128;                  // threads per CTA (4 warps)
constexpr int MT = 16;                   // query rows per chunk: one m16 tile
constexpr int SMEM_LIMIT = 232448;       // a CTA's shared memory on the H100

// dtype codes: 0 float32, 1 float16, 2 bfloat16, 3 int8 (pool only)
template <int C> struct Dt;
template <> struct Dt<0> { using T = float; };
template <> struct Dt<1> { using T = __half; };
template <> struct Dt<2> { using T = __nv_bfloat16; };
template <> struct Dt<3> { using T = int8_t; };

// Shared memory of a CTA, in bytes. A head of the partition's physical
// block ids, scales, the chunk's row max and sum and a flag; then Pp rows
// of K and Pp of V in the pool's dtype (Pp = bpp * bs rounded up to 16), 16
// query rows in q's dtype, the 16 x (Pp + 4) fp32 scores and, for the
// tensor-core path, the 16 x (Pp + 8) probabilities in q's dtype. A row of
// D elements holds D rounded up to 16 (the k16 steps), padded to a multiple
// of 16 bytes plus 16.
__host__ __device__ __forceinline__ int pad16(int x) {
  return (x + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int row_bytes(int D, int elt) {
  return pad16(pad16(D) * elt) + 16;
}
__host__ __device__ __forceinline__ int head_bytes(int bpp) {
  return pad16(4 * (3 * bpp + 2 * MT + 1));
}
__host__ __device__ __forceinline__ int smem_bytes(int bs, int bpp, int D,
                                                   int q_elt, int kv_elt) {
  const int Pp = pad16(bpp * bs);
  return head_bytes(bpp) + 2 * Pp * row_bytes(D, kv_elt) +
         MT * row_bytes(D, q_elt) + 4 * MT * (Pp + 4) +
         (q_elt == 2 ? 2 * MT * (Pp + 8) : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t r[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b for one m16n8k16 tile, fp32 accumulate, a and b in T
template <typename T>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float c[4],
                                                        const uint32_t a[4],
                                                        const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float c[4],
                                                 const uint32_t a[4],
                                                 const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two int8 values as a packed pair of T (the lower k in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(int8_t lo, int8_t hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(int8_t lo,
                                                         int8_t hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(int8_t lo, int8_t hi) {
  const __half2 v = __floats2half2_rn((float)lo, (float)hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// B fragment of the score product (k = d, n = position) from K rows
// [position][d] of `rb` bytes: positions n0..n0+7, d k0..k0+15.
template <typename TQ, typename TKV>
__device__ __forceinline__ void k_frag(uint32_t b[2], const unsigned char* ks,
                                       int rb, int n0, int k0, int lane) {
  if constexpr (sizeof(TKV) == 2) {
    ldsm_x2(b, ks + (n0 + (lane & 7)) * rb +
                   2 * (k0 + 8 * ((lane >> 3) & 1)));
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int8_t* row = reinterpret_cast<const int8_t*>(ks + (n0 + g) * rb);
    b[0] = pack2<TQ>(row[k0 + 2 * t], row[k0 + 2 * t + 1]);
    b[1] = pack2<TQ>(row[k0 + 8 + 2 * t], row[k0 + 9 + 2 * t]);
  }
}

// B fragment of p V (k = position, n = d) from V rows [position][d]:
// positions k0..k0+15, d n0..n0+7.
template <typename TQ, typename TKV>
__device__ __forceinline__ void v_frag(uint32_t b[2], const unsigned char* vs,
                                       int rb, int k0, int n0, int lane) {
  if constexpr (sizeof(TKV) == 2) {
    ldsm_x2_trans(b, vs + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * rb +
                         2 * n0);
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int8_t* col = reinterpret_cast<const int8_t*>(vs) + n0 + g;
    const int k = k0 + 2 * t;
    b[0] = pack2<TQ>(col[k * rb], col[(k + 1) * rb]);
    b[1] = pack2<TQ>(col[(k + 8) * rb], col[(k + 9) * rb]);
  }
}

// A fragment (16 rows x k16) of a row-major tile of 16-bit elements with
// rows `rb` bytes apart, columns k0..k0+15.
__device__ __forceinline__ void a_frag(uint32_t a[4], const unsigned char* t,
                                       int rb, int k0, int lane) {
  ldsm_x4(a, t + ((lane & 7) + 8 * ((lane >> 3) & 1)) * rb +
                 2 * (k0 + 8 * (lane >> 4)));
}

template <int QC, int KVC, bool VEC>
__global__ void __launch_bounds__(NT)
flash_decode_paged_kernel(const typename Dt<QC>::T* __restrict__ q,
                          const typename Dt<KVC>::T* __restrict__ kp,
                          const typename Dt<KVC>::T* __restrict__ vp,
                          const float* __restrict__ k_scale,  // (NB+1, Hk)
                          const float* __restrict__ v_scale,  // or null
                          const int* __restrict__ block_tables,  // (S, bps)
                          const int* __restrict__ visible,       // (S,)
                          float* __restrict__ o_p,  // (S, Hk, np, Q, G, D)
                          float* __restrict__ l_p,  // (S, Hk, np, Q, G)
                          int* __restrict__ tickets,  // (S * Hk)
                          typename Dt<QC>::T* __restrict__ out,  // q's shape
                          int nq, int Hk, int G, int D, int bs, int bps,
                          int bpp, int np, int window, int merge,
                          float scale) {
  using TQ = typename Dt<QC>::T;
  using TKV = typename Dt<KVC>::T;
  constexpr bool MMA = QC != 0;
  constexpr bool QUANT = KVC == 3;
  const int j = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = Hk * G, R = nq * G;
  const int P = bpp * bs, Pp = pad16(P), L = bps * bs, Dp = pad16(D);
  const int vis = visible[s];
  // the positions some row sees: [lo, hi)
  const int hi = min(vis + nq - 1, L);
  const int lo = window > 0 ? max(0, vis - window) : 0;
  const int j0 = lo / P, j1 = hi > lo ? (hi + P - 1) / P : j0;
  const long cell = ((long)s * Hk + h) * np + j;
  TQ* outb = out + ((long)s * nq * H + (long)h * G) * D;
  if (j < j0 || j >= j1) {
    if (!merge) {
      for (int i = tid; i < R * D; i += NT) o_p[cell * R * D + i] = 0.f;
      for (int i = tid; i < R; i += NT) l_p[cell * R + i] = DL4J_NEG_INF;
    } else if (j1 == j0 && j == 0) {
      for (int i = tid; i < R * D; i += NT) {
        const int qi = i / (G * D);
        outb[(long)qi * H * D + (i - qi * G * D)] = from_f<TQ>(0.f);
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  int* phys = reinterpret_cast<int*>(smem);            // bpp
  float* ksc = reinterpret_cast<float*>(phys + bpp);   // bpp
  float* vsc = ksc + bpp;                              // bpp
  float* ms = vsc + bpp;                               // MT
  float* ls = ms + MT;                                 // MT
  int* flag = reinterpret_cast<int*>(ls + MT);
  const int rbk = row_bytes(D, sizeof(TKV)), rbq = row_bytes(D, sizeof(TQ));
  unsigned char* ks = smem + head_bytes(bpp);
  unsigned char* vs = ks + Pp * rbk;
  unsigned char* qs = vs + Pp * rbk;
  float* sc = reinterpret_cast<float*>(qs + MT * rbq);  // MT x (Pp + 4)
  const int scs = Pp + 4;
  unsigned char* pb = reinterpret_cast<unsigned char*>(sc + MT * scs);
  const int rbp = 2 * (Pp + 8);                         // MT x (Pp + 8)

  // the partition's block-table entries, only of blocks some row sees
  const int p0 = j * P;
  const int b_lo = max(p0, lo) / bs - j * bpp;
  const int b_hi = min((hi + bs - 1) / bs, (j + 1) * bpp) - j * bpp;
  for (int b = tid; b < bpp; b += NT) {
    const bool used = b >= b_lo && b < b_hi;
    const int ph = used ? block_tables[(long)s * bps + j * bpp + b] : 0;
    phys[b] = ph;
    if (QUANT) {
      ksc[b] = used ? k_scale[(long)ph * Hk + h] : 0.f;
      vsc[b] = used ? v_scale[(long)ph * Hk + h] : 0.f;
    }
  }
  __syncthreads();

  // every K and V row in flight at once; rows no row sees, and the padding
  // of a row past D, are zeros
  const int q_lo = max(p0, lo), q_hi = min(p0 + P, hi);
  if (VEC) {
    const int nc = Dp * sizeof(TKV) / 16;       // 16-byte chunks a row
    const int nd = D * sizeof(TKV) / 16;        // ... of them holding data
    for (int i = tid; i < 2 * Pp * nc; i += NT) {
      const int row = i / nc, c = i - row * nc;
      const int t = row < Pp ? row : row - Pp;
      unsigned char* dst = (row < Pp ? ks : vs) + t * rbk + 16 * c;
      const int p = p0 + t;
      if (c < nd && p >= q_lo && p < q_hi) {
        const int b = t / bs;
        const long off =
            (((long)phys[b] * bs + (t - b * bs)) * Hk + h) * D;
        cp_async16(dst, (row < Pp ? kp : vp) + off + c * (16 / sizeof(TKV)));
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = tid; i < 2 * Pp * Dp; i += NT) {
      const int row = i / Dp, d = i - row * Dp;
      const int t = row < Pp ? row : row - Pp;
      TKV* dst = reinterpret_cast<TKV*>((row < Pp ? ks : vs) + t * rbk);
      const int p = p0 + t;
      TKV x{};
      if (d < D && p >= q_lo && p < q_hi) {
        const int b = t / bs;
        x = (row < Pp ? kp : vp)[(((long)phys[b] * bs + (t - b * bs)) * Hk +
                                  h) * D + d];
      }
      dst[d] = x;
    }
  }

  float* op = o_p + cell * R * D;
  float* lq = l_p + cell * R;
  for (int r0 = 0; r0 < R; r0 += MT) {
    const int nr = min(MT, R - r0);
    // the chunk's query rows (zeros past R and past D)
    for (int i = tid; i < MT * Dp; i += NT) {
      const int row = i / Dp, d = i - row * Dp;
      TQ x = from_f<TQ>(0.f);
      if (row < nr && d < D) {
        const int r = r0 + row, qi = r / G;
        x = q[(((long)s * nq + qi) * H + (long)h * G + (r - qi * G)) * D + d];
      }
      reinterpret_cast<TQ*>(qs + row * rbq)[d] = x;
    }
    if (r0 == 0 && VEC) cp_async_wait_all();
    __syncthreads();

    // scores s = q.k * (k_scale) * scale, NEG_INF where the row cannot see
    // the position
    auto sees = [&](int row, int t) {
      const int p = p0 + t, vr = vis + (r0 + row) / G;
      return row < nr && t < P && p < L && p < vr &&
             (window <= 0 || vr - 1 - p < window);
    };
    auto score = [&](float x, int row, int t) {
      if (QUANT) x *= ksc[min(t / bs, bpp - 1)];
      return sees(row, t) ? x * scale : DL4J_NEG_INF;
    };
    if constexpr (MMA) {
      const int g = lane >> 2, tq = lane & 3;
      for (int nt = warp; nt < Pp / 8; nt += NT / 32) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < Dp; k0 += 16) {
          uint32_t a[4], b[2];
          a_frag(a, qs, rbq, k0, lane);
          k_frag<TQ, TKV>(b, ks, rbk, nt * 8, k0, lane);
          mma16816<TQ>(c, a, b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e >> 1), t = nt * 8 + 2 * tq + (e & 1);
          sc[row * scs + t] = score(c[e], row, t);
        }
      }
    } else {
      for (int i = tid; i < nr * Pp; i += NT) {
        const int row = i / Pp, t = i - row * Pp;
        const float* qr = reinterpret_cast<const float*>(qs + row * rbq);
        const TKV* kr = reinterpret_cast<const TKV*>(ks + t * rbk);
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], to_f(kr[d]), acc);
        sc[row * scs + t] = score(acc, row, t);
      }
    }
    __syncthreads();

    // one warp a row: max, p = exp(s - m), sum; p (times v_scale) kept for
    // the p V product
    for (int row = warp; row < nr; row += NT / 32) {
      float* sr = sc + row * scs;
      float m = DL4J_NEG_INF;
      for (int t = lane; t < Pp; t += 32) m = fmaxf(m, sr[t]);
      m = warp_max(m);
      float l = 0.f;
      for (int t = lane; t < Pp; t += 32) {
        const float p = sees(row, t) ? expf(sr[t] - m) : 0.f;
        l += p;
        const float pv = QUANT ? p * vsc[min(t / bs, bpp - 1)] : p;
        if constexpr (MMA)
          reinterpret_cast<TQ*>(pb + row * rbp)[t] = from_f<TQ>(pv);
        else
          sr[t] = pv;
      }
      l = warp_sum(l);
      if (lane == 0) {
        ms[row] = m;
        ls[row] = l;
      }
    }
    __syncthreads();

    // o = p V / l into the partial; L_p = m + log l (NEG_INF for a row that
    // sees nothing here)
    if constexpr (MMA) {
      const int g = lane >> 2, tq = lane & 3;
      for (int nt = warp; nt < Dp / 8; nt += NT / 32) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < Pp; k0 += 16) {
          uint32_t a[4], b[2];
          a_frag(a, pb, rbp, k0, lane);
          v_frag<TQ, TKV>(b, vs, rbk, k0, nt * 8, lane);
          mma16816<TQ>(c, a, b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e >> 1), d = nt * 8 + 2 * tq + (e & 1);
          if (row < nr && d < D)
            op[(r0 + row) * D + d] = c[e] / fmaxf(ls[row], 1e-30f);
        }
      }
    } else {
      for (int i = tid; i < nr * D; i += NT) {
        const int row = i / D, d = i - row * D;
        const float* pr = sc + row * scs;
        float acc = 0.f;
        for (int t = 0; t < Pp; ++t)
          acc = fmaf(pr[t], to_f(reinterpret_cast<const TKV*>(vs + t * rbk)[d]),
                     acc);
        op[(r0 + row) * D + d] = acc / fmaxf(ls[row], 1e-30f);
      }
    }
    for (int row = tid; row < nr; row += NT) {
      const float l = ls[row];
      lq[r0 + row] = l > 0.f ? ms[row] + logf(fmaxf(l, 1e-30f))
                             : DL4J_NEG_INF;
    }
    __syncthreads();
  }
  if (!merge) return;

  // the CTA that draws the last ticket of (s, h) merges its partials; 4
  // output elements a thread and 4 partitions a step timed fastest for K2
  // (experiments/torch_decode_merge_ab.py)
  if (!last_ticket(&tickets[s * Hk + h], j1 - j0, flag)) return;
  merge_partitions<TQ, NT, 4, 4>(l_p + ((long)s * Hk + h) * np * R,
                                 o_p + ((long)s * Hk + h) * np * R * D, outb,
                                 R, G, (long)H * D, D, j0, j1,
                                 reinterpret_cast<float*>(ks),
                                 2 * Pp * rbk / 4);
}

template <int QC, int KVC>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* bt, const int* vis, float* o_p,
           float* l_p, int* tickets, void* out, int S, int nq, int Hk, int G,
           int D, int bs, int bps, int bpp, int window, int merge,
           float scale, cudaStream_t stream) {
  using TQ = typename Dt<QC>::T;
  using TKV = typename Dt<KVC>::T;
  if (KVC == 3 && (ks == nullptr || vs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(bs, bpp, D, sizeof(TQ), sizeof(TKV));
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const bool vec = (D * sizeof(TKV)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  auto kern = vec ? flash_decode_paged_kernel<QC, KVC, true>
                  : flash_decode_paged_kernel<QC, KVC, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int np = (bps + bpp - 1) / bpp;
  kern<<<dim3(np, Hk, S), NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), ks, vs, bt, vis, o_p, l_p, tickets,
      static_cast<TQ*>(out), nq, Hk, G, D, bs, bps, bpp, np, window, merge,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16 (q and out), and 3 int8
// for the pool (with k_scale / v_scale (NB+1, Hk) fp32). q (S, nq, Hk*G, D)
// and out alike; block_tables (S, bps) and visible (S,) int32; o_p
// (S, Hk, ceil(bps / bpp), nq, G, D) and l_p (S, Hk, ceil(bps / bpp), nq,
// G) fp32 scratch (the partials when merge = 0); tickets (S * Hk) int32,
// zero on entry and on return. Returns a cudaError_t code (0 on success).
// Allocates nothing and does not synchronize: it launches on `stream`.
extern "C" int dl4j_flash_decode_paged(
    const void* q, const void* kp, const void* vp, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* visible,
    void* o_p, void* l_p, void* tickets, void* out, int S, int nq, int Hk,
    int G, int D, int bs, int bps, int bpp, int window, int merge,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  if (S <= 0 || Hk <= 0 || G <= 0 || D <= 0) return 0;
  if (nq < 1 || bs < 1 || bps < 1 || bpp < 1)
    return (int)cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* vi = static_cast<const int*>(visible);
  float* o = static_cast<float*>(o_p);
  float* l = static_cast<float*>(l_p);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DL4J_LAUNCH(QC, KVC)                                                 \
  return launch<QC, KVC>(q, kp, vp, ks, vs, bt, vi, o, l, tk, out, S, nq,    \
                         Hk, G, D, bs, bps, bpp, window, merge, scale, st)
  if (kv_dtype == 3) {
    if (q_dtype == 0) DL4J_LAUNCH(0, 3);
    if (q_dtype == 1) DL4J_LAUNCH(1, 3);
    if (q_dtype == 2) DL4J_LAUNCH(2, 3);
  } else if (kv_dtype == q_dtype) {
    if (q_dtype == 0) DL4J_LAUNCH(0, 0);
    if (q_dtype == 1) DL4J_LAUNCH(1, 1);
    if (q_dtype == 2) DL4J_LAUNCH(2, 2);
  }
#undef DL4J_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA (bytes) for element sizes q_elt (4 or
// 2) and kv_elt (4, 2 or 1).
extern "C" int dl4j_flash_decode_paged_smem(int bs, int bpp, int D,
                                            int q_elt, int kv_elt) {
  return smem_bytes(bs, bpp, D, q_elt, kv_elt);
}

extern "C" const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
