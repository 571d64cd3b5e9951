// Split-K flash-decode over a contiguous KV cache, with the logaddexp merge
// in the same launch (K6), for Hopper (sm_90a).
//
// Replaces the Pallas kernel of deeplearning4j_tpu/ops/decode_attention.py:
//   - K6 `flash_decode_attention` (:180, body `_decode_kernel` :112 over
//     length partitions of a (S, L, Hk, D) cache, merged by logaddexp
//     after the pallas_call :211).
// Layout: q (S, H, D), kc/vc (S, L, Hk, D), out (S, H, D), all in one
// dtype (fp32, fp16 or bf16); visible (S,) int32: slot s sees positions j
// < visible[s], and with window > 0 only visible[s] - window <= j; query
// head h*G + g reads kv head h (G = H / Hk).
//
// What bounds it on the H100: the bytes of the visible K/V positions, read
// once (decode is one query row per head, ~G FLOPs per byte). At the
// served shape (S 8, L 1024, Hk 2, G 2, D 64, bf16, ~760 visible) that is
// 3.1 MB, 0.93 us at 3.35 TB/s: less than one launch and one trip to
// device memory, so what the card can do about it is latency and
// occupancy: many small CTAs, each a single round of loads, and no second
// launch.
//
// What the design does about it:
//   - One CTA (128 threads) per (partition of P positions, kv head, slot);
//     P is the caller's (64 at the served shape: 192 busy CTAs on 132
//     SMs). A partition wholly past `visible` or behind the window returns
//     before any load; the last one may be ragged (L need not be a
//     multiple of P).
//   - The partition's K and V rows are read once, as 16-byte vectors when
//     a row is a multiple of 16 bytes (else element by element), all
//     issued before the first use, into shared memory in their own dtype
//     (rows padded by 16 bytes, so that the score loop's 16-byte reads of
//     8 consecutive rows hit distinct banks); the G query rows of the kv
//     head share every load. Scores, row max and sum (warp shuffles) and
//     p V run in fp32.
//   - Each CTA writes its normalized partial o_p (G, D) and L_p = m + log l
//     to a scratch buffer, then takes a ticket (one atomicAdd per CTA) on
//     its (slot, kv head). The CTA that draws the last ticket merges the
//     partials of the (slot, kv head) in partition order, so the output
//     does not depend on which CTA finishes last, writes (G, D) of the
//     output in its dtype and puts the ticket back to 0 for the next
//     launch (the ticket and the merge are flash_decode_common.cuh's,
//     shared with K1/K2). A call is one launch; with `merge` = 0 the kernel writes the
//     partials only (skipped partitions as (0, NEG_INF)), for timing and
//     for the merge of ops/decode_attention.py.
// Row i of the output is the dense softmax attention of decode_attention_
// dense up to the order of the fp32 sums; a slot with no visible position
// gets zeros.
#include "flash_decode_common.cuh"

namespace {

using namespace dl4j_decode;

constexpr int NT = 128;                  // threads per CTA
constexpr int SMEM_LIMIT = 232448;       // a CTA's shared memory on the H100

// Shared memory of a CTA, in bytes: the G query rows and the G x P scores
// in fp32, the rows' max and sum and a flag, then P rows of K and P of V
// in their dtype, each row padded to a multiple of 16 bytes plus 16.
__host__ __device__ __forceinline__ int row_bytes(int D, int elt) {
  return (D * elt + 15) / 16 * 16 + 16;
}
__host__ __device__ __forceinline__ int kv_offset(int G, int D, int P) {
  return (4 * (G * D + G * P + 2 * G + 1) + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int smem_bytes(int G, int D, int P,
                                                   int elt) {
  return kv_offset(G, D, P) + 2 * P * row_bytes(D, elt);
}

// n rows of D elements, `stride` elements apart in global memory, into
// shared-memory rows of `rb` bytes
template <typename T, bool VEC>
__device__ __forceinline__ void load_rows(unsigned char* dst, const T* src,
                                          long stride, int n, int D, int rb) {
  if (VEC) {
    constexpr int E = 16 / sizeof(T);
    const int nv = D / E;
    for (int i = threadIdx.x; i < n * nv; i += NT) {
      const int t = i / nv, c = i - t * nv;
      *reinterpret_cast<uint4*>(dst + t * rb + 16 * c) =
          __ldg(reinterpret_cast<const uint4*>(src + t * stride + E * c));
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += NT) {
      const int t = i / D, d = i - t * D;
      reinterpret_cast<T*>(dst + t * rb)[d] = src[t * stride + d];
    }
  }
}

// q . k over D, q in fp32 and k a shared-memory row in its dtype
template <typename T, bool VEC>
__device__ __forceinline__ float dot_row(const float* q, const unsigned char* k,
                                         int D) {
  float acc = 0.f;
  if (VEC) {
    constexpr int E = 16 / sizeof(T);
    for (int c = 0; c < D / E; ++c) {
      const uint4 w = *reinterpret_cast<const uint4*>(k + 16 * c);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int u = 0; u < E; ++u) acc = fmaf(q[E * c + u], to_f(e[u]), acc);
    }
  } else {
    const T* e = reinterpret_cast<const T*>(k);
    for (int d = 0; d < D; ++d) acc = fmaf(q[d], to_f(e[d]), acc);
  }
  return acc;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
flash_decode_contiguous_kernel(const T* __restrict__ q,
                               const T* __restrict__ kc,
                               const T* __restrict__ vc,
                               const int* __restrict__ visible,
                               float* __restrict__ o_p,   // (S, Hk, np, G, D)
                               float* __restrict__ l_p,   // (S, Hk, np, G)
                               int* __restrict__ tickets, // (S * Hk)
                               T* __restrict__ out,       // (S, H, D)
                               int L, int Hk, int G, int D, int P, int np,
                               int window, int merge, float scale) {
  const int j = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, H = Hk * G;
  const int vis = visible[s];
  const int hi = min(vis, L);
  const int lo = window > 0 ? max(0, vis - window) : 0;
  const int j0 = lo / P, j1 = hi > lo ? (hi + P - 1) / P : j0;
  const long cell = ((long)s * Hk + h) * np + j;
  T* outb = out + ((long)s * H + (long)h * G) * D;
  if (j < j0 || j >= j1) {
    if (!merge) {
      for (int i = tid; i < G * D; i += NT) o_p[cell * G * D + i] = 0.f;
      for (int i = tid; i < G; i += NT) l_p[cell * G + i] = DL4J_NEG_INF;
    } else if (j1 == j0 && j == 0) {
      for (int i = tid; i < G * D; i += NT) outb[i] = from_f<T>(0.f);
    }
    return;
  }
  const int p0 = max(j * P, lo), n = min(j * P + P, hi) - p0;   // n >= 1

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);    // G x D
  float* sc = qs + G * D;                        // G x P
  float* ms = sc + G * P;                        // G
  float* ls = ms + G;                            // G
  int* last = reinterpret_cast<int*>(ls + G);
  const int rb = row_bytes(D, sizeof(T));
  unsigned char* ks = smem + kv_offset(G, D, P);
  unsigned char* vs = ks + P * rb;

  const long kv0 = (((long)s * L + p0) * Hk + h) * D;
  load_rows<T, VEC>(ks, kc + kv0, (long)Hk * D, n, D, rb);
  load_rows<T, VEC>(vs, vc + kv0, (long)Hk * D, n, D, rb);
  const T* qg = q + ((long)s * H + (long)h * G) * D;
  for (int i = tid; i < G * D; i += NT) qs[i] = to_f(qg[i]);
  __syncthreads();

  for (int i = tid; i < G * n; i += NT) {
    const int g = i / n, t = i - g * n;
    sc[g * P + t] = dot_row<T, VEC>(qs + g * D, ks + t * rb, D) * scale;
  }
  __syncthreads();

  // one warp a query row: max, p = exp(s - m) over the row, sum
  const int warp = tid >> 5, lane = tid & 31;
  for (int g = warp; g < G; g += NT / 32) {
    float* row = sc + g * P;
    float m = DL4J_NEG_INF;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(row[t] - m);
      row[t] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      ms[g] = m;
      ls[g] = l;
    }
  }
  __syncthreads();

  float* op = o_p + cell * G * D;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i - g * D;
    const float* pr = sc + g * P;
    float acc = 0.f;
    for (int t = 0; t < n; ++t)
      acc = fmaf(pr[t], to_f(reinterpret_cast<const T*>(vs + t * rb)[d]),
                 acc);
    op[i] = acc / ls[g];
  }
  for (int g = tid; g < G; g += NT) l_p[cell * G + g] = ms[g] + logf(ls[g]);
  if (!merge) return;

  // the CTA that draws the last ticket of (s, h) merges its partials (per
  // element at G * D <= 128; E and U timed by
  // experiments/torch_decode_merge_ab.py)
  if (!last_ticket(&tickets[s * Hk + h], j1 - j0, last)) return;
  merge_partitions<T, NT, 8, 2>(l_p + ((long)s * Hk + h) * np * G,
                                o_p + ((long)s * Hk + h) * np * G * D, outb,
                                G, G, 0, D, j0, j1,
                                reinterpret_cast<float*>(ks), 2 * P * rb / 4);
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* vis,
           float* o_p, float* l_p, int* tickets, void* out, int S, int L,
           int Hk, int G, int D, int P, int window, int merge, float scale,
           cudaStream_t st) {
  const int smem = smem_bytes(G, D, P, sizeof(T));
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(kc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vc) % 16 == 0;
  auto kern = vec ? flash_decode_contiguous_kernel<T, true>
                  : flash_decode_contiguous_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int np = (L + P - 1) / P;
  kern<<<dim3(np, Hk, S), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), vis, o_p, l_p, tickets, static_cast<T*>(out),
      L, Hk, G, D, P, np, window, merge, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16 (q, cache and output).
// o_p (S, Hk, ceil(L / P), G, D) and l_p (S, Hk, ceil(L / P), G) fp32
// scratch; tickets (S * Hk) int32, zero on entry and on return. Returns a
// cudaError_t code (0 on success). Allocates nothing and does not
// synchronize: it launches on `stream`.
extern "C" int dl4j_flash_decode_contiguous(
    const void* q, const void* kc, const void* vc, const void* visible,
    void* o_p, void* l_p, void* tickets, void* out, int S, int L, int Hk,
    int G, int D, int P, int window, int merge, int dtype, float scale,
    void* stream) {
  if (S <= 0 || Hk <= 0 || G <= 0 || D <= 0) return 0;
  if (L <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const int* vis = static_cast<const int*>(visible);
  float* o = static_cast<float*>(o_p);
  float* l = static_cast<float*>(l_p);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DL4J_LAUNCH(T)                                                     \
  return launch<T>(q, kc, vc, vis, o, l, tk, out, S, L, Hk, G, D, P, window, \
                   merge, scale, st)
  if (dtype == 0) DL4J_LAUNCH(float);
  if (dtype == 1) DL4J_LAUNCH(__half);
  if (dtype == 2) DL4J_LAUNCH(__nv_bfloat16);
#undef DL4J_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA (bytes) for element size `elt`.
extern "C" int dl4j_flash_decode_contiguous_smem(int G, int D, int P,
                                                 int elt) {
  return smem_bytes(G, D, P, elt);
}

extern "C" const char* dl4j_flash_decode_contiguous_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
