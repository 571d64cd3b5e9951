// Paged split-K flash-decode attention for Hopper (sm_90a), with Q query
// positions per slot.
//
// Replaces three Pallas kernels of deeplearning4j_tpu/ops/decode_attention.py:
//   - K1 `flash_decode_attention_paged` (:281, body `_decode_kernel` :112):
//     one query per slot, the Q = 1 case;
//   - K2 `flash_decode_attention_spec_paged` (:480, body
//     `_spec_decode_kernel` :428): Q consecutive query positions per slot
//     (speculative verification); query i sits at position vis - 1 + i;
//   - K6 `flash_decode_attention` (:180): a contiguous (S, L, Hk, D) cache,
//     which the wrapper hands in as S * nk blocks of bkv positions with the
//     block table bt[s, j] = s * nk + j.
// Each slot's cache lives in fixed-size physical blocks of a pool, reached
// through its row of the block table.
//
// One CTA per (logical block j, kv head h, slot s):
//   - read phys = block_tables[s, j];
//   - stage the block's (bs, D) K and V tiles and the (Q * G, D) query tile
//     of kv head h (Q positions x G grouped heads) in shared memory, widened
//     to fp32 (an int8 pool is multiplied by its per-(block, head) scale
//     here; no dequantized pool is written);
//   - fp32 scores q.k * scale for every (query row, position), masked per
//     (query i, position p = j*bs + t) by
//     p < vis + i && (window == 0 || vis + i - 1 - p < window);
//   - emit the block's normalized partial o_p (Q, G, D) and L_p = m + log l
//     per query row.
// A block that no query row can see (wholly past vis + Q - 1, or wholly
// behind the earliest query's window) is skipped and writes (0, NEG_INF);
// that union test runs once per CTA, outside the loops. The logaddexp merge
// of the partials across blocks runs outside (ops/decode_attention.py).
// Row i of a Q-query call does exactly the arithmetic of a Q = 1 call at
// visible length vis + i.
//
// What bounds it on the H100: the K/V bytes of the visible blocks (decode is
// a few query rows per slot, ~Q FLOPs per byte read), so at serving shapes
// the bound is HBM bandwidth and, at these small sizes, launch latency. The
// design reads each K/V element from device memory exactly once per call,
// whatever Q is (that is what makes speculative verification pay), and
// keeps everything else (scores, probabilities, the query tile) in shared
// memory. Tensor cores, TMA and a pipelined block loop are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DL4J_NEG_INF (-1e30f)

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ bool visible_pos(int pos, int vis, int window) {
  return pos < vis && (window <= 0 || vis - 1 - pos < window);
}

template <typename TQ, typename TKV>
__global__ void flash_decode_paged_kernel(
    const TQ* __restrict__ q,             // (S, Q, Hk*G, D)
    const TKV* __restrict__ kp,           // (NB+1, bs, Hk, D)
    const TKV* __restrict__ vp,           // (NB+1, bs, Hk, D)
    const float* __restrict__ k_scale,    // (NB+1, Hk) or null
    const float* __restrict__ v_scale,    // (NB+1, Hk) or null
    const int* __restrict__ block_tables, // (S, bps)
    const int* __restrict__ visible,      // (S,)
    float* __restrict__ o_p,              // (S, Hk, bps, Q, G, D)
    float* __restrict__ l_p,              // (S, Hk, bps, Q, G)
    int nq, int Hk, int G, int D, int bs, int bps, int window, float scale) {
  const int j = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int R = nq * G;                 // query rows: row r = i * G + g
  const long cell = ((long)s * Hk + h) * bps + j;
  float* o_out = o_p + cell * R * D;
  float* l_out = l_p + cell * R;
  const int vis = visible[s];
  const int lo = j * bs;
  bool run = lo < vis + nq - 1;         // any query row sees any position?
  if (window > 0) run = run && (lo + bs > vis - window);
  if (!run) {
    for (int i = tid; i < R * D; i += nthr) o_out[i] = 0.f;
    for (int i = tid; i < R; i += nthr) l_out[i] = DL4J_NEG_INF;
    return;
  }

  extern __shared__ float smem[];
  const int Dk = D + 1;           // padded K rows: no bank conflicts on t
  float* qs = smem;               // R * D
  float* ks = qs + R * D;         // bs * Dk
  float* vs = ks + bs * Dk;       // bs * D
  float* ps = vs + bs * D;        // R * bs scores, then probabilities
  float* ms = ps + R * bs;        // R row maxima
  float* ls = ms + R;             // R row sums

  const int phys = block_tables[(long)s * bps + j];
  const float ksc = k_scale ? k_scale[(long)phys * Hk + h] : 1.f;
  const float vsc = v_scale ? v_scale[(long)phys * Hk + h] : 1.f;
  const int H = Hk * G;
  for (int i = tid; i < R * D; i += nthr) {
    const int r = i / D, d = i - r * D;
    const int qi = r / G, g = r - qi * G;
    qs[i] = to_f(q[(((long)s * nq + qi) * H + (long)h * G + g) * D + d]);
  }
  for (int i = tid; i < bs * D; i += nthr) {
    const int t = i / D, d = i - t * D;
    const long off = (((long)phys * bs + t) * Hk + h) * D + d;
    float kv = to_f(kp[off]);
    float vv = to_f(vp[off]);
    if (k_scale) kv *= ksc;
    if (v_scale) vv *= vsc;
    ks[t * Dk + d] = kv;
    vs[i] = vv;
  }
  __syncthreads();

  for (int i = tid; i < R * bs; i += nthr) {
    const int r = i / bs, t = i - r * bs;
    const float* qr = qs + r * D;
    const float* kr = ks + t * Dk;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += qr[d] * kr[d];
    ps[i] = visible_pos(lo + t, vis + r / G, window) ? acc * scale
                                                     : DL4J_NEG_INF;
  }
  __syncthreads();

  // row softmax statistics, one warp per query row
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  for (int r = warp; r < R; r += nwarps) {
    float* row = ps + r * bs;
    const int vis_r = vis + r / G;
    float m = DL4J_NEG_INF;
    for (int t = lane; t < bs; t += 32) m = fmaxf(m, row[t]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int t = lane; t < bs; t += 32) {
      const float p = visible_pos(lo + t, vis_r, window) ? expf(row[t] - m)
                                                         : 0.f;
      row[t] = p;
      l += p;
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      ms[r] = m;
      ls[r] = l;
    }
  }
  __syncthreads();

  for (int i = tid; i < R * D; i += nthr) {
    const int r = i / D, d = i - r * D;
    const float* pr = ps + r * bs;
    float acc = 0.f;
    for (int t = 0; t < bs; ++t) acc += pr[t] * vs[t * D + d];
    o_out[i] = acc / fmaxf(ls[r], 1e-30f);
  }
  for (int r = tid; r < R; r += nthr) {
    const float l = ls[r];
    l_out[r] = l > 0.f ? ms[r] + logf(fmaxf(l, 1e-30f)) : DL4J_NEG_INF;
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* bt, const int* vis, float* o_p,
           float* l_p, int S, int nq, int Hk, int G, int D, int bs, int bps,
           int window, float scale, cudaStream_t stream) {
  const int threads = 128;
  const size_t R = (size_t)nq * G;
  const size_t smem = sizeof(float) *
      (R * D + (size_t)bs * (D + 1) + (size_t)bs * D + R * bs + 2 * R);
  auto kern = flash_decode_paged_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(bps, Hk, S);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), ks, vs, bt, vis, o_p, l_p, nq, Hk, G, D,
      bs, bps, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16, 3 int8 (pool only).
// Returns a cudaError_t code (0 on success). Allocates nothing and does not
// synchronize: it launches on `stream`.
extern "C" int dl4j_flash_decode_paged(
    const void* q, const void* kp, const void* vp, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* visible,
    void* o_p, void* l_p, int S, int nq, int Hk, int G, int D, int bs,
    int bps, int window, int q_dtype, int kv_dtype, float scale,
    void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* vi = static_cast<const int*>(visible);
  float* o = static_cast<float*>(o_p);
  float* l = static_cast<float*>(l_p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq < 1) return (int)cudaErrorInvalidValue;
#define DL4J_LAUNCH(TQ, TKV)                                                 \
  return launch<TQ, TKV>(q, kp, vp, ks, vs, bt, vi, o, l, S, nq, Hk, G, D,   \
                         bs, bps, window, scale, st)
  if (kv_dtype == 3) {
    if (q_dtype == 0) DL4J_LAUNCH(float, int8_t);
    if (q_dtype == 1) DL4J_LAUNCH(__half, int8_t);
    if (q_dtype == 2) DL4J_LAUNCH(__nv_bfloat16, int8_t);
  } else if (kv_dtype == q_dtype) {
    if (q_dtype == 0) DL4J_LAUNCH(float, float);
    if (q_dtype == 1) DL4J_LAUNCH(__half, __half);
    if (q_dtype == 2) DL4J_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  }
#undef DL4J_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
