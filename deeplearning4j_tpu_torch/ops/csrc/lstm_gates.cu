// The per-step LSTM cells for Hopper (sm_90a): the Graves peephole cell
// (K8) and the plain LSTM cell (K9), forward and backward, fp32 and bf16.
//
// Replaces the Pallas kernels of deeplearning4j_tpu/ops/pallas_kernels.py:
//   - K8 `graves_gates_pallas` (:226; bodies `_graves_gates_kernel` :164
//     and `_graves_gates_bwd_kernel` :184);
//   - K9 `lstm_gates_pallas` (:93; bodies `_lstm_gates_kernel` and
//     `_lstm_gates_bwd_kernel` :51).
// K9 is K8 with the peephole terms compiled out (one template, PEEP =
// false), as the JAX package's two kernels differ only by those terms.
//
// Layout: gates (B, 4H) row-major, gate order [i|f|o|g]; c, dc, dh, c_new,
// h_new, dc_prev (B, H); pi/pf/po and dpi/dpf/dpo (H,). Every input has one
// dtype; the math runs in fp32 and each output rounds once to the storage
// dtype, with the closed forms of the JAX package's kernels.
//
// What bounds it on the H100: bytes. At (B, H) = (8192, 256) in bf16 the
// forward moves 29.4 MB (gates and c read, c_new and h_new written), 8.8
// us at 3.35 TB/s, and the backward 50.3 MB, 15 us; a few dozen fp32
// operations per element are far below the card's rate. So the design
// reads each input once in 16-byte loads and writes each output once in
// 16-byte stores:
//   - a thread takes V neighbouring columns of one row (V = 8 in bf16, 4 in
//     fp32), neighbouring threads neighbouring column groups, and loads
//     each gate slice, c, dc and dh as one 16-byte vector; the peephole
//     vectors are read once a thread. Where H is not a multiple of V or a
//     pointer is not 16-byte aligned, the caller asks for the scalar path
//     of the same template (V = 1, 2- or 4-byte accesses);
//   - forward: one (row, column group) a thread, grid-stride;
//   - backward: a CTA is CV column groups x LANES row lanes (256 threads)
//     over RPB = 128 rows in K8 (RPB_K9 = 64 in K9, which then has twice
//     the CTAs in flight), RPB / LANES a thread. It writes dgates and dc_prev
//     and (K8) sums dzi*c, dzf*c and dzo*c_new over its rows: each thread
//     over its rows in order, then the row lanes in lane order through
//     shared memory, one fp32 partial per column to `partials` (3, row
//     blocks, H). The CTA then takes a ticket on its column block
//     (`last_ticket`, flash_decode_common.cuh); the one that draws the
//     last sums the row blocks' partials (row block l, l + LANES, ... per
//     lane, then the lanes in order), writes dpi/dpf/dpo in the storage
//     dtype, rounding once, and puts the ticket back to 0. So the
//     backward is one launch, and its sums run in a fixed order: two
//     calls give the same bits. The caller keeps the zeroed tickets per
//     stream and per CUDA graph capture (`dl4j_capture_id`).
//
// Measured (experiments/torch_lstm_gates_ab.py; NVIDIA H100 80GB HBM3,
// 700.00 W; (8192, 256) bf16, CUDA-graph replay): K8 0.0110 ms forward,
// 0.0256 backward (the one-element-a-thread design before it: 0.0162,
// 0.0455 with its torch sum); K9 0.0105, 0.0188. What holds K8's backward
// above K9's: its peephole epilogue (~2.2 us: each thread's fence drains
// its dgates stores before the ticket) and the last CTA's sum over the
// row blocks (~1.8 us); without both it runs 0.0216.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_decode_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int RPB = 128;     // backward: rows per CTA, K8
constexpr int RPB_K9 = 64;   // and K9, which sums nothing across rows
constexpr int MIN_COLS = 32; // backward: fewest columns a CTA covers

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

// V elements of T as loaded from p (one 16-byte load when V > 1, so p
// 16-byte aligned), read as fp32 one at a time: the registers hold the
// stored bits, 16 bytes a vector, and not V floats.
template <typename T, int V>
struct In;
template <int V>
struct In<float, V> {
  float x[V];
  __device__ __forceinline__ explicit In(const float* p) {
    if constexpr (V == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p);
      x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) x[k] = p[k];
    }
  }
  __device__ __forceinline__ float operator[](int k) const { return x[k]; }
};
template <int V>
struct In<bf16, V> {
  uint32_t w[(V + 1) / 2];
  __device__ __forceinline__ explicit In(const bf16* p) {
    if constexpr (V == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else {
#pragma unroll
      for (int k = 0; k < V; k += 2)
        w[k / 2] = __bfloat16_as_ushort(p[k]) |
                   (k + 1 < V ? (uint32_t)__bfloat16_as_ushort(p[k + 1]) << 16
                              : 0u);
    }
  }
  // bf16 -> fp32 is exact: the bits shifted up
  __device__ __forceinline__ float operator[](int k) const {
    return __uint_as_float(k & 1 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16);
  }
};

// V fp32 values, each rounded once to T as it is set (in order k = 0, 1,
// ...), stored at p by one 16-byte store when V > 1.
template <typename T, int V>
struct Out;
template <int V>
struct Out<float, V> {
  float x[V];
  __device__ __forceinline__ void set(int k, float v) { x[k] = v; }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) p[k] = x[k];
    }
  }
};
template <int V>
struct Out<bf16, V> {
  uint32_t w[(V + 1) / 2];
  float lo;
  __device__ __forceinline__ void set(int k, float v) {
    if (k & 1) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(lo, v);
      w[k / 2] = *reinterpret_cast<const uint32_t*>(&h);
    } else if (k + 1 < V) {
      lo = v;
    } else {
      w[k / 2] = __bfloat16_as_ushort(__float2bfloat16(v));
    }
  }
  __device__ __forceinline__ void store(bf16* p) const {
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        p[k] = __ushort_as_bfloat16(
            (unsigned short)(k & 1 ? w[k / 2] >> 16 : w[k / 2] & 0xffffu));
    }
  }
};

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int V, bool PEEP>
__global__ void __launch_bounds__(THREADS)
gates_fwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                 const T* __restrict__ pi, const T* __restrict__ pf,
                 const T* __restrict__ po, T* __restrict__ c_new,
                 T* __restrict__ h_new, int B, int H) {
  const int HV = H / V;
  const int n = B * HV;
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < n;
       e += gridDim.x * THREADS) {
    const int b = e / HV;
    const int j = (e - b * HV) * V;
    const T* g = gates + (long)b * 4 * H + j;
    const long o = (long)b * H + j;
    const In<T, V> zi(g), zf(g + H), zo(g + 2 * H), zg(g + 3 * H), cp(c + o);
    // K9 reads no peepholes: these loads are dead there
    const In<T, V> wi(PEEP ? pi + j : g), wf(PEEP ? pf + j : g),
        wo(PEEP ? po + j : g);
    Out<T, V> cn, hn;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float a = zi[k], f = zf[k], og = zo[k];
      const float gg = tanhf(zg[k]);
      if (PEEP) {
        a += cp[k] * wi[k];
        f += cp[k] * wf[k];
      }
      const float c1 = sigm(f) * cp[k] + sigm(a) * gg;
      if (PEEP) og += c1 * wo[k];
      cn.set(k, c1);
      hn.set(k, sigm(og) * tanhf(c1));
    }
    cn.store(c_new + o);
    hn.store(h_new + o);
  }
}

// The fixed-order sum over the LANES row lanes of red[3][LANES][W]: value
// (p, col) to out(p, column blockIdx.x * W + col) where that column < H.
template <int LANES, int W, typename F>
__device__ __forceinline__ void sum_lanes(float (*red)[LANES][W], int H,
                                          F out) {
  for (int q = threadIdx.x; q < 3 * W; q += THREADS) {
    const int p = q / W, col = q - p * W;
    const int jj = blockIdx.x * W + col;
    float s = 0.f;
#pragma unroll 8
    for (int l = 0; l < LANES; ++l) s += red[p][l][col];
    if (jj < H) out(p, jj, s);
  }
}

// Backward. CTA: CV column groups of V columns x LANES row lanes.
template <typename T, int V, int CV, bool PEEP>
__global__ void __launch_bounds__(THREADS, 2)
gates_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                 const T* __restrict__ pi, const T* __restrict__ pf,
                 const T* __restrict__ po, const T* __restrict__ dc,
                 const T* __restrict__ dh, T* __restrict__ dgates,
                 T* __restrict__ dcprev, float* __restrict__ partials,
                 int* __restrict__ tickets, T* __restrict__ dp, int B,
                 int H) {
  constexpr int LANES = THREADS / CV;
  constexpr int W = CV * V;                      // columns of the CTA
  constexpr int R = PEEP ? RPB : RPB_K9;
  static_assert(R % LANES == 0, "whole rows a lane");
  const int tx = threadIdx.x % CV, ty = threadIdx.x / CV;
  const int j = blockIdx.x * W + tx * V;
  const int r0 = blockIdx.y * R;
  const int r1 = min(B, r0 + R);
  float si[V], sf[V], so[V];
#pragma unroll
  for (int k = 0; k < V; ++k) si[k] = sf[k] = so[k] = 0.f;
  if (j < H) {                       // V > 1: H % V == 0, so all V columns
    // K9 reads no peepholes: these loads are dead there
    const In<T, V> wi(PEEP ? pi + j : c), wf(PEEP ? pf + j : c),
        wo(PEEP ? po + j : c);
    for (int b = r0 + ty; b < r1; b += LANES) {
      const long o = (long)b * H + j;
      const T* g = gates + (long)b * 4 * H + j;
      const In<T, V> zi(g), zf(g + H), zo(g + 2 * H), zg(g + 3 * H),
          cp(c + o), dcn(dc + o), dhv(dh + o);
      Out<T, V> gi, gf, go, gg, gc;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float i = sigm(PEEP ? zi[k] + cp[k] * wi[k] : zi[k]);
        const float f = sigm(PEEP ? zf[k] + cp[k] * wf[k] : zf[k]);
        const float g2 = tanhf(zg[k]);
        const float cn = f * cp[k] + i * g2;
        const float o2 = sigm(PEEP ? zo[k] + cn * wo[k] : zo[k]);
        const float t = tanhf(cn);
        const float dzo = dhv[k] * t * o2 * (1.f - o2);
        float dct = dcn[k] + dhv[k] * o2 * (1.f - t * t);
        if (PEEP) dct += dzo * wo[k];
        const float dzi = dct * g2 * i * (1.f - i);
        const float dzf = dct * cp[k] * f * (1.f - f);
        gi.set(k, dzi);
        gf.set(k, dzf);
        go.set(k, dzo);
        gg.set(k, dct * i * (1.f - g2 * g2));
        gc.set(k, PEEP ? dct * f + dzi * wi[k] + dzf * wf[k] : dct * f);
        if (PEEP) {
          si[k] += dzi * cp[k];
          sf[k] += dzf * cp[k];
          so[k] += dzo * cn;
        }
      }
      T* dg = dgates + (long)b * 4 * H + j;
      gi.store(dg);
      gf.store(dg + H);
      go.store(dg + 2 * H);
      gg.store(dg + 3 * H);
      gc.store(dcprev + o);
    }
  }
  if constexpr (PEEP) {
    __shared__ float red[3][LANES][W];
    __shared__ int last;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][ty][tx * V + k] = si[k];
      red[1][ty][tx * V + k] = sf[k];
      red[2][ty][tx * V + k] = so[k];
    }
    __syncthreads();
    const int nrb = gridDim.y;
    auto to_partials = [&](int p, int jj, float s) {
      partials[((long)p * nrb + blockIdx.y) * H + jj] = s;
    };
    sum_lanes<LANES, W>(red, H, to_partials);
    if (!dl4j_decode::last_ticket(tickets + blockIdx.x, nrb, &last)) return;
    // the last CTA of the column block: lane l sums row blocks l, l +
    // LANES, ... of every column in order, then the lanes in order. A
    // thread holds IT items (p, lane, Q neighbouring columns), 6 in bf16, 3
    // in fp32 and on the scalar path, their loads in flight together (Q =
    // 4 columns, one 16-byte load, on the 16-byte path: there H % 4 == 0).
    constexpr int Q = V >= 4 ? 4 : 1, WQ = W / Q;
    constexpr int IT = 3 * LANES * WQ / THREADS;
    static_assert(IT * THREADS == 3 * LANES * WQ, "whole items a thread");
    float s[IT][Q];
#pragma unroll
    for (int i = 0; i < IT; ++i)
#pragma unroll
      for (int k = 0; k < Q; ++k) s[i][k] = 0.f;
#pragma unroll 4
    for (int rr = 0; rr < nrb; rr += LANES) {
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const int q = threadIdx.x + i * THREADS;
        const int quad = q % WQ, l = (q / WQ) % LANES, p = q / (WQ * LANES);
        const int jj = blockIdx.x * W + quad * Q;
        if (rr + l >= nrb || jj >= H) continue;
        const float* src = partials + ((long)p * nrb + rr + l) * H + jj;
        if constexpr (Q == 4) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(src));
          s[i][0] += v.x, s[i][1] += v.y, s[i][2] += v.z, s[i][3] += v.w;
        } else {
          s[i][0] += __ldcg(src);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int q = threadIdx.x + i * THREADS;
      const int quad = q % WQ, l = (q / WQ) % LANES, p = q / (WQ * LANES);
#pragma unroll
      for (int k = 0; k < Q; ++k) red[p][l][quad * Q + k] = s[i][k];
    }
    __syncthreads();
    auto to_dp = [&](int p, int jj, float v) { st1(dp + p * H + jj, v); };
    sum_lanes<LANES, W>(red, H, to_dp);
  }
}

template <typename T>
constexpr int vec_of() {
  return 16 / (int)sizeof(T);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int V>
void fwd_at(const T* g, const T* c, const T* pi, const T* pf, const T* po,
            T* cn, T* hn, int B, int H, cudaStream_t st) {
  const int n = B * (H / V);
  const int want = (n + THREADS - 1) / THREADS;
  const int grid = want < 132 * 64 ? want : 132 * 64;
  if (pi)
    gates_fwd_kernel<T, V, true><<<grid, THREADS, 0, st>>>(g, c, pi, pf, po,
                                                           cn, hn, B, H);
  else
    gates_fwd_kernel<T, V, false><<<grid, THREADS, 0, st>>>(
        g, c, nullptr, nullptr, nullptr, cn, hn, B, H);
}

template <typename T, int V, int CV>
void bwd_at(const T* g, const T* c, const T* pi, const T* pf, const T* po,
            const T* dc, const T* dh, T* dg, T* dcp, float* partials,
            int* tickets, T* dp, int B, int H, cudaStream_t st) {
  constexpr int W = CV * V;
  static_assert(W >= MIN_COLS, "tickets count column blocks of MIN_COLS");
  const int R = pi ? RPB : RPB_K9;
  dim3 grid((H + W - 1) / W, (B + R - 1) / R);
  if (pi)
    gates_bwd_kernel<T, V, CV, true><<<grid, THREADS, 0, st>>>(
        g, c, pi, pf, po, dc, dh, dg, dcp, partials, tickets, dp, B, H);
  else
    gates_bwd_kernel<T, V, CV, false><<<grid, THREADS, 0, st>>>(
        g, c, nullptr, nullptr, nullptr, dc, dh, dg, dcp, nullptr, nullptr,
        nullptr, B, H);
}

// 16-byte path: 8 column groups x 32 row lanes (a warp reads 8 x 16 = 128
// contiguous bytes of each of 4 rows); scalar path: 32 columns x 8 lanes.
template <typename T>
int launch_fwd(const void* gates, const void* c, const void* pi,
               const void* pf, const void* po, void* c_new, void* h_new,
               int B, int H, int vec, cudaStream_t st) {
  auto* g = static_cast<const T*>(gates);
  auto* cc = static_cast<const T*>(c);
  auto* a = static_cast<const T*>(pi);
  auto* f = static_cast<const T*>(pf);
  auto* o = static_cast<const T*>(po);
  if (vec)
    fwd_at<T, vec_of<T>()>(g, cc, a, f, o, static_cast<T*>(c_new),
                           static_cast<T*>(h_new), B, H, st);
  else
    fwd_at<T, 1>(g, cc, a, f, o, static_cast<T*>(c_new),
                 static_cast<T*>(h_new), B, H, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* gates, const void* c, const void* pi,
               const void* pf, const void* po, const void* dc,
               const void* dh, void* dgates, void* dcprev, void* partials,
               void* tickets, void* dp, int B, int H, int vec,
               cudaStream_t st) {
  auto* g = static_cast<const T*>(gates);
  auto* cc = static_cast<const T*>(c);
  auto* a = static_cast<const T*>(pi);
  auto* f = static_cast<const T*>(pf);
  auto* o = static_cast<const T*>(po);
  auto* d1 = static_cast<const T*>(dc);
  auto* d2 = static_cast<const T*>(dh);
  auto* p = static_cast<float*>(partials);
  auto* tk = static_cast<int*>(tickets);
  if (vec)
    bwd_at<T, vec_of<T>(), 8>(g, cc, a, f, o, d1, d2, static_cast<T*>(dgates),
                              static_cast<T*>(dcprev), p, tk,
                              static_cast<T*>(dp), B, H, st);
  else
    bwd_at<T, 1, 32>(g, cc, a, f, o, d1, d2, static_cast<T*>(dgates),
                     static_cast<T*>(dcprev), p, tk, static_cast<T*>(dp), B,
                     H, st);
  return (int)cudaGetLastError();
}

// cudaErrorInvalidValue where the arguments do not make a call: peepholes
// all given or none, the sizes in 32-bit indexing, and for the 16-byte
// path H a multiple of the vector width and every pointer aligned.
int refuse(const void* const* ptrs, int n, const void* pi, const void* pf,
           const void* po, int B, int H, int vec, int dtype) {
  if ((pi == nullptr) != (pf == nullptr) || (pi == nullptr) != (po == nullptr))
    return 1;
  if ((long)B * 4 * H > 0x7fffffffL || (dtype != 0 && dtype != 2)) return 1;
  if (!vec) return 0;
  if (H % (dtype == 0 ? vec_of<float>() : vec_of<bf16>())) return 1;
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i])) return 1;
  return 0;
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16. pi/pf/po null selects K9 (no
// peepholes), non-null K8. vec 1 asks for the 16-byte path (H a multiple of
// 16 bytes' elements, every pointer 16-byte aligned), 0 for the scalar
// path. Return a cudaError_t code (0 on success); they allocate nothing and
// do not synchronize.
extern "C" int dl4j_lstm_gates_fwd(const void* gates, const void* c,
                                   const void* pi, const void* pf,
                                   const void* po, void* c_new, void* h_new,
                                   int B, int H, int dtype, int vec,
                                   void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const void* ptrs[] = {gates, c, pi, pf, po, c_new, h_new};
  if (refuse(ptrs, 7, pi, pf, po, B, H, vec, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(gates, c, pi, pf, po, c_new, h_new, B, H, vec,
                             st);
  return launch_fwd<bf16>(gates, c, pi, pf, po, c_new, h_new, B, H, vec, st);
}

// The backward's scratch: K8 takes `partials` of 3 x dl4j_lstm_gates_blocks(B)
// x H floats and `tickets` of dl4j_lstm_gates_tickets(H) zeroed ints (each
// launch leaves them zeroed), and writes dpi, dpf, dpo to dp (3, H).
extern "C" int dl4j_lstm_gates_blocks(int B) { return (B + RPB - 1) / RPB; }
extern "C" int dl4j_lstm_gates_tickets(int H) {
  return (H + MIN_COLS - 1) / MIN_COLS;
}

extern "C" int dl4j_lstm_gates_bwd(const void* gates, const void* c,
                                   const void* pi, const void* pf,
                                   const void* po, const void* dc,
                                   const void* dh, void* dgates, void* dcprev,
                                   void* partials, void* tickets, void* dp,
                                   int B, int H, int dtype, int vec,
                                   void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const void* ptrs[] = {gates, c, pi, pf, po, dc, dh, dgates, dcprev};
  if (refuse(ptrs, 9, pi, pf, po, B, H, vec, dtype) ||
      (pi && (!partials || !tickets || !dp)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(gates, c, pi, pf, po, dc, dh, dgates, dcprev,
                             partials, tickets, dp, B, H, vec, st);
  return launch_bwd<bf16>(gates, c, pi, pf, po, dc, dh, dgates, dcprev,
                          partials, tickets, dp, B, H, vec, st);
}

extern "C" const char* dl4j_lstm_gates_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
