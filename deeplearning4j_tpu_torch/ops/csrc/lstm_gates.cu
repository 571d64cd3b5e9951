// The per-step LSTM cells for Hopper (sm_90a): the Graves peephole cell
// (K8) and the plain LSTM cell (K9), forward and backward, fp32 and bf16.
//
// Replaces the Pallas kernels of deeplearning4j_tpu/ops/pallas_kernels.py:
//   - K8 `graves_gates_pallas` (:226; bodies `_graves_gates_kernel` and
//     `_graves_gates_bwd_kernel` :184);
//   - K9 `lstm_gates_pallas` (:93; bodies `_lstm_gates_kernel` and
//     `_lstm_gates_bwd_kernel` :51).
// K9 is K8 with the peephole terms compiled out (one template, PEEP =
// false), as the JAX package's two kernels differ only by those terms.
//
// Layout: gates (B, 4H) row-major, gate order [i|f|o|g]; c, dc, dh, c_new,
// h_new, dc_prev (B, H); pi/pf/po (H,). Every input has one dtype; the
// math runs in fp32 and each output rounds once to the storage dtype.
//
// Forward: one thread per (row, column j) computes all four gates of
// column j, so the cell update needs nothing from other threads.
// Backward: blocks of 32 columns x 8 row lanes, each block over RPB rows;
// a thread recomputes the activations of its (row, j) from (gates, c),
// writes dgates and dc_prev, and (K8) sums dzi*c, dzf*c and dzo*c_new over
// its rows. The 8 row lanes of a column add their sums in a fixed order in
// shared memory and the block writes one fp32 partial per column, (3,
// blocks, H); the caller sums the partials over the blocks.
//
// What bounds it on the H100: bytes. At (B, H) = (8192, 256) in bf16 the
// forward moves 29.4 MB (gates and c read, c_new and h_new written), 8.8
// us at 3.35 TB/s, and the backward 50.3 MB, 15 us; a few dozen fp32
// operations per element are far below the card's rate. The design reads
// each input once, coalesced (neighbouring threads on neighbouring
// columns of each gate), and keeps the fp32 activations in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int COLS = 32;     // backward: columns per block
constexpr int LANES = 8;     // backward: row lanes per block
constexpr int RPB = 64;      // backward: rows per block

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename T, bool PEEP>
__global__ void __launch_bounds__(256)
gates_fwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                 const T* __restrict__ pi, const T* __restrict__ pf,
                 const T* __restrict__ po, T* __restrict__ c_new,
                 T* __restrict__ h_new, int B, int H) {
  const long n = (long)B * H;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < n;
       e += (long)gridDim.x * blockDim.x) {
    const long b = e / H;
    const int j = (int)(e - b * H);
    const T* g = gates + b * 4 * H + j;
    const float cp = ld(c + e);
    float zi = ld(g), zf = ld(g + H), zo = ld(g + 2 * H);
    const float gg = tanhf(ld(g + 3 * H));
    if (PEEP) {
      zi += cp * ld(pi + j);
      zf += cp * ld(pf + j);
    }
    const float cn = sigm(zf) * cp + sigm(zi) * gg;
    if (PEEP) zo += cn * ld(po + j);
    st(c_new + e, cn);
    st(h_new + e, sigm(zo) * tanhf(cn));
  }
}

template <typename T, bool PEEP>
__global__ void __launch_bounds__(COLS * LANES)
gates_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                 const T* __restrict__ pi, const T* __restrict__ pf,
                 const T* __restrict__ po, const T* __restrict__ dc,
                 const T* __restrict__ dh, T* __restrict__ dgates,
                 T* __restrict__ dcprev, float* __restrict__ partials, int B,
                 int H) {
  __shared__ float red[3][LANES][COLS];
  const int tx = threadIdx.x % COLS, ty = threadIdx.x / COLS;
  const int j = blockIdx.x * COLS + tx;
  const int r0 = blockIdx.y * RPB;
  const int r1 = min(B, r0 + RPB);
  float spi = 0.f, spf = 0.f, spo = 0.f;
  if (j < H) {
    const float wi = PEEP ? ld(pi + j) : 0.f;
    const float wf = PEEP ? ld(pf + j) : 0.f;
    const float wo = PEEP ? ld(po + j) : 0.f;
    for (int b = r0 + ty; b < r1; b += LANES) {
      const long e = (long)b * H + j;
      const T* g = gates + (long)b * 4 * H + j;
      const float cp = ld(c + e), dcn = ld(dc + e), dhv = ld(dh + e);
      const float i = sigm(ld(g) + cp * wi);
      const float f = sigm(ld(g + H) + cp * wf);
      const float gg = tanhf(ld(g + 3 * H));
      const float cn = f * cp + i * gg;
      const float o = sigm(ld(g + 2 * H) + cn * wo);
      const float t = tanhf(cn);
      const float dzo = dhv * t * o * (1.f - o);
      const float dct = dcn + dhv * o * (1.f - t * t) + dzo * wo;
      const float dzi = dct * gg * i * (1.f - i);
      const float dzf = dct * cp * f * (1.f - f);
      const float dzg = dct * i * (1.f - gg * gg);
      T* dg = dgates + (long)b * 4 * H + j;
      st(dg, dzi);
      st(dg + H, dzf);
      st(dg + 2 * H, dzo);
      st(dg + 3 * H, dzg);
      st(dcprev + e, dct * f + dzi * wi + dzf * wf);
      if (PEEP) {
        spi += dzi * cp;
        spf += dzf * cp;
        spo += dzo * cn;
      }
    }
  }
  if (!PEEP) return;
  red[0][ty][tx] = spi;
  red[1][ty][tx] = spf;
  red[2][ty][tx] = spo;
  __syncthreads();
  if (ty < 3 && j < H) {
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < LANES; ++l) s += red[ty][l][tx];
    partials[((long)ty * gridDim.y + blockIdx.y) * H + j] = s;
  }
}

int blocks_of(int B) { return (B + RPB - 1) / RPB; }

template <typename T>
int launch_fwd(const void* gates, const void* c, const void* pi,
               const void* pf, const void* po, void* c_new, void* h_new,
               int B, int H, cudaStream_t st) {
  const long n = (long)B * H;
  const int grid = (int)((n + 255) / 256 < 65535 * 16 ? (n + 255) / 256
                                                       : 65535 * 16);
  const T* g = static_cast<const T*>(gates);
  const T* cc = static_cast<const T*>(c);
  if (pi) {
    gates_fwd_kernel<T, true><<<grid, 256, 0, st>>>(
        g, cc, static_cast<const T*>(pi), static_cast<const T*>(pf),
        static_cast<const T*>(po), static_cast<T*>(c_new),
        static_cast<T*>(h_new), B, H);
  } else {
    gates_fwd_kernel<T, false><<<grid, 256, 0, st>>>(
        g, cc, nullptr, nullptr, nullptr, static_cast<T*>(c_new),
        static_cast<T*>(h_new), B, H);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* gates, const void* c, const void* pi,
               const void* pf, const void* po, const void* dc,
               const void* dh, void* dgates, void* dcprev, float* partials,
               int B, int H, cudaStream_t st) {
  dim3 grid((H + COLS - 1) / COLS, blocks_of(B));
  const T* g = static_cast<const T*>(gates);
  const T* cc = static_cast<const T*>(c);
  const T* dcc = static_cast<const T*>(dc);
  const T* dhh = static_cast<const T*>(dh);
  if (pi) {
    if (!partials) return (int)cudaErrorInvalidValue;
    gates_bwd_kernel<T, true><<<grid, COLS * LANES, 0, st>>>(
        g, cc, static_cast<const T*>(pi), static_cast<const T*>(pf),
        static_cast<const T*>(po), dcc, dhh, static_cast<T*>(dgates),
        static_cast<T*>(dcprev), partials, B, H);
  } else {
    gates_bwd_kernel<T, false><<<grid, COLS * LANES, 0, st>>>(
        g, cc, nullptr, nullptr, nullptr, dcc, dhh, static_cast<T*>(dgates),
        static_cast<T*>(dcprev), nullptr, B, H);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16. pi/pf/po null selects K9 (no
// peepholes), non-null K8. Return a cudaError_t code (0 on success); they
// allocate nothing and do not synchronize.
extern "C" int dl4j_lstm_gates_fwd(const void* gates, const void* c,
                                   const void* pi, const void* pf,
                                   const void* po, void* c_new, void* h_new,
                                   int B, int H, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if ((pi == nullptr) != (pf == nullptr) || (pi == nullptr) != (po == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(gates, c, pi, pf, po, c_new, h_new, B, H, st);
  if (dtype == 2)
    return launch_fwd<bf16>(gates, c, pi, pf, po, c_new, h_new, B, H, st);
  return (int)cudaErrorInvalidValue;
}

// Rows of blocks of the backward: the `partials` argument of K8's backward
// holds (3, dl4j_lstm_gates_blocks(B), H) floats.
extern "C" int dl4j_lstm_gates_blocks(int B) { return blocks_of(B); }

extern "C" int dl4j_lstm_gates_bwd(const void* gates, const void* c,
                                   const void* pi, const void* pf,
                                   const void* po, const void* dc,
                                   const void* dh, void* dgates, void* dcprev,
                                   void* partials, int B, int H, int dtype,
                                   void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if ((pi == nullptr) != (pf == nullptr) || (pi == nullptr) != (po == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  if (dtype == 0)
    return launch_bwd<float>(gates, c, pi, pf, po, dc, dh, dgates, dcprev, p,
                             B, H, st);
  if (dtype == 2)
    return launch_bwd<bf16>(gates, c, pi, pf, po, dc, dh, dgates, dcprev, p,
                            B, H, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_lstm_gates_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
