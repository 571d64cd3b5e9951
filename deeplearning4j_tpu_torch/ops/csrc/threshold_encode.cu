// Threshold encoding of gradient updates for Hopper (sm_90a): Strom-style
// 1-bit compression with a residual (K11), fp32, bf16 and fp64, over a list
// of tensors in one launch.
//
// Replaces the Pallas kernel of deeplearning4j_tpu/ops/pallas_kernels.py
// `threshold_encode_pallas` (:325; body `_make_threshold_kernel` :313, call
// :338). Per element, in the storage dtype T:
//   acc = T(update + residual)
//   message = sign(acc) * t  where |acc| >= t, else +0
//   residual' = T(acc - message)
// t is the threshold already rounded to T by the caller (the JAX package's
// weakly typed Python float rounds the same way), passed at run time: the
// Pallas kernel compiles one kernel per threshold value. bf16 rounds acc
// to bf16 before the comparison, as the JAX package adds in bf16 before
// its kernel; nothing is widened past the storage dtype. The edges follow
// from `>=`: |acc| == t is sent; NaN is never sent and stays in the
// residual; +-inf is sent as +-t and stays +-inf; -0.0 sends +0.0 and
// keeps -0.0.
//
// What bounds it on the H100: bytes. It reads update and residual and
// writes message and residual, 4 n elt bytes (409 MB, 0.122 ms at 3.35
// TB/s, for ResNet50's 25,583,592 fp32 parameters), and does a handful of
// operations per element. A data-parallel step encodes every parameter
// tensor (214 for ResNet50, from 64 elements to 2.4 million), so one launch
// takes a table of tensors:
//   - the table (`Table`: each tensor's four pointers, n, and where its
//     chunks start in the concatenated chunk index) is a kernel parameter,
//     read through `__grid_constant__` from the parameter bank. CUDA 12.1
//     and later take 32,764 bytes of parameters; MAX_ENTRIES = 256 entries
//     make 13,320 bytes, so a step's table needs no host-to-device copy
//     (none to capture in a CUDA graph) and one launch. A longer list is
//     split over launches of MAX_ENTRIES each;
//   - CTAs walk chunks of CHUNK elements of the concatenated index space,
//     grid-stride; a CTA finds its chunk's tensor by walking the chunk
//     starts forward from the last one it found;
//   - within a chunk, where a tensor's four pointers sit at the same offset
//     from 16 bytes, a thread loads and stores 16-byte vectors (U of them
//     in flight a thread), with scalar heads and tails at the chunk's
//     edges; otherwise the chunk runs scalar. Every element takes the same
//     arithmetic on both paths.
// Measured (chip_smoke.py kernel_threshold; NVIDIA H100 80GB HBM3, 700.00
// W; fp32): the flat 25.6M-element gradient 0.146 ms (bound 0.122); a
// ResNet50 step's 214 tensors in one launch 0.146 ms by CUDA-graph replay,
// against 0.561 as 214 launches of one tensor each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;            // elements a CTA takes at a time
constexpr int MAX_ENTRIES = 256;       // tensors a launch
constexpr int MAX_BLOCKS = 132 * 8;

struct Entry {
  const void* update;
  const void* residual;
  void* msg;
  void* new_residual;
  long long n;
  int head;        // scalar elements before 16-byte alignment; -1: scalar
};

struct Table {
  Entry e[MAX_ENTRIES];
  int start[MAX_ENTRIES + 1];          // first chunk of each tensor
  int count;
};

// acc = T(u + r), returned in the compute type C (exact widening of T)
__device__ __forceinline__ float add_round(float u, float r) {
  return __fadd_rn(u, r);
}
__device__ __forceinline__ double add_round(double u, double r) {
  return __dadd_rn(u, r);
}
__device__ __forceinline__ float add_round(bf16 u, bf16 r) {
  return __bfloat162float(
      __float2bfloat16_rn(__fadd_rn(__bfloat162float(u), __bfloat162float(r))));
}

__device__ __forceinline__ float to_t(float v, float) { return v; }
__device__ __forceinline__ double to_t(double v, double) { return v; }
__device__ __forceinline__ bf16 to_t(float v, bf16) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// one element: (message, new residual) of (update, residual)
template <typename T, typename C>
__device__ __forceinline__ void encode(T u, T r, C t, T& m, T& nr) {
  const C acc = add_round(u, r);
  // |acc| >= t > 0 implies acc != 0, so sign(acc) is acc > 0 ? 1 : -1;
  // NaN fails the comparison
  const C v = fabs(acc) >= t ? (acc > C(0) ? t : -t) : C(0);
  m = to_t(v, T());
  nr = to_t(sub_rn(acc, v), T());
}

template <typename T>
union Vec16 {
  uint4 raw;
  T x[16 / sizeof(T)];
};

template <typename T, typename C>
__device__ __forceinline__ void encode_chunk(const Entry& en, long long s,
                                             long long e, C t) {
  constexpr int V = 16 / sizeof(T);
  constexpr int U = CHUNK / (THREADS * V);         // vectors a thread
  const T* __restrict__ u = static_cast<const T*>(en.update);
  const T* __restrict__ r = static_cast<const T*>(en.residual);
  T* __restrict__ m = static_cast<T*>(en.msg);
  T* __restrict__ nr = static_cast<T*>(en.new_residual);
  const int tid = threadIdx.x;
  long long vs = e, nv = 0;
  if (en.head >= 0) {                // s is a multiple of V: same offset
    vs = min(e, s + en.head);
    nv = (e - vs) / V;
  }
  const long long ts = vs + nv * V;
  // scalar head [s, vs) and tail [ts, e): fewer than V elements each,
  // unless the chunk runs scalar
  for (long long i = s + tid; i < vs; i += THREADS)
    encode(u[i], r[i], t, m[i], nr[i]);
  for (long long i = ts + tid; i < e; i += THREADS)
    encode(u[i], r[i], t, m[i], nr[i]);
  for (long long q0 = 0; q0 < nv; q0 += (long long)THREADS * U) {
    Vec16<T> a[U], b[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long q = q0 + k * THREADS + tid;
      if (q < nv) {
        a[k].raw = *reinterpret_cast<const uint4*>(u + vs + q * V);
        b[k].raw = *reinterpret_cast<const uint4*>(r + vs + q * V);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long q = q0 + k * THREADS + tid;
      if (q < nv) {
        Vec16<T> mo, ro;
#pragma unroll
        for (int l = 0; l < V; ++l)
          encode(a[k].x[l], b[k].x[l], t, mo.x[l], ro.x[l]);
        *reinterpret_cast<uint4*>(m + vs + q * V) = mo.raw;
        *reinterpret_cast<uint4*>(nr + vs + q * V) = ro.raw;
      }
    }
  }
}

template <typename T, typename C>
__global__ void __launch_bounds__(THREADS)
threshold_encode_kernel(const __grid_constant__ Table tab, C t) {
  const int chunks = tab.start[tab.count];
  int i = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (tab.start[i + 1] <= c) ++i;             // uniform across the CTA
    const Entry& en = tab.e[i];
    const long long s = (long long)(c - tab.start[i]) * CHUNK;
    const long long e = min(en.n, s + CHUNK);
    encode_chunk<T, C>(en, s, e, t);
  }
}

struct HostEntry {                     // the caller's table, one a tensor
  const void* update;
  const void* residual;
  void* msg;
  void* new_residual;
  long long n;
};

// elements of elt bytes before p is 16-byte aligned (p is elt-aligned)
int head_of(const void* p, int elt) {
  const int off = (int)(reinterpret_cast<uintptr_t>(p) & 15);
  return ((16 - off) & 15) / elt;
}

template <typename T, typename C>
int launch(const HostEntry* list, int count, double t, cudaStream_t st) {
  constexpr int elt = (int)sizeof(T);
  for (int i0 = 0; i0 < count; i0 += MAX_ENTRIES) {
    Table tab;
    tab.count = min(MAX_ENTRIES, count - i0);
    tab.start[0] = 0;
    for (int k = 0; k < tab.count; ++k) {
      const HostEntry& h = list[i0 + k];
      if (h.n <= 0) return (int)cudaErrorInvalidValue;
      const long long chunks = (h.n + CHUNK - 1) / CHUNK;
      if (tab.start[k] + chunks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
      const int hd = head_of(h.update, elt);
      const bool same = hd == head_of(h.residual, elt) &&
                        hd == head_of(h.msg, elt) &&
                        hd == head_of(h.new_residual, elt);
      tab.e[k] = {h.update, h.residual, h.msg, h.new_residual, h.n,
                  same ? hd : -1};
      tab.start[k + 1] = tab.start[k] + (int)chunks;
    }
    const int chunks = tab.start[tab.count];
    const int grid = chunks < MAX_BLOCKS ? chunks : MAX_BLOCKS;
    threshold_encode_kernel<T, C><<<grid, THREADS, 0, st>>>(tab, (C)t);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // namespace

// The most tensors one launch takes: a list of `count` makes
// ceil(count / this) launches.
extern "C" int dl4j_threshold_encode_max_entries() { return MAX_ENTRIES; }

// dtype codes: 0 float32, 2 bfloat16, 3 float64. `list` holds `count`
// tensors (host memory, read before this returns), each four pointers to n
// > 0 contiguous elements of that dtype; `t` is the threshold rounded to
// it (exactly representable in the compute type). Returns a cudaError_t
// code (0 on success); count 0 launches nothing. Allocates nothing and
// does not synchronize.
extern "C" int dl4j_threshold_encode(const void* list, int count, double t,
                                     int dtype, void* stream) {
  if (count <= 0) return 0;
  if (!(t > 0.0)) return (int)cudaErrorInvalidValue;
  const HostEntry* l = static_cast<const HostEntry*>(list);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, float>(l, count, t, st);
  if (dtype == 2) return launch<bf16, float>(l, count, t, st);
  if (dtype == 3) return launch<double, double>(l, count, t, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_threshold_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
