// Threshold encoding of a gradient update for Hopper (sm_90a): Strom-style
// 1-bit compression with a residual (K11), fp32, bf16 and fp64.
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
// operations per element. The design is one grid-stride loop, neighbouring
// threads on neighbouring elements, each input read once: a simple kernel
// first; wider loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;   // 16 resident blocks on each SM

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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

template <typename T, typename C>
__global__ void __launch_bounds__(THREADS)
threshold_encode_kernel(const T* __restrict__ update,
                        const T* __restrict__ residual, T* __restrict__ msg,
                        T* __restrict__ new_residual, long long n, C t) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const C acc = add_round(update[i], residual[i]);
    // |acc| >= t > 0 implies acc != 0, so sign(acc) is acc > 0 ? 1 : -1;
    // NaN fails the comparison
    const C m = fabs(acc) >= t ? (acc > C(0) ? t : -t) : C(0);
    store(msg + i, m);
    store(new_residual + i, sub_rn(acc, m));
  }
}

template <typename T, typename C>
int launch(const void* update, const void* residual, void* msg,
           void* new_residual, long long n, double t, cudaStream_t st) {
  const long long want = (n + THREADS - 1) / THREADS;
  const int grid = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  threshold_encode_kernel<T, C><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(update), static_cast<const T*>(residual),
      static_cast<T*>(msg), static_cast<T*>(new_residual), n, (C)t);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16, 3 float64. Every pointer holds n
// contiguous elements of that dtype; `t` is the threshold rounded to it
// (exactly representable in the compute type). Returns a cudaError_t code
// (0 on success); n <= 0 launches nothing. Allocates nothing and does not
// synchronize.
extern "C" int dl4j_threshold_encode(const void* update, const void* residual,
                                     void* msg, void* new_residual,
                                     long long n, double t, int dtype,
                                     void* stream) {
  if (n <= 0) return 0;
  if (!(t > 0.0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(update, residual, msg, new_residual, n, t, st);
  if (dtype == 2)
    return launch<bf16, float>(update, residual, msg, new_residual, n, t, st);
  if (dtype == 3)
    return launch<double, double>(update, residual, msg, new_residual, n, t,
                                  st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_threshold_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
