// What the split-K decode sources share: the element conversions, warp
// reductions, the ticket that elects the CTA which merges a (slot, kv head),
// and that merge. Included by flash_decode_contiguous.cu (K6) and
// flash_decode_paged.cu (K1, K2).
//
// The merge protocol: every CTA with work writes its normalized partial
// o_p (R, D) and L_p = m + log l (R) to scratch, then takes a ticket on its
// (slot, kv head) (`last_ticket`). The CTA that draws the last of `count`
// tickets reads the partials of every partition in partition order
// (`merge_partitions`), so the output does not depend on which CTA finishes
// last, and puts the ticket back to 0 for the next launch. The caller keeps
// one ticket buffer per stream and per CUDA graph capture
// (`dl4j_capture_id`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DL4J_NEG_INF (-1e30f)

namespace dl4j_decode {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Called by every thread of the CTA once its partial is written: true in
// the CTA that drew the last of `count` tickets, which has put the ticket
// back to 0. `flag` is an int of shared memory.
__device__ __forceinline__ bool last_ticket(int* ticket, int count,
                                            int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1) == count - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;
  return true;
}

// Logaddexp merge of partitions j0 .. j1-1 of one (slot, kv head): lb the
// L_p (np, R) and ob the o_p (np, R, D) of its partitions, fp32, written in
// this launch by other CTAs (read through L2). Row r = i * G + g goes to
// out + i * qstride + g * D. A partition a row cannot see carries L_p =
// NEG_INF and o_p = 0 and adds exact zeros. With one output element a
// thread (K1 and K6 at the served shapes), each element forms its weights
// w = exp(L_p - max) and their sum itself. With more, where (j1 - j0 + 1)
// R floats fit the `cap` floats of `ws` (shared memory the CTA no longer
// needs), the weights and sums are formed once a row there, and each
// thread sums E output elements at once over U partitions a step, their
// loads in flight together. Both give the same bits: the same max, and the
// same sums in partition order.
template <typename T, int NT, int E, int U>
__device__ __forceinline__ void merge_partitions(const float* lb,
                                                 const float* ob, T* out,
                                                 int R, int G, long qstride,
                                                 int D, int j0, int j1,
                                                 float* ws, int cap) {
  const int n = j1 - j0;
  if (R * D > NT && (n + 1) * R <= cap) {
    float* den = ws + n * R;
    for (int i = threadIdx.x; i < n * R; i += NT)
      ws[i] = __ldcg(lb + j0 * R + i);
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += NT) {
      float mx = DL4J_NEG_INF;
      for (int jj = 0; jj < n; ++jj) mx = fmaxf(mx, ws[jj * R + r]);
      float d = 0.f;
      for (int jj = 0; jj < n; ++jj) {
        const float w = expf(ws[jj * R + r] - mx);
        ws[jj * R + r] = w;
        d += w;
      }
      den[r] = d;
    }
    __syncthreads();
    for (int base = threadIdx.x; base < R * D; base += E * NT) {
      float acc[E];
      int row[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[e] = 0.f;
        row[e] = (base + e * NT) / D;
      }
#pragma unroll U
      for (int jj = 0; jj < n; ++jj) {
        const float* o = ob + (long)(j0 + jj) * R * D + base;
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (base + e * NT < R * D)
            acc[e] = fmaf(ws[jj * R + row[e]], __ldcg(o + e * NT), acc[e]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = base + e * NT, qi = row[e] / G;
        if (i < R * D)
          out[qi * qstride + (i - qi * G * D)] =
              from_f<T>(acc[e] / den[row[e]]);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D;
    float mx = DL4J_NEG_INF;
    for (int jj = j0; jj < j1; ++jj) mx = fmaxf(mx, __ldcg(lb + jj * R + r));
    float den = 0.f, acc = 0.f;
    for (int jj = j0; jj < j1; ++jj) {
      const float w = expf(__ldcg(lb + jj * R + r) - mx);
      den += w;
      acc = fmaf(w, __ldcg(ob + (long)jj * R * D + i), acc);
    }
    const int qi = r / G;
    out[qi * qstride + (i - qi * G * D)] = from_f<T>(acc / den);
  }
}

}  // namespace dl4j_decode

// The id of the CUDA graph capture under way on `stream`, 0 when none: the
// caller keeps one ticket buffer per capture, zeroed inside the graph.
extern "C" unsigned long long dl4j_capture_id(void* stream) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               &id) != cudaSuccess)
    return 0;
  return status == cudaStreamCaptureStatusActive ? id : 0;
}
