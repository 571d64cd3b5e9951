// What K7's two bf16 cluster kernels share (lstm_scan_fwd_sm90.cu, the
// forward; lstm_scan_bwd_sm90.cu, the backward sweep): a cluster of CL = 8
// CTAs owns BT = 128 batch rows, CTA k the hidden units [k U, k U + U), U =
// H / 8, and keeps their RW columns of all four gates (H x 4U bf16) in
// shared memory for the whole sequence.
//
// The slice's columns are laid out [i | f | o | g] of the same U units,
// column p of a gate holding unit unit_of(p): an m64n(4U) accumulator then
// gives every thread the i, f, o and g pre-activations of the same (row,
// unit) pairs, 2 A8 consecutive units a thread (A8 = U / 8), so the cell
// runs in registers and loads 4 A8 bytes a (row, gate).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace lstm90 {

using namespace sm90;
typedef __nv_bfloat16 bf16;

constexpr int CL = 8;            // CTAs per cluster
constexpr int BT = 128;          // batch rows per cluster
constexpr int NT = 256;          // two warpgroups of 64 rows
constexpr int TURN = 3;          // named barriers 3, 4: the cell's turns

// The RW slice of one CTA at H units: N = 4U gate columns in boxes of
// COLS, rows of RB bytes swizzled at RB.
template <int H>
struct Slice {
  static constexpr int U = H / CL;                 // units per CTA
  static constexpr int A8 = U / 8;                 // unit pairs a thread
  static constexpr int N = 4 * U;                  // gate columns per CTA
  static constexpr int COLS = N < 64 ? N : 64;     // columns of a B box
  static constexpr int RB = 2 * COLS;              // its row bytes
  static constexpr int RW_BYTES = H * N * 2;
  static_assert(U % 8 == 0 && N <= 128 && RB >= 64, "wgmma shapes");
};

// 1 / (1 + e^-x) on the special-function unit (ex2, rcp: relative error a
// few fp32 ulps, far under bf16's rounding of h and c)
__device__ __forceinline__ float sigm(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// The unit at column p of a gate's block of the RW slice: accumulator
// columns 8 a + 2 q + e (a < A8, e < 2) belong to the threads with lane % 4
// == q, and hold units 2 A8 q + 2 a + e, 2 A8 consecutive units a thread.
template <int A8>
__device__ __forceinline__ int unit_of(int p) {
  return 2 * A8 * ((p >> 1) & 3) + 2 * (p >> 3) + (p & 1);
}

// A8 words (4, 8 or 16 bytes, aligned) from global or to shared memory
template <int A8>
__device__ __forceinline__ void load_words(uint32_t (&x)[A8],
                                           const void* src) {
  if constexpr (A8 == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (A8 == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
  }
}
template <int A8>
__device__ __forceinline__ void store_words(unsigned char* dst,
                                            const uint32_t (&x)[A8]) {
  if constexpr (A8 == 4)
    *reinterpret_cast<uint4*>(dst) = make_uint4(x[0], x[1], x[2], x[3]);
  else if constexpr (A8 == 2)
    *reinterpret_cast<uint2*>(dst) = make_uint2(x[0], x[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = x[0];
}

// The high or low bf16 of a packed pair as fp32
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_half(uint32_t v, int e) {
  return e ? bf_hi(v) : bf_lo(v);
}

// The CTA's RW slice into shared memory at `sm`: (k, n) with n = gate * U +
// p, boxes of COLS columns, rows of RB bytes swizzled at RB; column p of a
// gate holds unit u0 + unit_of(p), 4 bytes (a unit pair) a copy. With
// PERMUTE_ROWS, row k holds RW's row (k / U) U + unit_of(k % U) (the
// backward's h order, see lstm_scan_bwd_sm90.cu), else row k.
template <int H, bool PERMUTE_ROWS>
__device__ __forceinline__ void load_rw_slice(unsigned char* sm,
                                              const bf16* __restrict__ rw,
                                              int u0) {
  using S = Slice<H>;
  constexpr int U = S::U, N = S::N;
  for (int q = threadIdx.x; q < H * (N / 2); q += blockDim.x) {
    const int k = q / (N / 2), n = 2 * (q % (N / 2));
    const int g = n / U, pc = n % U;
    const int kr = PERMUTE_ROWS ? (k / U) * U + unit_of<S::A8>(k % U) : k;
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        rw + (long)kr * 4 * H + g * H + u0 + unit_of<S::A8>(pc));
    const int c = n % S::COLS;
    *reinterpret_cast<uint32_t*>(
        sm + (n / S::COLS) * H * S::RB + k * S::RB +
        (((c >> 3) ^ swizzle_term<S::RB>(k)) << 4) + (c & 7) * 2) = v;
  }
}

}  // namespace lstm90
