// Flash attention on Hopper's wgmma and TMA (sm_90a) for bf16 inputs: the
// forward (K3), both passes of the two-pass backward (K5) and the fused
// backward (K4). fp32 inputs stay with flash_attention.cu.
//
// Replaces the Pallas kernels of deeplearning4j_tpu/ops/flash_attention.py:
//   - flash_fwd_sm90_kernel: K3, `_call_fwd` (:448) with body `_fwd_kernel`
//     (:123): the online-softmax forward, o and the row log-sum-exp L;
//   - flash_dq_sm90_kernel: K5's dq pass, `_dq_kernel` (:262);
//   - flash_dkv_sm90_kernel: K5's dk/dv pass, `_dkv_kernel` (:301);
//   - flash_bwd_fused_sm90_kernel: K4, `_fused_bwd_kernel` (:349): the
//     dk/dv pass that also forms dq, one launch.
// Layout: q (B*H, T, D), k/v (B*Hk, T, D) bf16 row-major; L and D_i
// (B*H, T) fp32; key mask (B, T) int32 or null; dq (B*H, T, D) fp32, dk/dv
// bf16. Query head h reads kv row b*Hk + h / (H/Hk) (GQA, forward only).
// They compute what the wmma kernels they replace computed, under the same
// masks and at the same rounding points: scores in fp32 scaled after the
// dot, p masked before the exp, p rounded to bf16 for P V and dv, dS =
// p (dP - D_i) rounded to bf16 for dq and dk (:153, :331), every sum in
// fp32, o = acc / l and dk = scale dS^T q rounded to bf16 once at the end.
// Rows with no visible key give o = 0 and L = NEG_INF (:161-169). The
// exponentials are taken base 2 with the scale folded in, exp(scale s -
// m) = 2^(s scale log2(e) - m log2(e)), on the MUFU unit (ex2.approx).
//
// What bounds them on the H100: operations. At the training shape (B*H
// 16, T 8192, D 64, causal, 33,558,528 visible pairs per head) the forward
// does 2 products over the visible pairs, 137.5 GFLOP: 0.139 ms at 989
// TFLOP/s of bf16 tensor cores, against 0.020 ms for its bytes at 3.35
// TB/s. The backward's function is 5 products (0.347 ms): K4 does those 5,
// the two-pass design recomputes S and dP in its second pass, 7 (0.486
// ms). Beside the tensor cores, the exponentials: one per visible pair and
// pass, at 16 a clock per SM, take as long as the forward's two products
// at D 64. K4 also sums dq across the CTAs of a head in L2 (below).
//
// What the design does about it: every product is a warpgroup wgmma with
// fp32 accumulators in registers, and nothing else goes through shared
// memory but K4's dS and dq. Each CTA has two consumer warpgroups of 64
// rows and a producer warpgroup, of which one warp loads (and in K4 a
// second hands dq to the TMA unit); setmaxnreg moves registers from the
// producer (40) to the consumers (232). The producer
// streams the tiles of the inner loop by TMA into a three-stage ring of
// swizzled shared-memory tiles (a "full" and an "empty" mbarrier per
// stage), so the next tile loads while this one is multiplied; the fixed
// operand of the CTA is loaded once. The consumers run these shapes of
// product:
//   - "SS": both operands in shared memory, both K-major (the head dim
//     contiguous): S = Q K^T, dP = dO V^T, and transposed S^T = K Q^T,
//     dP^T = V dO^T;
//   - "RS": A from registers, B from shared memory with N = D contiguous
//     (wgmma's transpose bit, no transpose pass): O += P V, dq += dS K,
//     dv += P^T dO, dk += dS^T Q;
//   - K4's dq only, "SS" with both operands MN-major (DqPath).
// An fp32 accumulator of m64nN wgmma holds, in thread t of the warpgroup
// (warp w, lane l), rows 16w + l/4 (+8) and columns 8i + 2(l%4) + {0, 1};
// for 16-bit types that is the A-fragment layout of the next product, k16
// slice by k16 slice, so softmax, P and dS stay in registers: the row max
// and sum are taken over the lane quad with two shuffles, the per-element
// `visible` test runs only on tiles where `tile_masked` is true (the
// others take a copy of the pass without it), and the online-softmax
// rescale of O happens in registers. The dk/dv pass is written in
// transposed form (rows = keys) so that P^T and dS^T come out of the
// accumulators in the A layout as well; it reads L and D_i by column from
// a per-stage copy in shared memory. The two consumer warpgroups take
// turns at the tensor cores (two named barriers), so that one's register
// pass (exponentials) runs while the other's products do. In the forward
// a warpgroup's register pass of tile t also runs while its own P V of
// tile t - 1 is in flight: p is written over the scores in place and
// packed into A fragments once P V is done. The backward passes do not:
// the dq pass then spills at D 64 (S, dP, dS and dq live at once), and
// the dk/dv pass measured slower.
//
// K4's dq: dq of a q tile sums dS K over every key, that is over the CTAs
// of the head, so it cannot be summed in one CTA. Each consumer warpgroup
// writes its dS^T (64 keys x BQ q, bf16, the rounding point K5 shares) to
// a swizzled shared-memory tile (two, alternating by tile, so that the
// next tile's write never waits for the previous product), forms dq of
// the tile over its own 64 keys with one chain of products in its turn at
// the tensor cores, and writes it, scaled, to an fp32 staging tile of its
// own (two a warpgroup, alternating). The producer warpgroup's second
// warp, the dq warp, hands each staged tile to the TMA unit as a
// reduce-add into the zeroed fp32 (B*H, T, D) buffer
// (cp.reduce.async.bulk.tensor, UTMAREDG): the adds happen in L2 and no
// consumer warp issues or waits on them. Named barriers (FULL, FREE) pass
// each staging tile between its warpgroup and the dq warp, so the two
// warpgroups never wait for each other. At the training shape the
// reductions move 2 x (T^2/2 / 128) x D x 4 B x 16 heads ~ 2.2 GB into
// the 33.5 MB buffer, which stays in the 50 MB L2. On an H100 80GB HBM3
// at 700 W they cost 2% of K4's time (0.976 ms, 0.958 with them compiled
// out), where adding from the consumers' registers (red.global.add) had
// taken K4 from 0.65 to 1.37 ms, the warps stalled behind the adds.
// Summing the two warpgroups' halves in shared memory first halves those
// bytes but makes each warpgroup wait for the other: slower. Their
// order differs from run to run, so dq is not bitwise repeatable; dk and
// dv are summed in one CTA and written once, and so is every output of K3
// and K5: those are bitwise the same from run to run, and hold no atomic
// or reduction.
//
// Tiles: the forward takes 128 q rows per CTA and key tiles of 128 (D <=
// 64) or 64 (D 128) keys; the dq pass 128 q rows and key tiles of the same
// sizes; the dk/dv pass and K4 128 keys per CTA and q tiles of 64 (32 at D
// 128, to keep dk, dv, S^T and dP^T in registers). TMA maps are 3-D (D, T,
// rows), so a box that runs past T is zero-filled instead of reading the
// next head; D 16/32/64 rows are one box with 32/64/128-byte swizzle, D
// 128 is two 64-column boxes.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int NCWG = 2;                  // consumer warpgroups per CTA
constexpr int NC = 128 * NCWG;           // consumer threads
constexpr int NT = NC + 128;             // and a producer warpgroup
constexpr int PRODUCER_REGS = 40;        // setmaxnreg: the producer gives
constexpr int CONSUMER_REGS = 232;       // registers to the consumers
constexpr int STAGES = 3;                // depth of the TMA ring
constexpr int ROWS = 64 * NCWG;          // CTA rows: q (K3, dq), keys (dk/dv)

// ------------------------------------------------------------- PTX helpers
// Registers per thread of this warpgroup from here on (all its warps).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The two consumer warpgroups take turns at the tensor cores: warpgroup wg
// starts its products between turn_wait (named barrier 1 + wg) and
// turn_pass (barrier 2 - wg, the other's), so that one's register pass
// runs while the other's products do.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(NC) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(NC) : "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// an m64 x N fp32 accumulator as the bf16 A fragments of the next product
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2],
                                       uint32_t (&a)[N / 4]) {
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) a[e / 2] = pack_bf16(x[e], x[e + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the MUFU unit (ex2.approx, denormals flushed): 2^-1e30 = +0
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------ wgmma and its operands
// Shared-memory tiles are TMA boxes of COLS columns: a (rows, D) tile is
// NBOX boxes of (rows, COLS), each with rows of RB bytes, swizzled at RB.
template <int D>
struct Box {
  static constexpr int COLS = D < 64 ? D : 64;
  static constexpr int RB = 2 * COLS;          // 32, 64 or 128 bytes
  static constexpr int NBOX = D / COLS;        // 1, or 2 at D 128
  static constexpr int SPB = RB / 32;          // k16 slices in a box row
  // wgmma descriptor layout: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
};

// K-major operand: rows [row0, row0 + 64) (A) or all rows (B) of an R-row
// tile at `tile`, k16 slice kk of the head dim. The 8-row groups are 8 RB
// bytes apart (SBO); a k16 slice is 32 bytes along the swizzled row.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  using X = Box<D>;
  return gmma_desc(tile + (kk / X::SPB) * R * X::RB + row0 * X::RB +
                       (kk % X::SPB) * 32,
                   16, 8 * X::RB, X::LAYOUT);
}

// B operand with N = D contiguous (transposed), K = the tile's rows, k16
// slice kk = rows 16 kk..16 kk + 15 of an R-row tile: 8-row groups 8 RB
// bytes apart (SBO), 64-column boxes R RB bytes apart (LBO).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using X = Box<D>;
  return gmma_desc(tile + kk * 16 * X::RB, R * X::RB, 8 * X::RB, X::LAYOUT);
}

// d (m64 x N, fp32) += A B over one k16 slice: "SS" with A and B K-major
// in shared memory (acc = 0 overwrites d), "RS" with A as four bf16x2
// registers and B transposed in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t* a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t* a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t* a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t* a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d += A B over one k16 slice with both operands in shared memory and both
// MN-major (wgmma's two transpose bits): A's M and B's N contiguous, K =
// the rows of each tile. K4's dq product only.
template <int N>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_ss_t<16>(float (&d)[8], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss_t<32>(float (&d)[16], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss_t<64>(float (&d)[32], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}


// The two shapes every product of the three kernels takes, over the whole
// k extent: d = A B^T with A rows [a_row0, a_row0 + 64) of an R-row tile
// and B the N-row tile, both K-major, K = D ("SS"); d += A B with A the
// m64 x K bf16 fragments in registers and B a K-row tile, N = D ("RS").
template <int D, int R, int N>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint32_t a,
                                           int a_row0, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(d, desc_k<D, R>(a, a_row0, kk), desc_k<D, N>(b, 0, kk),
                kk > 0);
}

template <int D, int K>
__device__ __forceinline__ void rs_product(float (&d)[D / 2],
                                           const uint32_t (&a)[K / 4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<D>(d, a + 4 * kk, desc_mn<D, K>(b, kk), 1);
}

// ------------------------------------------------ K4's dq path
// dS^T of a warpgroup leaves registers through a swizzled (BK keys x BQ
// q) bf16 tile laid out as a TMA box of BQ columns would be; dq of the q
// tile over the warpgroup's 64 keys is one chain of products with both
// operands read from shared memory, MN-major. For D <= 64 (BQ 64) it is
// dq (BQ x D) = dS K with M = the q rows (A = dS, the dS^T tile read
// M-major; B = the warpgroup's K rows, N = D contiguous); at D 128 (BQ
// 32, too few rows for M) its transpose dq^T (D x BQ) = K^T dS^T with M
// = the head dim in two halves of 64 (A = K^T, the K box read M-major; B
// = the dS^T tile, N = BQ contiguous).
template <int D>
struct DqPath {
  static constexpr int BQ = D <= 64 ? 64 : 32;
  static constexpr int REGS = D <= 64 ? D / 2 : BQ;   // accumulator floats
};

// The thread's dS^T fragments (rows row0 and row0 + 8, q columns 8 e / 4 +
// cq of its m64 x BQ A fragments) into the swizzled (BK x BQ) bf16 tile,
// laid out as TMA writes a box
template <int BQ>
__device__ __forceinline__ void store_ds(unsigned char* tile,
                                         const uint32_t (&da)[BQ / 4],
                                         int row0, int cq) {
  constexpr int RB = Box<BQ>::RB;
  unsigned char* base = tile + row0 * RB + 2 * cq;
  const uint32_t x = swizzle_term<RB>(row0);
#pragma unroll
  for (int e = 0; e < BQ / 2; e += 2)
    *reinterpret_cast<uint32_t*>(base + 8 * RB * ((e >> 1) & 1) +
                                 (((e >> 2) ^ x) << 4)) = da[e / 2];
}

// the 128 threads of consumer warpgroup wg (named barrier 3 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// d = dq (or dq^T at D 128) of one q tile over keys [64 wg, 64 wg + 64)
// of the CTA: ds the dS^T tile, ks the K tile (BK rows).
template <int D, int BK>
__device__ __forceinline__ void dq_product(float (&d)[DqPath<D>::REGS],
                                           uint32_t ds, uint32_t ks,
                                           int wg) {
  constexpr int BQ = DqPath<D>::BQ;
  const uint32_t dsw = ds + 64 * wg * Box<BQ>::RB;
  const uint32_t ksw = ks + 64 * wg * Box<D>::RB;
  if constexpr (D <= 64) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_t<D>(d, desc_mn<BQ, BK>(dsw, kk), desc_mn<D, BK>(ksw, kk),
                    kk > 0);
  } else {
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_t<BQ>(*reinterpret_cast<float(*)[BQ / 2]>(d + mh * BQ / 2),
                       desc_mn<D, BK>(ksw + mh * BK * Box<D>::RB, kk),
                       desc_mn<BQ, BK>(dsw, kk), kk > 0);
  }
}

// fp32 dq staging tiles: TMA boxes of COLS columns (128- or 64-byte rows,
// swizzled at their width), NBOX boxes across the head dim, BQ rows each.
template <int D>
struct DqBox {
  static constexpr int COLS = D < 32 ? D : 32;
  static constexpr int RB = 4 * COLS;
  static constexpr int NBOX = D / COLS;
  static constexpr int BYTES = DqPath<D>::BQ * D * 4;
};

// scale d of one q tile into the fp32 staging tile of its (q rows x D)
// block (DqBox: boxes of COLS columns, swizzled at RB): pairs of head-dim
// columns for D <= 64, single elements at D 128 (whose accumulator is
// dq^T, rows along the head dim)
template <int D>
__device__ __forceinline__ void stage_dq(unsigned char* tile,
                                         const float (&d)[DqPath<D>::REGS],
                                         float scale, int tw, int cq) {
  using Y = DqBox<D>;
  constexpr int BQ = DqPath<D>::BQ, BOX = BQ * Y::RB;
  const int r0 = 16 * (tw >> 5) + ((tw & 31) >> 2);
  if constexpr (D <= 64) {
    // pair (row r0 + 8 rr, column 8 j + cq): box 8 j / COLS, byte 32 (j %
    // (COLS / 8)) + 4 cq of the row, so chunk 2 (j % (COLS / 8)) + cq / 4
    unsigned char* base = tile + r0 * Y::RB + 4 * (cq & 2);
    const uint32_t x = swizzle_term<Y::RB>(r0), c4 = cq >> 2;
#pragma unroll
    for (int e = 0; e < D / 2; e += 2) {
      constexpr int JB = Y::COLS / 8;
      const int j = e >> 2;
      *reinterpret_cast<float2*>(base + (j / JB) * BOX +
                                 8 * Y::RB * ((e >> 1) & 1) +
                                 (((2 * (j % JB) + c4) ^ x) << 4)) =
          make_float2(scale * d[e], scale * d[e + 1]);
    }
  } else {
    // element (row 8 i + cq + u, column 64 mh + col, col = r0 + 8 rr):
    // box (64 mh + col) / COLS, byte 4 (col % COLS) of the row; rows vary
    // along q here, so the swizzle term does too
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) {
      const int row = 8 * (e >> 2) + cq + (e & 1);
      const int col = r0 + 8 * ((e >> 1) & 1);
      const uint32_t off = row * Y::RB + 4 * (col % Y::COLS);
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
        *reinterpret_cast<float*>(
            tile + ((64 * mh + col) / Y::COLS) * BOX +
            (off ^ (swizzle_term<Y::RB>(row) << 4))) =
            scale * d[mh * BQ / 2 + e];
    }
  }
}

// dq[box] += the staging box at `src`, by the TMA unit, asynchronously
// (rows past T are not written); {c0, c1, c2} = (column, row, head row)
__device__ __forceinline__ void tma_reduce_add(const void* src,
                                               const CUtensorMap* map,
                                               int c0, int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile"
      ".bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}

// K4's dq handoff, per consumer warpgroup w and staging buffer b (two a
// warpgroup, alternating by q tile): FULL (5 + 2 w + b) when the
// warpgroup has written its part of the tile, FREE (9 + 2 w + b) once the
// TMA unit has read it; each between the warpgroup and the dq warp.
constexpr int DQ_FULL = 5, DQ_FREE = 9, DQ_HANDOFF = 128 + 32;

// The dq warp (the producer warpgroup's second): for each q tile and
// warpgroup, waits for the staging buffer to be full, has the TMA unit add
// it into dq, and hands back the buffer of the warpgroup's previous tile
// once that reduction has read it (two groups later in issue order).
template <int D>
__device__ __forceinline__ void dq_writer(const CUtensorMap& tdq,
                                          unsigned char* bufs, int i0, int nt,
                                          int bh) {
  using Y = DqBox<D>;
  constexpr int BQ = DqPath<D>::BQ;
  const bool lead = (threadIdx.x & 31) == 0;
  for (int w = 0; w < NCWG; ++w) {
    named_arrive(DQ_FREE + 2 * w, DQ_HANDOFF);
    if (nt >= 2) named_arrive(DQ_FREE + 2 * w + 1, DQ_HANDOFF);
  }
  for (int n = 0; n < nt; ++n) {
    const int b = n & 1;
    for (int w = 0; w < NCWG; ++w) {
      named_sync(DQ_FULL + 2 * w + b, DQ_HANDOFF);
      if (lead) {
        unsigned char* buf = bufs + (2 * w + b) * Y::BYTES;
#pragma unroll
        for (int c = 0; c < Y::NBOX; ++c)
          tma_reduce_add(buf + c * BQ * Y::RB, &tdq, c * Y::COLS,
                         (i0 + n) * BQ, bh);
        bulk_commit();
        bulk_wait_read<NCWG>();
      }
      __syncwarp();
      if (n >= 1 && n + 1 < nt)
        named_arrive(DQ_FREE + 2 * w + (b ^ 1), DQ_HANDOFF);
    }
  }
  if (lead) bulk_wait_read<0>();
}

// ------------------------------------------ the per-tile register passes
// Every exponent is taken base 2 with the scale folded in: c = scale
// log2(e), so exp(scale s - m) = 2^(c s - m log2 e), one FMUL or FFMA and a
// MUFU.EX2 per score. A masked score gets the exponent NEG_INF, whose 2^x
// is exactly 0: p is masked before the exp, with no branch. MASKED tiles
// (edges, key mask) test `visible` per element; the others do not.

// Online softmax of an m64 x BN score tile held as the accumulator of this
// thread (rows qi0 and qi0 + 8, columns 8 e / 4 + cq + {0, 1}), in log2
// units: scores scaled, masked, the row max over the lane quad; p = 2^(s -
// m) written over the scores; the running max m and sum l updated, and
// al = 2^(m_old - m_new) returned for the rows' accumulators.
template <bool MASKED, int BN>
__device__ __forceinline__ void online_softmax(
    float (&sc)[BN / 2], float (&m)[2], float (&l)[2], float (&al)[2],
    float c, const Geometry& g, int qi0, int k_lo, const int* kmk, int cq) {
  float mx[2] = {DL4J_NEG_INF, DL4J_NEG_INF};
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const int r = (e >> 1) & 1;
    float x = sc[e] * c;
    if (MASKED) {
      const int col = 8 * (e >> 2) + cq + (e & 1);
      if (!visible(g, qi0 + 8 * r, k_lo + col, kmk[col] != 0))
        x = DL4J_NEG_INF;
    }
    sc[e] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  float mu[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    // a row with no visible key yet keeps m = NEG_INF; its exponents are
    // taken from 0, so that its masked scores give 2^NEG_INF = 0
    mu[r] = (MASKED && mn == DL4J_NEG_INF) ? 0.f : mn;
    al[r] = exp2_fast(m[r] - mu[r]);
    m[r] = mn;
  }
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int r = (e >> 1) & 1;
    sc[e] = exp2_fast(sc[e] - mu[r]);
    sc[e + 1] = exp2_fast(sc[e + 1] - mu[r]);
    rs[r] += sc[e] + sc[e + 1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + quad_sum(rs[r]);
}

// dS = p (dP - D_i) of an m64 x BN tile of the dq pass as bf16 A
// fragments, p = 2^(c s - L log2 e); rows qi0 and qi0 + 8 with L2 = L
// log2(e) and D_i in registers.
template <bool MASKED, int BN>
__device__ __forceinline__ void dq_ds(const float (&sc)[BN / 2],
                                      const float (&dp)[BN / 2],
                                      uint32_t (&da)[BN / 4], float c,
                                      const float (&L2)[2],
                                      const float (&Dr)[2],
                                      const Geometry& g, int qi0, int k_lo,
                                      const int* kmk, int cq) {
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int r = (e >> 1) & 1, col = 8 * (e >> 2) + cq;
    float ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float x = fmaf(sc[e + u], c, -L2[r]);
      if (MASKED && !visible(g, qi0 + 8 * r, k_lo + col + u,
                             kmk[col + u] != 0))
        x = DL4J_NEG_INF;
      ds[u] = exp2_fast(x) * (dp[e + u] - Dr[r]);
    }
    da[e / 2] = pack_bf16(ds[0], ds[1]);
  }
}

// P^T and dS^T of an m64 (keys) x BQ (queries) tile of the dk/dv pass as
// bf16 A fragments; L2 = L log2(e) and D_i by column from shared memory;
// rows (keys) kj0 and kj0 + 8 with their key-ok flags ko.
template <bool MASKED, int BQ>
__device__ __forceinline__ void dkv_p_ds(const float (&st)[BQ / 2],
                                         const float (&dpt)[BQ / 2],
                                         uint32_t (&pa)[BQ / 4],
                                         uint32_t (&da)[BQ / 4], float c,
                                         const float* L2q, const float* Dq,
                                         const Geometry& g, int q_lo,
                                         int kj0, const bool (&ko)[2],
                                         int cq) {
#pragma unroll
  for (int e = 0; e < BQ / 2; e += 2) {
    const int r = (e >> 1) & 1, col = 8 * (e >> 2) + cq;
    const float2 L2 = *reinterpret_cast<const float2*>(L2q + col);
    const float2 Di = *reinterpret_cast<const float2*>(Dq + col);
    float p[2], ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float x = fmaf(st[e + u], c, -(u ? L2.y : L2.x));
      if (MASKED && !visible(g, q_lo + col + u, kj0 + 8 * r, ko[r]))
        x = DL4J_NEG_INF;
      p[u] = exp2_fast(x);
      ds[u] = p[u] * (dpt[e + u] - (u ? Di.y : Di.x));
    }
    pa[e / 2] = pack_bf16(p[0], p[1]);
    da[e / 2] = pack_bf16(ds[0], ds[1]);
  }
}

// ------------------------------------------------------------------ K3
template <int D>
struct FwdTiles {
  static constexpr int BM = ROWS;                 // q rows per CTA
  static constexpr int BN = D <= 64 ? 128 : 64;   // keys per tile
  static constexpr int QBYTES = BM * D * 2;
  static constexpr int KBYTES = BN * D * 2;
  static constexpr int K_OFF = QBYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KBYTES;
  static constexpr int KM_OFF = V_OFF + STAGES * KBYTES;
  static constexpr int BAR_OFF = KM_OFF + STAGES * BN * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const int* __restrict__ km, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int Hk, Geometry g,
                      float scale) {
  using C = FwdTiles<D>;
  using X = Box<D>;
  constexpr int BM = C::BM, BN = C::BN;
  const int i = gridDim.x - 1 - blockIdx.x;   // the longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int kvrow = b * Hk + h / (H / Hk);
  const int T = g.T, q_lo = i * BM;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* Ks = reinterpret_cast<bf16*>(sm + C::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(sm + C::V_OFF);
  int* kms = reinterpret_cast<int*>(sm + C::KM_OFF);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    mbar_fence_init();
  }
  __syncthreads();
  int j0, j1;
  key_tiles<BM, BN>(g, q_lo, &j0, &j1);
  const int nt = j1 - j0;

  if (threadIdx.x >= NC) {
    // producer warpgroup (its first warp): Q once, then K, V and the
    // key-ok flags of each tile
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= NC + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(qbar, C::QBYTES);
      for (int c = 0; c < X::NBOX; ++c)
        tma_load_3d(Qs + c * BM * X::COLS, &tq, qbar, c * X::COLS, q_lo, bh);
    }
    for (int n = 0; n < nt; ++n) {
      const int s = n % STAGES, k_lo = (j0 + n) * BN;
      mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
      for (int c = lane; c < BN; c += 32) {
        const int kj = k_lo + c;
        kms[s * BN + c] =
            kj < T && (km == nullptr || km[(long)b * T + kj] != 0);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::KBYTES);
        for (int c = 0; c < X::NBOX; ++c) {
          tma_load_3d(Ks + s * BN * D + c * BN * X::COLS, &tk, &full[s],
                   c * X::COLS, k_lo, kvrow);
          tma_load_3d(Vs + s * BN * D + c * BN * X::COLS, &tv, &full[s],
                   c * X::COLS, k_lo, kvrow);
        }
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    // consumer warpgroup wg: q rows q_lo + 64 wg ..; this thread's rows
    // qi0 and qi0 + 8, columns 8 e + cq + {0, 1} of every accumulator
    const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
    const int lane = tw & 31, cq = 2 * (lane & 3);
    const int q_wg = q_lo + 64 * wg;
    const int qi0 = q_wg + 16 * (tw >> 5) + (lane >> 2);
    const uint32_t qs = smem_u32(Qs);
    const float c = scale * LOG2E;
    float acc[D / 2];
    zero(acc);
    float m[2] = {DL4J_NEG_INF, DL4J_NEG_INF}, l[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);
    // Turn 0 starts S = Q K^T of key tile 0; turn t in [1, nt) S of tile t
    // and O += P V of tile t - 1; turn nt the last P V. The register pass
    // of tile t runs while P V of tile t - 1 does: it turns S into p in
    // place, and only once P V is done are O rescaled and p packed into
    // the A fragments. nt >= 1: key_tiles is never empty. The loop is
    // peeled so that no product is started under a condition (ptxas would
    // serialize the products).
    float sc[BN / 2];
    uint32_t pa[BN / 4];
    float al[2];
    auto register_pass = [&](int n) {
      const int k_lo = (j0 + n) * BN;
      const int* kmk = kms + (n % STAGES) * BN;
      if (tile_masked<64, BN>(g, q_wg, k_lo, km != nullptr))
        online_softmax<true, BN>(sc, m, l, al, c, g, qi0, k_lo, kmk, cq);
      else
        online_softmax<false, BN>(sc, m, l, al, c, g, qi0, k_lo, kmk, cq);
    };
    const uint32_t ks = smem_u32(Ks), vs = smem_u32(Vs);
    constexpr int TILE = BN * D * 2;            // bytes of a K or V stage
    if (wg == 1) turn_pass(wg);                 // warpgroup 0 goes first
    turn_wait(wg);
    wg_fence();
    mbar_wait(&full[0], 0);
    ss_product<D, BM, BN>(sc, qs, 64 * wg, ks);
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    fence_regs(sc);
    register_pass(0);
    pack_a<BN>(sc, pa);
    for (int t = 1; t < nt; ++t) {
      turn_wait(wg);
      wg_fence();
      mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
      ss_product<D, BM, BN>(sc, qs, 64 * wg, ks + (t % STAGES) * TILE);
      wg_commit();
      rs_product<D, BN>(acc, pa, vs + ((t - 1) % STAGES) * TILE);
      wg_commit();
      turn_pass(wg);
      wg_wait<1>();
      fence_regs(sc);
      register_pass(t);
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(t - 1) % STAGES]);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] *= al[(e >> 1) & 1];
      pack_a<BN>(sc, pa);
    }
    turn_wait(wg);
    wg_fence();
    rs_product<D, BN>(acc, pa, vs + ((nt - 1) % STAGES) * TILE);
    wg_commit();
    if (wg == 0) turn_pass(wg);
    wg_wait<0>();
    fence_regs(acc);
    bf16* ob = o + (long)bh * T * D;
#pragma unroll
    for (int e = 0; e < D / 2; e += 2) {
      const int r = (e >> 1) & 1, qi = qi0 + 8 * r;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      if (qi < T)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)qi * D + 8 * (e >> 2) +
                                           cq) =
            __floats2bfloat162_rn(acc[e] * inv, acc[e + 1] * inv);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // L = m + log l, with m back from log2 units
      if ((lane & 3) == 0 && qi0 + 8 * r < T)
        lse[(long)bh * T + qi0 + 8 * r] =
            l[r] > 0.f ? m[r] * LN2 + logf(fmaxf(l[r], 1e-30f))
                       : DL4J_NEG_INF;
    }
  }
}

// ------------------------------------------------------ K5's dq pass
template <int D>
struct DqTiles {
  static constexpr int BM = ROWS;                 // q rows per CTA
  static constexpr int BN = D <= 64 ? 128 : 64;   // keys per tile
  static constexpr int QBYTES = BM * D * 2;
  static constexpr int KBYTES = BN * D * 2;
  static constexpr int DO_OFF = QBYTES;
  static constexpr int K_OFF = 2 * QBYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KBYTES;
  static constexpr int KM_OFF = V_OFF + STAGES * KBYTES;
  static constexpr int BAR_OFF = KM_OFF + STAGES * BN * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const int* __restrict__ km,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dq,
                     int H, Geometry g, float scale) {
  using C = DqTiles<D>;
  using X = Box<D>;
  constexpr int BM = C::BM, BN = C::BN;
  const int i = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H;
  const int T = g.T, q_lo = i * BM;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* dOs = reinterpret_cast<bf16*>(sm + C::DO_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(sm + C::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(sm + C::V_OFF);
  int* kms = reinterpret_cast<int*>(sm + C::KM_OFF);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    mbar_fence_init();
  }
  __syncthreads();
  int j0, j1;
  key_tiles<BM, BN>(g, q_lo, &j0, &j1);
  const int nt = j1 - j0;

  if (threadIdx.x >= NC) {
    // producer warpgroup (its first warp): Q and dO once, then K, V and
    // the key-ok flags of each tile
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= NC + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * C::QBYTES);
      for (int c = 0; c < X::NBOX; ++c) {
        tma_load_3d(Qs + c * BM * X::COLS, &tq, qbar, c * X::COLS, q_lo, bh);
        tma_load_3d(dOs + c * BM * X::COLS, &tdo, qbar, c * X::COLS, q_lo, bh);
      }
    }
    for (int n = 0; n < nt; ++n) {
      const int s = n % STAGES, k_lo = (j0 + n) * BN;
      mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
      for (int c = lane; c < BN; c += 32) {
        const int kj = k_lo + c;
        kms[s * BN + c] =
            kj < T && (km == nullptr || km[(long)b * T + kj] != 0);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::KBYTES);
        for (int c = 0; c < X::NBOX; ++c) {
          tma_load_3d(Ks + s * BN * D + c * BN * X::COLS, &tk, &full[s],
                   c * X::COLS, k_lo, bh);
          tma_load_3d(Vs + s * BN * D + c * BN * X::COLS, &tv, &full[s],
                   c * X::COLS, k_lo, bh);
        }
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
    const int lane = tw & 31, cq = 2 * (lane & 3);
    const int q_wg = q_lo + 64 * wg;
    const int qi0 = q_wg + 16 * (tw >> 5) + (lane >> 2);
    // L log2(e) and D_i of this thread's rows (rows past T: 0; they are
    // masked)
    float L2[2], Dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qi0 + 8 * r;
      L2[r] = qi < T ? lse[(long)bh * T + qi] * LOG2E : 0.f;
      Dr[r] = qi < T ? di[(long)bh * T + qi] : 0.f;
    }
    const uint32_t qs = smem_u32(Qs), dos = smem_u32(dOs);
    const float c = scale * LOG2E;
    float acc[D / 2];
    zero(acc);
    mbar_wait(qbar, 0);
    // Turn 0 starts S = Q K^T and dP = dO V^T of key tile 0; turn t in [1,
    // nt) dq += dS K of tile t - 1 and S, dP of tile t; turn nt the last
    // dS K. Between turns the register pass forms dS of tile t - 1.
    float sc[BN / 2], dp[BN / 2];
    uint32_t da[BN / 4];
    auto register_pass = [&](int n) {
      const int k_lo = (j0 + n) * BN;
      const int* kmk = kms + (n % STAGES) * BN;
      if (tile_masked<64, BN>(g, q_wg, k_lo, km != nullptr))
        dq_ds<true, BN>(sc, dp, da, c, L2, Dr, g, qi0, k_lo, kmk, cq);
      else
        dq_ds<false, BN>(sc, dp, da, c, L2, Dr, g, qi0, k_lo, kmk, cq);
    };
    const uint32_t ks = smem_u32(Ks), vs = smem_u32(Vs);
    constexpr int TILE = BN * D * 2;
    if (wg == 1) turn_pass(wg);
    turn_wait(wg);
    wg_fence();
    mbar_wait(&full[0], 0);
    ss_product<D, BM, BN>(sc, qs, 64 * wg, ks);
    ss_product<D, BM, BN>(dp, dos, 64 * wg, vs);
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    for (int t = 1; t < nt; ++t) {
      register_pass(t - 1);
      turn_wait(wg);
      wg_fence();
      rs_product<D, BN>(acc, da, ks + ((t - 1) % STAGES) * TILE);
      mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
      ss_product<D, BM, BN>(sc, qs, 64 * wg, ks + (t % STAGES) * TILE);
      ss_product<D, BM, BN>(dp, dos, 64 * wg, vs + (t % STAGES) * TILE);
      wg_commit();
      turn_pass(wg);
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(acc);
      mbar_arrive(&empty[(t - 1) % STAGES]);
    }
    register_pass(nt - 1);
    turn_wait(wg);
    wg_fence();
    rs_product<D, BN>(acc, da, ks + ((nt - 1) % STAGES) * TILE);
    wg_commit();
    if (wg == 0) turn_pass(wg);
    wg_wait<0>();
    fence_regs(acc);
    float* dqb = dq + (long)bh * T * D;
#pragma unroll
    for (int e = 0; e < D / 2; e += 2) {
      const int qi = qi0 + 8 * ((e >> 1) & 1);
      if (qi < T)
        *reinterpret_cast<float2*>(dqb + (long)qi * D + 8 * (e >> 2) + cq) =
            make_float2(scale * acc[e], scale * acc[e + 1]);
    }
  }
}

// ------------------------------------- K5's dk/dv pass, and K4 (DQ)
template <int D, bool DQ>
struct DkvTiles {
  static constexpr int BK = ROWS;                 // keys per CTA
  static constexpr int BQ = D <= 64 ? 64 : 32;    // q rows per tile
  static constexpr int KBYTES = BK * D * 2;
  static constexpr int QBYTES = BQ * D * 2;
  static constexpr int DSBYTES = DQ ? BK * BQ * 2 : 0;   // a dS^T tile
  static constexpr int DQBYTES = DQ ? DqBox<D>::BYTES : 0;  // fp32 dq
  static constexpr int V_OFF = KBYTES;
  static constexpr int Q_OFF = 2 * KBYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QBYTES;
  static constexpr int DS_OFF = DO_OFF + STAGES * QBYTES;  // two
  static constexpr int DQ_OFF = DS_OFF + 2 * DSBYTES;      // two a warpgroup
  static constexpr int L_OFF = DQ_OFF + 2 * NCWG * DQBYTES;
  static constexpr int DI_OFF = L_OFF + STAGES * BQ * 4;
  static constexpr int BAR_OFF = DI_OFF + STAGES * BQ * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// The dk/dv pass (DQ false, K5's second kernel) and the fused backward
// (DQ true, K4): the same walk over the q tiles that see the CTA's 128
// keys; K4 also forms each tile's dq over its keys (DqPath) and adds it
// into the zeroed fp32 buffer that `tdq` maps.
template <int D, bool DQ>
__device__ __forceinline__ void dkv_pass(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const CUtensorMap& tdq,
    const int* __restrict__ km, const float* __restrict__ lse,
    const float* __restrict__ di, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, Geometry g, float scale) {
  using C = DkvTiles<D, DQ>;
  using X = Box<D>;
  constexpr int BK = C::BK, BQ = C::BQ;
  const int j = blockIdx.x;         // the most-visited key tiles first
  const int bh = blockIdx.y, b = bh / H;
  const int T = g.T, k_lo = j * BK;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Vs = reinterpret_cast<bf16*>(sm + C::V_OFF);
  bf16* Qs = reinterpret_cast<bf16*>(sm + C::Q_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(sm + C::DO_OFF);
  float* Ls = reinterpret_cast<float*>(sm + C::L_OFF);   // L log2(e)
  float* Dis = reinterpret_cast<float*>(sm + C::DI_OFF);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    mbar_fence_init();
  }
  __syncthreads();
  int i0, i1;
  query_tiles<BQ, BK>(g, k_lo, &i0, &i1);
  const int nt = i1 - i0;

  if (threadIdx.x >= NC) {
    // producer warpgroup: its first warp loads K and V once, then Q, dO,
    // L and D_i of each q tile; in K4 its second warp is the dq warp
    regs_dec<PRODUCER_REGS>();
    if constexpr (DQ)
      if (threadIdx.x >= NC + 32 && threadIdx.x < NC + 64) {
        dq_writer<D>(tdq, sm + C::DQ_OFF, i0, nt, bh);
        return;
      }
    if (threadIdx.x >= NC + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * C::KBYTES);
      for (int c = 0; c < X::NBOX; ++c) {
        tma_load_3d(Ks + c * BK * X::COLS, &tk, kvbar, c * X::COLS, k_lo, bh);
        tma_load_3d(Vs + c * BK * X::COLS, &tv, kvbar, c * X::COLS, k_lo, bh);
      }
    }
    for (int n = 0; n < nt; ++n) {
      const int s = n % STAGES, q_lo = (i0 + n) * BQ;
      mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
      for (int r = lane; r < BQ; r += 32) {
        const int qi = q_lo + r;   // rows past T: 0 (their pairs are masked)
        Ls[s * BQ + r] = qi < T ? lse[(long)bh * T + qi] * LOG2E : 0.f;
        Dis[s * BQ + r] = qi < T ? di[(long)bh * T + qi] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::QBYTES);
        for (int c = 0; c < X::NBOX; ++c) {
          tma_load_3d(Qs + s * BQ * D + c * BQ * X::COLS, &tq, &full[s],
                   c * X::COLS, q_lo, bh);
          tma_load_3d(dOs + s * BQ * D + c * BQ * X::COLS, &tdo, &full[s],
                   c * X::COLS, q_lo, bh);
        }
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    // consumer warpgroup wg: keys k_lo + 64 wg ..; this thread's keys kj0
    // and kj0 + 8 (rows), q columns 8 e + cq + {0, 1} of each tile
    const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
    const int lane = tw & 31, cq = 2 * (lane & 3);
    const int k_wg = k_lo + 64 * wg;
    const int kj0 = k_wg + 16 * (tw >> 5) + (lane >> 2);
    bool ko[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = kj0 + 8 * r;
      ko[r] = kj < T && (km == nullptr || km[(long)b * T + kj] != 0);
    }
    const uint32_t ks = smem_u32(Ks), vs = smem_u32(Vs);
    const float c = scale * LOG2E;
    float dka[D / 2], dva[D / 2];
    zero(dka);
    zero(dva);
    mbar_wait(kvbar, 0);
    // Turn 0 starts S^T = K Q^T and dP^T = V dO^T of q tile 0; turn t in
    // [1, nt) dv += P^T dO, dk += dS^T Q of tile t - 1 and S^T, dP^T of
    // tile t; turn nt the last dv, dk. Between turns the register pass
    // forms P^T and dS^T of tile t - 1.
    float st[BQ / 2], dpt[BQ / 2];
    uint32_t pa[BQ / 4], da[BQ / 4];
    auto register_pass = [&](int n) {
      const int s = n % STAGES, q_lo = (i0 + n) * BQ;
      if (tile_masked<BQ, 64>(g, q_lo, k_wg, km != nullptr))
        dkv_p_ds<true, BQ>(st, dpt, pa, da, c, Ls + s * BQ, Dis + s * BQ,
                           g, q_lo, kj0, ko, cq);
      else
        dkv_p_ds<false, BQ>(st, dpt, pa, da, c, Ls + s * BQ, Dis + s * BQ,
                            g, q_lo, kj0, ko, cq);
    };
    const uint32_t qs = smem_u32(Qs), dos = smem_u32(dOs);
    constexpr int TILE = BQ * D * 2;            // bytes of a Q or dO stage
    // K4: tile n's dS^T goes to buffer n % 2, whose last reader (the dq
    // product of tile n - 2) every thread of the warpgroup has waited for
    // before the barrier that follows the write of tile n - 1. Its dq over
    // the warpgroup's keys goes to the warpgroup's fp32 staging buffer n %
    // 2, which the dq warp then hands to the TMA unit (dq_writer).
    float dqa[DQ ? DqPath<D>::REGS : 1];
    const int ds_row = 64 * wg + 16 * (tw >> 5) + (lane >> 2);
    // One proxy fence a tile covers both stores of the warpgroup: the dS^T
    // of tile n and the staged dq of tile n - 1, handed to the dq warp
    // (FULL) once it has passed.
    auto stage_ds = [&](int n) {
      if constexpr (DQ) {
        store_ds<BQ>(sm + C::DS_OFF + (n & 1) * C::DSBYTES, da, ds_row, cq);
        fence_async_smem();
        wg_sync(wg);
        if (n >= 1) named_arrive(DQ_FULL + 2 * wg + ((n - 1) & 1), DQ_HANDOFF);
      }
    };
    auto dq_issue = [&](int n) {
      if constexpr (DQ)
        dq_product<D, BK>(dqa, smem_u32(sm + C::DS_OFF + (n & 1) * C::DSBYTES),
                          ks, wg);
    };
    auto dq_add = [&](int n) {
      if constexpr (DQ) {
        fence_regs(dqa);
        const int wb = 2 * wg + (n & 1);
        named_sync(DQ_FREE + wb, DQ_HANDOFF);
        stage_dq<D>(sm + C::DQ_OFF + wb * C::DQBYTES, dqa, scale, tw, cq);
      }
    };
    if (wg == 1) turn_pass(wg);
    turn_wait(wg);
    wg_fence();
    mbar_wait(&full[0], 0);
    ss_product<D, BK, BQ>(st, ks, 64 * wg, qs);
    ss_product<D, BK, BQ>(dpt, vs, 64 * wg, dos);
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    for (int t = 1; t < nt; ++t) {
      const int sp = (t - 1) % STAGES, sn = t % STAGES;
      register_pass(t - 1);
      stage_ds(t - 1);
      turn_wait(wg);
      wg_fence();
      rs_product<D, BQ>(dva, pa, dos + sp * TILE);
      rs_product<D, BQ>(dka, da, qs + sp * TILE);
      dq_issue(t - 1);
      mbar_wait(&full[sn], (t / STAGES) & 1);
      ss_product<D, BK, BQ>(st, ks, 64 * wg, qs + sn * TILE);
      ss_product<D, BK, BQ>(dpt, vs, 64 * wg, dos + sn * TILE);
      wg_commit();
      turn_pass(wg);
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(&empty[sp]);
      dq_add(t - 1);
    }
    register_pass(nt - 1);
    stage_ds(nt - 1);
    turn_wait(wg);
    wg_fence();
    rs_product<D, BQ>(dva, pa, dos + ((nt - 1) % STAGES) * TILE);
    rs_product<D, BQ>(dka, da, qs + ((nt - 1) % STAGES) * TILE);
    dq_issue(nt - 1);
    wg_commit();
    if (wg == 0) turn_pass(wg);
    wg_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    dq_add(nt - 1);
    if constexpr (DQ) {
      fence_async_smem();
      named_arrive(DQ_FULL + 2 * wg + ((nt - 1) & 1), DQ_HANDOFF);
    }
    const long base = (long)bh * T * D;
#pragma unroll
    for (int e = 0; e < D / 2; e += 2) {
      const int kj = kj0 + 8 * ((e >> 1) & 1);
      if (kj < T) {
        const long off = base + (long)kj * D + 8 * (e >> 2) + cq;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(scale * dka[e], scale * dka[e + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(dva[e], dva[e + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const int* __restrict__ km,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, Geometry g, float scale) {
  dkv_pass<D, false>(tq, tk, tv, tdo, tq, km, lse, di, dk, dv, H, g, scale);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_fused_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tdq,
                            const int* __restrict__ km,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int H, Geometry g, float scale) {
  dkv_pass<D, true>(tq, tk, tv, tdo, tdq, km, lse, di, dk, dv, H, g, scale);
}

// ------------------------------------------------------------- host side
// A 3-D map (D, T, rows) of a (rows, T, D) tensor of `elt`-byte elements
// (bf16, or K4's fp32 dq), boxes of (cols, box_rows, 1) swizzled at the
// box's row width; boxes past T are zero-filled on loads and clipped on
// reductions.
int make_map(CUtensorMap* map, const void* ptr, int D, int T, int rows,
             int cols, int box_rows, int elt) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  const int rb = cols * elt;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elt,
                                 (cuuint64_t)T * D * elt};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = rb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadMap;
}

// the bf16 q/k/v/dO maps of the kernels
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int T, int rows,
             int box_rows) {
  return make_map(map, ptr, D, T, rows, Box<D>::COLS, box_rows, 2);
}

template <typename K>
int prepare(K kern, int smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* km,
               void* o, float* lse, int B, int H, int Hk, Geometry g,
               float scale, cudaStream_t st) {
  using C = FwdTiles<D>;
  CUtensorMap mq, mk, mv;
  int err;
  if ((err = make_map<D>(&mq, q, g.T, B * H, C::BM))) return err;
  if ((err = make_map<D>(&mk, k, g.T, B * Hk, C::BN))) return err;
  if ((err = make_map<D>(&mv, v, g.T, B * Hk, C::BN))) return err;
  auto kern = flash_fwd_sm90_kernel<D>;
  if ((err = prepare(kern, C::SMEM))) return err;
  dim3 grid((g.T + C::BM - 1) / C::BM, B * H);
  kern<<<grid, NT, C::SMEM, st>>>(mq, mk, mv, km, static_cast<bf16*>(o), lse,
                                  H, Hk, g, scale);
  return (int)cudaGetLastError();
}

// The dk/dv pass (DQ false) or K4 (DQ true, dq into the zeroed buffer):
// one CTA per 128 keys.
template <int D, bool DQ>
int launch_dkv(const void* q, const void* k, const void* v, const int* km,
               const void* dout, const float* lse, const float* di,
               float* dq, void* dk, void* dv, int B, int H, Geometry g,
               float scale, cudaStream_t st) {
  using K = DkvTiles<D, DQ>;
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = make_map<D>(&mq, q, g.T, B * H, K::BQ))) return err;
  if ((err = make_map<D>(&mdo, dout, g.T, B * H, K::BQ))) return err;
  if ((err = make_map<D>(&mk, k, g.T, B * H, K::BK))) return err;
  if ((err = make_map<D>(&mv, v, g.T, B * H, K::BK))) return err;
  const dim3 grid((g.T + K::BK - 1) / K::BK, B * H);
  if constexpr (DQ) {
    CUtensorMap mdq;
    if ((err = make_map(&mdq, dq, D, g.T, B * H, DqBox<D>::COLS, K::BQ, 4)))
      return err;
    auto kern = flash_bwd_fused_sm90_kernel<D>;
    if ((err = prepare(kern, K::SMEM))) return err;
    kern<<<grid, NT, K::SMEM, st>>>(mq, mk, mv, mdo, mdq, km, lse, di,
                                    static_cast<bf16*>(dk),
                                    static_cast<bf16*>(dv), H, g, scale);
  } else {
    auto kern = flash_dkv_sm90_kernel<D>;
    if ((err = prepare(kern, K::SMEM))) return err;
    kern<<<grid, NT, K::SMEM, st>>>(mq, mk, mv, mdo, km, lse, di,
                                    static_cast<bf16*>(dk),
                                    static_cast<bf16*>(dv), H, g, scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const int* km,
               const void* dout, const float* lse, const float* di,
               float* dq, void* dk, void* dv, int B, int H, Geometry g,
               float scale, cudaStream_t st) {
  using Q = DqTiles<D>;
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = make_map<D>(&mq, q, g.T, B * H, Q::BM))) return err;
  if ((err = make_map<D>(&mdo, dout, g.T, B * H, Q::BM))) return err;
  if ((err = make_map<D>(&mk, k, g.T, B * H, Q::BN))) return err;
  if ((err = make_map<D>(&mv, v, g.T, B * H, Q::BN))) return err;
  auto kq = flash_dq_sm90_kernel<D>;
  if ((err = prepare(kq, Q::SMEM))) return err;
  kq<<<dim3((g.T + Q::BM - 1) / Q::BM, B * H), NT, Q::SMEM, st>>>(
      mq, mk, mv, mdo, km, lse, di, dq, H, g, scale);
  if ((err = (int)cudaGetLastError())) return err;
  return launch_dkv<D, false>(q, k, v, km, dout, lse, di, nullptr, dk, dv, B,
                              H, g, scale, st);
}

template <int D>
int launch_fused(const void* q, const void* k, const void* v, const int* km,
                 const void* dout, const float* lse, const float* di,
                 float* dq, void* dk, void* dv, int B, int H, Geometry g,
                 float scale, cudaStream_t st) {
  return launch_dkv<D, true>(q, k, v, km, dout, lse, di, dq, dk, dv, B, H, g,
                             scale, st);
}

}  // namespace

// bf16 only; head dims 16, 32, 64, 128. q, k, v, dout 16-byte aligned and
// contiguous. Return a cudaError_t code, or kNoEncoder / kBadMap (0 on
// success). They allocate nothing and do not synchronize: the kernels
// launch on `stream`.
#define DL4J_SM90_DISPATCH(FN, ...)                                \
  {                                                                \
    if (D == 16) return FN<16>(__VA_ARGS__);                       \
    if (D == 32) return FN<32>(__VA_ARGS__);                       \
    if (D == 64) return FN<64>(__VA_ARGS__);                       \
    if (D == 128) return FN<128>(__VA_ARGS__);                     \
    return (int)cudaErrorInvalidValue;                             \
  }

extern "C" int dl4j_flash_sm90_fwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   void* o, void* lse, int B, int H, int Hk,
                                   int T, int D, int causal, int window,
                                   float scale, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (Hk <= 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  const Geometry g{T, causal, window};
  DL4J_SM90_DISPATCH(launch_fwd, q, k, v, static_cast<const int*>(key_mask),
                     o, static_cast<float*>(lse), B, H, Hk, g, scale,
                     static_cast<cudaStream_t>(stream));
}

// K5: the dq pass, then the dk/dv pass (two launches).
extern "C" int dl4j_flash_sm90_bwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   const void* dout, const void* lse,
                                   const void* di, void* dq, void* dk,
                                   void* dv, int B, int H, int T, int D,
                                   int causal, int window, float scale,
                                   void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  const Geometry g{T, causal, window};
  DL4J_SM90_DISPATCH(launch_bwd, q, k, v, static_cast<const int*>(key_mask),
                     dout, static_cast<const float*>(lse),
                     static_cast<const float*>(di), static_cast<float*>(dq),
                     dk, dv, B, H, g, scale,
                     static_cast<cudaStream_t>(stream));
}

// K4: the fused backward, one launch; dq (fp32) must be zero on entry and
// receives the sum of every key tile's reductions.
extern "C" int dl4j_flash_sm90_bwd_fused(const void* q, const void* k,
                                         const void* v, const void* key_mask,
                                         const void* dout, const void* lse,
                                         const void* di, void* dq, void* dk,
                                         void* dv, int B, int H, int T, int D,
                                         int causal, int window, float scale,
                                         void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  const Geometry g{T, causal, window};
  DL4J_SM90_DISPATCH(launch_fused, q, k, v, static_cast<const int*>(key_mask),
                     dout, static_cast<const float*>(lse),
                     static_cast<const float*>(di), static_cast<float*>(dq),
                     dk, dv, B, H, g, scale,
                     static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a kernel: kind 0 the forward, 1 the dq pass, 2
// the dk/dv pass, 3 the fused backward (K4); -1 for a head dim without
// kernels or an unknown kind.
extern "C" int dl4j_flash_sm90_smem(int kind, int D) {
#define DL4J_SM90_SMEM(DD)                                           \
  if (D == DD) {                                                     \
    if (kind == 0) return FwdTiles<DD>::SMEM;                        \
    if (kind == 1) return DqTiles<DD>::SMEM;                         \
    if (kind == 2) return DkvTiles<DD, false>::SMEM;                 \
    if (kind == 3) return DkvTiles<DD, true>::SMEM;                  \
    return -1;                                                       \
  }
  DL4J_SM90_SMEM(16)
  DL4J_SM90_SMEM(32)
  DL4J_SM90_SMEM(64)
  DL4J_SM90_SMEM(128)
#undef DL4J_SM90_SMEM
  return -1;
}

extern "C" const char* dl4j_flash_sm90_error_string(int code) {
  if (code == kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from libcuda";
  if (code == kBadMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
