// Flash attention on Hopper's wgmma and TMA (sm_90a) for bf16 inputs: the
// forward (K3), both passes of the two-pass backward (K5) and the fused
// backward (K4) at head dims 16 to 512. fp32 inputs stay with
// flash_attention.cu.
//
// Replaces the Pallas kernels of deeplearning4j_tpu/ops/flash_attention.py:
//   - flash_fwd_sm90_kernel: K3, `_call_fwd` (:448) with body `_fwd_kernel`
//     (:123): the online-softmax forward, o and the row log-sum-exp L, and
//     flash_fwd_split_sm90_kernel, the same at D 384 and 512;
//   - flash_dq_sm90_kernel: K5's dq pass, `_dq_kernel` (:262), and
//     flash_dq_split_sm90_kernel at D 384 and 512;
//   - flash_dkv_sm90_kernel: K5's dk/dv pass, `_dkv_kernel` (:301),
//     flash_dkv_wide_sm90_kernel, the same pass at D 192 and 256, and
//     flash_dkv_split_sm90_kernel at D 384 and 512;
//   - flash_bwd_fused_sm90_kernel: K4, `_fused_bwd_kernel` (:349): the
//     dk/dv pass that also forms dq, one launch,
//     flash_bwd_fused_wide_sm90_kernel, the wide dk/dv pass that also
//     forms dq, at D 192 and 256, and flash_bwd_fused_split_sm90_kernel,
//     the split dk/dv pass that also forms dq, at D 384 and 512.
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
// 64) or 64 (D 128 to 256) keys, a ring of three stages (two at D 256,
// where three stages beside Q would take 256 KB); the dq pass 128 q rows
// and key tiles of 128, 64 (D 128) or 32 keys (D 192/256: Q and dO stay
// resident, 128 KB at D 256, and dq takes D / 2 registers a thread); the
// dk/dv pass and K4 128 keys per CTA and q tiles of 64 (32 at D 128, to
// keep dk, dv, S^T and dP^T in registers). At D 192 and 256 dk and dv of
// 128 keys do not fit the register file: the wide dk/dv pass takes 64
// keys a CTA and splits the head dim between its warpgroups, and K4 there
// is the same pass with dq staged in 8 KB boxes (see wide_pass). At D 256
// the forward's O is 128 registers a thread beside S (32) and P (16), under
// the consumers' 232. At D 384 and 512 the split kernels take 64 rows a
// CTA and split the head dim between the warpgroups, and K4 there is the
// split dk/dv pass with dq staged in 8 KB pieces (see their section).
// TMA maps are 3-D (D, T, rows), so a box that runs past T is zero-filled
// instead of reading the next head; D 16/32/64 rows are one box with
// 32/64/128-byte swizzle, D 128 to 512 are 2 to 8 boxes of 64 columns.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  static constexpr int NBOX = D / COLS;        // 1, or D / 64 from D 128
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
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
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

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t* a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t* a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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
// m64 x K bf16 fragments in registers and B a K-row tile, N = D ("RS"),
// or N of its columns from the 64-column box at b (the dk/dv pass at D
// 192 and 256, whose warpgroups split the head dim).
template <int D, int R, int N>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint32_t a,
                                           int a_row0, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(d, desc_k<D, R>(a, a_row0, kk), desc_k<D, N>(b, 0, kk),
                kk > 0);
}

template <int D, int K, int N = D>
__device__ __forceinline__ void rs_product(float (&d)[N / 2],
                                           const uint32_t (&a)[K / 4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<N>(d, a + 4 * kk, desc_mn<D, K>(b, kk), 1);
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

// MH m64 x 32 pieces of dq^T (rows: 64 head-dim columns a piece; columns:
// the 32 q rows of a tile) of a thread, scaled, into fp32 staging boxes of
// 32 q rows x 32 columns (128-byte rows, swizzled at 128, as TMA reads
// them): element (row 8 i + cq + u, column 64 mh + col, col = r0 + 8 rr)
// goes to box (64 mh + col) / 32, byte 4 (col % 32) of the row; rows vary
// along q here, so the swizzle term does too
template <int MH>
__device__ __forceinline__ void stage_dq_t(unsigned char* tile,
                                           const float (&d)[16 * MH],
                                           float scale, int tw, int cq) {
  constexpr int BOX = 32 * 128;
  const int r0 = 16 * (tw >> 5) + ((tw & 31) >> 2);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int row = 8 * (e >> 2) + cq + (e & 1);
    const int col = r0 + 8 * ((e >> 1) & 1);
    const uint32_t off = row * 128 + 4 * (col % 32);
#pragma unroll
    for (int mh = 0; mh < MH; ++mh)
      *reinterpret_cast<float*>(tile + ((64 * mh + col) / 32) * BOX +
                                (off ^ (swizzle_term<128>(row) << 4))) =
          scale * d[16 * mh + e];
  }
}

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
  if constexpr (D <= 64) {
    // pair (row r0 + 8 rr, column 8 j + cq): box 8 j / COLS, byte 32 (j %
    // (COLS / 8)) + 4 cq of the row, so chunk 2 (j % (COLS / 8)) + cq / 4
    const int r0 = 16 * (tw >> 5) + ((tw & 31) >> 2);
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
    static_assert(BQ == 32 && Y::COLS == 32, "dq^T in 32-column boxes");
    stage_dq_t<2>(tile, d, scale, tw, cq);
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

// The producer warp of K3 or the dq pass: the CTA's BM rows of Q (and of
// dO if tdo is given) once on qbar, then K, V and the key-ok flags of each
// of the nt key tiles of BN keys from tile j0 on into the STAGES-deep
// ring; k/v rows of head row `kvrow`.
template <int D, int BM, int BN, int STAGES>
__device__ __forceinline__ void load_q_tiles(
    const CUtensorMap& tq, const CUtensorMap* tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, bf16* Qs, bf16* dOs, bf16* Ks, bf16* Vs,
    int* kms, uint64_t* qbar, uint64_t* full, uint64_t* empty,
    const int* __restrict__ km, int j0, int nt, int q_lo, int bh, int kvrow,
    int b, int T) {
  using X = Box<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_expect_tx(qbar, (tdo ? 2 : 1) * BM * D * 2);
    for (int c = 0; c < X::NBOX; ++c) {
      tma_load_3d(Qs + c * BM * X::COLS, &tq, qbar, c * X::COLS, q_lo, bh);
      if (tdo)
        tma_load_3d(dOs + c * BM * X::COLS, tdo, qbar, c * X::COLS, q_lo,
                    bh);
    }
  }
  for (int n = 0; n < nt; ++n) {
    const int s = n % STAGES, k_lo = (j0 + n) * BN;
    mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
    for (int c = lane; c < BN; c += 32) {
      const int kj = k_lo + c;
      kms[s * BN + c] = kj < T && (km == nullptr || km[(long)b * T + kj] != 0);
    }
    __syncwarp();
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * BN * D * 2);
      for (int c = 0; c < X::NBOX; ++c) {
        tma_load_3d(Ks + s * BN * D + c * BN * X::COLS, &tk, &full[s],
                    c * X::COLS, k_lo, kvrow);
        tma_load_3d(Vs + s * BN * D + c * BN * X::COLS, &tv, &full[s],
                    c * X::COLS, k_lo, kvrow);
      }
    }
  }
}

// ------------------------------------------------------------------ K3
template <int D>
struct FwdTiles {
  static constexpr int BM = ROWS;                 // q rows per CTA
  static constexpr int BN = D <= 64 ? 128 : 64;   // keys per tile
  // depth of the K/V ring: Q and three stages of K and V are 256 KB at D
  // 256, above a CTA's 227 KB
  static constexpr int STAGES = D > 192 ? 2 : 3;
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
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES;
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
    load_q_tiles<D, BM, BN, STAGES>(tq, nullptr, tk, tv, Qs, nullptr, Ks, Vs,
                                    kms, qbar, full, empty, km, j0, nt, q_lo,
                                    bh, kvrow, b, T);
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
  // keys per tile: above D 128, Q and dO resident (128 KB at D 256) leave
  // room for three stages of 32 keys, and dq (D / 2 registers a thread)
  // beside S, dP and dS of 32 keys fits the consumers' registers
  static constexpr int BN = D <= 64 ? 128 : D <= 128 ? 64 : 32;
  static constexpr int STAGES = 3;
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
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES;
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
    load_q_tiles<D, BM, BN, STAGES>(tq, &tdo, tk, tv, Qs, dOs, Ks, Vs, kms,
                                    qbar, full, empty, km, j0, nt, q_lo, bh,
                                    bh, b, T);
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
  static constexpr int STAGES = 3;
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

// The producer warp of a dk/dv pass: K and V of the CTA's BK keys once
// (on kvbar), then Q, dO, L log2(e) and D_i of each of the nt q tiles of
// BQ rows from tile i0 on into the STAGES-deep ring, SWEEPS times over
// (the split pass walks the q tiles twice).
template <int D, int BK, int BQ, int STAGES, int SWEEPS = 1>
__device__ __forceinline__ void load_dkv_tiles(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, bf16* Ks, bf16* Vs, bf16* Qs, bf16* dOs,
    float* Ls, float* Dis, uint64_t* kvbar, uint64_t* full, uint64_t* empty,
    const float* __restrict__ lse, const float* __restrict__ di, int i0,
    int nt, int k_lo, int bh, int T) {
  using X = Box<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_expect_tx(kvbar, 2 * BK * D * 2);
    for (int c = 0; c < X::NBOX; ++c) {
      tma_load_3d(Ks + c * BK * X::COLS, &tk, kvbar, c * X::COLS, k_lo, bh);
      tma_load_3d(Vs + c * BK * X::COLS, &tv, kvbar, c * X::COLS, k_lo, bh);
    }
  }
  for (int n = 0; n < SWEEPS * nt; ++n) {
    const int s = n % STAGES;
    const int q_lo = (i0 + (SWEEPS == 1 ? n : n % nt)) * BQ;
    mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
    for (int r = lane; r < BQ; r += 32) {
      const int qi = q_lo + r;   // rows past T: 0 (their pairs are masked)
      Ls[s * BQ + r] = qi < T ? lse[(long)bh * T + qi] * LOG2E : 0.f;
      Dis[s * BQ + r] = qi < T ? di[(long)bh * T + qi] : 0.f;
    }
    __syncwarp();
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * BQ * D * 2);
      for (int c = 0; c < X::NBOX; ++c) {
        tma_load_3d(Qs + s * BQ * D + c * BQ * X::COLS, &tq, &full[s],
                    c * X::COLS, q_lo, bh);
        tma_load_3d(dOs + s * BQ * D + c * BQ * X::COLS, &tdo, &full[s],
                    c * X::COLS, q_lo, bh);
      }
    }
  }
}

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
  constexpr int BK = C::BK, BQ = C::BQ, STAGES = C::STAGES;
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
    load_dkv_tiles<D, BK, BQ, STAGES>(tq, tk, tv, tdo, Ks, Vs, Qs, dOs, Ls,
                                      Dis, kvbar, full, empty, lse, di, i0,
                                      nt, k_lo, bh, T);
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

// ------------------------------- K5's dk/dv pass and K4 at D 192 and 256
// dK and dV of 128 keys (2 x 128 x D fp32) would take the whole register
// file at D 256. So a CTA takes 64 keys, and its two consumer warpgroups
// split each q tile's work by role: warpgroup 0 forms S^T = K Q^T and P^T,
// warpgroup 1 dP^T = V dO^T and dS^T = P^T (dP^T - D_i). P^T (fp32) goes
// from 0 to 1 in two halves through one 8 KB buffer, laid out by thread
// (word e of thread t at e * 128 + t, so that thread t of one warpgroup
// reads what thread t of the other wrote, without bank conflicts), which
// then holds dS^T as a swizzled bf16 tile (store_ds) until the next tile's
// P^T. Each warpgroup holds dK and dV of its own 64-column boxes of the
// head dim (two each at D 256; two and one at D 192) and adds P^T dO (P^T
// from registers, "RS") and dS^T Q (dS^T from the tile, K-major, "SS")
// over them. S^T and dP^T are formed once; dS^T is rounded where the other
// instances round it, so the pass computes what theirs does.
//
// K4 (DQ) is the same pass that also forms dq, in one launch: the same
// tiles, q-tile order and products for dk and dv, so those come out as
// K5's bit for bit. Beside them each warpgroup forms dq = dS K of the tile
// over the CTA's keys for its own 64-column pieces of the head dim
// (warpgroup 0 the first D / 128 of them), one piece (32 registers a
// thread) at a time, both operands MN-major in shared memory as in DqPath,
// and stages its scaled pieces as boxes of 64 q rows x 32 fp32 columns (8
// KB) in a ring of its own (at D 256 one for warpgroup 0 and two for 1,
// whose second piece is staged inside the exchange; two and three at D
// 192), which a warp of the producer warpgroup hands to the TMA unit as
// reduce-adds into the zeroed fp32 dq (dq_wide_writer). K, V and two
// stages of Q and dO take 192 KB at D 256; the boxes leave K4 two stages
// at D 192 too, where K5 keeps three. The staging of a piece waits on the
// products in flight: the first piece of a tile is staged while the next
// tile's S^T or dP^T product runs, the second where the other warpgroup
// works (see `exchange`). On the H100 the dq products add no measurable
// time to the pass; the staging (stores, proxy fences, handoffs) and the
// reductions do, about as much as the pass itself at D 256
// (experiments/torch_flash_k4_wide_ab.py times each).

// The exchange between the two roles (named barriers of all NC consumer
// threads): P_READY when a half of P^T is in the buffer, DS_READY when
// dS^T is; X_FREE (warpgroup 1 to 0) once its products have read dS^T,
// and again once it has read the first half of P^T. K4's staging handoff
// of warpgroup w's box s: FULL when the warpgroup has written it, FREE
// once the TMA unit has read it, each between the warpgroup and its dq
// warp (WidePieces).
constexpr int P_READY = 1, DS_READY = 2, X_FREE = 3, WQ_FULL = 4;

template <int D, bool DQ>
struct WideTiles {
  static constexpr int BK = 64;                   // keys per CTA
  static constexpr int BQ = 64;                   // q rows per tile
  static constexpr int STAGES = DQ || D > 192 ? 2 : 3;
  static constexpr int NB = D / 64;               // 64-column boxes of D
  static constexpr int NB0 = (NB + 1) / 2;        // dk/dv boxes of wg 0
  static constexpr int NQ0 = NB / 2;              // dq pieces of wg 0
  // K4's dq staging boxes of warpgroup 0 and 1
  static constexpr int NSB0 = !DQ ? 0 : D > 192 ? 1 : 2;
  static constexpr int NSB1 = !DQ ? 0 : D > 192 ? 2 : 3;
  static constexpr int SBYTES = BQ * 32 * 4;      // a staging box
  static constexpr int KBYTES = BK * D * 2;
  static constexpr int QBYTES = BQ * D * 2;
  static constexpr int V_OFF = KBYTES;
  static constexpr int Q_OFF = 2 * KBYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QBYTES;
  // half of P^T (fp32), then dS^T (bf16)
  static constexpr int XP_OFF = DO_OFF + STAGES * QBYTES;
  static constexpr int SB_OFF = XP_OFF + BK * BQ * 2;      // staging boxes
  static constexpr int L_OFF = SB_OFF + (NSB0 + NSB1) * SBYTES;
  static constexpr int DI_OFF = L_OFF + STAGES * BQ * 4;
  static constexpr int BAR_OFF = DI_OFF + STAGES * BQ * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  // warpgroup 1's own barrier: all of it has read the second half of P^T
  static constexpr int XP_READ = WQ_FULL + 2 * (NSB0 + NSB1);
  static_assert(XP_READ <= 15, "named barriers 1 to 15");
};

// p = 2^(c s - L log2 e) of an m64 (keys) x BQ (queries) S^T tile in
// place, masked as in dkv_p_ds; the thread's elements [E0, E1) only
template <bool MASKED, int BQ, int E0 = 0, int E1 = BQ / 2>
__device__ __forceinline__ void dkv_p(float (&st)[BQ / 2], float c,
                                      const float* L2q, const Geometry& g,
                                      int q_lo, int kj0, const bool (&ko)[2],
                                      int cq) {
#pragma unroll
  for (int e = E0; e < E1; e += 2) {
    const int r = (e >> 1) & 1, col = 8 * (e >> 2) + cq;
    const float2 L2 = *reinterpret_cast<const float2*>(L2q + col);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float x = fmaf(st[e + u], c, -(u ? L2.y : L2.x));
      if (MASKED && !visible(g, q_lo + col + u, kj0 + 8 * r, ko[r]))
        x = DL4J_NEG_INF;
      st[e + u] = exp2_fast(x);
    }
  }
}

// K4's dq pieces of consumer warpgroup W: NPC 64-column pieces from PC0;
// its NSB staging boxes from box B0, with the named barriers FULL + s and
// FREE + s of box s
template <int D, int W>
struct WidePieces {
  using C = WideTiles<D, true>;
  static constexpr int NPC = W == 0 ? C::NQ0 : C::NB - C::NQ0;
  static constexpr int PC0 = W == 0 ? 0 : C::NQ0;
  static constexpr int NSB = W == 0 ? C::NSB0 : C::NSB1;
  static constexpr int B0 = W == 0 ? 0 : C::NSB0;
  static constexpr int FULL = WQ_FULL + B0;
  static constexpr int FREE = WQ_FULL + C::NSB0 + C::NSB1 + B0;
  static_assert(NPC == 1 || NPC == 2, "one or two dq pieces a tile");
};

// columns [32 H, 32 H + 32) of a thread's m64 x 64 dq piece (rows q),
// scaled, into an fp32 staging box (64 rows of 128 bytes, swizzled at
// 128, as a TMA box): pair (row r0 + 8 r, column 8 j + cq) at chunk 2 (j %
// 4) + cq / 4 of its row
template <int H>
__device__ __forceinline__ void stage_dq_box(unsigned char* box,
                                             const float (&d)[32],
                                             float scale, int tw, int cq) {
  const int r0 = 16 * (tw >> 5) + ((tw & 31) >> 2);
  unsigned char* base = box + r0 * 128 + 4 * (cq & 2);
  const uint32_t x = swizzle_term<128>(r0), c4 = cq >> 2;
#pragma unroll
  for (int e = 16 * H; e < 16 * H + 16; e += 2)
    *reinterpret_cast<float2*>(base + 8 * 128 * ((e >> 1) & 1) +
                               (((2 * ((e >> 2) & 3) + c4) ^ x) << 4)) =
        make_float2(scale * d[e], scale * d[e + 1]);
}

// The dq warp of consumer warpgroup W: for each of its staged boxes, in
// the order the warpgroup writes them (q tile, piece, box), waits for it
// to be full, has the TMA unit add it into dq, and hands the box back once
// the reduction has read it.
template <int D, int W>
__device__ __forceinline__ void dq_wide_writer(const CUtensorMap& tdq,
                                               unsigned char* sb, int i0,
                                               int nt, int bh) {
  using C = WideTiles<D, true>;
  using P = WidePieces<D, W>;
  constexpr int NSB = P::NSB;
  const bool lead = (threadIdx.x & 31) == 0;
  const int uses = 2 * P::NPC * nt;
  int j = 0;
  for (int n = 0; n < nt; ++n)
#pragma unroll
    for (int pc = 0; pc < P::NPC; ++pc)
#pragma unroll
      for (int h = 0; h < 2; ++h, ++j) {
        const int s = j % NSB;
        named_sync(P::FULL + s, DQ_HANDOFF);
        if (lead) {
          tma_reduce_add(sb + s * C::SBYTES, &tdq,
                         64 * (P::PC0 + pc) + 32 * h, (i0 + n) * C::BQ, bh);
          bulk_commit();
          bulk_wait_read<0>();
        }
        __syncwarp();
        if (j + NSB < uses) named_arrive(P::FREE + s, DQ_HANDOFF);
      }
}

// Consumer warpgroup W of the wide pass (K4's if DQ) over the nt q tiles
// from i0 that see the CTA's 64 keys at k_lo.
template <int D, int W, bool DQ>
__device__ __forceinline__ void wide_role(
    unsigned char* sm, int i0, int nt, int k_lo, int b,
    const int* __restrict__ km, const Geometry& g, float scale,
    bf16* __restrict__ dk, bf16* __restrict__ dv, long base) {
  using C = WideTiles<D, DQ>;
  using P = WidePieces<D, W>;
  constexpr int BK = C::BK, BQ = C::BQ, STAGES = C::STAGES, NSB = P::NSB;
  constexpr int NCOL = W == 0 ? 64 * C::NB0 : D - 64 * C::NB0;
  constexpr int COL0 = W == 0 ? 0 : 64 * C::NB0;
  constexpr int TILE = BQ * D * 2;             // bytes of a Q or dO stage
  // the first of the warpgroup's boxes in a Q or dO stage
  constexpr int AT = (COL0 / 64) * BQ * Box<D>::RB;
  constexpr int HALF = BQ / 4;                 // P^T floats in a half
  constexpr bool TWO = DQ && P::NPC == 2;      // a second dq piece a tile
  const int T = g.T;
  const int tw = threadIdx.x & 127, lane = tw & 31, cq = 2 * (lane & 3);
  const int row = 16 * (tw >> 5) + (lane >> 2);
  const int kj0 = k_lo + row;
  const uint32_t ks = smem_u32(sm), vs = smem_u32(sm + C::V_OFF);
  const uint32_t qs = smem_u32(sm + C::Q_OFF), dos = smem_u32(sm + C::DO_OFF);
  const uint32_t dss = smem_u32(sm + C::XP_OFF);
  const float* Ls = reinterpret_cast<const float*>(sm + C::L_OFF);
  const float* Dis = reinterpret_cast<const float*>(sm + C::DI_OFF);
  float2* xp = reinterpret_cast<float2*>(sm + C::XP_OFF);
  unsigned char* sb = sm + C::SB_OFF + P::B0 * C::SBYTES;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;
  bool ko[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kj0 + 8 * r;
    ko[r] = kj < T && (km == nullptr || km[(long)b * T + kj] != 0);
  }
  const float c = scale * LOG2E;
  float dka[NCOL / 2], dva[NCOL / 2], dqa[DQ ? 32 : 1];
  zero(dka);
  zero(dva);
  zero(dqa);
  float x[BQ / 2];            // S^T (warpgroup 0) or dP^T (1) of a tile
  uint32_t pa[BQ / 4];
  int use = 0;                // staging boxes written so far
  auto stage_box = [&](auto h) {
    const int s = use % NSB;
    if (use >= NSB) named_sync(P::FREE + s, DQ_HANDOFF);
    stage_dq_box<decltype(h)::value>(sb + s * C::SBYTES, dqa, scale, tw, cq);
    fence_async_smem();
    named_arrive(P::FULL + s, DQ_HANDOFF);
    ++use;
  };
  auto stage_piece = [&] {
    if constexpr (DQ) {
      stage_box(std::integral_constant<int, 0>());
      stage_box(std::integral_constant<int, 1>());
    }
  };
  // dqa = dS K over the CTA's keys, columns of the warpgroup's piece pc
  auto dq_piece = [&](int pc) {
    if constexpr (DQ) {
      const uint32_t kb = ks + (P::PC0 + pc) * BK * 128;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_t<64>(dqa, desc_mn<64, BK>(dss, kk),
                       desc_mn<64, BK>(kb, kk), kk > 0);
    }
  };
  // dv += P^T dO, dk += dS^T Q over the warpgroup's columns of stage s
  auto dkv_products = [&](int s) {
    rs_product<D, BQ, NCOL>(dva, pa, dos + s * TILE + AT);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_tn<NCOL>(dka, desc_k<BQ, BK>(dss, 0, kk),
                     desc_mn<D, BQ>(qs + s * TILE + AT, kk), 1);
  };
  // P^T and dS^T of q tile n: P^T as A fragments in both warpgroups, dS^T
  // in the shared buffer; `pending` stages what is left of the previous
  // tile's dq where the other warpgroup works: warpgroup 1 while 0 forms
  // P^T, warpgroup 0 once the exchange is done, while 1's next products
  // run
  auto exchange = [&](int n, bool pending) {
    const int s = n % STAGES, q_lo = (i0 + n) * BQ;
    if constexpr (W == 0) {
      const bool masked = tile_masked<BQ, BK>(g, q_lo, k_lo, km != nullptr);
      if (masked)
        dkv_p<true, BQ, 0, HALF>(x, c, Ls + s * BQ, g, q_lo, kj0, ko, cq);
      else
        dkv_p<false, BQ, 0, HALF>(x, c, Ls + s * BQ, g, q_lo, kj0, ko, cq);
      named_sync(X_FREE, NC);
#pragma unroll
      for (int e = 0; e < HALF; e += 2)
        xp[(e / 2) * 128 + tw] = make_float2(x[e], x[e + 1]);
      named_arrive(P_READY, NC);
      if (masked)
        dkv_p<true, BQ, HALF>(x, c, Ls + s * BQ, g, q_lo, kj0, ko, cq);
      else
        dkv_p<false, BQ, HALF>(x, c, Ls + s * BQ, g, q_lo, kj0, ko, cq);
      pack_a<BQ>(x, pa);
      named_sync(X_FREE, NC);
#pragma unroll
      for (int e = HALF; e < BQ / 2; e += 2)
        xp[((e - HALF) / 2) * 128 + tw] = make_float2(x[e], x[e + 1]);
      named_arrive(P_READY, NC);
      named_sync(DS_READY, NC);
      if (pending) stage_piece();
    } else {
      const float* Dq = Dis + s * BQ;
      uint32_t da[BQ / 4];
      named_arrive(X_FREE, NC);
      if (pending) stage_piece();
#pragma unroll
      for (int e = 0; e < BQ / 2; e += 2) {
        if (e % HALF == 0) {
          if (e) named_arrive(X_FREE, NC);
          named_sync(P_READY, NC);
        }
        const float2 p = xp[((e % HALF) / 2) * 128 + tw];
        const float2 Di =
            *reinterpret_cast<const float2*>(Dq + 8 * (e >> 2) + cq);
        pa[e / 2] = pack_bf16(p.x, p.y);
        da[e / 2] = pack_bf16(p.x * (x[e] - Di.x), p.y * (x[e + 1] - Di.y));
      }
      named_sync(C::XP_READ, 128);
      store_ds<BQ>(sm + C::XP_OFF, da, row, cq);
      fence_async_smem();
      // a sync, not an arrive: this warpgroup's own products read the tile
      // next, so every one of its warps must have written its part
      named_sync(DS_READY, NC);
    }
  };
  // Turn 0 forms the role's tile of q tile 0; turn t in [1, nt) the dk,
  // dv (and dq) products of tile t - 1 and the role's tile of tile t;
  // turn nt the last ones. The exchange of tile t follows its product.
  const uint32_t a0 = W == 0 ? ks : vs, b0 = W == 0 ? qs : dos;
  mbar_wait(kvbar, 0);
  wg_fence();
  mbar_wait(&full[0], 0);
  ss_product<D, BK, BQ>(x, a0, 0, b0);
  wg_commit();
  wg_wait<0>();
  fence_regs(x);
  exchange(0, false);
  for (int t = 1; t < nt; ++t) {
    const int sp = (t - 1) % STAGES, sn = t % STAGES;
    wg_fence();
    dkv_products(sp);
    dq_piece(0);
    wg_commit();
    mbar_wait(&full[sn], (t / STAGES) & 1);
    ss_product<D, BK, BQ>(x, a0, 0, b0 + sn * TILE);
    wg_commit();
    wg_wait<1>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(dqa);
    mbar_arrive(&empty[sp]);
    stage_piece();
    if constexpr (TWO) {
      wg_fence();
      dq_piece(1);
      wg_commit();
    }
    wg_wait<0>();
    fence_regs(x);
    fence_regs(dqa);
    exchange(t, TWO);
  }
  wg_fence();
  dkv_products((nt - 1) % STAGES);
  dq_piece(0);
  wg_commit();
  wg_wait<0>();
  fence_regs(dva);
  fence_regs(dka);
  fence_regs(dqa);
  stage_piece();
  if constexpr (TWO) {
    wg_fence();
    dq_piece(1);
    wg_commit();
    wg_wait<0>();
    fence_regs(dqa);
    stage_piece();
  }
#pragma unroll
  for (int e = 0; e < NCOL / 2; e += 2) {
    const int kj = kj0 + 8 * ((e >> 1) & 1);
    if (kj < T) {
      const long off = base + (long)kj * D + COL0 + 8 * (e >> 2) + cq;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(scale * dka[e], scale * dka[e + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dva[e], dva[e + 1]);
    }
  }
}

// The wide dk/dv pass (DQ false, K5's second kernel) and K4 (DQ true) at
// D 192/256: one CTA per 64 keys.
template <int D, bool DQ>
__device__ __forceinline__ void wide_pass(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const CUtensorMap& tdq,
    const int* __restrict__ km, const float* __restrict__ lse,
    const float* __restrict__ di, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, Geometry g, float scale) {
  using C = WideTiles<D, DQ>;
  constexpr int BK = C::BK, BQ = C::BQ, STAGES = C::STAGES;
  const int j = blockIdx.x;         // the most-visited key tiles first
  const int bh = blockIdx.y, b = bh / H;
  const int T = g.T, k_lo = j * BK;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
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
    // producer warpgroup: warp 0 loads; in K4 warps 1 and 2 hand the dq
    // boxes of consumer warpgroups 0 and 1 to the TMA unit
    regs_dec<PRODUCER_REGS>();
    const int warp = (threadIdx.x - NC) >> 5;
    if constexpr (DQ) {
      unsigned char* sb = sm + C::SB_OFF;
      if (warp == 1) dq_wide_writer<D, 0>(tdq, sb, i0, nt, bh);
      if (warp == 2)
        dq_wide_writer<D, 1>(tdq, sb + C::NSB0 * C::SBYTES, i0, nt, bh);
    }
    if (warp != 0) return;
    load_dkv_tiles<D, BK, BQ, STAGES>(
        tq, tk, tv, tdo, reinterpret_cast<bf16*>(sm),
        reinterpret_cast<bf16*>(sm + C::V_OFF),
        reinterpret_cast<bf16*>(sm + C::Q_OFF),
        reinterpret_cast<bf16*>(sm + C::DO_OFF),
        reinterpret_cast<float*>(sm + C::L_OFF),
        reinterpret_cast<float*>(sm + C::DI_OFF), kvbar, full, empty, lse,
        di, i0, nt, k_lo, bh, T);
  } else {
    regs_inc<CONSUMER_REGS>();
    const long base = (long)bh * T * D;
    if (threadIdx.x < 128)
      wide_role<D, 0, DQ>(sm, i0, nt, k_lo, b, km, g, scale, dk, dv, base);
    else
      wide_role<D, 1, DQ>(sm, i0, nt, k_lo, b, km, g, scale, dk, dv, base);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const int* __restrict__ km,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, Geometry g, float scale) {
  wide_pass<D, false>(tq, tk, tv, tdo, tq, km, lse, di, dk, dv, H, g, scale);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_fused_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const __grid_constant__ CUtensorMap tdq,
                                 const int* __restrict__ km,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ di,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                                 int H, Geometry g, float scale) {
  wide_pass<D, true>(tq, tk, tv, tdo, tdq, km, lse, di, dk, dv, H, g, scale);
}

// ------------------------- K3, K4 and K5 at D 384 and 512: the split kernels
// Why the designs above do not stretch to D 384 and 512. A CTA has 232,448
// bytes of shared memory and an SM 64K registers; the consumers get
// CONSUMER_REGS (232) a thread; wgmma's M is 64 rows per warpgroup. At D
// 512 the O (or dq) accumulator of 64 rows is 64 x 512 fp32: 256 registers
// a thread if one warpgroup holds it. A 64-row bf16 tile of Q, K, V or dO
// is 64 KB. dK and dV of 64 keys are 256 KB of fp32, the whole register
// file. So FwdTiles (128 q rows, each warpgroup holding all of D), DqTiles
// and WideTiles (each warpgroup holding dK and dV of half the boxes, over
// 64 keys) do not carry over.
//
// The split kernels give each CTA 64 rows (q rows in K3 and the dq pass,
// keys in the dk/dv pass) and split the head dim between the two consumer
// warpgroups: warpgroup w holds the accumulator's columns [w D/2, (w + 1)
// D/2) (O, dq, dV then dK: 128 registers a thread at D 512, 96 at 384)
// and forms each score product over its half of D only ("SS", K = D/2).
// The two partials of S (and dP, or S^T and dP^T) go through a shared
// exchange laid out by thread (float2 j of thread t at j * 128 + t, so
// thread t of one warpgroup reads what thread t of the other wrote,
// without bank conflicts): two slots used in turn behind one named barrier
// (X_SYNC) a tile, or, where shared memory holds one slot, that slot behind
// two. Each warpgroup adds the other's partial to its own: a + b = b + a
// exactly, so both hold the same bits of the full scores and run the same
// softmax or dS, and every output but K4's dq is written once by one
// thread: no atomic, no reduction, bit for bit repeatable. The
// accumulating product takes the warpgroup's half of the streamed tile's
// columns ("RS", N = D/2: 256 or 192).
//   - K3 (flash_fwd_split_sm90_kernel): Q resident (64 KB at D 512), K and
//     V stream at 64 keys in one stage (D 512) or 32 in three (384);
//     O_w += P V_w.
//   - K5's dq pass (flash_dq_split_sm90_kernel): Q and dO resident (128
//     KB), K and V stream at 32 keys in one stage (D 512) or 16 in three
//     (384); dS = p (dP - D_i) rounded to bf16 as everywhere, dq_w += dS
//     K_w.
//   - K5's dk/dv pass (flash_dkv_split_sm90_kernel): K and V resident, Q
//     and dO stream at 32 q rows in one stage (D 512) or two (384), and
//     the CTA walks its q tiles twice:
//     first dV_w += P^T dO_w (S^T exchanged), written out, then dK_w +=
//     dS^T Q_w (S^T and dP^T exchanged) in the same registers. The products
//     are 5 where one sweep would do 4 (S^T twice), but one accumulator of
//     128 registers is live where dK and dV together would not fit.
//   - K4 (flash_bwd_fused_split_sm90_kernel): that pass with dq formed in
//     its second sweep and reduce-added by TMA (see split_dkv_pass).
// Every walk with two stages or more overlaps the accumulating product of
// tile t - 1 with the score products, exchange and register pass of tile
// t (split_walk). What bounds them: shared memory, in size and in reads.
// At D 512 the resident operand and one stage take 192 KB and the
// exchange's one slot 32 KB, so the loads of a tile wait for the products
// of the one before. The score products read their A operand (Q, dO, K or
// V rows) from shared memory for every tile: 2 KB a k16 step, beside 0.5
// to 2 KB of B for 8 to 32 clocks of tensor work at N 16 to 64, where the
// SM reads 128 bytes a clock: the larger N, the nearer the tensor rate.

// The exchange's barrier: all NC consumer threads, once (twice with one
// slot) a tile.
constexpr int X_SYNC = 1;

// With ON, a shared-memory address the compiler cannot carry from one
// product to the next: the descriptors built from it are recomputed at
// each product instead of held in registers across the walk. At D 512 the
// resident operand's and the one-stage ring's are loop-invariant; held,
// they spill (60 to 548 bytes) and K5 took 20.0 ms against 16.0-16.3 (B*H
// 16, T 8192, causal, on an H100 80GB HBM3 at 700 W); at D 384 nothing
// spills and recomputing them cost K5 5% there
// (experiments/torch_flash_split_ab.py, "opaque_other").
template <bool ON>
__device__ __forceinline__ uint32_t opaque(uint32_t a) {
  if constexpr (ON) asm volatile("" : "+r"(a));
  return a;
}

// the m64 x N partial d of this thread to its place in the exchange, and
// the other warpgroup's partial of the same elements added to it
template <int N>
__device__ __forceinline__ void put_partial(float* x, const float (&d)[N / 2],
                                            int tw) {
  float2* p = reinterpret_cast<float2*>(x);
#pragma unroll
  for (int e = 0; e < N / 2; e += 2)
    p[(e / 2) * 128 + tw] = make_float2(d[e], d[e + 1]);
}
template <int N>
__device__ __forceinline__ void add_partial(float (&d)[N / 2], const float* x,
                                            int tw) {
  const float2* p = reinterpret_cast<const float2*>(x);
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) {
    const float2 o = p[(e / 2) * 128 + tw];
    d[e] += o.x;
    d[e + 1] += o.y;
  }
}

// Exchange n of NP partials (a, and b if NP is 2) of m64 x N accumulators:
// slot n % XSLOTS of `xs` holds [warpgroup][partial] blocks of N / 2 x 128
// floats. With two slots, exchange n + 2 writes a slot the other warpgroup
// finished reading before it reached the barrier of exchange n + 1.
template <int N, int NP, int XSLOTS>
__device__ __forceinline__ void exchange(float* xs, int n, int wg, int tw,
                                         float (&a)[N / 2],
                                         float (&b)[N / 2]) {
  constexpr int PART = N / 2 * 128;
  float* slot = xs + (n % XSLOTS) * NCWG * NP * PART;
  put_partial<N>(slot + wg * NP * PART, a, tw);
  if constexpr (NP == 2) put_partial<N>(slot + (wg * NP + 1) * PART, b, tw);
  named_sync(X_SYNC, NC);
  const float* other = slot + (wg ^ 1) * NP * PART;
  add_partial<N>(a, other, tw);
  if constexpr (NP == 2) add_partial<N>(b, other + PART, tw);
  if constexpr (XSLOTS == 1) named_sync(X_SYNC, NC);
}

// The walk of a split kernel's consumer warpgroup over nt streamed tiles,
// whose ring slots start at n0: turn 0 forms the scores of tile 0 (ss);
// turn t in [1, nt) the scores of tile t and the accumulating product of
// tile t - 1 (acc), with the exchange and register pass of tile t (pass)
// running while the latter is in flight, and `pack` (A fragments of the
// next accumulating product) once it is done; the last turn the last
// accumulating product. `post` (K4's dq of tile t - 1) runs once the
// accumulating product of tile t - 1 is done and its ring slot handed
// back, before `pack` of tile t. Every ring slot is handed back. With one
// stage the slot of tile t - 1 must be free before tile t loads, so
// nothing overlaps but `post` with that load. No product is issued under
// a condition (ptxas would serialize the products).
struct NoPost {
  __device__ __forceinline__ void operator()(int) const {}
};

template <int STAGES, class SS, class ACC, class PASS, class PACK,
          class POST = NoPost>
__device__ __forceinline__ void split_walk(int nt, int n0, uint64_t* full,
                                           uint64_t* empty, SS ss, ACC acc,
                                           PASS pass, PACK pack,
                                           POST post = {}) {
  wg_fence();
  mbar_wait(&full[n0 % STAGES], (n0 / STAGES) & 1);
  ss(n0 % STAGES);
  wg_commit();
  wg_wait<0>();
  pass(0);
  pack(0);
  for (int t = 1; t < nt; ++t) {
    const int n = n0 + t, sp = (n - 1) % STAGES, sn = n % STAGES;
    wg_fence();
    if constexpr (STAGES == 1) {
      acc(sp);
      wg_commit();
      wg_wait<0>();
      mbar_arrive(&empty[sp]);
      post(t - 1);
      wg_fence();
      mbar_wait(&full[sn], (n / STAGES) & 1);
      ss(sn);
      wg_commit();
      wg_wait<0>();
      pass(t);
    } else {
      mbar_wait(&full[sn], (n / STAGES) & 1);
      ss(sn);
      wg_commit();
      acc(sp);
      wg_commit();
      wg_wait<1>();
      pass(t);
      wg_wait<0>();
      mbar_arrive(&empty[sp]);
      post(t - 1);
    }
    pack(t);
  }
  const int sl = (n0 + nt - 1) % STAGES;
  wg_fence();
  acc(sl);
  wg_commit();
  wg_wait<0>();
  mbar_arrive(&empty[sl]);
  post(nt - 1);
}

// shared-memory offset (bytes) of warpgroup wg's first 64-column box in a
// tile of R rows at D: its columns start at box wg (D / 2) / 64
template <int D, int R>
__device__ __forceinline__ uint32_t half_off(int wg) {
  return wg * (D / 128) * R * 128;
}

// Tiles (experiments/torch_flash_split_ab.py chose them): at D 512 the
// ring holds one stage and the exchange one slot beside the resident
// operand, and the larger tile of that one stage measured faster than
// smaller tiles in more stages (fewer barriers a key, score products with
// a larger N); at D 384, except for the dk/dv pass, smaller tiles in three
// stages with two slots measured faster.
template <int D>
struct SplitFwdTiles {
  static constexpr int BM = 64;                 // q rows per CTA
  static constexpr int BN = D > 384 ? 64 : 32;  // keys per tile
  static constexpr int STAGES = D > 384 ? 1 : 3;
  static constexpr int XSLOTS = D > 384 ? 1 : 2;
  static constexpr bool OPAQUE = D > 384;       // see opaque
  static constexpr int QBYTES = BM * D * 2;
  static constexpr int KBYTES = BN * D * 2;
  static constexpr int K_OFF = QBYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KBYTES;
  static constexpr int X_OFF = V_OFF + STAGES * KBYTES;
  static constexpr int KM_OFF = X_OFF + XSLOTS * NCWG * BM * BN * 4;
  static constexpr int BAR_OFF = KM_OFF + STAGES * BN * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_split_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const int* __restrict__ km,
                            bf16* __restrict__ o, float* __restrict__ lse,
                            int H, int Hk, Geometry g, float scale) {
  using C = SplitFwdTiles<D>;
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES, DH = D / 2;
  const int i = gridDim.x - 1 - blockIdx.x;   // the longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int kvrow = b * Hk + h / (H / Hk);
  const int T = g.T, q_lo = i * BM;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
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
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= NC + 32) return;
    load_q_tiles<D, BM, BN, STAGES>(
        tq, nullptr, tk, tv, reinterpret_cast<bf16*>(sm), nullptr, Ks, Vs,
        kms, qbar, full, empty, km, j0, nt, q_lo, bh, kvrow, b, T);
  } else {
    regs_inc<CONSUMER_REGS>();
    // consumer warpgroup wg: all 64 q rows, O's columns [wg DH, wg DH +
    // DH); this thread's rows qi0 and qi0 + 8
    const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
    const int lane = tw & 31, cq = 2 * (lane & 3);
    const int qi0 = q_lo + 16 * (tw >> 5) + (lane >> 2);
    const uint32_t qs = smem_u32(sm) + half_off<D, BM>(wg);
    const uint32_t ks = smem_u32(Ks) + half_off<D, BN>(wg);
    const uint32_t vs = smem_u32(Vs) + half_off<D, BN>(wg);
    float* xs = reinterpret_cast<float*>(sm + C::X_OFF);
    constexpr int TILE = BN * D * 2;            // bytes of a K or V stage
    const float c = scale * LOG2E;
    float acc[DH / 2];
    zero(acc);
    float m[2] = {DL4J_NEG_INF, DL4J_NEG_INF}, l[2] = {0.f, 0.f};
    float sc[BN / 2], al[2];
    uint32_t pa[BN / 4];
    const auto at = [](uint32_t a) { return opaque<C::OPAQUE>(a); };
    mbar_wait(qbar, 0);
    split_walk<STAGES>(
        nt, 0, full, empty,
        [&](int s) {
          ss_product<DH, BM, BN>(sc, at(qs), 0, at(ks + s * TILE));
        },
        [&](int s) { rs_product<D, BN, DH>(acc, pa, at(vs + s * TILE)); },
        [&](int t) {
          // S = the two partials, then p = 2^(S - m) over it in place
          fence_regs(sc);
          exchange<BN, 1, C::XSLOTS>(xs, t, wg, tw, sc, sc);
          const int k_lo = (j0 + t) * BN;
          const int* kmk = kms + (t % STAGES) * BN;
          if (tile_masked<BM, BN>(g, q_lo, k_lo, km != nullptr))
            online_softmax<true, BN>(sc, m, l, al, c, g, qi0, k_lo, kmk, cq);
          else
            online_softmax<false, BN>(sc, m, l, al, c, g, qi0, k_lo, kmk,
                                      cq);
        },
        [&](int) {
          // O of the tiles before t to the new running max (0 at t = 0)
          fence_regs(acc);
#pragma unroll
          for (int e = 0; e < DH / 2; ++e) acc[e] *= al[(e >> 1) & 1];
          pack_a<BN>(sc, pa);
        });
    fence_regs(acc);
    bf16* ob = o + (long)bh * T * D + wg * DH;
#pragma unroll
    for (int e = 0; e < DH / 2; e += 2) {
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
      if (wg == 0 && (lane & 3) == 0 && qi0 + 8 * r < T)
        lse[(long)bh * T + qi0 + 8 * r] =
            l[r] > 0.f ? m[r] * LN2 + logf(fmaxf(l[r], 1e-30f))
                       : DL4J_NEG_INF;
    }
  }
}

template <int D>
struct SplitDqTiles {
  static constexpr int BM = 64;                 // q rows per CTA
  static constexpr int BN = D > 384 ? 32 : 16;  // keys per tile
  static constexpr int STAGES = D > 384 ? 1 : 3;
  static constexpr int XSLOTS = D > 384 ? 1 : 2;
  static constexpr bool OPAQUE = D > 384;
  static constexpr int QBYTES = BM * D * 2;
  static constexpr int KBYTES = BN * D * 2;
  static constexpr int DO_OFF = QBYTES;
  static constexpr int K_OFF = 2 * QBYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KBYTES;
  static constexpr int X_OFF = V_OFF + STAGES * KBYTES;
  static constexpr int KM_OFF = X_OFF + XSLOTS * NCWG * 2 * BM * BN * 4;
  static constexpr int BAR_OFF = KM_OFF + STAGES * BN * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// dS = p (dP - D_i) of an m64 x BN tile of the dq pass in place of the
// scores (fp32; the caller rounds it to bf16 A fragments), p = 2^(c s - L
// log2 e) as in dq_ds
template <bool MASKED, int BN>
__device__ __forceinline__ void dq_ds_fp32(float (&sc)[BN / 2],
                                           const float (&dp)[BN / 2],
                                           float c, const float (&L2)[2],
                                           const float (&Dr)[2],
                                           const Geometry& g, int qi0,
                                           int k_lo, const int* kmk, int cq) {
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const int r = (e >> 1) & 1, col = 8 * (e >> 2) + cq + (e & 1);
    float x = fmaf(sc[e], c, -L2[r]);
    if (MASKED && !visible(g, qi0 + 8 * r, k_lo + col, kmk[col] != 0))
      x = DL4J_NEG_INF;
    sc[e] = exp2_fast(x) * (dp[e] - Dr[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dq_split_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const int* __restrict__ km,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           float* __restrict__ dq, int H, Geometry g,
                           float scale) {
  using C = SplitDqTiles<D>;
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES, DH = D / 2;
  const int i = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H;
  const int T = g.T, q_lo = i * BM;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
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
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= NC + 32) return;
    load_q_tiles<D, BM, BN, STAGES>(
        tq, &tdo, tk, tv, reinterpret_cast<bf16*>(sm),
        reinterpret_cast<bf16*>(sm + C::DO_OFF), Ks, Vs, kms, qbar, full,
        empty, km, j0, nt, q_lo, bh, bh, b, T);
  } else {
    regs_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
    const int lane = tw & 31, cq = 2 * (lane & 3);
    const int qi0 = q_lo + 16 * (tw >> 5) + (lane >> 2);
    float L2[2], Dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qi0 + 8 * r;   // rows past T: 0 (they are masked)
      L2[r] = qi < T ? lse[(long)bh * T + qi] * LOG2E : 0.f;
      Dr[r] = qi < T ? di[(long)bh * T + qi] : 0.f;
    }
    const uint32_t qs = smem_u32(sm) + half_off<D, BM>(wg);
    const uint32_t dos = smem_u32(sm + C::DO_OFF) + half_off<D, BM>(wg);
    const uint32_t ks = smem_u32(Ks) + half_off<D, BN>(wg);
    const uint32_t vs = smem_u32(Vs) + half_off<D, BN>(wg);
    float* xs = reinterpret_cast<float*>(sm + C::X_OFF);
    constexpr int TILE = BN * D * 2;
    const float c = scale * LOG2E;
    float acc[DH / 2];
    zero(acc);
    float sc[BN / 2], dp[BN / 2];
    uint32_t da[BN / 4];
    const auto at = [](uint32_t a) { return opaque<C::OPAQUE>(a); };
    mbar_wait(qbar, 0);
    split_walk<STAGES>(
        nt, 0, full, empty,
        [&](int s) {
          ss_product<DH, BM, BN>(sc, at(qs), 0, at(ks + s * TILE));
          ss_product<DH, BM, BN>(dp, at(dos), 0, at(vs + s * TILE));
        },
        [&](int s) { rs_product<D, BN, DH>(acc, da, at(ks + s * TILE)); },
        [&](int t) {
          fence_regs(sc);
          fence_regs(dp);
          exchange<BN, 2, C::XSLOTS>(xs, t, wg, tw, sc, dp);
          const int k_lo = (j0 + t) * BN;
          const int* kmk = kms + (t % STAGES) * BN;
          if (tile_masked<BM, BN>(g, q_lo, k_lo, km != nullptr))
            dq_ds_fp32<true, BN>(sc, dp, c, L2, Dr, g, qi0, k_lo, kmk, cq);
          else
            dq_ds_fp32<false, BN>(sc, dp, c, L2, Dr, g, qi0, k_lo, kmk, cq);
        },
        [&](int) {
          fence_regs(acc);
          pack_a<BN>(sc, da);
        });
    fence_regs(acc);
    float* dqb = dq + (long)bh * T * D + wg * DH;
#pragma unroll
    for (int e = 0; e < DH / 2; e += 2) {
      const int qi = qi0 + 8 * ((e >> 1) & 1);
      if (qi < T)
        *reinterpret_cast<float2*>(dqb + (long)qi * D + 8 * (e >> 2) + cq) =
            make_float2(scale * acc[e], scale * acc[e + 1]);
    }
  }
}

// K5's dk/dv pass at D 384/512 (DQ false) and K4 there (DQ true): the same
// two sweeps, tiles, q-tile order and products for dk and dv, so that
// K4's dk and dv are K5's bit for bit; K4 also forms dq in sweep 2.
//
// K4's dq: dq of a q tile sums scale dS K over every key, that is over the
// CTAs of the head. After the exchange of sweep 2 both warpgroups hold the
// same bits of dS^T (64 keys x 32 q, rounded to bf16 where K5 rounds it,
// the values dK's product takes); each writes it to a swizzled bf16 tile
// of its own, forms dq^T (its D/2 head-dim columns x 32 q) = K_w^T dS^T
// one 64-column piece at a time (m64n32, 16 registers: A = the resident
// K box read MN-major, B = the dS^T tile, as DqPath at D 128), and stages
// each piece, scaled, as two fp32 boxes of 32 q rows x 32 columns for a
// warp of the producer warpgroup (dq_split_writer), which hands them to
// the TMA unit as reduce-adds into the zeroed fp32 dq, as the wide pass
// does. Each warpgroup's pieces go through one piece slot of 8 KB (a FULL
// and a FREE named barrier). The products and the staging of tile t run
// once dK's product of tile t is done and its ring slot handed back, so
// with one stage they overlap the load of tile t + 1.
//
// Shared memory sets where the dS^T tile and the slots live. K5's pass
// takes 230,680 of a CTA's 232,448 bytes at D 512 (K and V 128 KB, one
// stage of Q and dO 64 KB, the exchange slot 32 KB, as sweep 2 exchanges
// S^T and dP^T at once, sweep 1 only S^T) and 230,952 at D 384 (two
// stages): under 2 KB beside it, and a dS^T tile is 4 KB and a piece
// slot 8 KB. So K4's sweep 2 exchanges S^T, then dP^T, through a 16 KB
// slot (the same sums a + b, so dk and dv keep their bits), which frees
// 16 KB: 8 KB for the two warpgroups' dS^T tiles, and each warpgroup's 8
// KB part of the slot is its piece slot between exchanges, handed back
// (FREE) before the warpgroup writes its next partial. K4 keeps K5's
// stages, 222,488 bytes at D 512 and 222,760 at D 384. Measured on an
// H100 80GB HBM3 at 700 W (B*H 16, causal, T 8192; PERF.md), K4
// at D 512 takes 12.7 ms against K5's 16.0: the dq products add nothing
// measurable, the staging ~0.8 ms and the reduce-adds (~17 GB into a 268
// MB dq) ~1.3. Exchanging both partials at once with the dS^T tile in the
// slot (one stage needed: with two the next exchange would run before
// the dq of the tile before) ties at D 512 and is 7% slower at D 384,
// where it spills, as is one stage alone there
// (experiments/torch_flash_split_ab.py k4).
template <int D, bool DQ>
struct SplitDkvTiles {
  static constexpr int BK = 64;                 // keys per CTA
  static constexpr int BQ = 32;                 // q rows per tile
  static constexpr int STAGES = D > 384 ? 1 : 2;
  static constexpr int XSLOTS = 1;
  static constexpr bool OPAQUE = D > 384;
  static constexpr int KBYTES = BK * D * 2;
  static constexpr int QBYTES = BQ * D * 2;
  static constexpr int PART = BK * BQ * 4;      // a partial of S^T or dP^T
  // a warpgroup's part of the exchange slot: two partials in K5, one in
  // K4, where it is also the warpgroup's piece slot
  static constexpr int XWG = (DQ ? 1 : 2) * PART;
  // K4: dq pieces of 64 columns a warpgroup, a piece (two boxes) and a
  // dS^T tile
  static constexpr int NPC = D / 128;
  static constexpr int PIECE = BQ * 64 * 4;
  static constexpr int DSBYTES = BK * BQ * 2;
  static_assert(PIECE <= XWG, "a piece fits a warpgroup's part");
  static constexpr int V_OFF = KBYTES;
  static constexpr int Q_OFF = 2 * KBYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QBYTES;
  static constexpr int X_OFF = DO_OFF + STAGES * QBYTES;
  static constexpr int DS_OFF = X_OFF + XSLOTS * NCWG * XWG;
  static constexpr int L_OFF = DS_OFF + (DQ ? NCWG * DSBYTES : 0);
  static constexpr int DI_OFF = L_OFF + STAGES * BQ * 4;
  static constexpr int BAR_OFF = DI_OFF + STAGES * BQ * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  // K4's named barriers beside X_SYNC: DS_READY + w once warpgroup w has
  // written its dS^T tile; FULL + w once it has staged a piece, FREE + w
  // once the TMA unit has read it
  static constexpr int DS_READY = 2, FULL = 4, FREE = 6;

  // the piece slot of warpgroup w
  __device__ static unsigned char* slot(unsigned char* sm, int w) {
    return sm + X_OFF + w * XWG;
  }
};

// dS^T = P^T (dP^T - D_i) of an m64 (keys) x BQ (queries) tile in place of
// S^T (fp32), p as in dkv_p; L2 = L log2(e) and D_i by column from shared
// memory
template <bool MASKED, int BQ>
__device__ __forceinline__ void dkv_ds_fp32(float (&st)[BQ / 2],
                                            const float (&dpt)[BQ / 2],
                                            float c, const float* L2q,
                                            const float* Dq,
                                            const Geometry& g, int q_lo,
                                            int kj0, const bool (&ko)[2],
                                            int cq) {
#pragma unroll
  for (int e = 0; e < BQ / 2; e += 2) {
    const int r = (e >> 1) & 1, col = 8 * (e >> 2) + cq;
    const float2 L2 = *reinterpret_cast<const float2*>(L2q + col);
    const float2 Di = *reinterpret_cast<const float2*>(Dq + col);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float x = fmaf(st[e + u], c, -(u ? L2.y : L2.x));
      if (MASKED && !visible(g, q_lo + col + u, kj0 + 8 * r, ko[r]))
        x = DL4J_NEG_INF;
      st[e + u] = exp2_fast(x) * (dpt[e + u] - (u ? Di.y : Di.x));
    }
  }
}

// K4's dq warp of consumer warpgroup w: for each q tile of sweep 2 and
// each of the warpgroup's pieces, in the order the warpgroup stages them,
// waits for the piece slot to be full, has the TMA unit add its two boxes
// into dq, and hands the slot back once they are read (except after the
// last piece, for which nothing waits).
template <int D>
__device__ __forceinline__ void dq_split_writer(const CUtensorMap& tdq,
                                                unsigned char* sm, int w,
                                                int i0, int nt, int bh) {
  using C = SplitDkvTiles<D, true>;
  const bool lead = (threadIdx.x & 31) == 0;
  const int uses = C::NPC * nt;
  for (int j = 0; j < uses; ++j) {
    const int n = j / C::NPC, pc = j % C::NPC;
    named_sync(C::FULL + w, DQ_HANDOFF);
    if (lead) {
      const unsigned char* p = C::slot(sm, w);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tma_reduce_add(p + h * (C::PIECE / 2), &tdq,
                       w * (D / 2) + 64 * pc + 32 * h, (i0 + n) * C::BQ, bh);
      bulk_commit();
      bulk_wait_read<0>();
    }
    __syncwarp();
    if (j + 1 < uses) named_arrive(C::FREE + w, DQ_HANDOFF);
  }
}

template <int D, bool DQ>
__device__ __forceinline__ void split_dkv_pass(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const CUtensorMap& tdq,
    const int* __restrict__ km, const float* __restrict__ lse,
    const float* __restrict__ di, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, Geometry g, float scale) {
  using C = SplitDkvTiles<D, DQ>;
  constexpr int BK = C::BK, BQ = C::BQ, STAGES = C::STAGES, DH = D / 2;
  const int j = blockIdx.x;         // the most-visited key tiles first
  const int bh = blockIdx.y, b = bh / H;
  const int T = g.T, k_lo = j * BK;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const float* Ls = reinterpret_cast<const float*>(sm + C::L_OFF);
  const float* Dis = reinterpret_cast<const float*>(sm + C::DI_OFF);
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
    // producer warpgroup: warp 0 loads; in K4 warps 1 and 2 hand the dq
    // pieces of consumer warpgroups 0 and 1 to the TMA unit
    regs_dec<PRODUCER_REGS>();
    const int warp = (threadIdx.x - NC) >> 5;
    if constexpr (DQ) {
      if (warp == 1 || warp == 2)
        dq_split_writer<D>(tdq, sm, warp - 1, i0, nt, bh);
    }
    if (warp != 0) return;
    load_dkv_tiles<D, BK, BQ, STAGES, 2>(
        tq, tk, tv, tdo, reinterpret_cast<bf16*>(sm),
        reinterpret_cast<bf16*>(sm + C::V_OFF),
        reinterpret_cast<bf16*>(sm + C::Q_OFF),
        reinterpret_cast<bf16*>(sm + C::DO_OFF),
        reinterpret_cast<float*>(sm + C::L_OFF),
        reinterpret_cast<float*>(sm + C::DI_OFF), kvbar, full, empty, lse,
        di, i0, nt, k_lo, bh, T);
  } else {
    regs_inc<CONSUMER_REGS>();
    // consumer warpgroup wg: all 64 keys (rows), the columns [wg DH, wg DH
    // + DH) of dV, then of dK (and of dq); this thread's keys kj0 and kj0
    // + 8
    const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
    const int lane = tw & 31, cq = 2 * (lane & 3);
    const int row = 16 * (tw >> 5) + (lane >> 2), kj0 = k_lo + row;
    bool ko[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = kj0 + 8 * r;
      ko[r] = kj < T && (km == nullptr || km[(long)b * T + kj] != 0);
    }
    const uint32_t ks = smem_u32(sm) + half_off<D, BK>(wg);
    const uint32_t vs = smem_u32(sm + C::V_OFF) + half_off<D, BK>(wg);
    const uint32_t qs = smem_u32(sm + C::Q_OFF) + half_off<D, BQ>(wg);
    const uint32_t dos = smem_u32(sm + C::DO_OFF) + half_off<D, BQ>(wg);
    float* xs = reinterpret_cast<float*>(sm + C::X_OFF);
    constexpr int TILE = BQ * D * 2;            // bytes of a Q or dO stage
    const float c = scale * LOG2E;
    const bool has_km = km != nullptr;
    float acc[DH / 2];                          // dV_w, then dK_w
    float st[BQ / 2], dpt[BQ / 2];
    uint32_t pa[BQ / 4];
    const auto at = [](uint32_t a) { return opaque<C::OPAQUE>(a); };
    // this thread's part of dV or dK (scaled by `sc`) in bf16
    auto store = [&](bf16* out, float sc) {
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < DH / 2; e += 2) {
        const int kj = kj0 + 8 * ((e >> 1) & 1);
        if (kj < T)
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((long)bh * T + kj) * D + wg * DH + 8 * (e >> 2) + cq) =
              __floats2bfloat162_rn(sc * acc[e], sc * acc[e + 1]);
      }
    };
    // K4: this warpgroup's dS^T tile; `pending` while its piece slot is
    // with the dq warp and not yet seen back
    unsigned char* dsp = sm + C::DS_OFF + wg * C::DSBYTES;
    const uint32_t dss = smem_u32(dsp);
    bool pending = false;
    // the piece slot back from the dq warp before this warpgroup writes it
    auto take = [&]() {
      if constexpr (DQ) {
        if (pending) named_sync(C::FREE + wg, DQ_HANDOFF);
        pending = false;
      }
    };
    auto stage = [&](const float (&d)[16]) {
      if constexpr (DQ) {
        take();
        stage_dq_t<1>(C::slot(sm, wg), d, scale, tw, cq);
        fence_async_smem();
        named_arrive(C::FULL + wg, DQ_HANDOFF);
        pending = true;
      }
    };
    // dq^T of q tile t over the CTA's keys, piece by piece, each staged
    // while the next is multiplied
    auto dq_tile = [&](int) {
      if constexpr (DQ) {
        float dqa[2][BQ / 2];
#pragma unroll
        for (int pc = 0; pc < C::NPC; ++pc) {
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_ss_t<BQ>(dqa[pc & 1],
                           desc_mn<D, BK>(at(ks + pc * BK * 128), kk),
                           desc_mn<BQ, BK>(dss, kk), kk > 0);
          wg_commit();
          if (pc > 0) {
            wg_wait<1>();
            fence_regs(dqa[(pc - 1) & 1]);
            stage(dqa[(pc - 1) & 1]);
          }
        }
        wg_wait<0>();
        fence_regs(dqa[(C::NPC - 1) & 1]);
        stage(dqa[(C::NPC - 1) & 1]);
      }
    };
    mbar_wait(kvbar, 0);
    // sweep 1, ring slots 0 ..: S^T, P^T, dV_w += P^T dO_w
    zero(acc);
    split_walk<STAGES>(
        nt, 0, full, empty,
        [&](int s) {
          ss_product<DH, BK, BQ>(st, at(ks), 0, at(qs + s * TILE));
        },
        [&](int s) { rs_product<D, BQ, DH>(acc, pa, at(dos + s * TILE)); },
        [&](int t) {
          fence_regs(st);
          exchange<BQ, 1, C::XSLOTS>(xs, t, wg, tw, st, st);
          const int s = t % STAGES, q_lo = (i0 + t) * BQ;
          if (tile_masked<BQ, BK>(g, q_lo, k_lo, has_km))
            dkv_p<true, BQ>(st, c, Ls + s * BQ, g, q_lo, kj0, ko, cq);
          else
            dkv_p<false, BQ>(st, c, Ls + s * BQ, g, q_lo, kj0, ko, cq);
        },
        [&](int) {
          fence_regs(acc);
          pack_a<BQ>(st, pa);
        });
    store(dv, 1.f);
    // sweep 2, ring slots nt ..: S^T, dP^T, dS^T, dK_w += dS^T Q_w (and
    // in K4 dq of each tile)
    zero(acc);
    split_walk<STAGES>(
        nt, nt, full, empty,
        [&](int s) {
          ss_product<DH, BK, BQ>(st, at(ks), 0, at(qs + s * TILE));
          ss_product<DH, BK, BQ>(dpt, at(vs), 0, at(dos + s * TILE));
        },
        [&](int s) { rs_product<D, BQ, DH>(acc, pa, at(qs + s * TILE)); },
        [&](int t) {
          fence_regs(st);
          fence_regs(dpt);
          take();   // the piece slot is this warpgroup's part of the slot
          if constexpr (DQ) {
            exchange<BQ, 1, C::XSLOTS>(xs, nt + t, wg, tw, st, st);
            exchange<BQ, 1, C::XSLOTS>(xs, nt + t, wg, tw, dpt, dpt);
          } else {
            exchange<BQ, 2, C::XSLOTS>(xs, nt + t, wg, tw, st, dpt);
          }
          const int s = (nt + t) % STAGES, q_lo = (i0 + t) * BQ;
          if (tile_masked<BQ, BK>(g, q_lo, k_lo, has_km))
            dkv_ds_fp32<true, BQ>(st, dpt, c, Ls + s * BQ, Dis + s * BQ, g,
                                  q_lo, kj0, ko, cq);
          else
            dkv_ds_fp32<false, BQ>(st, dpt, c, Ls + s * BQ, Dis + s * BQ, g,
                                   q_lo, kj0, ko, cq);
        },
        [&](int) {
          fence_regs(acc);
          pack_a<BQ>(st, pa);
          if constexpr (DQ) {
            // with two stages the dq products of the tile before may still
            // read the tile in another warp of this warpgroup
            if constexpr (STAGES > 1) named_sync(C::DS_READY + wg, 128);
            store_ds<BQ>(dsp, pa, row, cq);
            fence_async_smem();
            named_sync(C::DS_READY + wg, 128);
          }
        },
        dq_tile);
    store(dk, scale);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_split_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const int* __restrict__ km,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int H, Geometry g, float scale) {
  split_dkv_pass<D, false>(tq, tk, tv, tdo, tq, km, lse, di, dk, dv, H, g,
                           scale);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_fused_split_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const __grid_constant__ CUtensorMap tdq,
                                  const int* __restrict__ km,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ di,
                                  bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int H, Geometry g,
                                  float scale) {
  split_dkv_pass<D, true>(tq, tk, tv, tdo, tdq, km, lse, di, dk, dv, H, g,
                          scale);
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

// K3's and the dq pass's tiles and kernels: 128 q rows a CTA up to D 256,
// the split kernels' 64 above
template <int D>
using FwdTilesOf =
    std::conditional_t<(D <= 256), FwdTiles<D>, SplitFwdTiles<D>>;
template <int D>
using DqTilesOf = std::conditional_t<(D <= 256), DqTiles<D>, SplitDqTiles<D>>;

template <int D>
auto fwd_kernel() {
  if constexpr (D <= 256)
    return flash_fwd_sm90_kernel<D>;
  else
    return flash_fwd_split_sm90_kernel<D>;
}

template <int D>
auto dq_kernel() {
  if constexpr (D <= 256)
    return flash_dq_sm90_kernel<D>;
  else
    return flash_dq_split_sm90_kernel<D>;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* km,
               void* o, float* lse, int B, int H, int Hk, Geometry g,
               float scale, cudaStream_t st) {
  using C = FwdTilesOf<D>;
  CUtensorMap mq, mk, mv;
  int err;
  if ((err = make_map<D>(&mq, q, g.T, B * H, C::BM))) return err;
  if ((err = make_map<D>(&mk, k, g.T, B * Hk, C::BN))) return err;
  if ((err = make_map<D>(&mv, v, g.T, B * Hk, C::BN))) return err;
  static_assert(C::SMEM <= 232448, "one CTA's shared memory");
  auto kern = fwd_kernel<D>();
  if ((err = prepare(kern, C::SMEM))) return err;
  dim3 grid((g.T + C::BM - 1) / C::BM, B * H);
  kern<<<grid, NT, C::SMEM, st>>>(mq, mk, mv, km, static_cast<bf16*>(o), lse,
                                  H, Hk, g, scale);
  return (int)cudaGetLastError();
}

// the dk/dv pass's (DQ false) or K4's (DQ true) tiles: 128 keys a CTA up to
// D 128, the wide pass's 64 at D 192/256, the split pass's 64 above
template <int D, bool DQ>
using DkvTilesOf = std::conditional_t<
    (D <= 128), DkvTiles<D, DQ>,
    std::conditional_t<(D <= 256), WideTiles<D, DQ>, SplitDkvTiles<D, DQ>>>;

template <int D>
auto dkv_kernel() {
  if constexpr (D <= 128)
    return flash_dkv_sm90_kernel<D>;
  else if constexpr (D <= 256)
    return flash_dkv_wide_sm90_kernel<D>;
  else
    return flash_dkv_split_sm90_kernel<D>;
}

template <int D>
auto fused_kernel() {
  if constexpr (D <= 128)
    return flash_bwd_fused_sm90_kernel<D>;
  else if constexpr (D <= 256)
    return flash_bwd_fused_wide_sm90_kernel<D>;
  else
    return flash_bwd_fused_split_sm90_kernel<D>;
}

// The dk/dv pass (DQ false) or K4 (DQ true, dq into the zeroed buffer).
template <int D, bool DQ>
int launch_dkv(const void* q, const void* k, const void* v, const int* km,
               const void* dout, const float* lse, const float* di,
               float* dq, void* dk, void* dv, int B, int H, Geometry g,
               float scale, cudaStream_t st) {
  using K = DkvTilesOf<D, DQ>;
  static_assert(K::SMEM <= 232448, "one CTA's shared memory");
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
    auto kern = fused_kernel<D>();
    if ((err = prepare(kern, K::SMEM))) return err;
    kern<<<grid, NT, K::SMEM, st>>>(mq, mk, mv, mdo, mdq, km, lse, di,
                                    static_cast<bf16*>(dk),
                                    static_cast<bf16*>(dv), H, g, scale);
  } else {
    auto kern = dkv_kernel<D>();
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
  using Q = DqTilesOf<D>;
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = make_map<D>(&mq, q, g.T, B * H, Q::BM))) return err;
  if ((err = make_map<D>(&mdo, dout, g.T, B * H, Q::BM))) return err;
  if ((err = make_map<D>(&mk, k, g.T, B * H, Q::BN))) return err;
  if ((err = make_map<D>(&mv, v, g.T, B * H, Q::BN))) return err;
  static_assert(Q::SMEM <= 232448, "one CTA's shared memory");
  auto kq = dq_kernel<D>();
  if ((err = prepare(kq, Q::SMEM))) return err;
  kq<<<dim3((g.T + Q::BM - 1) / Q::BM, B * H), NT, Q::SMEM, st>>>(
      mq, mk, mv, mdo, km, lse, di, dq, H, g, scale);
  if ((err = (int)cudaGetLastError())) return err;
  return launch_dkv<D, false>(q, k, v, km, dout, lse, di, nullptr, dk, dv, B,
                              H, g, scale, st);
}

// K4: one launch
template <int D>
int launch_fused(const void* q, const void* k, const void* v, const int* km,
                 const void* dout, const float* lse, const float* di,
                 float* dq, void* dk, void* dv, int B, int H, Geometry g,
                 float scale, cudaStream_t st) {
  return launch_dkv<D, true>(q, k, v, km, dout, lse, di, dq, dk, dv, B, H, g,
                             scale, st);
}

// Dynamic shared memory of kernel `kind` (as dl4j_flash_sm90_smem) at D;
// -1 where D has no such kernel
template <int D>
constexpr int smem_of(int kind) {
  if (kind == 0) return FwdTilesOf<D>::SMEM;
  if (kind == 1) return DqTilesOf<D>::SMEM;
  if (kind == 2) return DkvTilesOf<D, false>::SMEM;
  if (kind == 3) return DkvTilesOf<D, true>::SMEM;
  return -1;
}

}  // namespace

// bf16 only; head dims 16, 32, 64, 128, 192, 256, 384 and 512.
// q, k, v, dout 16-byte aligned and contiguous. Return a cudaError_t code, or
// kNoEncoder / kBadMap (0 on success). They allocate nothing and do not
// synchronize: the kernels launch on `stream`.
#define DL4J_SM90_DISPATCH(FN, ...)                                \
  {                                                                \
    if (D == 16) return FN<16>(__VA_ARGS__);                       \
    if (D == 32) return FN<32>(__VA_ARGS__);                       \
    if (D == 64) return FN<64>(__VA_ARGS__);                       \
    if (D == 128) return FN<128>(__VA_ARGS__);                     \
    if (D == 192) return FN<192>(__VA_ARGS__);                     \
    if (D == 256) return FN<256>(__VA_ARGS__);                     \
    if (D == 384) return FN<384>(__VA_ARGS__);                     \
    if (D == 512) return FN<512>(__VA_ARGS__);                     \
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
// the dk/dv pass, 3 the fused backward (K4); -1 for another head dim or an
// unknown kind.
extern "C" int dl4j_flash_sm90_smem(int kind, int D) {
  switch (D) {
    case 16: case 32: case 64: case 128: case 192: case 256: case 384:
    case 512:
      DL4J_SM90_DISPATCH(smem_of, kind);
  }
  return -1;
}

extern "C" const char* dl4j_flash_sm90_error_string(int code) {
  if (code == kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from libcuda";
  if (code == kBadMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
