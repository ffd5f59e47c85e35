// What the Hopper attention kernels share (flash_attn.cu, the forward, and
// flash_bwd.cu, the backward): mbarrier and TMA helpers, wgmma wrappers and
// shared-memory descriptors, and the host-side tensor-map encoding with its
// cache. Everything is in an anonymous namespace: each source that includes
// it is its own shared library.
//
// Layout shared by both kernels: a bf16 [B, H, T, D] view (any batch, head
// and row strides, unit stride on D) is read by a rank-4 tensor map (dims D,
// T, H, B innermost first) in boxes of `rows` rows by CW = min(D, 64)
// columns, D / CW boxes per row block, each box landing in shared memory
// with TMA's 128-byte swizzle (64-byte at D = 32), as the wgmma descriptors
// below read it. A tile is read K-major (contiguous along the reduction) or
// MN-major (contiguous along the output columns: the descriptor's transpose
// bit) from the same swizzled layout, so nothing is transposed by hand.
// Rows past T come zero-filled from TMA's out-of-bounds handling.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <mutex>

namespace {

constexpr float kNeg = -1e30f;  // the TPU kernels' _NEG
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgThreads = 128;
constexpr uint32_t kSpinLimit = 1u << 24;

// the swizzled tile layout of one head dim: columns per TMA box, boxes per
// row block, bytes per swizzled row, k16 steps per box, and the wgmma
// descriptor's layout type (1 = 128-byte swizzle, 2 = 64-byte)
template <int D>
struct Swz {
  static_assert(D % 32 == 0 && D <= 256, "head dim 32, 64, 128 or 256");
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int NCH = D / CW;
  static constexpr int ROWB = CW * 2;
  static constexpr int KPC = CW / 16;
  static constexpr uint64_t SWZ = ROWB == 128 ? 1 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the phase of parity `parity` to complete; trap after
// kSpinLimit polls rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == kSpinLimit) __trap();
  }
}

// one box of a rank-4 tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// the D / CW boxes of one row block of a head, `rows` rows at row r0, into
// consecutive boxes of `rows` x CW at dst
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int r0,
                                         int h, int b) {
  using S = Swz<D>;
#pragma unroll
  for (int c = 0; c < S::NCH; ++c)
    tma_load(dst + c * rows * S::ROWB, map, bar, c * S::CW, r0, h, b);
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (all >> 4) and the swizzle layout type
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// the K-major descriptor of k16 step kk of a tile of `rows` rows (64-row
// slices start at row offsets inside the box, which `base` carries)
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int rows, int kk) {
  using S = Swz<D>;
  return smem_desc(base + (kk / S::KPC) * rows * S::ROWB + (kk % S::KPC) * 32,
                   16, 8 * S::ROWB, S::SWZ);
}

// the MN-major (transposed) descriptor of the 16 rows at kk * 16 of a tile
// of `rows` rows, starting at column box `box`: the B operand of a product
// whose reduction runs over the tile's rows
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int rows, int kk,
                                            int box) {
  using S = Swz<D>;
  return smem_desc(base + box * rows * S::ROWB + kk * 16 * S::ROWB,
                   rows * S::ROWB, 8 * S::ROWB, S::SWZ);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// a consumer warp is done with a buffer: lane 0 arrives on its empty barrier
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// registers an asynchronous wgmma reads or writes: keep the compiler from
// moving their uses across the fence/wait
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// setmaxnreg: a producer warpgroup gives back all but 24 registers a
// thread, so each of two consumer warpgroups may hold 240 (2 x 128 x 240 +
// 128 x 24 <= 65,536). ptxas reports the launch share (168 at 384
// threads); the consumer code after the raise is allocated up to 240.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one register of two bf16 (round to nearest even), lo in the
// low half as the A fragments expect
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// The accumulator of an m64nN product, rounded to bf16 as the A operand of
// the next product over its N columns: N / 16 k16 steps of 4 registers.
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4],
                                           const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------- wgmma
// SS: D (64 x N, f32) (+)= A (64 x 16) B^T (N x 16), both K-major in shared
// memory. RS: D (64 x N) += A (registers) B (16 x N, MN-major: transposed).

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the score-shaped SS product over one k16 step, N = 32, 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, acc);
  else if constexpr (N == 64) wgmma_ss_n64(d, a, b, acc);
  else wgmma_ss_n128(d, a, b, acc);
}

// columns 128 i .. 128 i + 127 of an accumulator, as the accumulator of
// an n128 product
template <int N>
__device__ __forceinline__ float (&cols128(float (&d)[N], int i))[64] {
  return *reinterpret_cast<float(*)[64]>(&d[64 * i]);
}

// D (64 x N) += A (registers, 64 x 16) B, B the 16 rows at kk * 16 of a
// swizzled tile of `rows` rows read MN-major; N = 32, 64, 128 or 256 (two
// n128 products over column boxes 0-1 and 2-3)
template <int N, int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t base, int rows, int kk,
                                         int box0) {
  if constexpr (N == 32) {
    wgmma_rs_n32(d, a, mnmajor<D>(base, rows, kk, box0));
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, mnmajor<D>(base, rows, kk, box0));
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, mnmajor<D>(base, rows, kk, box0));
  } else {
    static_assert(N == 256, "N must be 32, 64, 128 or 256");
    wgmma_rs_n128(cols128(d, 0), a, mnmajor<D>(base, rows, kk, box0));
    wgmma_rs_n128(cols128(d, 1), a, mnmajor<D>(base, rows, kk, box0 + 2));
  }
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so the library links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// errors of the tensor-map encoding, returned below cudaError_t's range
constexpr int kErrNoEncoder = -1;
constexpr int kErrEncodeBase = -1000;  // kErrEncodeBase - CUresult

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The last tensor maps encoded, keyed by everything that goes into them:
// encoding costs the host more than the launch, and a caller's tensors
// come back at the same addresses call after call.
struct MapKey {
  const void* ptr;
  long long b, h, t, sb, sh, st, rows, d;
  bool operator==(const MapKey& o) const {
    return memcmp(this, &o, sizeof(MapKey)) == 0;
  }
};
struct MapSlot {
  MapKey key;
  CUtensorMap map;
  bool used;
};
constexpr int kMapSlots = 32;
MapSlot g_maps[kMapSlots];
int g_next_slot = 0;
std::mutex g_maps_mutex;

// a rank-4 bf16 tensor map over a strided [B, H, T, D] view (strides in
// elements), boxes of `rows` rows by Swz<D>::CW columns, swizzled as the
// wgmma descriptors read them; rows past T read as zeros. Returns 0 or an
// encoding error (kErrNoEncoder, kErrEncodeBase - CUresult).
template <int D>
int encode_view(CUtensorMap* map, const void* ptr, int B, int H, int T,
                long long sb, long long sh, long long st, int rows) {
  using S = Swz<D>;
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.ptr = ptr, key.b = B, key.h = H, key.t = T;
  key.sb = sb, key.sh = sh, key.st = st, key.rows = rows, key.d = D;
  std::lock_guard<std::mutex> lock(g_maps_mutex);
  for (const MapSlot& slot : g_maps)
    if (slot.used && slot.key == key) {
      *map = slot.map;
      return 0;
    }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const long long given[3] = {st * 2, sh * 2, sb * 2};
  cuuint64_t strides[3];
  cuuint64_t span = D * 2;  // bytes one step of the previous dim covers
  for (int i = 0; i < 3; ++i) {
    // a dim of extent 1 is never stepped: any stride TMA accepts will do
    strides[i] = dims[i + 1] == 1 ? span
                                  : static_cast<cuuint64_t>(given[i]);
    span = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(S::CW),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      S::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kErrEncodeBase - static_cast<int>(res);
  MapSlot& slot = g_maps[g_next_slot];
  g_next_slot = (g_next_slot + 1) % kMapSlots;
  slot.key = key, slot.map = *map, slot.used = true;
  return 0;
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per kernel
// and device (`opted` is the kernel's own bit set), and read the device's SM
// count (cached): what a persistent launch needs. Returns a cudaError_t.
int persistent_setup(const void* kernel, int bytes, unsigned long long& opted,
                     int& n_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted |= bit;
  }
  static int sms[64] = {0};
  int& n = sms[dev & 63];
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  n_sm = n;
  return 0;
}

// the message of a launch's return code: a cudaError_t or an encoding error
const char* launch_error_string(int err) {
  static thread_local char buf[96];
  if (err == kErrNoEncoder)
    return "the driver entry point cuTensorMapEncodeTiled was not found";
  if (err <= kErrEncodeBase) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             kErrEncodeBase - err);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace
