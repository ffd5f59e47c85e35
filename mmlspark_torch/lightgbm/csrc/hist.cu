// K1: masked histogram build for the GBDT engine, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_hist_kernel`
// (mmlspark_tpu/lightgbm/pallas_hist.py:45, launched at :103). Computes, for
// bins [n, F] (uint8 or int32, row-major) and pre-masked vals [n, 3] f32
// (grad, hess, count weight), the per-(feature, bin) sums out[F, num_bins,
// 3]. Bin ids outside [0, num_bins) add nothing; rows at or past `count`
// add nothing (the caller guarantees they are padding, so skipping per row
// gives the same sums as the TPU kernel's per-block skip).
//
// What bounds it on an H100: bytes. Each call must read n*F bin bytes and
// 12n vals bytes and write F*num_bins*12 bytes (20.3 MB at the fit's
// 500,000 x 28 u8 bins: 0.0060 ms at 3.35 TB/s); it does 3 adds per (row,
// feature), far below the card's f32 rate. What it runs into first is the
// shared-memory updates of a row whose vals are not all zero, at random
// bins: shared memory has no f32 atomic add on this card (atomicAdd on a
// shared float compiles to a compare-and-swap loop, ATOMS.CAST.SPIN), and
// a warp's lanes hit random banks.
//
// The first design ran 4 feature blocks x 66 row chunks of 256
// threads, each thread reading its rows' 8 bins as dependent byte loads at
// the row stride, vals once per feature block, and merged its CTA's
// histogram into a zero-filled output with ~1.6M global float atomics:
// 0.1983 ms for the root histogram, 33x its byte bound. Design now (not
// the TPU's one-hot MXU contraction, which the GPU would pay for in 256x
// redundant multiply-adds):
//  - Two kernels, one call. `hist_partial`: a grid of about one CTA of
//    1024 threads per SM, each over a contiguous range of rows (a multiple
//    of 16), holding the histogram of all F features in shared memory
//    where F * num_bins * 16 bytes fit beside the stages (114 KB at 28 x
//    256), so vals are read once; above that, feature blocks (a grid axis)
//    and vals read once per block. `hist_reduce` sums the CTAs' partial
//    histograms in CTA order into out: no global atomics and no zero-fill
//    launch. (The shared-memory updates land in whatever order the warps
//    reach a cell, so two calls may differ in the last bits of grad and
//    hess, as the first design's did; the count channel is exact.) Summing
//    clusters of 4 CTAs through distributed shared memory first, which
//    cuts the partials 4x, was tried on an H100 and was slower: not kept.
//  - The row range streams through a ring of 4 stages: a chunk's bins are
//    one contiguous span of rows x F bytes and its vals another of rows x
//    12, each one 1-D bulk copy (cp.async.bulk, completing on an
//    mbarrier), requested four chunks ahead of the threads that consume them.
//    The last rows of a range past a multiple of 16 (only where `count`
//    or n is not one) are read from global memory directly.
//  - A warp takes a row at a time: its three vals (one broadcast read),
//    then its lanes over the row's features. Each in-range bin takes one
//    8-byte compare-and-swap loop for (grad, hess) together and, for a
//    count weight of exactly 1 (the engine's row mask), one native integer
//    atomicAdd to a count of such rows; any other nonzero weight goes to an
//    f32 sum beside it. That is one loop a cell where three f32 atomicAdds
//    were three (tools/probe_kernel_variants.py, PERF.md §6). A row
//    whose three vals are zero (outside the split's child) is skipped by
//    the whole warp at once: adding +-0 to a +0 sum changes nothing, and
//    the masked scans of a fit are mostly such rows. Their bytes are still
//    read, as the TPU kernel reads them.
//  - Sums stay in f32 throughout (the TPU kernel's bf16 rounding of vals
//    is not reproduced); the count channel of 0/1 weights is exact.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kStages = 4;  // lightgbm/hist.py's STAGES
constexpr int kReduceThreads = 256;
constexpr uint32_t kSpinLimit = 1u << 24;

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

// wait for the phase of parity `parity`; trap after kSpinLimit polls
// rather than hang the card
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

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

struct Params {
  const void* bins;    // [n, F] row-major, 16-byte aligned
  const float* vals;   // [n, 3], 16-byte aligned
  float* part;         // [grid.x, F * B * 3]: each row-range CTA's sums
  long long n;
  int F, B;
  int fb;              // features per CTA (grid.y blocks of them)
  long long rows_per_cta;  // a multiple of 16
  int stage_rows;          // rows a stage holds, a multiple of 16
  long long count_host;
  const int* count_dev;    // null: count_host
};

// A CTA's histogram in shared memory, per (feature, bin) cell of its nf
// features: (grad, hess) as one 8-byte pair, an integer count of the rows
// whose count weight is exactly 1 and an f32 sum of the other weights.
struct Hist {
  float2* gh;         // [nf * B]
  unsigned* n_one;    // [nf * B]
  float* w_other;     // [nf * B]
};

// (g, h) += (dg, dh) as one 8-byte compare-and-swap loop: shared memory has
// no f32 atomic add (atomicAdd compiles to such a loop per channel), so
// the pair costs one loop where two channels would cost two
__device__ __forceinline__ void add_pair(float2* cell, float dg, float dh) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(cell);
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(a);
  unsigned long long seen;
  do {
    seen = old;
    float2 x;
    memcpy(&x, &seen, sizeof(x));
    x.x += dg;
    x.y += dh;
    unsigned long long next;
    memcpy(&next, &x, sizeof(next));
    old = atomicCAS(a, seen, next);
  } while (old != seen);
}

// one row's contribution to this CTA's features [f0, f0 + nf): lanes over
// the features; per in-range bin one pair update and one count update (an
// integer atomicAdd, native in shared memory, for a weight of exactly 1)
template <typename BinT>
__device__ __forceinline__ void add_row(const Hist& hs, const BinT* row,
                                        const float* v, int nf, int B,
                                        int lane) {
  const float g = v[0], h = v[1], w = v[2];
  if (g == 0.f && h == 0.f && w == 0.f) return;  // the whole warp skips
  for (int f = lane; f < nf; f += 32) {
    const int b = static_cast<int>(row[f]);
    if (b < 0 || b >= B) continue;
    const int cell = f * B + b;
    add_pair(hs.gh + cell, g, h);
    if (w == 1.f)
      atomicAdd(hs.n_one + cell, 1u);
    else if (w != 0.f)
      atomicAdd(hs.w_other + cell, w);
  }
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads, 1) hist_partial(const Params p) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const int F = p.F, B = p.B;
  const int f0 = blockIdx.y * p.fb;
  const int nf = min(p.fb, F - f0);
  const int cells = nf * B;
  // layout: the histogram (Hist: 16 bytes a cell of fb * B), then kStages
  // stages of (bins, vals), each part 16-byte aligned, then kStages
  // mbarriers
  Hist hs;
  hs.gh = reinterpret_cast<float2*>(smem_raw);
  hs.n_one = reinterpret_cast<unsigned*>(smem_raw + p.fb * B * 8);
  hs.w_other = reinterpret_cast<float*>(smem_raw + p.fb * B * 12);
  const int hist_bytes = p.fb * B * 16;
  const int bin_bytes = p.stage_rows * F * static_cast<int>(sizeof(BinT));
  const int stage_bytes = bin_bytes + p.stage_rows * 12;
  uint8_t* stages = smem_raw + hist_bytes;
  const uint32_t bars = smem_u32(stages + kStages * stage_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  long long count = p.count_host;
  if (p.count_dev != nullptr) {
    const long long c = static_cast<long long>(*p.count_dev);
    count = c < 0 ? 0 : (c < p.n ? c : p.n);
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * p.rows_per_cta;
  const long long r1 = min(r0 + p.rows_per_cta, count);
  const long long rows = r1 > r0 ? r1 - r0 : 0;
  const int n_chunks = static_cast<int>((rows + p.stage_rows - 1) /
                                        p.stage_rows);
  const BinT* bins = static_cast<const BinT*>(p.bins);

  // chunk c's rows from smem: the whole 16-row groups of it (the rest,
  // only in a range ending off a multiple of 16, from global memory)
  auto staged_rows = [&](int c) {
    const long long left = rows - static_cast<long long>(c) * p.stage_rows;
    const int nr = static_cast<int>(left < p.stage_rows ? left : p.stage_rows);
    return nr & ~15;
  };
  auto fetch = [&](int c) {
    const int st = c % kStages;
    const long long row = r0 + static_cast<long long>(c) * p.stage_rows;
    const int nr = staged_rows(c);
    const uint32_t nb = nr * F * static_cast<uint32_t>(sizeof(BinT));
    const uint32_t bar = bars + 8u * st;
    mbar_expect_tx(bar, nb + nr * 12u);  // 0 bytes completes at once
    if (nr > 0) {
      const uint32_t dst = smem_u32(stages + st * stage_bytes);
      bulk_copy(dst, bins + row * F, nb, bar);
      bulk_copy(dst + bin_bytes, p.vals + row * 3, nr * 12u, bar);
    }
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8u * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < n_chunks && c < kStages; ++c) fetch(c);
  }
  for (int i = tid; i < p.fb * B * 4; i += kThreads)
    reinterpret_cast<unsigned*>(smem_raw)[i] = 0u;
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % kStages;
    mbar_wait(bars + 8u * st, (c / kStages) & 1);
    const BinT* sb = reinterpret_cast<const BinT*>(stages + st * stage_bytes);
    const float* sv =
        reinterpret_cast<const float*>(stages + st * stage_bytes + bin_bytes);
    const int nr = staged_rows(c);
    for (int r = warp; r < nr; r += kThreads / 32)
      add_row(hs, sb + r * F + f0, sv + r * 3, nf, B, lane);
    if (c == n_chunks - 1) {  // the rows past the last whole 16-row group
      const long long row = r0 + static_cast<long long>(c) * p.stage_rows;
      for (long long r = row + nr + warp; r < r1; r += kThreads / 32)
        add_row(hs, bins + r * F + f0, p.vals + r * 3, nf, B, lane);
    }
    __syncthreads();  // stage st is consumed
    if (tid == 0 && c + kStages < n_chunks) fetch(c + kStages);
  }

  // this CTA's cells are contiguous in a row of part from f0 on, as
  // [nf, B, 3]; the count is the two count sums added (exact for 0/1
  // weights: integers below 2^24)
  float* dst = p.part + static_cast<long long>(blockIdx.x) * F * B * 3 +
               static_cast<long long>(f0) * B * 3;
  for (int i = tid; i < cells * 3; i += kThreads) {
    const int cell = i / 3, ch = i - 3 * cell;
    dst[i] = ch == 0 ? hs.gh[cell].x
           : ch == 1 ? hs.gh[cell].y
                     : hs.w_other[cell] + static_cast<float>(hs.n_one[cell]);
  }
}

// out[i] = sum over the row-range CTAs of part[g][i], in CTA order
__global__ void __launch_bounds__(kReduceThreads)
    hist_reduce(const float* __restrict__ part, float* __restrict__ out,
                int n_parts, long long cells) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= cells) return;
  float s = 0.f;
  // 32 loads in flight a thread: the sum waits on memory, not on the adds
#pragma unroll 32
  for (int g = 0; g < n_parts; ++g) s += part[g * cells + i];
  out[i] = s;
}

// the dynamic shared memory of hist_partial for this plan
long long smem_bytes(const Params& p, int bin_size) {
  const long long hist = static_cast<long long>(p.fb) * p.B * 16;
  const long long stage =
      static_cast<long long>(p.stage_rows) * (p.F * bin_size + 12);
  return hist + kStages * (stage + 8);
}

template <typename BinT>
int launch(const Params& p, int grid_x, long long smem, float* out,
           cudaStream_t s) {
  auto kernel = hist_partial<BinT>;
  // the shared-memory opt-in, once per instance and device
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(opted & (1ull << (dev & 63)))) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted |= 1ull << (dev & 63);
  }
  const dim3 grid(grid_x, (p.F + p.fb - 1) / p.fb);
  kernel<<<grid, kThreads, static_cast<int>(smem), s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long cells = static_cast<long long>(p.F) * p.B * 3;
  hist_reduce<<<static_cast<unsigned>((cells + kReduceThreads - 1) /
                                      kReduceThreads),
                kReduceThreads, 0, s>>>(p.part, out, grid_x, cells);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch K1 (the partial histograms, then their reduction into out) on
// `stream` (a cudaStream_t from PyTorch) on device `device`. bin_bytes is
// 1 (uint8 bins) or 4 (int32 bins); bins and vals 16-byte aligned. The plan
// is lightgbm/hist.py's hist_plan: grid_x row-range CTAs of rows_per_cta
// rows (a multiple of 16), fb features per CTA, stage_rows rows a stage (a
// multiple of 16); part is [grid_x, F * num_bins * 3] f32 scratch and out
// [F, num_bins, 3] f32 (both written whole). count_dev may be null, then
// count_host rows are used. Returns the cudaError_t of the launches.
int mmlspark_hist_launch(const void* bins, int bin_bytes, const float* vals,
                         float* part, float* out, long long n,
                         int num_features, int num_bins, int fb, int grid_x,
                         long long rows_per_cta, int stage_rows,
                         long long count_host, const int* count_dev,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.bins = bins;
  p.vals = vals;
  p.part = part;
  p.n = n;
  p.F = num_features;
  p.B = num_bins;
  p.fb = fb;
  p.rows_per_cta = rows_per_cta;
  p.stage_rows = stage_rows;
  p.count_host = count_host;
  p.count_dev = count_dev;
  const long long smem = smem_bytes(p, bin_bytes);
  if ((bin_bytes != 1 && bin_bytes != 4) || n < 1 || num_features < 1 ||
      num_bins < 1 || fb < 1 || fb > num_features || grid_x < 1 ||
      rows_per_cta < 16 || rows_per_cta % 16 != 0 || stage_rows < 16 ||
      stage_rows % 16 != 0 ||
      static_cast<long long>(grid_x) * rows_per_cta < n || smem > 232448 ||
      static_cast<long long>(num_features) * num_bins * 3 > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(bins) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bin_bytes == 1 ? launch<uint8_t>(p, grid_x, smem, out, s)
                        : launch<int32_t>(p, grid_x, smem, out, s);
}

const char* mmlspark_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
