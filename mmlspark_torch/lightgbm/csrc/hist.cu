// K1: masked histogram build for the GBDT engine, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel `_hist_kernel`
// (mmlspark_tpu/lightgbm/pallas_hist.py:45). Computes, for bins [n, F]
// (uint8 or int32, row-major) and pre-masked vals [n, 3] f32 (grad, hess,
// count weight), the per-(feature, bin) sums out[F, num_bins, 3].
// Bin ids outside [0, num_bins) add nothing; rows at or past `count` add
// nothing (the caller guarantees they are padding, so skipping per row gives
// the same sums as the TPU kernel's per-block skip).
//
// What bounds it on an H100: bytes. Each call must read n*F bin bytes and
// 12n vals bytes and write F*num_bins*12 bytes; it does 3 adds per
// (row, feature), far below the card's f32 rate.
//
// Design (not the TPU's one-hot MXU contraction, which the GPU would pay
// for in 256x redundant multiply-adds):
//  - grid = (feature blocks of `feat_block` features) x (row chunks),
//    sized by the wrapper to put a few CTAs on every SM;
//  - each CTA keeps a private shared-memory histogram
//    [feat_block, num_bins, 3] f32 (24 KB at 8 x 256), accumulated with
//    shared-memory atomicAdd, so global memory sees one atomic per nonzero
//    cell per CTA instead of one per (row, feature);
//  - rows whose three vals are all zero (rows outside the split's child)
//    skip their atomics: adding +-0 to a +0-initialised sum changes nothing;
//  - sums stay in f32 throughout (the TPU kernel's bf16 rounding of vals
//    is not reproduced).
// The global output must be zero-initialised by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename BinT>
__global__ void hist_kernel(const BinT* __restrict__ bins,
                            const float* __restrict__ vals,
                            float* __restrict__ out,
                            long long n, int num_features, int num_bins,
                            int feat_block, long long rows_per_chunk,
                            long long count_host,
                            const int* __restrict__ count_dev) {
  extern __shared__ float sh[];  // [feat_block][num_bins][3]
  const int f0 = blockIdx.x * feat_block;
  const int nf = min(feat_block, num_features - f0);
  const int cells = nf * num_bins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  long long count = count_host;
  if (count_dev != nullptr) {
    const long long c = static_cast<long long>(*count_dev);
    count = c < 0 ? 0 : (c < n ? c : n);
  }
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  long long r1 = r0 + rows_per_chunk;
  if (r1 > count) r1 = count;

  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const float g = vals[3 * r];
    const float h = vals[3 * r + 1];
    const float w = vals[3 * r + 2];
    if (g == 0.f && h == 0.f && w == 0.f) continue;
    const BinT* row = bins + r * num_features + f0;
    for (int i = 0; i < nf; ++i) {
      const int b = static_cast<int>(row[i]);
      if (b < 0 || b >= num_bins) continue;
      float* cell = sh + (i * num_bins + b) * 3;
      atomicAdd(cell, g);
      atomicAdd(cell + 1, h);
      atomicAdd(cell + 2, w);
    }
  }
  __syncthreads();

  // this CTA's cells are contiguous in out[F, num_bins, 3] from f0 on
  float* dst = out + static_cast<long long>(f0) * num_bins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = sh[i];
    if (v != 0.f) atomicAdd(dst + i, v);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device`.
// bin_bytes is 1 (uint8 bins) or 4 (int32 bins). count_dev may be null,
// then count_host rows are used. Returns the cudaError_t of the launch.
int mmlspark_hist_launch(const void* bins, int bin_bytes, const float* vals,
                         float* out, long long n, int num_features,
                         int num_bins, int feat_block, long long row_chunks,
                         long long count_host, const int* count_dev,
                         int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_per_chunk = (n + row_chunks - 1) / row_chunks;
  const dim3 grid((num_features + feat_block - 1) / feat_block,
                  static_cast<unsigned>(row_chunks));
  const size_t smem =
      static_cast<size_t>(feat_block) * num_bins * 3 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1) {
    hist_kernel<uint8_t><<<grid, threads, smem, s>>>(
        static_cast<const uint8_t*>(bins), vals, out, n, num_features,
        num_bins, feat_block, rows_per_chunk, count_host, count_dev);
  } else if (bin_bytes == 4) {
    hist_kernel<int32_t><<<grid, threads, smem, s>>>(
        static_cast<const int32_t*>(bins), vals, out, n, num_features,
        num_bins, feat_block, rows_per_chunk, count_host, count_dev);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mmlspark_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
