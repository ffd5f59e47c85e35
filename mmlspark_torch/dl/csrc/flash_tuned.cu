// The bf16 attention forward (K2a, K2b, K2c, K2c-lse) at the key tiles and
// ring depths the tile search picks from, beside flash_attn.cu's defaults:
// a library of its own, so that a process with no tuned winner builds and
// loads exactly the default library.
//
// Replaces no TPU kernel of its own: it is flash_attn.cu's kernel (which
// replaces `_flash_kernel`, `_flash_kernel_lse` and
// `_flash_kernel_causal_packed`, mmlspark_tpu/dl/pallas_attention.py:77,
// :126, :142) instantiated at other tiles, as the TPU kernels take their
// `block_q` x `block_k` (pallas_attention.py:628-662) from the autotuner's
// registry (mmlspark_tpu/perf/autotune.py). Same body (flash_fwd.cuh),
// same dense source and launcher (flash_dense.cuh), same numerics: the
// online softmax with the unnormalised p rounded to v's dtype; only the
// tile the loop runs over changes, so results move by the float order of
// the per-tile rescaling and nothing else.
//
// What bounds it on an H100: operations at long T, bytes at short T, as
// flash_attn.cu's note says. What a tile choice trades: a 64-key tile
// halves the score accumulator (BK/2 registers a thread) and the stage
// (16 KB at D = 64), so a 4-stage ring holds 256 keys in flight where the
// default's holds 512, and a short row (T <= 64 after padding) reads no
// padded keys; 2 or 3 stages free shared memory (to no other use: one CTA
// per SM) and bound the copies ahead of the consumers. The q tile stays
// kBQ = 128, the CTA's two consumer warpgroups of 64 rows: a 64-row tile
// would be another CTA, not another instance of this one.
//
// The instances: D = 64 (the head dim of every shipped path) at each
// (key tile, stages) of TUNED_TILES below, for the four (kLse, kCausal)
// flag pairs. dl/flash_attention.py's TUNED_TILES and perf/autotune.py's
// "cuda" grid list the same pairs (a test reads them from this file).

#include "flash_dense.cuh"

namespace {

constexpr int kTunedD = 64;

template <int D, bool kLse, bool kCausal, int BK, int STAGES>
__global__ void __launch_bounds__(Tile<D, BK, STAGES>::THREADS, 1)
    flash_fwd_tuned(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  fwd_bf16_body<D, Dense<D, kLse, kCausal, BK, STAGES>>(tq, tk, tv, p);
}

template <int BK, int STAGES, bool kLse, bool kCausal>
int launch_flags(const Params& p, int B, cudaStream_t s) {
  // the shared-memory opt-in, once per instance and device
  static unsigned long long opted = 0;
  return launch_dense<kTunedD, Tile<kTunedD, BK, STAGES>>(
      flash_fwd_tuned<kTunedD, kLse, kCausal, BK, STAGES>, opted, p, B, s);
}

template <int BK, int STAGES>
int launch_tile(const Params& p, bool lse, bool causal, int B,
                cudaStream_t s) {
  if (causal)
    return lse ? launch_flags<BK, STAGES, true, true>(p, B, s)
               : launch_flags<BK, STAGES, false, true>(p, B, s);
  return lse ? launch_flags<BK, STAGES, true, false>(p, B, s)
             : launch_flags<BK, STAGES, false, false>(p, B, s);
}

}  // namespace

extern "C" {

// Launch K2a, K2b, K2c or K2c-lse as mmlspark_flash_launch does (the same
// arguments, bf16 only, at D = 64), at key tile `bk` and ring depth
// `stages`, which must be one of TUNED_TILES. Returns 0, a cudaError_t of
// the launch, or a negative code of the tensor-map encoding.
int mmlspark_flash_tuned_launch(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    float* lse, int B, int H, int T, int D, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, long long mask_sb, float scale,
    int causal, long long q_offset, long long k_offset, int bk, int stages,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D != kTunedD || B < 1 || H < 1 || T < 1 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.o = o;
  p.lse = lse;
  p.BH = B * H;
  p.H = H;
  p.T = T;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_st = q_st;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_st = k_st;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_st = v_st;
  p.o_sb = o_sb, p.o_sh = o_sh, p.o_st = o_st;
  p.mask_sb = mask_sb;
  p.qk_shift = q_offset - k_offset;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_lse = lse != nullptr, is_causal = causal != 0;
  // TUNED_TILES: (key tile, stages) of every instance this library holds
#define TILE(BK, ST)                                                \
  if (bk == BK && stages == ST)                                     \
    return launch_tile<BK, ST>(p, with_lse, is_causal, B, s);
  TILE(128, 3)
  TILE(128, 2)
  TILE(64, 4)
  TILE(64, 3)
  TILE(64, 2)
#undef TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mmlspark_flash_tuned_error_string(int err) {
  return launch_error_string(err);
}

}  // extern "C"
