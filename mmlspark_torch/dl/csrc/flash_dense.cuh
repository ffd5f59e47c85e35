// The dense attention forward's shared parts: the launch parameters, the
// dense key source of flash_fwd.cuh's kernel body and the bf16 launcher,
// included by flash_attn.cu (K2a, K2b, K2c, K2c-lse at each head dim's
// default tile, and the f32 path) and flash_tuned.cu (the same kernels at
// the other key tiles and ring depths the tile search picks from). The
// design is set out in flash_attn.cu's note.

#pragma once

#include "flash_fwd.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B, T] with batch stride mask_sb; null = all valid
  void* o;
  float* lse;  // [B*H, T] f32 (K2b); unused by K2a
  int BH, H, T;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  long long mask_sb;
  long long qk_shift;  // q_offset - k_offset (K2c): key c <= row r + shift
  float scale;
};

// the key tiles a causal CTA visits: those its last query row can reach
__device__ __forceinline__ int reach_tiles(const Params& p, int last_row,
                                           int bk, int n_tiles) {
  const long long last = static_cast<long long>(last_row) + p.qk_shift;
  if (last < 0) return 0;
  const long long n = last / bk + 1;
  return n < n_tiles ? static_cast<int>(n) : n_tiles;
}

// the last local key row `row` may attend (causal), clamped into
// [-1, T] so the per-pair compare runs on 32-bit ints
__device__ __forceinline__ int row_limit(const Params& p, int row) {
  const long long lim = static_cast<long long>(row) + p.qk_shift;
  return lim < -1 ? -1 : lim > p.T ? p.T : static_cast<int>(lim);
}

__device__ __forceinline__ bool key_valid(const Params& p, int b, int key) {
  return key < p.T &&
         (p.mask == nullptr ||
          p.mask[static_cast<long long>(b) * p.mask_sb + key] != 0);
}

// ---------------------------------------------------------------- bf16 path

// The dense key source of flash_fwd.cuh's kernel body: K and V [B, H, T, D]
// views read by TMA in tiles of BK rows (the tile of D with BK keys and a
// ring of STAGES), keys valid by the key mask.
template <int D, bool kLse_, bool kCausal_, int BK = default_bk(D),
          int STAGES = default_stages(D)>
struct Dense {
  using Params = ::Params;
  using C = Tile<D, BK, STAGES>;
  static constexpr bool kLse = kLse_, kCausal = kCausal_;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kExtraSmem = 0;

  __device__ static void prepare(const Params&, uint8_t*, uint8_t*) {}

  // CTA i takes items i, i + grid, ...
  __device__ static int walk(int k) { return blockIdx.x + k * gridDim.x; }

  __device__ static int n_work(const Params& p) {
    return (p.T + kBQ - 1) / kBQ * p.BH;
  }

  // work item w -> (b*h, q tile): causal takes every head's last q tile
  // first (the longest rows: the longest-first order balances the
  // persistent CTAs), the rest go head by head so that a head's q tiles
  // run together and share its K and V in L2
  __device__ static bool item(const Params& p, const uint8_t*, int w,
                              Item& it) {
    const int n_qt = (p.T + kBQ - 1) / kBQ;
    int bh;
    if (kCausal) {
      it.qt = n_qt - 1 - w / p.BH;
      bh = w % p.BH;
    } else {
      bh = w / n_qt;
      it.qt = w % n_qt;
    }
    it.b = bh / p.H;
    it.h = bh % p.H;
    const int n = (p.T + C::BK - 1) / C::BK;
    it.kt0 = 0;
    it.kt1 = kCausal ? reach_tiles(p, it.qt * kBQ + kBQ - 1, C::BK, n) : n;
    it.Tq = p.T;
    it.lim_max = p.T;
    it.shift = p.qk_shift;
    it.part = 0;
    return true;
  }

  __device__ static void tile_words(const Params& p, const Item& it, int k0,
                                    int lane, uint32_t (&wv)[C::NW]) {
#pragma unroll
    for (int i = 0; i < C::NW; ++i)
      wv[i] = __ballot_sync(0xffffffffu,
                            key_valid(p, it.b, k0 + 32 * i + lane));
  }

  __device__ static void copy_tile(const Params&, const Item& it, int k0,
                                   int lane, uint32_t ks, uint32_t bar,
                                   const CUtensorMap* tk,
                                   const CUtensorMap* tv) {
    if (lane != 0) return;
    mbar_expect_tx(bar, C::STAGE_BYTES);
    tma_rows<D>(ks, tk, bar, C::BK, k0, it.h, it.b);
    tma_rows<D>(ks + C::KV_BYTES, tv, bar, C::BK, k0, it.h, it.b);
  }

  __device__ static void epilogue(const Params& p, const Item& it,
                                  const float (&acc)[D / 2], float m_lo,
                                  float m_hi, float l_lo, float l_hi,
                                  int r_lo, int r_hi, int t4) {
    const int T = p.T;
    if (kLse && t4 == 0) {
      // natural-log units; l = 0 only for a row with no allowed key
      float* lse = p.lse + static_cast<long long>(it.b * p.H + it.h) * T;
      if (r_lo < T) lse[r_lo] = l_lo > 0.f ? m_lo * p.scale + logf(l_lo) : kNeg;
      if (r_hi < T) lse[r_hi] = l_hi > 0.f ? m_hi * p.scale + logf(l_hi) : kNeg;
    }
    store_o<D>(static_cast<__nv_bfloat16*>(p.o) + it.b * p.o_sb +
                   it.h * p.o_sh,
               p.o_st, acc, l_lo, l_hi, r_lo, r_hi, t4, T);
  }
};


// Launch one bf16 instance `kernel` of the dense forward, tiled as `C` (a
// Tile of D), over the persistent grid: tensor maps of q (boxes of kBQ
// rows) and k, v (boxes of C::BK rows), the instance's shared-memory opt-in
// once per device (`opted`, the instance's own), one CTA per SM. Returns
// 0, a cudaError_t, or a tensor-map encoding error.
template <int D, class C, class Kernel>
int launch_dense(Kernel kernel, unsigned long long& opted, const Params& p,
                 int B, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int err = encode_view<D>(&tq, p.q, B, p.H, p.T, p.q_sb, p.q_sh, p.q_st,
                           kBQ);
  if (err == 0)
    err = encode_view<D>(&tk, p.k, B, p.H, p.T, p.k_sb, p.k_sh, p.k_st,
                         C::BK);
  if (err == 0)
    err = encode_view<D>(&tv, p.v, B, p.H, p.T, p.v_sb, p.v_sh, p.v_st,
                         C::BK);
  if (err != 0) return err;
  int n_sm = 0;
  err = persistent_setup(reinterpret_cast<const void*>(kernel), C::SMEM,
                         opted, n_sm);
  if (err != 0) return err;
  const long long work = static_cast<long long>((p.T + kBQ - 1) / kBQ) * p.BH;
  if (work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(work < n_sm ? work : n_sm);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
