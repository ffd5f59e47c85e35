// K2d and K2e: the fused flash-attention backward (key mask; causal or
// not), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` (K2d,
// mmlspark_tpu/dl/pallas_attention.py:350, launched at :462) and
// `_bwd_dkv_kernel` (K2e, :388, launched at :483), with their causal
// branches, which `_flash_backward` (:435) runs for the custom VJP of
// `flash_attention` and `flash_attention_lse`. For q, k, v, dO [B, H, T, D]
// (any batch, head and row strides; unit stride on D), a key mask [B, T]
// (nonzero = valid; null = all valid), and per-row f32 lse and dsum
// [B, H, T] (contiguous), with scale = D^-0.5 of the caller's true head dim:
//   s  = (q . k^T) * scale in f32;  p = exp(s - lse), set to 0 at invalid
//        keys by a select (at an invalid key exp can overflow to inf, and
//        every key of a fully masked row has lse = -1e30: inf * 0 would be
//        NaN);
//   dp = dO . v^T in f32;  ds = p * (dp - dsum) * scale;
//   K2d: dq = ds.astype(k) . k                 (f32 sum, q's dtype out)
//   K2e: dv = p.astype(dO)^T . dO,  dk = ds.astype(q)^T . q
// dsum = sum_d dO * o (minus dlse for the lse variant) is computed by the
// caller in plain PyTorch, as the JAX package computes it in XLA.
// Causal (the template flag kCausal): query row r sits at q_offset + r and
// key c at k_offset + c (64-bit offsets, the forward's); a pair is allowed
// iff the key is valid and k_offset + c <= q_offset + r, and p of any other
// pair is 0 by the same select, so a row with no allowed key (lse = -1e30)
// gets dq = 0 and a key no row may see gets dk = dv = 0, exactly.
//
// What bounds it on an H100: operations. K2d does three products (s, dp,
// dq) and K2e four (s, dp, dv, dk): 6*P*D and 8*P*D flops for P allowed
// (query, key) pairs, against 4 or 5 [B, H, T, D] tensors of bytes. At the
// training path's shape (B=8, H=8, T=2048, D=64, every key valid) that is
// 103 and 137 GFLOP, 0.10 and 0.14 ms at 989 TFLOP/s bf16 dense (NVIDIA H100
// SXM data sheet), against 8 MB per tensor (2.5 us each at 3.35 TB/s);
// causal at q_offset = k_offset, P is T(T+1)/2 per (b, h), about half.
//
// Design, bf16 (the f32 path below is the tight check of the same
// algorithm and keeps a simple design: 4 threads a row, 32-row tiles,
// plain FMA), the forward's (flash_attn.cu) shape with its helpers
// (flash_common.cuh):
//  - Two kernels, deterministic, no atomics: K2d owns dq rows, K2e owns
//    dk/dv rows, so every output element is one CTA's sum in a fixed order
//    and two launches on the same inputs give the same bits.
//  - A persistent grid, one CTA per SM, walks the work items. A CTA is two
//    consumer warpgroups and one producer warpgroup, 384 threads. At 288
//    threads (one producer warp) ptxas holds a thread to 168 registers,
//    and the instances spilled; the producer warpgroup gives its registers
//    to the consumers with setmaxnreg (24 / 240), and one of its warps
//    issues the copies. Each item's own tiles (Q and
//    dO in K2d, K and V in K2e) load once into one of two item buffers (one
//    at D = 256 in K2d), so the next item's load overlaps this one; the
//    streamed tiles (K and V in K2d; Q, dO and their lse and dsum in K2e)
//    come through a ring of 3-4 stages, each buffer and stage guarded by a
//    full and an empty mbarrier. Tensor maps over the caller's strided
//    views; rows past T are zero-filled by TMA.
//  - K2d: an item is (b*h, 128 q rows), 64 per warpgroup; key tiles of 64
//    (32 at D = 256). S = Q K^T and dP = dO V^T are SS wgmma products (all
//    four operands K-major from shared memory); p and dS are formed in
//    registers and dS, rounded to bf16, is the register A operand of
//    dQ += dS K with K read MN-major through the descriptor. The producer
//    posts every key tile with its validity words, as in the forward: a
//    tile with no valid key arrives without a copy and is skipped.
//  - K2e: an item is (b*h, 128 keys), 64 per warpgroup; q tiles of 64 rows
//    (32 at D = 256). S^T = K Q^T and dP^T = V dO^T (SS), P^T and dS^T in
//    registers as the A operands of dV += P^T dO and dK += dS^T Q, dO and
//    Q read MN-major through the descriptor, so no operand is transposed
//    by hand. The producer warp
//    writes each q tile's lse (times log2 e; +inf for rows past T, which
//    makes their p exactly 0) and dsum into the stage before its arrive.
//    An item with no valid key loads nothing and writes zeros.
//  - Registers: dK and dV are D/2 f32 each per thread of a 64-key
//    warpgroup tile. At D = 128 that is 128 beside S^T and dP^T (64 at
//    64-row q tiles), within the 240; at D = 256 they would be 256, so
//    the two warpgroups share one 64-key tile and split its D columns:
//    each recomputes the full S^T and dP^T (the reduction runs over all of
//    D) and accumulates its own 128 columns of dK and dV. That costs 1.5x
//    the flops of the shared products; sharing P^T and dS^T through shared
//    memory instead would need both warpgroups to meet on named barriers
//    every tile, and the recompute keeps them independent.
//  - Numerics: p = 2^(s * c - lse * log2 e) with c = scale * log2(e), one
//    FFMA and the exp2 per score, zeroed by a select at every disallowed
//    pair (never a multiply), so the -1e30 sentinel rows stay exactly 0.
//    A K2d tile whose keys are all valid and off the causal diagonal takes
//    no select.
//  - Causal: K2d loops to n_reach = clamp(floor((q0 + 127 + shift) / BK) +
//    1, 0, nk) with shift = q_offset - k_offset (the forward's bound); K2e
//    starts at clamp(floor((k0 - shift) / BQ), 0, nq), the mirror of
//    `_block_reachable`. Both floors are signed and on 64-bit values, so
//    offsets need not be multiples of the tile and may exceed T. A
//    warpgroup skips the tiles none of its pairs reach and runs the
//    per-pair compare only on tiles that cross its diagonal. Items go
//    longest first (K2d: every head's last q tile first; K2e: the first key
//    tiles), which balances the persistent CTAs.
//  - dq, dk and dv are written through their own strides, so the wrapper
//    hands back [B, H, T, D] views of [B, T, H, D] buffers.
//  - A wait that does not complete within ~2^24 polls traps.

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 128;          // the f32 path's CTA
constexpr int kTile32 = kThreads / 4;  // rows per f32 tile (4 threads a row)

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const uint8_t* mask;  // [B, T] with batch stride mask_sb; null = all valid
  const float* lse;     // [B*H, T]
  const float* dsum;    // [B*H, T]
  void* dq;
  void* dk;
  void* dv;
  int BH, H, T;
  // batch, head, row strides (elements) of q, k, v, dO, dq, dk, dv
  long long st[7][3];
  long long mask_sb;
  long long qk_shift;  // q_offset - k_offset (causal): key c <= row r + shift
  float scale;
};

enum { kQ, kK, kV, kDO, kDQ, kDK, kDV };

// causal: the key tiles (of bk keys) that a q tile whose last row is
// `last_row` reaches: the forward's n_reach
__device__ __forceinline__ int reach_tiles(const Params& p, int last_row,
                                           int bk, int n_tiles) {
  const long long last = static_cast<long long>(last_row) + p.qk_shift;
  if (last < 0) return 0;
  const long long n = last / bk + 1;
  return n < n_tiles ? static_cast<int>(n) : n_tiles;
}

// causal: the first q tile (of bq rows) whose last row reaches key k0,
// clamp(floor((k0 - shift) / bq), 0, n_tiles)
__device__ __forceinline__ int first_q_tile(const Params& p, int k0, int bq,
                                            int n_tiles) {
  const long long first = static_cast<long long>(k0) - p.qk_shift;
  if (first <= 0) return 0;
  const long long t = first / bq;
  return t < n_tiles ? static_cast<int>(t) : n_tiles;
}

// causal: the last local key row `row` may attend, clamped into [-1, T]
// so the per-pair compare runs on 32-bit ints
__device__ __forceinline__ int row_limit(const Params& p, int row) {
  const long long lim = static_cast<long long>(row) + p.qk_shift;
  return lim < -1 ? -1 : lim > p.T ? p.T : static_cast<int>(lim);
}

// causal: the first local query row that may attend key `key`, clamped
// into [0, T]
__device__ __forceinline__ int key_first_row(const Params& p, int key) {
  const long long first = static_cast<long long>(key) - p.qk_shift;
  return first < 0 ? 0 : first > p.T ? p.T : static_cast<int>(first);
}

__device__ __forceinline__ bool key_valid(const Params& p, int b, int key) {
  return key < p.T &&
         (p.mask == nullptr ||
          p.mask[static_cast<long long>(b) * p.mask_sb + key] != 0);
}

template <typename T>
__device__ __forceinline__ T* head_ptr(const void* base, const Params& p,
                                       int which, int b, int h) {
  return static_cast<T*>(const_cast<void*>(base)) + b * p.st[which][0] +
         h * p.st[which][1];
}

// ---------------------------------------------------------------- bf16 path

constexpr int kConsumers = 2 * kWgThreads;  // two consumer warpgroups

// rows r_lo and r_lo + 8 of an m64nN accumulator (this thread's columns
// 8j + 2 t4, + 1), rounded to bf16, through the row stride of `base`
template <int N>
__device__ __forceinline__ void store_acc(bf16* base, long long st,
                                          const float (&acc)[N / 2],
                                          int r_lo, int T, int c0, int t4) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = c0 + j * 8 + t4 * 2;
    if (r_lo < T)
      *reinterpret_cast<uint32_t*>(base + r_lo * st + c) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r_hi < T)
      *reinterpret_cast<uint32_t*>(base + r_hi * st + c) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// K2d's shared-memory layout of one head dim: NQB item buffers of (Q, dO),
// STAGES of (K, V), each stage's validity words, then the barriers
template <int D>
struct DqTile : Swz<D> {
  static constexpr int BQ = 128;  // q rows per item: 64 per warpgroup
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per streamed tile
  static constexpr int NW = BK / 32;             // validity words per tile
  static constexpr int NQB = D == 256 ? 1 : 2;
  static constexpr int STAGES = D >= 128 ? 3 : 4;
  static constexpr int ROWS_BYTES = BQ * D * 2;  // one of Q or dO
  static constexpr int ITEM_BYTES = 2 * ROWS_BYTES;
  static constexpr int KV_BYTES = BK * D * 2;    // one of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int META = STAGES * 16;
  static constexpr int BARS = (2 * STAGES + 2 * NQB) * 8;
  static constexpr int SMEM =
      1024 + NQB * ITEM_BYTES + STAGES * STAGE_BYTES + META + BARS;
  static constexpr int THREADS = kConsumers + kWgThreads;
  static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
};

// K2e's: two item buffers of (K, V), STAGES of (Q, dO), each stage's lse
// and dsum (BQ floats each), then the barriers
template <int D>
struct DkvTile : Swz<D> {
  // warpgroups on one 64-key tile, splitting its dK/dV columns (D = 256)
  static constexpr int SPLIT = D == 256 ? 2 : 1;
  static constexpr int BKEY = 128 / SPLIT;  // keys per item
  static constexpr int DC = D / SPLIT;      // dK/dV columns a warpgroup owns
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int STAGES = D >= 128 ? 3 : 4;
  static constexpr int KEYS_BYTES = BKEY * D * 2;  // one of K or V
  static constexpr int ITEM_BYTES = 2 * KEYS_BYTES;
  static constexpr int ROWS_BYTES = BQ * D * 2;    // one of Q or dO
  static constexpr int STAGE_BYTES = 2 * ROWS_BYTES;
  static constexpr int META = STAGES * BQ * 8;
  static constexpr int BARS = (2 * STAGES + 4) * 8;
  static constexpr int SMEM =
      1024 + 2 * ITEM_BYTES + STAGES * STAGE_BYTES + META + BARS;
  static constexpr int THREADS = kConsumers + kWgThreads;
  static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
};

// K2d: dq, one work item per (b*h, 128-row q tile)
template <int D, bool kCausal>
__global__ void __launch_bounds__(DqTile<D>::THREADS, 1)
    bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = DqTile<D>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t item_s = base;  // buffer i: Q, then dO
  const uint32_t kv_s = base + C::NQB * C::ITEM_BYTES;  // stage s: K, V
  const uint32_t meta_off =
      C::NQB * C::ITEM_BYTES + C::STAGES * C::STAGE_BYTES;
  uint32_t* const meta =
      reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + meta_off);
  const uint32_t bars = base + meta_off + C::META;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::STAGES + s); };
  auto ifull = [&](int i) { return bars + 8u * (2 * C::STAGES + i); };
  auto iempty = [&](int i) {
    return bars + 8u * (2 * C::STAGES + C::NQB + i);
  };

  const int tid = threadIdx.x;
  const int T = p.T;
  const int n_qt = (T + BQ - 1) / BQ;
  const int n_kt = (T + BK - 1) / BK;
  const int n_work = n_qt * p.BH;
  // causal: every head's last q tile first (the longest rows), else head
  // by head so that a head's q tiles share its K and V in L2
  auto work_at = [&](int w, int& bh, int& qt) {
    if (kCausal) {
      qt = n_qt - 1 - w / p.BH;
      bh = w % p.BH;
    } else {
      bh = w / n_qt;
      qt = w % n_qt;
    }
  };
  auto tiles_of = [&](int qt) {
    return kCausal ? reach_tiles(p, qt * BQ + BQ - 1, BK, n_kt) : n_kt;
  };

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's one arrival (+ the bytes)
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < C::NQB; ++i) {
      mbar_init(ifull(i), 1);
      mbar_init(iempty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---------------------------------------------------------- producer
    producer_regs();
    if (tid >= kConsumers + 32) return;  // one warp issues the copies
    const int lane = tid - kConsumers;
    int stage = 0;
    uint32_t phase = 0;
    int it = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
      int bh, qt;
      work_at(w, bh, qt);
      const int b = bh / p.H, h = bh % p.H;
      if (lane == 0) {
        const int ib = it % C::NQB;
        mbar_wait(iempty(ib), ((it / C::NQB) & 1) ^ 1);
        mbar_expect_tx(ifull(ib), C::ITEM_BYTES);
        const uint32_t dst = item_s + ib * C::ITEM_BYTES;
        tma_rows<D>(dst, &tq, ifull(ib), BQ, qt * BQ, h, b);
        tma_rows<D>(dst + C::ROWS_BYTES, &tdo, ifull(ib), BQ, qt * BQ, h, b);
      }
      const int n_tiles = tiles_of(qt);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * BK;
        uint32_t wv[C::NW], any = 0;
#pragma unroll
        for (int i = 0; i < C::NW; ++i) {
          wv[i] = __ballot_sync(0xffffffffu,
                                key_valid(p, b, k0 + 32 * i + lane));
          any |= wv[i];
        }
        if (lane == 0) {
          mbar_wait(empty(stage), phase ^ 1);
          uint32_t* m = meta + 4 * stage;
#pragma unroll
          for (int i = 0; i < C::NW; ++i) m[i] = wv[i];
          if (any) {
            mbar_expect_tx(full(stage), C::STAGE_BYTES);
            const uint32_t ks = kv_s + stage * C::STAGE_BYTES;
            tma_rows<D>(ks, &tk, full(stage), BK, k0, h, b);
            tma_rows<D>(ks + C::KV_BYTES, &tv, full(stage), BK, k0, h, b);
          } else {
            mbar_arrive(full(stage));  // no valid key: no copy, same list
          }
        }
        if (++stage == C::STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  consumer_regs();
  const int cw = tid / kWgThreads;  // this warpgroup: rows 64 * cw + ...
  const int t = tid % kWgThreads;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row / column pair
  const float scale2 = p.scale * kLog2e;
  int stage = 0;
  uint32_t phase = 0;
  int it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
    int bh, qt;
    work_at(w, bh, qt);
    const int b = bh / p.H, h = bh % p.H;
    const int n_tiles = tiles_of(qt);
    const int wg_row0 = qt * BQ + 64 * cw;
    const int r_lo = wg_row0 + warp * 16 + g, r_hi = r_lo + 8;
    // causal: the last key the first and the last row of the warpgroup reach
    const long long reach_first = wg_row0 + p.qk_shift;
    const long long reach_last = wg_row0 + 63 + p.qk_shift;
    // causal: key column 8j + e of this thread's pairs is allowed iff
    // 8j + e <= row limit - k0 - 2 * t4
    const int lim_lo = row_limit(p, r_lo) - 2 * t4;
    const int lim_hi = row_limit(p, r_hi) - 2 * t4;
    const float* lse = p.lse + static_cast<long long>(bh) * T;
    const float* dsum = p.dsum + static_cast<long long>(bh) * T;
    const float l2_lo = r_lo < T ? lse[r_lo] * kLog2e : 0.f;
    const float l2_hi = r_hi < T ? lse[r_hi] * kLog2e : 0.f;
    const float ds_lo = r_lo < T ? dsum[r_lo] : 0.f;
    const float ds_hi = r_hi < T ? dsum[r_hi] : 0.f;
    const int ib = it % C::NQB;
    const uint32_t qa = item_s + ib * C::ITEM_BYTES + 64 * cw * C::ROWB;
    const uint32_t da = qa + C::ROWS_BYTES;

    float acc[D / 2];
    zero(acc);
    mbar_wait(ifull(ib), (it / C::NQB) & 1);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * BK;
      mbar_wait(full(stage), phase);
      const uint32_t* mw = meta + 4 * stage;
      uint32_t w[C::NW], any = 0, all = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < C::NW; ++i) {
        w[i] = mw[i];
        any |= w[i];
        all &= w[i];
      }
      // a warpgroup with no row before T, or (causal) none that reaches the
      // tile, only releases it
      const bool reach = wg_row0 < T && (!kCausal || k0 <= reach_last);
      if (any != 0 && reach) {
        const uint32_t ks = kv_s + stage * C::STAGE_BYTES;
        const uint32_t vs = ks + C::KV_BYTES;
        float s[BK / 2], dp[BK / 2];
        zero(s);
        zero(dp);
        keep(s);
        keep(dp);
        keep(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(s, kmajor<D>(qa, BQ, kk), kmajor<D>(ks, BK, kk),
                       kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(dp, kmajor<D>(da, BQ, kk), kmajor<D>(vs, BK, kk),
                       kk > 0);
        wg_commit();
        wg_wait0();
        keep(s);
        keep(dp);
        const bool diag = kCausal && k0 + BK - 1 > reach_first;
        const bool full_tile = !diag && all == 0xffffffffu;
        const int d_lo = lim_lo - k0, d_hi = lim_hi - k0;
#pragma unroll
        for (int i = 0; i < C::NW; ++i) w[i] >>= 2 * t4;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool valid = (w[j / 4] >> (8 * (j % 4) + e)) & 1u;
            const bool ok_lo =
                full_tile || (valid && (!diag || 8 * j + e <= d_lo));
            const bool ok_hi =
                full_tile || (valid && (!diag || 8 * j + e <= d_hi));
            const float p_lo =
                ok_lo ? ex2(fmaf(s[4 * j + e], scale2, -l2_lo)) : 0.f;
            const float p_hi =
                ok_hi ? ex2(fmaf(s[4 * j + 2 + e], scale2, -l2_hi)) : 0.f;
            s[4 * j + e] = p_lo * (dp[4 * j + e] - ds_lo) * p.scale;  // ds
            s[4 * j + 2 + e] = p_hi * (dp[4 * j + 2 + e] - ds_hi) * p.scale;
          }
        }
        uint32_t dsa[BK / 16][4];
        to_a_frags<BK>(dsa, s);
        keep(acc);
        keep(dsa);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // dq += ds . k, k MN-major
          wgmma_rs<D, D>(acc, dsa[kk], ks, BK, kk, 0);
        wg_commit();
        wg_wait0();
        keep(acc);
        keep(dsa);
      }
      release(empty(stage), lane);
      if (++stage == C::STAGES) stage = 0, phase ^= 1;
    }
    release(iempty(ib), lane);  // the products that read this Q, dO are done
    store_acc<D>(head_ptr<bf16>(p.dq, p, kDQ, b, h), p.st[kDQ][2], acc, r_lo,
                 T, 0, t4);
  }
}

// any valid key among the `n` (a multiple of 32) keys at k0: one warp's
// ballots, the same answer on every lane
__device__ __forceinline__ bool keys_any(const Params& p, int b, int k0,
                                         int n, int lane) {
  bool any = false;
  for (int i = 0; i < n; i += 32) any |= key_valid(p, b, k0 + i + lane);
  return __any_sync(0xffffffffu, any);
}

// K2e: dk and dv, one work item per (b*h, BKEY-key tile)
template <int D, bool kCausal>
__global__ void __launch_bounds__(DkvTile<D>::THREADS, 1)
    bwd_dkv_bf16(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = DkvTile<D>;
  constexpr int BQ = C::BQ, BKEY = C::BKEY, DC = C::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t item_s = base;  // buffer i: K, then V
  const uint32_t q_s = base + 2 * C::ITEM_BYTES;  // stage s: Q, then dO
  const uint32_t meta_off = 2 * C::ITEM_BYTES + C::STAGES * C::STAGE_BYTES;
  float* const meta =
      reinterpret_cast<float*>(smem_raw + (base - raw) + meta_off);
  const uint32_t bars = base + meta_off + C::META;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::STAGES + s); };
  auto ifull = [&](int i) { return bars + 8u * (2 * C::STAGES + i); };
  auto iempty = [&](int i) { return bars + 8u * (2 * C::STAGES + 2 + i); };

  const int tid = threadIdx.x;
  const int T = p.T;
  const int n_qt = (T + BQ - 1) / BQ;
  const int n_kt = (T + BKEY - 1) / BKEY;
  const int n_work = n_kt * p.BH;
  // causal: every head's first key tile first (the keys most rows see),
  // else head by head so that a head's key tiles share its Q and dO in L2
  auto work_at = [&](int w, int& bh, int& kt) {
    if (kCausal) {
      kt = w / p.BH;
      bh = w % p.BH;
    } else {
      bh = w / n_kt;
      kt = w % n_kt;
    }
  };
  auto first_tile = [&](int k0) {
    return kCausal ? first_q_tile(p, k0, BQ, n_qt) : 0;
  };

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's arrival (+ the bytes)
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(ifull(i), 1);
      mbar_init(iempty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---------------------------------------------------------- producer
    producer_regs();
    if (tid >= kConsumers + 32) return;  // one warp issues the copies
    const int lane = tid - kConsumers;
    int stage = 0;
    uint32_t phase = 0;
    int it = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      int bh, kt;
      work_at(w, bh, kt);
      const int b = bh / p.H, h = bh % p.H;
      const int k0 = kt * BKEY;
      if (!keys_any(p, b, k0, BKEY, lane)) continue;  // no copy, zeros out
      if (lane == 0) {
        const int ib = it & 1;
        mbar_wait(iempty(ib), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(ifull(ib), C::ITEM_BYTES);
        const uint32_t dst = item_s + ib * C::ITEM_BYTES;
        tma_rows<D>(dst, &tk, ifull(ib), BKEY, k0, h, b);
        tma_rows<D>(dst + C::KEYS_BYTES, &tv, ifull(ib), BKEY, k0, h, b);
      }
      ++it;
      const float* lse = p.lse + static_cast<long long>(bh) * T;
      const float* dsum = p.dsum + static_cast<long long>(bh) * T;
      for (int qt = first_tile(k0); qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        mbar_wait(empty(stage), phase ^ 1);
        // the tile's lse (log2 units; +inf past T, so p = 0 there) and
        // dsum, written before the arrive that publishes the stage
        float* m = meta + stage * 2 * BQ;
#pragma unroll
        for (int i = 0; i < BQ; i += 32) {
          const int r = q0 + i + lane;
          m[i + lane] = r < T ? lse[r] * kLog2e : __int_as_float(0x7f800000);
          m[BQ + i + lane] = r < T ? dsum[r] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(full(stage), C::STAGE_BYTES);
          const uint32_t dst = q_s + stage * C::STAGE_BYTES;
          tma_rows<D>(dst, &tq, full(stage), BQ, q0, h, b);
          tma_rows<D>(dst + C::ROWS_BYTES, &tdo, full(stage), BQ, q0, h, b);
        }
        if (++stage == C::STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  consumer_regs();
  const int cw = tid / kWgThreads;
  const int t = tid % kWgThreads;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this warpgroup's keys in the item and its dK/dV column boxes
  const int koff = C::SPLIT == 1 ? 64 * cw : 0;
  const int box0 = C::SPLIT == 1 ? 0 : cw * (DC / C::CW);
  const float scale2 = p.scale * kLog2e;
  int stage = 0;
  uint32_t phase = 0;
  int it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    int bh, kt;
    work_at(w, bh, kt);
    const int b = bh / p.H, h = bh % p.H;
    const int k0 = kt * BKEY;
    const int kw0 = k0 + koff;
    const int key_lo = kw0 + warp * 16 + g, key_hi = key_lo + 8;
    float dk[DC / 2], dv[DC / 2];
    zero(dk);
    zero(dv);
    if (keys_any(p, b, k0, BKEY, lane)) {
      const int ib = it & 1;
      mbar_wait(ifull(ib), (it >> 1) & 1);
      ++it;
      const uint32_t ka = item_s + ib * C::ITEM_BYTES + koff * C::ROWB;
      const uint32_t va = ka + C::KEYS_BYTES;
      const bool wg_any = keys_any(p, b, kw0, 64, lane);
      const bool kval_lo = key_valid(p, b, key_lo);
      const bool kval_hi = key_valid(p, b, key_hi);
      // causal: query column 8j + e of this thread's pairs may see its key
      // iff 8j + e >= the key's first row - q0 - 2 * t4
      const int f_lo = key_first_row(p, key_lo) - 2 * t4;
      const int f_hi = key_first_row(p, key_hi) - 2 * t4;
      const int f_first = key_first_row(p, kw0);
      const int f_last = key_first_row(p, kw0 + 63);
      for (int qt = first_tile(k0); qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        mbar_wait(full(stage), phase);
        const bool reach = !kCausal || q0 + BQ - 1 >= f_first;
        if (wg_any && reach) {
          const uint32_t qs = q_s + stage * C::STAGE_BYTES;
          const uint32_t dos = qs + C::ROWS_BYTES;
          float st[BQ / 2], dpt[BQ / 2];  // rows: keys; columns: q rows
          zero(st);
          zero(dpt);
          keep(st);
          keep(dpt);
          keep(dk);
          keep(dv);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BQ>(st, kmajor<D>(ka, BKEY, kk), kmajor<D>(qs, BQ, kk),
                         kk > 0);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BQ>(dpt, kmajor<D>(va, BKEY, kk),
                         kmajor<D>(dos, BQ, kk), kk > 0);
          wg_commit();
          wg_wait0();
          keep(st);
          keep(dpt);
          const float* m = meta + stage * 2 * BQ;
          const bool diag = kCausal && q0 < f_last;
          const int d_lo = f_lo - q0, d_hi = f_hi - q0;
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + 2 * t4 + e;
              const float l2 = m[c], dd = m[BQ + c];
              const bool ok_lo = kval_lo && (!diag || 8 * j + e >= d_lo);
              const bool ok_hi = kval_hi && (!diag || 8 * j + e >= d_hi);
              const float p_lo =
                  ok_lo ? ex2(fmaf(st[4 * j + e], scale2, -l2)) : 0.f;
              const float p_hi =
                  ok_hi ? ex2(fmaf(st[4 * j + 2 + e], scale2, -l2)) : 0.f;
              st[4 * j + e] = p_lo;  // p^T, for dv
              st[4 * j + 2 + e] = p_hi;
              dpt[4 * j + e] = p_lo * (dpt[4 * j + e] - dd) * p.scale;
              dpt[4 * j + 2 + e] = p_hi * (dpt[4 * j + 2 + e] - dd) * p.scale;
            }
          }
          uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
          to_a_frags<BQ>(pa, st);
          to_a_frags<BQ>(sa, dpt);
          keep(dk);
          keep(dv);
          keep(pa);
          keep(sa);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)  // dv += p^T . dO, MN-major
            wgmma_rs<DC, D>(dv, pa[kk], dos, BQ, kk, box0);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)  // dk += ds^T . q, MN-major
            wgmma_rs<DC, D>(dk, sa[kk], qs, BQ, kk, box0);
          wg_commit();
          wg_wait0();
          keep(dk);
          keep(dv);
          keep(pa);
          keep(sa);
        }
        release(empty(stage), lane);
        if (++stage == C::STAGES) stage = 0, phase ^= 1;
      }
      release(iempty(ib), lane);  // the products that read this K, V are done
    }
    const int c0 = box0 * C::CW;
    store_acc<DC>(head_ptr<bf16>(p.dk, p, kDK, b, h), p.st[kDK][2], dk,
                  key_lo, T, c0, t4);
    store_acc<DC>(head_ptr<bf16>(p.dv, p, kDV, b, h), p.st[kDV][2], dv,
                  key_lo, T, c0, t4);
  }
}

// ----------------------------------------------------------------- f32 path

// rows [r0, r0 + kTile32) of a [T, D] f32 head into an unpadded tile
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               long long st, int r0, int T,
                                               int tid) {
  for (int i = tid; i < kTile32 * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T)
      x = *reinterpret_cast<const float4*>(src + (r0 + r) * st + c);
    *reinterpret_cast<float4*>(&dst[r * D + c]) = x;
  }
}

// the four partial dots of a row; every thread of the four gets the sum
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K2d in f32: dq for one (b*h, 32-row q tile), 4 threads a row
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads) bwd_dq_f32(const Params p) {
  constexpr int DP = D / 4;  // dims per thread: part, part + 4, ...
  __shared__ __align__(16) float ks[kTile32 * D];
  __shared__ __align__(16) float vs[kTile32 * D];
  __shared__ uint8_t allowed[kTile32];

  const int tid = threadIdx.x, part = tid & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int T = p.T;
  const int row = blockIdx.y * kTile32 + (tid >> 2);
  const float* qb = head_ptr<const float>(p.q, p, kQ, b, h);
  const float* kb = head_ptr<const float>(p.k, p, kK, b, h);
  const float* vb = head_ptr<const float>(p.v, p, kV, b, h);
  const float* dob = head_ptr<const float>(p.dout, p, kDO, b, h);

  float q[DP], g[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    q[i] = row < T ? qb[row * p.st[kQ][2] + part + 4 * i] : 0.f;
    g[i] = row < T ? dob[row * p.st[kDO][2] + part + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  const long long r = static_cast<long long>(bh) * T + row;
  const float lse = row < T ? p.lse[r] : 0.f;
  const float dsum = row < T ? p.dsum[r] : 0.f;

  const int lim = row_limit(p, row);  // causal: last allowed local key
  int n_tiles = (T + kTile32 - 1) / kTile32;
  if (kCausal)
    n_tiles = reach_tiles(p, blockIdx.y * kTile32 + kTile32 - 1, kTile32,
                          n_tiles);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile32;
    __syncthreads();
    const bool ok = tid < kTile32 && key_valid(p, b, k0 + tid);
    if (tid < kTile32) allowed[tid] = ok;
    if (!__syncthreads_or(ok)) continue;
    stage_rows_f32<D>(ks, kb, p.st[kK][2], k0, T, tid);
    stage_rows_f32<D>(vs, vb, p.st[kV][2], k0, T, tid);
    __syncthreads();
    for (int j = 0; j < kTile32; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s = fmaf(q[i], ks[j * D + part + 4 * i], s);
        dp = fmaf(g[i], vs[j * D + part + 4 * i], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const bool ok = allowed[j] && (!kCausal || k0 + j <= lim);
      const float pj = ok ? expf(s * p.scale - lse) : 0.f;
      const float ds = pj * (dp - dsum) * p.scale;
#pragma unroll
      for (int i = 0; i < DP; ++i)
        acc[i] = fmaf(ds, ks[j * D + part + 4 * i], acc[i]);
    }
  }
  if (row < T) {
    float* dqb = head_ptr<float>(p.dq, p, kDQ, b, h);
#pragma unroll
    for (int i = 0; i < DP; ++i)
      dqb[row * p.st[kDQ][2] + part + 4 * i] = acc[i];
  }
}

// K2e in f32: dk and dv for one (b*h, 32-key tile), 4 threads a key
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads) bwd_dkv_f32(const Params p) {
  constexpr int DP = D / 4;
  __shared__ __align__(16) float qs[kTile32 * D];
  __shared__ __align__(16) float dos[kTile32 * D];
  __shared__ float lse_s[kTile32], dsum_s[kTile32];

  const int tid = threadIdx.x, part = tid & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int T = p.T;
  const int k0 = blockIdx.y * kTile32;
  const int key = k0 + (tid >> 2);
  const bool kval = key_valid(p, b, key);
  const bool any = __syncthreads_or(kval);
  const int first = key_first_row(p, key);  // causal: first row to see it
  const float* kb = head_ptr<const float>(p.k, p, kK, b, h);
  const float* vb = head_ptr<const float>(p.v, p, kV, b, h);

  float k[DP], v[DP], dk[DP], dv[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    k[i] = key < T ? kb[key * p.st[kK][2] + part + 4 * i] : 0.f;
    v[i] = key < T ? vb[key * p.st[kV][2] + part + 4 * i] : 0.f;
    dk[i] = dv[i] = 0.f;
  }
  if (any) {
    const float* qb = head_ptr<const float>(p.q, p, kQ, b, h);
    const float* dob = head_ptr<const float>(p.dout, p, kDO, b, h);
    const float* lse = p.lse + static_cast<long long>(bh) * T;
    const float* dsum = p.dsum + static_cast<long long>(bh) * T;
    const int n_tiles = (T + kTile32 - 1) / kTile32;
    const int qt0 = kCausal ? first_q_tile(p, k0, kTile32, n_tiles) : 0;
    for (int qt = qt0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile32;
      __syncthreads();
      stage_rows_f32<D>(qs, qb, p.st[kQ][2], q0, T, tid);
      stage_rows_f32<D>(dos, dob, p.st[kDO][2], q0, T, tid);
      if (tid < kTile32) {
        const bool in = q0 + tid < T;
        lse_s[tid] = in ? lse[q0 + tid] : 0.f;
        dsum_s[tid] = in ? dsum[q0 + tid] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kTile32; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          s = fmaf(k[i], qs[j * D + part + 4 * i], s);
          dp = fmaf(v[i], dos[j * D + part + 4 * i], dp);
        }
        s = row_sum(s);
        dp = row_sum(dp);
        const bool ok = kval && q0 + j < T &&
                        (!kCausal || q0 + j >= first);
        const float pj = ok ? expf(s * p.scale - lse_s[j]) : 0.f;
        const float ds = pj * (dp - dsum_s[j]) * p.scale;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          dv[i] = fmaf(pj, dos[j * D + part + 4 * i], dv[i]);
          dk[i] = fmaf(ds, qs[j * D + part + 4 * i], dk[i]);
        }
      }
    }
  }
  if (key < T) {
    float* dkb = head_ptr<float>(p.dk, p, kDK, b, h);
    float* dvb = head_ptr<float>(p.dv, p, kDV, b, h);
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      dkb[key * p.st[kDK][2] + part + 4 * i] = dk[i];
      dvb[key * p.st[kDV][2] + part + 4 * i] = dv[i];
    }
  }
}


// ------------------------------------------------------------------ launch

template <int D, bool kCausal>
int launch_dq(const Params& p, int B, cudaStream_t s) {
  using C = DqTile<D>;
  const long long(&st)[7][3] = p.st;
  CUtensorMap tq, tdo, tk, tv;
  int err = encode_view<D>(&tq, p.q, B, p.H, p.T, st[kQ][0], st[kQ][1],
                           st[kQ][2], C::BQ);
  if (err == 0)
    err = encode_view<D>(&tdo, p.dout, B, p.H, p.T, st[kDO][0], st[kDO][1],
                         st[kDO][2], C::BQ);
  if (err == 0)
    err = encode_view<D>(&tk, p.k, B, p.H, p.T, st[kK][0], st[kK][1],
                         st[kK][2], C::BK);
  if (err == 0)
    err = encode_view<D>(&tv, p.v, B, p.H, p.T, st[kV][0], st[kV][1],
                         st[kV][2], C::BK);
  if (err != 0) return err;
  auto kernel = bwd_dq_bf16<D, kCausal>;
  static unsigned long long opted = 0;
  int n_sm = 0;
  err = persistent_setup(reinterpret_cast<const void*>(kernel), C::SMEM,
                         opted, n_sm);
  if (err != 0) return err;
  const long long work = static_cast<long long>((p.T + C::BQ - 1) / C::BQ) *
                         p.BH;
  if (work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(work < n_sm ? work : n_sm);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(tq, tdo, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCausal>
int launch_dkv(const Params& p, int B, cudaStream_t s) {
  using C = DkvTile<D>;
  const long long(&st)[7][3] = p.st;
  CUtensorMap tq, tdo, tk, tv;
  int err = encode_view<D>(&tq, p.q, B, p.H, p.T, st[kQ][0], st[kQ][1],
                           st[kQ][2], C::BQ);
  if (err == 0)
    err = encode_view<D>(&tdo, p.dout, B, p.H, p.T, st[kDO][0], st[kDO][1],
                         st[kDO][2], C::BQ);
  if (err == 0)
    err = encode_view<D>(&tk, p.k, B, p.H, p.T, st[kK][0], st[kK][1],
                         st[kK][2], C::BKEY);
  if (err == 0)
    err = encode_view<D>(&tv, p.v, B, p.H, p.T, st[kV][0], st[kV][1],
                         st[kV][2], C::BKEY);
  if (err != 0) return err;
  auto kernel = bwd_dkv_bf16<D, kCausal>;
  static unsigned long long opted = 0;
  int n_sm = 0;
  err = persistent_setup(reinterpret_cast<const void*>(kernel), C::SMEM,
                         opted, n_sm);
  if (err != 0) return err;
  const long long work =
      static_cast<long long>((p.T + C::BKEY - 1) / C::BKEY) * p.BH;
  if (work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(work < n_sm ? work : n_sm);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(tq, tdo, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCausal>
int launch(const Params& p, int dkv, int dtype, int B, cudaStream_t s) {
  if (dtype == 0)
    return dkv ? launch_dkv<D, kCausal>(p, B, s)
               : launch_dq<D, kCausal>(p, B, s);
  // f32 (the tight check) is built for D <= 128: its CTA keeps two tiles
  // of 32 rows in static shared memory (64 KB at D = 256, over the 48 KB a
  // static allocation may take)
  if constexpr (D > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const dim3 grid(B * p.H, (p.T + kTile32 - 1) / kTile32);
    if (dkv)
      bwd_dkv_f32<D, kCausal><<<grid, kThreads, 0, s>>>(p);
    else
      bwd_dq_f32<D, kCausal><<<grid, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <bool kCausal>
int launch_dim(const Params& p, int dkv, int dtype, int D, int B,
               cudaStream_t s) {
  switch (D) {
    case 32: return launch<32, kCausal>(p, dkv, dtype, B, s);
    case 64: return launch<64, kCausal>(p, dkv, dtype, B, s);
    case 128: return launch<128, kCausal>(p, dkv, dtype, B, s);
    case 256: return launch<256, kCausal>(p, dkv, dtype, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch K2d (dkv = 0: writes dq) or K2e (dkv = 1: writes dk and dv) on
// `stream` (a cudaStream_t from PyTorch) on device `device`. dtype: 0 =
// bf16, 1 = f32 (q, k, v, dO and the gradients all of it). `strides` holds
// 21 element strides: batch, head and row of q, k, v, dO, dq, dk, dv (the
// pointers of the outputs a launch does not write may be null). lse and
// dsum are contiguous [B, H, T] f32. D must be 32, 64, 128 or (bf16 only)
// 256 with unit stride, and for bf16 the q/k/v/dO base addresses and
// strides multiples of 16 bytes (the tensor maps' rule). causal 1 masks on
// the global positions q_offset + r and k_offset + c (the forward's).
// Returns 0, a cudaError_t
// of the launch, or a negative code of the tensor-map encoding.
int mmlspark_flash_bwd_launch(int dkv, const void* q, const void* k,
                              const void* v, const void* dout,
                              const void* mask, const float* lse,
                              const float* dsum, void* dq, void* dk,
                              void* dv, int dtype, int B, int H, int T,
                              int D, const long long* strides,
                              long long mask_sb, float scale, int causal,
                              long long q_offset, long long k_offset,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || (dkv != 0 && dkv != 1) || B < 1 ||
      H < 1 || T < 1 || static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.mask = static_cast<const uint8_t*>(mask);
  p.lse = lse;
  p.dsum = dsum;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.BH = B * H;
  p.H = H;
  p.T = T;
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.mask_sb = mask_sb;
  p.qk_shift = q_offset - k_offset;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? launch_dim<true>(p, dkv, dtype, D, B, s)
                : launch_dim<false>(p, dkv, dtype, D, B, s);
}

const char* mmlspark_flash_bwd_error_string(int err) {
  return launch_error_string(err);
}

// The bf16 backward's design, one line: CTA shape, item and streamed
// tiles, stages and dynamic shared memory per head dim.
const char* mmlspark_flash_bwd_design() {
  static char buf[512];
  snprintf(buf, sizeof(buf),
           "bf16 backward: persistent, one CTA per SM, %d threads = 2 "
           "consumer warpgroups (setmaxnreg 240) + 1 producer warpgroup "
           "(24; one warp issues TMA); K2d items of %d q "
           "rows, key tiles %d/%d/%d/%d, %d/%d/%d/%d stages, smem "
           "%d/%d/%d/%d B; K2e items of %d/%d/%d/%d keys, q tiles "
           "%d/%d/%d/%d, %d/%d/%d/%d stages, smem %d/%d/%d/%d B (D = "
           "32/64/128/256)",
           DqTile<32>::THREADS, DqTile<32>::BQ, DqTile<32>::BK, DqTile<64>::BK,
           DqTile<128>::BK, DqTile<256>::BK, DqTile<32>::STAGES,
           DqTile<64>::STAGES, DqTile<128>::STAGES, DqTile<256>::STAGES,
           DqTile<32>::SMEM, DqTile<64>::SMEM, DqTile<128>::SMEM,
           DqTile<256>::SMEM, DkvTile<32>::BKEY, DkvTile<64>::BKEY,
           DkvTile<128>::BKEY, DkvTile<256>::BKEY, DkvTile<32>::BQ,
           DkvTile<64>::BQ, DkvTile<128>::BQ, DkvTile<256>::BQ,
           DkvTile<32>::STAGES, DkvTile<64>::STAGES, DkvTile<128>::STAGES,
           DkvTile<256>::STAGES, DkvTile<32>::SMEM, DkvTile<64>::SMEM,
           DkvTile<128>::SMEM, DkvTile<256>::SMEM);
  return buf;
}

}  // extern "C"
