// The bf16 attention forward's kernel body for Hopper (sm_90a), shared by
// flash_attn.cu (K2a, K2b, K2c, K2c-lse: K and V as dense [B, H, T, D]
// views) and paged_attn.cu (K3's window kernel: K and V through a block
// table of pool blocks). One consumer loop and one producer loop; a key
// source `Src` supplies what differs:
//  - the work items of the persistent walk (`Src::n_work`, `Src::walk`: the
//    k-th item of this CTA, `Src::item`): which (batch or slot, head,
//    128-row q tile), which key tiles, the causal shift (key c is allowed
//    for row r iff c <= r + shift) and the number of query rows, with a
//    set-up every thread runs first (`Src::prepare`, a table of
//    `Src::kExtraSmem` bytes);
//  - each key tile's validity words (`Src::tile_words`: a ballot per 32
//    keys) and its copies into a stage of the ring (`Src::copy_tile`,
//    which completes the stage's full barrier itself: by TMA bytes, or by
//    an arrival after copies through registers);
//  - the epilogue (`Src::epilogue`): o, the lse, or a chunk's partials;
//  - at D = 256 (a producer warpgroup), the setmaxnreg split
//    (`Src::kProducerRegs`, `Src::kConsumerRegs`).
// The design of the loop (two consumer warpgroups and a TMA producer,
// persistent CTAs, the ring and the Q buffers, wgmma, the online softmax
// in exp2) is set out in flash_attn.cu's note.

#pragma once

#include "flash_common.cuh"

namespace {

constexpr int kBQ = 128;  // query rows per work item: 64 per warpgroup
// two consumer warpgroups, and one producer warp (a producer warpgroup
// with setmaxnreg at D = 256, see Tile): one CTA per SM
constexpr int kConsumerThreads = 2 * kWgThreads;

// keys per tile by default: 64 at D = 128 keeps the score and output
// accumulators (BK/2 + D/2 registers a thread) small; 128-key tiles
// spilled at D = 128 in the one 3-warpgroup attempt (flash_attn.cu's note);
// 32 at D = 256, where the output accumulator alone is 128 registers
constexpr int default_bk(int D) { return D == 256 ? 32 : D == 128 ? 64 : 128; }
// stages in flight by default: 4; 3 at D = 256, where two Q buffers take
// 128 KB
constexpr int default_stages(int D) { return D == 256 ? 3 : 4; }

// shared-memory layout of one head dim, key tile and ring depth: two Q
// buffers, then STAGES of (K, V), then each stage's four validity words,
// then the barriers. `Tile<D>` is the default tile of D, which every
// library but the tuned forward's (flash_tuned.cu) runs.
template <int D, int BK_ = default_bk(D), int STAGES_ = default_stages(D)>
struct Tile : Swz<D> {
  static constexpr int BK = BK_;
  // wgmma's n of S = Q K^T, and at most the stage's four validity words
  static_assert(BK == 32 || BK == 64 || BK == 128,
                "key tiles of 32, 64 or 128 keys");
  static constexpr int NW = BK / 32;          // validity words per tile
  static constexpr int STAGES = STAGES_;
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int META = STAGES * 16;
  static constexpr int BARS = (2 * STAGES + 4) * 8;  // + Q full/empty x 2
  // + 1024: the dynamic base is rounded up to the swizzle atom; Q is
  // double-buffered, so the next work item's Q loads during this one
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES + META + BARS;
  // D = 256: a producer warpgroup and setmaxnreg (the 168 registers of a
  // 288-thread CTA spilled there); the other head dims fit without
  static constexpr bool WIDE = D == 256;
  static constexpr int THREADS = kConsumerThreads + (WIDE ? kWgThreads : 32);
  static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
};

// one work item of the persistent walk
struct Item {
  int b, h, qt;     // batch (the paged source: slot), head, q tile
  int kt0, kt1;     // the key tiles it reads: [kt0, kt1)
  int Tq;           // query rows: rows at or past Tq are neither read nor
                    // written
  int lim_max;      // causal row limits are clamped into [-1, lim_max]
  long long shift;  // causal: key c is allowed for row r iff c <= r + shift
  int part;         // the source's own index (the paged source's chunk)
};

// the last key `row` may attend (causal), clamped into [-1, lim_max] so
// the per-pair compare runs on 32-bit ints
__device__ __forceinline__ int row_limit(const Item& it, int row) {
  const long long lim = static_cast<long long>(row) + it.shift;
  return lim < -1 ? -1 : lim > it.lim_max ? it.lim_max
                                          : static_cast<int>(lim);
}

// O += P V over one key tile of BK keys in steps of 16 keys, V read
// MN-major from the stage at `vs`; started and committed as one group
template <int D, int BK>
__device__ __forceinline__ void pv_products(float (&acc)[D / 2],
                                            const uint32_t (&pa)[BK / 16][4],
                                            uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D, D>(acc, pa[kk], vs, BK, kk, 0);
  wg_commit();
}

// setmaxnreg to N registers a thread: a producer warpgroup gives back what
// its source's copies do not need, and the consumer warpgroups take it
// (2 x 128 x consumer + 128 x producer <= 65,536)
template <int N>
__device__ __forceinline__ void producer_regs_to() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void consumer_regs_to() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

// The kernel body: `tq` maps q as [B, H, T, D] in boxes of kBQ rows, `tk`
// and `tv` whatever the source's copy_tile reads, in tiles of the source's
// `Src::C` (a Tile of D).
template <int D, class Src>
__device__ __forceinline__ void fwd_bf16_body(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const typename Src::Params& p) {
  using C = typename Src::C;
  constexpr int BK = C::BK;
  constexpr bool kCausal = Src::kCausal;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;                   // Q buffer i at + i * Q_BYTES
  const uint32_t kv_s = base + 2 * C::Q_BYTES;  // stage s: K, then V
  const uint32_t meta_off = 2 * C::Q_BYTES + C::STAGES * C::STAGE_BYTES;
  uint32_t* const meta =
      reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + meta_off);
  const uint32_t bars = base + meta_off + C::META;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::STAGES + s); };
  auto qfull = [&](int i) { return bars + 8u * (2 * C::STAGES + i); };
  auto qempty = [&](int i) { return bars + 8u * (2 * C::STAGES + 2 + i); };

  const int tid = threadIdx.x;
  const int n_work = Src::n_work(p);
  // the source's set-up, by every thread: its table (Src::kExtraSmem bytes
  // after the barriers), with the Q buffers as scratch until it returns
  uint8_t* const table = smem_raw + (base - raw) + meta_off + C::META + C::BARS;
  Src::prepare(p, table, smem_raw + (base - raw));

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's one arrival (+ the bytes)
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull(i), 1);
      mbar_init(qempty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---------------------------------------------------------- producer
    if constexpr (C::WIDE) {
      static_assert(2 * kWgThreads * Src::kConsumerRegs +
                        kWgThreads * Src::kProducerRegs <= 65536,
                    "setmaxnreg beyond the register file");
      producer_regs_to<Src::kProducerRegs>();
      if (tid >= kConsumerThreads + 32) return;  // one warp starts the copies
    }
    const int lane = tid - kConsumerThreads;
    int stage = 0;
    uint32_t phase = 0;
    int it = 0;
    for (int k = 0, w; (w = Src::walk(k)) < n_work; ++k) {
      Item item;
      if (!Src::item(p, table, w, item)) continue;  // the consumers skip it too
      // Q into buffer it % 2 once the consumers are done with the Q two
      // items back: the next item's Q loads while this one is consumed
      if (lane == 0) {
        const int qb = it & 1;
        mbar_wait(qempty(qb), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(qfull(qb), C::Q_BYTES);
        tma_rows<D>(q_s + qb * C::Q_BYTES, &tq, qfull(qb), kBQ,
                    item.qt * kBQ, item.h, item.b);
      }
      for (int kt = item.kt0; kt < item.kt1; ++kt) {
        const int k0 = kt * BK;
        uint32_t wv[C::NW], any = 0;
        Src::tile_words(p, item, k0, lane, wv);
#pragma unroll
        for (int i = 0; i < C::NW; ++i) any |= wv[i];
        if (lane == 0) {
          mbar_wait(empty(stage), phase ^ 1);
          uint32_t* m = meta + 4 * stage;
#pragma unroll
          for (int i = 0; i < C::NW; ++i) m[i] = wv[i];
        }
        __syncwarp();
        if (any)
          Src::copy_tile(p, item, k0, lane, kv_s + stage * C::STAGE_BYTES,
                         full(stage), &tk, &tv);
        else if (lane == 0)
          mbar_arrive(full(stage));  // no valid key: no copy, same list
        if (++stage == C::STAGES) stage = 0, phase ^= 1;
      }
      ++it;
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  if constexpr (C::WIDE) consumer_regs_to<Src::kConsumerRegs>();
  const int cw = tid / kWgThreads;  // this warpgroup: rows 64 * cw + ...
  const int t = tid % kWgThreads;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row / column pair
  const float scale2 = p.scale * kLog2e;
  int stage = 0;
  uint32_t phase = 0;
  int it = 0;
  for (int k = 0, w; (w = Src::walk(k)) < n_work; ++k) {
    Item item;
    if (!Src::item(p, table, w, item)) continue;
    const int wg_row0 = item.qt * kBQ + 64 * cw;
    const int r_lo = wg_row0 + warp * 16 + g, r_hi = r_lo + 8;
    // causal: the last key the first and the last row of the warpgroup reach
    const long long reach_first = wg_row0 + item.shift;
    const long long reach_last = wg_row0 + 63 + item.shift;
    // causal: key column 8j + e of this thread's pairs is allowed iff
    // 8j + e <= row limit - k0 - 2 * t4
    const int lim_lo = row_limit(item, r_lo) - 2 * t4;
    const int lim_hi = row_limit(item, r_hi) - 2 * t4;
    const int qb = it & 1;
    const uint32_t qa = q_s + qb * C::Q_BYTES + 64 * cw * C::ROWB;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_lo = kNeg, m_hi = kNeg;  // running max of the raw scores
    float l_lo = 0.f, l_hi = 0.f;    // this thread's share of the running sum

    mbar_wait(qfull(qb), (it >> 1) & 1);
    for (int kt = item.kt0; kt < item.kt1; ++kt) {
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
      // a warpgroup with no row before Tq, or (causal) none that reaches
      // the tile, only releases it
      const bool reach = wg_row0 < item.Tq && (!kCausal || k0 <= reach_last);
      if (any != 0 && reach) {
        const uint32_t ks = kv_s + stage * C::STAGE_BYTES;
        const uint32_t vs = ks + C::KV_BYTES;
        float s[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
        keep(s);
        keep(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(s, kmajor<D>(qa, kBQ, kk), kmajor<D>(ks, BK, kk),
                       kk > 0);
        wg_commit();
        wg_wait0();
        keep(s);
        const bool diag = kCausal && k0 + BK - 1 > reach_first;
        const bool full = !diag && all == 0xffffffffu;
        if (!full) {
          const int d_lo = lim_lo - k0, d_hi = lim_hi - k0;
#pragma unroll
          for (int i = 0; i < C::NW; ++i) w[i] >>= 2 * t4;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool valid = (w[j / 4] >> (8 * (j % 4) + e)) & 1u;
              const bool ok_lo = valid && (!diag || 8 * j + e <= d_lo);
              const bool ok_hi = valid && (!diag || 8 * j + e <= d_hi);
              s[4 * j + e] = ok_lo ? s[4 * j + e] : kNeg;
              s[4 * j + 2 + e] = ok_hi ? s[4 * j + 2 + e] : kNeg;
            }
          }
        }
        float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
          mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
          mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
        }
        const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
        const float ms_lo = mn_lo * scale2, ms_hi = mn_hi * scale2;
        const float corr_lo = ex2((m_lo - mn_lo) * scale2);
        const float corr_hi = ex2((m_hi - mn_hi) * scale2);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& a = s[4 * j + e];
            float& c = s[4 * j + 2 + e];
            const float pa_ = ex2(fmaf(a, scale2, -ms_lo));
            const float pc_ = ex2(fmaf(c, scale2, -ms_hi));
            a = full || a > kNeg ? pa_ : 0.f;
            c = full || c > kNeg ? pc_ : 0.f;
            ps_lo += a;
            ps_hi += c;
          }
        }
        l_lo = l_lo * corr_lo + ps_lo;
        l_hi = l_hi * corr_hi + ps_hi;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= corr_lo;
          acc[4 * j + 1] *= corr_lo;
          acc[4 * j + 2] *= corr_hi;
          acc[4 * j + 3] *= corr_hi;
        }
        uint32_t pa[BK / 16][4];
        to_a_frags<BK>(pa, s);
        keep(acc);
        keep(pa);
        wg_fence();
        pv_products<D, BK>(acc, pa, vs);
        wg_wait0();
        keep(acc);
        keep(pa);
      }
      release(empty(stage), lane);
      if (++stage == C::STAGES) stage = 0, phase ^= 1;
    }
    release(qempty(qb), lane);  // the products that read this Q are done

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    Src::epilogue(p, item, acc, m_lo, m_hi, l_lo, l_hi, r_lo, r_hi, t4);
    ++it;
  }  // work items
}

// o = acc / max(l, 1e-35) in bf16 at rows r_lo and r_hi (those below Tq) of
// the [rows, D] view at `ob` with row stride `st`: the fragment layout of
// an m64nD accumulator (columns 8j + 2 t4 and + 1 of each row)
template <int D>
__device__ __forceinline__ void store_o(__nv_bfloat16* ob, long long st,
                                        const float (&acc)[D / 2], float l_lo,
                                        float l_hi, int r_lo, int r_hi,
                                        int t4, int Tq) {
  const float den_lo = fmaxf(l_lo, 1e-35f), den_hi = fmaxf(l_hi, 1e-35f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + t4 * 2;
    if (r_lo < Tq)
      *reinterpret_cast<uint32_t*>(ob + r_lo * st + c) =
          pack_bf16(acc[4 * j] / den_lo, acc[4 * j + 1] / den_lo);
    if (r_hi < Tq)
      *reinterpret_cast<uint32_t*>(ob + r_hi * st + c) =
          pack_bf16(acc[4 * j + 2] / den_hi, acc[4 * j + 3] / den_hi);
  }
}

}  // namespace
