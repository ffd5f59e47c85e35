// K3's window kernel: paged window attention over the block table,
// hand-written for Hopper (sm_90a), for windows wider than the decode
// kernel's (paged_decode.cu, w <= 16): the engine's prefill batches.
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (mmlspark_tpu/dl/pallas_paged_attention.py:89, launched by `_paged_pallas`
// at :199). For each slot s, head h and window row i (w rows per slot: the
// bucketed suffix of a prefill window; any w >= 1 is taken) it computes
// softmax attention of q [S, H, w, hd] over the slot's chain of pool blocks:
//   chain position t lives in block rows[s, t / BL] at offset t % BL of the
//   pools k, v [NB, BL, H, hd]; a chain entry equal to the trash block (0) is
//   skipped whole, whatever pos says (so is an id outside [0, NB), which the
//   host table never holds); key t is allowed for row i iff t <= pos[s] + i;
//   s = (q . k) * hd^-0.5 in f32, -1e30 outside, p = exp(s - m) zeroed again
//   by a select, the running max and sum in f32, acc += p.astype(v) @ v in
//   f32, o = acc / max(l, 1e-35) in v's dtype, so a slot whose row is all
//   trash (an inactive slot, a padded prefill row) writes exactly 0.
//
// What bounds it on an H100: at the prefill shapes, bytes. A window of w
// rows over a chain of c positions reads 4 * c * hd bytes of K and V per
// head for 4 * hd * (w * c - w^2 / 2) flops, about w flops a byte: below
// the ~295 at which the tensor cores bind in bf16 until w passes ~300
// rows, so at the phase-9
// window (w = 128 over chains of up to 4096 positions) the bytes bind, and
// the long prompt (w = 4096 over a 4096-position chain, 4096^2 / 2 allowed
// pairs a head) is bound by operations.
//
// The first design (right and simple first) ran one CTA of 4 warps
// per (slot * head, 64-row tile) on mma.sync, staging each 64-key tile
// through registers (K row by row, V transposed by hand) with nothing in
// flight during the products; every q tile read the slot's K and V again.
// It took 0.4971 ms at the phase-9 window, 2.6x SDPA on a dense cache
// gathered beforehand. Design now, bf16 (f32, below, keeps the simple
// design as the tight check of the same algorithm):
//  - The window kernel is the flash forward of flash_attn.cu with a paged
//    key source: one kernel body (flash_fwd.cuh) runs both. Persistent
//    CTAs (one per SM) of two consumer warpgroups (64 rows each, wgmma for
//    S = Q K^T and O += P V, the online softmax in registers with exp2)
//    and a producer warp feeding a ring of 4 stages of (K, V) tiles (128
//    keys; 64 at hd 128, 32 in 3 stages at hd 256) on mbarriers; a work
//    item is (slot, head, 128-row q tile[, chain chunk]), so a window of
//    up to 128 rows reads each K/V tile of its (slot, head) once. Causal on
//    global positions: the item's shift is pos[s], a row's last key
//    pos[s] + i, and the walk stops at the tile holding the q tile's last
//    row's position, as K2c's does.
//  - A balanced walk: the items' lengths are data (the slots' positions),
//    so every CTA first ranks the (slot, q tile) rows by the key tiles
//    they reach, longest first, and the CTAs take items in a snake (i, 2
//    grid - 1 - i, ...); at the phase-9 window (32 slots of 128 to 4096
//    positions) that cut the kernel's time by about 40 %
//    (tools/probe_kernel_variants.py, PERF.md §6).
//  - K and V by TMA through the table: each pool is a rank-4 tensor map over
//    [NB, BL, H, hd] (dims hd, BL, H, NB), and a box of R rows x 1 head x
//    64 columns (R = gcd(BL, tile keys), 1 to 128) is R positions of one
//    pool block: one box per block and column box of a tile, sent by the
//    producer's lanes in parallel, landing with the 128-byte swizzle the
//    wgmma descriptors read (64-byte at hd 32; the swizzle follows the
//    shared-memory address, so boxes of fewer rows than an atom land
//    right). A trash entry, an id outside
//    [1, NB) or a position past the table reads block NB, out of the map's
//    bounds: TMA fills zeros without touching memory, so those keys cost no
//    bytes, their V rows are zeros (a masked p of 0 never meets stale
//    shared memory), and the producer's validity words mask them. At hd
//    32 an odd block length (a one-row box of 64 bytes, where a copy must
//    start on 128) is copied by the producer's lanes through registers
//    into the same swizzled layout (a proxy fence, then the stage's
//    arrival).
//  - Too few items to fill the card (slots x heads x q tiles short of the
//    SM count, as a warm suffix over a long cached prefix gives): the chain
//    is cut into chunks of L positions (a multiple of 128, at least 512),
//    planned from the shape alone (`paged_attention.window_plan`); each
//    (item, chunk) writes its f32 (m, l, acc) partials to scratch the
//    wrapper allocates, and the decode kernel's combine (paged_decode.cu,
//    `paged_combine`) merges the live chunks in chunk order. A chunk past
//    a slot's reachable end is skipped by both sides. No atomics: two
//    launches give the same bits.
//  - q is read through its strides by a tensor map (a view of the fused qkv
//    projection; rows past w read as zeros) and o is written through its own
//    (the wrapper hands back a [S, H, w, hd] view of a [S, w, H, hd] buffer,
//    so the head merge needs no copy).
//  - Head dims 32, 64, 128 and 256 (bf16; f32 up to 128; wider pools run on
//    attn_wide.cu). Every mbarrier wait traps after 2^24 polls rather than
//    hang the card.

#include "flash_fwd.cuh"

namespace {

constexpr int kThreads = 128;   // the f32 path's CTA
constexpr int kTrash = 0;       // paged_kv.TRASH_BLOCK

struct Params {
  const void* q;       // [S, H, w, hd], strides q_ss, q_sh, q_sw; unit on hd
  const void* k_pool;  // [NB, BL, H, hd] contiguous
  const void* v_pool;
  const int* rows;     // [S, MB] int32 contiguous
  const int* pos;      // [S] int32
  void* o;             // [S, H, w, hd], strides o_ss, o_sh, o_sw
  int H, w, NB, BL, MB;
  long long q_ss, q_sh, q_sw;
  long long o_ss, o_sh, o_sw;
  float scale;
};

// The pool row of chain position t of slot s and head h ([NB * BL * H]
// rows of hd elements), or -1 when t lies in a trash block or is past
// `t_end`. Chain positions fit in 32 bits (MB * BL is checked on launch);
// pool rows may not.
__device__ __forceinline__ long long pool_row(const Params& p, int s, int h,
                                              int t, int t_end) {
  if (t >= t_end) return -1;
  const int blk = p.rows[static_cast<long long>(s) * p.MB + t / p.BL];
  if (blk == kTrash || blk < 0 || blk >= p.NB) return -1;
  return (static_cast<long long>(blk) * p.BL + t % p.BL) * p.H + h;
}

// The chain positions a CTA whose last window row is `last_row` reads:
// [0, min(pos + last_row + 1, MB * BL)).
__device__ __forceinline__ int chain_end(const Params& p, int pos,
                                         int last_row) {
  const long long reach = static_cast<long long>(pos) + last_row + 1;
  const int cap = p.MB * p.BL;
  return reach < cap ? static_cast<int>(reach) : cap;
}

// ---------------------------------------------------------------- bf16 path

struct WindowParams {
  const void* k_pool;  // [NB, BL, H, D] contiguous (the register copies)
  const void* v_pool;
  const int* rows;     // [S, MB] int32 contiguous
  const int* pos;      // [S] int32
  void* o;             // [S, H, w, D], strides o_ss, o_sh, o_sw
  float* part_acc;     // [S, n_chunks, H, w, D] f32 (n_chunks > 1)
  float* part_ml;      // [S, n_chunks, H, w, 2] f32: (m, l)
  int S, H, w, NB, BL, MB;
  int R;               // rows of a K/V box (0: copies through registers)
  int L, n_chunks;     // chain positions per chunk (a multiple of 128)
  long long o_ss, o_sh, o_sw;
  float scale;
};

__device__ __forceinline__ bool live_block(const WindowParams& p, int blk) {
  return blk != kTrash && blk > 0 && blk < p.NB;
}

// the 16-byte store of x at a shared-memory address
__device__ __forceinline__ void st_shared16(uint32_t addr, const uint4& x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// The paged key source of flash_fwd.cuh's kernel body: the slot's chain of
// pool blocks through the table, keys valid where their block is live.
template <int D>
struct Paged {
  using Params = WindowParams;
  using C = Tile<D>;
  static constexpr bool kLse = false, kCausal = true;
  // D = 256: the producer's table reads and copies spilled in the 24
  // registers the dense source leaves it (and in 40)
  static constexpr int kProducerRegs = 56, kConsumerRegs = 224;
  // the walk's order of (slot, q tile) rows, longest first: up to
  // kMaxRows of them (more keep the plain order)
  static constexpr int kMaxRows = 256;
  static constexpr int kExtraSmem = kMaxRows * 2;

  __device__ static int n_work(const Params& p) {
    return (p.w + kBQ - 1) / kBQ * p.S * p.H * p.n_chunks;
  }

  // the key tiles row (slot s, q tile qt) reaches: up to its last row's
  // position, within the table
  __device__ static int reach_tiles(const Params& p, int s, int qt) {
    const long long cap = static_cast<long long>(p.MB) * p.BL;
    const long long reach =
        min(static_cast<long long>(p.pos[s]) + min(qt * kBQ + kBQ, p.w), cap);
    return reach <= 0 ? 0 : static_cast<int>((reach + C::BK - 1) / C::BK);
  }

  // The order of the rows in the walk: by the tiles they reach, most first
  // (ties by index), so that with `walk`'s snake every CTA gets about the
  // same number of tiles whatever the slots' lengths. Each CTA ranks the
  // same keys the same way, so all agree on the order.
  __device__ static void prepare(const Params& p, uint8_t* table,
                                 uint8_t* scratch) {
    const int n_qt = (p.w + kBQ - 1) / kBQ;
    const int n_rows = p.S * n_qt;
    if (n_rows > kMaxRows) return;
    int* key = reinterpret_cast<int*>(scratch);
    uint16_t* order = reinterpret_cast<uint16_t*>(table);
    for (int r = threadIdx.x; r < n_rows; r += blockDim.x)
      key[r] = reach_tiles(p, r / n_qt, r % n_qt);
    __syncthreads();
    for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
      const int kr = key[r];
      int rank = 0;
      for (int j = 0; j < n_rows; ++j)
        rank += key[j] > kr || (key[j] == kr && j < r);
      order[rank] = static_cast<uint16_t>(r);
    }
    __syncthreads();  // the order is read, and the scratch reused, later
  }

  // a snake over the CTAs: CTA i takes items i, 2 grid - 1 - i, 2 grid +
  // i, ..., so a CTA with a long item early gets a short one next
  __device__ static int walk(int k) {
    return k * gridDim.x +
           ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  }

  // work item w -> (row, head, chunk), a row's heads and chunks as
  // neighbours; the rows in `prepare`'s order (where there are more than
  // kMaxRows: every slot's last q tile first). False for a chunk past the
  // slot's reachable end: no partial of it is read.
  __device__ static bool item(const Params& p, const uint8_t* table, int w,
                              Item& it) {
    const int n_qt = (p.w + kBQ - 1) / kBQ;
    const int n_rows = p.S * n_qt;
    it.part = w % p.n_chunks;
    w /= p.n_chunks;
    it.h = w % p.H;
    const int j = w / p.H;
    if (n_rows <= kMaxRows) {
      const int r = reinterpret_cast<const uint16_t*>(table)[j];
      it.b = r / n_qt;
      it.qt = r % n_qt;
    } else {
      it.b = j % p.S;
      it.qt = n_qt - 1 - j / p.S;
    }
    const int pos = p.pos[it.b];
    const long long cap = static_cast<long long>(p.MB) * p.BL;
    const long long end = min(static_cast<long long>(pos) + p.w, cap);
    const int c0 = it.part * p.L;
    if (p.n_chunks > 1 && c0 >= end) return false;
    const int n_reach = reach_tiles(p, it.b, it.qt);
    it.kt0 = c0 / C::BK;
    it.kt1 = max(it.kt0, min(it.kt0 + p.L / C::BK, n_reach));
    it.Tq = p.w;
    it.lim_max = static_cast<int>(cap);
    it.shift = pos;
    return true;
  }

  __device__ static void tile_words(const Params& p, const Item& it, int k0,
                                    int lane, uint32_t (&wv)[C::NW]) {
    const int* row_s = p.rows + static_cast<long long>(it.b) * p.MB;
    const int cap = p.MB * p.BL;
#pragma unroll
    for (int i = 0; i < C::NW; ++i) {
      const int t = k0 + 32 * i + lane;
      wv[i] = __ballot_sync(0xffffffffu,
                            t < cap && live_block(p, row_s[t / p.BL]));
    }
  }

  __device__ static void copy_tile(const Params& p, const Item& it, int k0,
                                   int lane, uint32_t ks, uint32_t bar,
                                   const CUtensorMap* tk,
                                   const CUtensorMap* tv) {
    const int* row_s = p.rows + static_cast<long long>(it.b) * p.MB;
    if (p.R > 0) {
      // one box of R positions per block of the tile (R divides BL and
      // BK), K and V, each column box, the lanes taking boxes in turn; a
      // dead block reads block NB, out of the map: zeros, no bytes from
      // memory
      if (lane == 0) mbar_expect_tx(bar, C::STAGE_BYTES);
      __syncwarp();
      for (int j = lane; j < C::BK / p.R; j += 32) {
        const int t = k0 + j * p.R;
        const int bi = t / p.BL;
        const int blk = bi < p.MB ? row_s[bi] : kTrash;
        const int nb = live_block(p, blk) ? blk : p.NB;
        const uint32_t dst = ks + j * p.R * C::ROWB;
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          const uint32_t d = dst + c * C::BK * C::ROWB;
          tma_load(d, tk, bar, c * C::CW, t % p.BL, it.h, nb);
          tma_load(d + C::KV_BYTES, tv, bar, c * C::CW, t % p.BL, it.h, nb);
        }
      }
      return;
    }
    // an odd block length at 64-byte rows: 16-byte vectors through
    // registers into the swizzled layout TMA would write (zeros for dead
    // positions), a proxy fence so the wgmma reads see them, one arrival
    constexpr int VEC = D / 8;
    constexpr int N = C::BK * VEC / 32;  // vectors of K (and of V) a lane
    // loads in flight a lane before its stores (fewer at D = 256, whose
    // producer holds kProducerRegs registers)
    constexpr int G = D == 256 ? 2 : 4;
    static_assert(N % G == 0, "a lane's vectors in whole groups");
    const int cap = p.MB * p.BL;
    const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k_pool);
    const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v_pool);
    for (int i0 = 0; i0 < N; i0 += G) {
      uint4 kx[G], vx[G];
      uint32_t a[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int i = lane + 32 * (i0 + j);
        const int r = i / VEC, col = (i % VEC) * 8;
        const int t = k0 + r;
        const int blk = t < cap ? row_s[t / p.BL] : kTrash;
        kx[j] = vx[j] = make_uint4(0u, 0u, 0u, 0u);
        if (live_block(p, blk)) {
          const long long off =
              ((static_cast<long long>(blk) * p.BL + t % p.BL) * p.H + it.h) *
                  D + col;
          kx[j] = *reinterpret_cast<const uint4*>(kp + off);
          vx[j] = *reinterpret_cast<const uint4*>(vp + off);
        }
        a[j] = ks + (col / C::CW) * C::BK * C::ROWB + r * C::ROWB +
               (col % C::CW) * 2;
        // the 128-byte swizzle XORs address bits 4-6 with bits 7-9, the
        // 64-byte one bits 4-5 with bits 7-8 (the stage is 1024-aligned)
        a[j] ^= ((a[j] >> 7) & (C::SWZ == 1 ? 7u : 3u)) << 4;
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        st_shared16(a[j], kx[j]);
        st_shared16(a[j] + C::KV_BYTES, vx[j]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  }

  __device__ static void epilogue(const Params& p, const Item& it,
                                  const float (&acc)[D / 2], float m_lo,
                                  float m_hi, float l_lo, float l_hi,
                                  int r_lo, int r_hi, int t4) {
    if (p.n_chunks == 1) {
      store_o<D>(static_cast<__nv_bfloat16*>(p.o) + it.b * p.o_ss +
                     it.h * p.o_sh,
                 p.o_sw, acc, l_lo, l_hi, r_lo, r_hi, t4, p.w);
      return;
    }
    // (s, chunk, h, row) is partial row ((s * n_chunks + chunk) * H + h)
    // * w + row, as paged_decode.cu's combine reads them
    const long long row0 =
        (static_cast<long long>(it.b * p.n_chunks + it.part) * p.H + it.h) *
        p.w;
    const bool lo = r_lo < p.w, hi = r_hi < p.w;
    float* a_lo = p.part_acc + (row0 + r_lo) * D;
    float* a_hi = p.part_acc + (row0 + r_hi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + t4 * 2;
      if (lo)
        *reinterpret_cast<float2*>(a_lo + c) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (hi)
        *reinterpret_cast<float2*>(a_hi + c) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (t4 == 0) {
      if (lo) {
        p.part_ml[2 * (row0 + r_lo)] = m_lo;
        p.part_ml[2 * (row0 + r_lo) + 1] = l_lo;
      }
      if (hi) {
        p.part_ml[2 * (row0 + r_hi)] = m_hi;
        p.part_ml[2 * (row0 + r_hi) + 1] = l_hi;
      }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
    paged_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const WindowParams p) {
  fwd_bf16_body<D, Paged<D>>(tq, tk, tv, p);
}

// ----------------------------------------------------------------- f32 path

constexpr int kBQ32 = kThreads / 4;  // 4 threads per window row
constexpr int kBK32 = 32;

template <int D>
__global__ void __launch_bounds__(kThreads) paged_f32(const Params p) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  constexpr int DP = D / 4;
  __shared__ __align__(16) float ks[kBK32 * D];
  __shared__ __align__(16) float vs[kBK32 * D];
  __shared__ long long krow[kBK32];
  __shared__ uint8_t live[kBK32];

  const int tid = threadIdx.x;
  const int part = tid & 3;
  const int s = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int w = p.w;
  const int row0 = blockIdx.y * kBQ32;
  const int row = row0 + (tid >> 2);
  const int t_end = chain_end(p, p.pos[s], min(w - 1, row0 + kBQ32 - 1));
  const int lim = min(p.pos[s] + min(row, w), t_end);

  const float* qb = static_cast<const float*>(p.q) + s * p.q_ss + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k_pool);
  const float* vp = static_cast<const float*>(p.v_pool);
  float* ob = static_cast<float*>(p.o) + s * p.o_ss + h * p.o_sh;

  float q[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    q[i] = row < w ? qb[row * p.q_sw + part + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  const int n_tiles = (t_end + kBK32 - 1) / kBK32;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = kt * kBK32;
    __syncthreads();
    long long r = -1;
    if (tid < kBK32) {
      r = pool_row(p, s, h, t0 + tid, t_end);
      krow[tid] = r;
      live[tid] = r >= 0;
    }
    if (!__syncthreads_or(r >= 0)) continue;
    for (int i = tid; i < kBK32 * D / 4; i += kThreads) {
      const int rr = i / (D / 4), c = (i % (D / 4)) * 4;
      const long long pr = krow[rr];
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (pr >= 0) {
        kx = *reinterpret_cast<const float4*>(kp + pr * D + c);
        vx = *reinterpret_cast<const float4*>(vp + pr * D + c);
      }
      *reinterpret_cast<float4*>(&ks[rr * D + c]) = kx;
      *reinterpret_cast<float4*>(&vs[rr * D + c]) = vx;
    }
    __syncthreads();

    const int d = lim - t0;  // key j is allowed iff j <= d
    auto ok = [&](int j) { return live[j] && j <= d; };
    float sc[kBK32];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i)
        dot = fmaf(q[i], ks[j * D + part + 4 * i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      sc[j] = ok(j) ? dot * p.scale : kNeg;
      mx = fmaxf(mx, sc[j]);
    }
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      sc[j] = ok(j) ? expf(sc[j] - mn) : 0.f;
      ps += sc[j];
    }
    l = l * corr + ps;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kBK32; ++j)
        a = fmaf(sc[j], vs[j * D + part + 4 * i], a);
      acc[i] = a;
    }
  }

  if (row < w) {
    const float den = fmaxf(l, 1e-35f);
#pragma unroll
    for (int i = 0; i < DP; ++i)
      ob[row * p.o_sw + part + 4 * i] = acc[i] / den;
  }
}

// ------------------------------------------------------------------ launch

template <int D>
int launch_bf16(WindowParams p, const void* q, long long q_ss,
                long long q_sh, long long q_sw, cudaStream_t s) {
  using C = Tile<D>;
  // boxes of R = gcd(BL, BK) positions, down to one: TMA swizzles by the
  // shared-memory address, so a box of fewer rows than a swizzle atom
  // lands as the atom's rows would; but a copy must start on 128 bytes,
  // so at 64-byte rows (hd 32) an odd block length copies through
  // registers instead
  int R = C::BK;
  while (p.BL % R != 0) R >>= 1;
  p.R = R * C::ROWB % 128 == 0 ? R : 0;
  CUtensorMap tq, tk, tv;
  int err = encode_view<D>(&tq, q, p.S, p.H, p.w, q_ss, q_sh, q_sw, kBQ);
  if (err == 0 && p.R > 0) {
    const long long st = static_cast<long long>(p.H) * D;
    err = encode_view<D>(&tk, p.k_pool, p.NB, p.H, p.BL, p.BL * st, D, st,
                         p.R);
    if (err == 0)
      err = encode_view<D>(&tv, p.v_pool, p.NB, p.H, p.BL, p.BL * st, D, st,
                           p.R);
  } else {
    tk = tv = tq;  // not read: the register copies take the pools
  }
  if (err != 0) return err;
  auto kernel = paged_fwd_bf16<D>;
  // the shared-memory opt-in, once per instance and device; a persistent
  // grid: one CTA per SM walks the work items
  static unsigned long long opted = 0;
  int n_sm = 0;
  constexpr int smem = C::SMEM + Paged<D>::kExtraSmem;
  static_assert(smem <= 232448, "more shared memory than a CTA may have");
  err = persistent_setup(reinterpret_cast<const void*>(kernel), smem, opted,
                         n_sm);
  if (err != 0) return err;
  const long long work = static_cast<long long>((p.w + kBQ - 1) / kBQ) *
                         p.S * p.H * p.n_chunks;
  if (work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(work < n_sm ? work : n_sm);
  kernel<<<grid, C::THREADS, smem, s>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Params& p, int sh, cudaStream_t s) {
  // f32 is built for D <= 128: its K and V tiles of 32 rows would take
  // 64 KB of static shared memory at D = 256 (48 KB at most)
  if constexpr (D > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const dim3 grid(sh, (p.w + kBQ32 - 1) / kBQ32);
    paged_f32<D><<<grid, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

extern "C" {

// Launch K3's window kernel on `stream` (a cudaStream_t from PyTorch) on
// device `device`. dtype: 0 = bf16, 1 = f32 (q, the pools and o all of
// it). q and o are [S, H, w, D] with the given strides (elements; unit
// stride on D; bf16 q 16-byte aligned, as its tensor map needs); the pools
// [NB, BL, H, D] contiguous and 16-byte aligned; rows [S, MB] and pos [S]
// int32 contiguous. D must be 32, 64, 128 or (bf16 only) 256. The chain is
// cut into n_chunks chunks of L positions (paged_attention.window_plan: L a
// multiple of 128, L * n_chunks >= MB * BL; f32 takes one chunk); with more
// than one, each chunk's partials go to part_acc [S, n_chunks, H, w, D] and
// part_ml [S, n_chunks, H, w, 2] (f32) and o is left to the combine
// (mmlspark_paged_combine_launch, paged_decode.cu). Returns 0, a
// cudaError_t of the launch, or a negative code of the tensor-map encoding
// (see the error string).
int mmlspark_paged_launch(const void* q, const void* k_pool,
                          const void* v_pool, const int* rows, const int* pos,
                          void* o, float* part_acc, float* part_ml, int dtype,
                          int S, int H, int w, int D, int NB, int BL, int MB,
                          long long q_ss, long long q_sh, long long q_sw,
                          long long o_ss, long long o_sh, long long o_sw,
                          float scale, int L, int n_chunks, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || S < 1 || H < 1 || w < 1 || NB < 1 ||
      BL < 1 || MB < 1 || static_cast<long long>(S) * H > 0x7fffffffLL ||
      static_cast<long long>(MB) * BL + w > 0x3fffffffLL || L < 128 ||
      L % 128 != 0 || n_chunks < 1 ||
      static_cast<long long>(L) * n_chunks <
          static_cast<long long>(MB) * BL ||
      (n_chunks > 1 &&
       (dtype != 0 || part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    WindowParams p;
    p.k_pool = k_pool, p.v_pool = v_pool;
    p.rows = rows, p.pos = pos, p.o = o;
    p.part_acc = part_acc, p.part_ml = part_ml;
    p.S = S, p.H = H, p.w = w, p.NB = NB, p.BL = BL, p.MB = MB;
    p.R = 0, p.L = L, p.n_chunks = n_chunks;
    p.o_ss = o_ss, p.o_sh = o_sh, p.o_sw = o_sw;
    p.scale = scale;
    switch (D) {
      case 32: return launch_bf16<32>(p, q, q_ss, q_sh, q_sw, st);
      case 64: return launch_bf16<64>(p, q, q_ss, q_sh, q_sw, st);
      case 128: return launch_bf16<128>(p, q, q_ss, q_sh, q_sw, st);
      case 256: return launch_bf16<256>(p, q, q_ss, q_sh, q_sw, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  Params p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.rows = rows;
  p.pos = pos;
  p.o = o;
  p.H = H;
  p.w = w;
  p.NB = NB;
  p.BL = BL;
  p.MB = MB;
  p.q_ss = q_ss, p.q_sh = q_sh, p.q_sw = q_sw;
  p.o_ss = o_ss, p.o_sh = o_sh, p.o_sw = o_sw;
  p.scale = scale;
  switch (D) {
    case 32: return launch_f32<32>(p, S * H, st);
    case 64: return launch_f32<64>(p, S * H, st);
    case 128: return launch_f32<128>(p, S * H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* mmlspark_paged_error_string(int err) {
  return launch_error_string(err);
}

}  // extern "C"
