// K3 for decode and verify windows (w <= 16 rows a slot): paged attention
// over the block table as a split-KV ("flash-decoding") kernel, hand-written
// for Hopper (sm_90a), and the pass that combines its chunks.
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (mmlspark_tpu/dl/pallas_paged_attention.py:89, launched by `_paged_pallas`
// at :199) for the windows the engine's decode step (w = 1) and its
// speculative verify (w = spec_k + 1) run; wider prefill windows take the
// window kernel of paged_attn.cu, which also launches this file's combine
// when its plan splits a chain. It computes exactly what paged_attn.cu
// states: for slot s, head h and window row i, softmax attention of q
// [S, H, w, hd] over the slot's chain of pool blocks (chain position t at
// offset t % BL of block rows[s, t / BL] of the pools [NB, BL, H, hd]); key
// t is allowed for row i iff t <= pos[s] + i; a chain entry equal to the
// trash block (0), or outside [0, NB), is skipped whole; scores in f32
// scaled by the true hd^-0.5; the running max and sum in f32, p rounded to
// v's dtype before the PV product; o = acc / max(l, 1e-35) in v's dtype, so
// an all-trash slot writes exactly 0; q and o through their strides.
//
// What bounds it on an H100: bytes. Decode reads each reached K/V row once
// for 4 * hd flops per head: 2 flops per byte in bf16, against the ~295 at
// which the tensor cores would bind, so the CUDA cores keep up with the
// stream and the work is to keep enough copies in flight on all 132 SMs.
// The first K3 ran one CTA per (slot, head), each walking its whole
// chain in series with its loads exposed: 8 CTAs for a one-slot long
// context. Here:
//  - The grid is (slot, chain chunk) [x head group, x column group]: the
//    wrapper cuts the table's L = MB * BL positions into chunks of a whole
//    number of positions, from the shape alone (S, H, L and the SM count;
//    `paged_attention.decode_plan`), aiming at two CTAs per SM. A chunk
//    past a slot's last reachable position exits at once.
//  - A CTA takes all H heads of its slot (fewer only where one position of
//    all heads would not fit a stage), so a stage, a run of up to 16 chain
//    positions for every head, is one contiguous span of a pool block
//    ([BL, H, hd]): one 1-D bulk copy (cp.async.bulk, completing on an
//    mbarrier; no tensor map) of K and one of V per block the stage
//    touches. One producer warp keeps a ring of 3 stages in flight; trash
//    entries are not copied (their positions are masked).
//  - Math on the CUDA cores, FMA from shared memory in row-major K and V,
//    nothing transposed: a consumer warp per (head, up to 128 output
//    columns). For the scores a lane holds one position and half of hd
//    (16-byte reads, rotated per lane so a quarter-warp hits distinct
//    banks), q's rows read through the cache; for the output a lane holds 4
//    columns (2 at w > 8) of every row. exp2 with log2(e) folded into the
//    scale; the running max and sum in f32, as the forward does. A version
//    with bf16 on mma.sync (the rows padded to 16, K and V fragments by
//    ldmatrix from rows staged at a padded pitch, so one bulk copy per
//    position) was right and 3.7x slower at w = 1, 12 % faster at w = 5:
//    its 1 KB copies, not the math, bound it (`PERF.md` §6); not kept.
//  - Each chunk writes (m, l, acc) in f32 to scratch the wrapper allocates;
//    paged_combine (one CTA per slot, head and row, its threads over the
//    chunks) merges them and writes o. A table of one chunk writes o
//    directly and launches no combine. No atomics and a fixed order: two
//    launches give the same bits.
//  - Every mbarrier wait traps after 2^24 polls rather than hang the card.
// Any head dim the pools hold (a multiple of 32) runs here: the columns are
// looped, and one position of one head's K and V must fit a stage (3 x 2 x
// hd x 4 bytes of shared memory in f32: hd up to about 9,000).

#include "flash_common.cuh"

namespace {

constexpr int kStages = 3;
constexpr int kMaxWarps = 8;   // consumer warps a CTA may have
constexpr int kTrash = 0;      // paged_kv.TRASH_BLOCK
constexpr int kSmemMax = 232448;

struct DecodeParams {
  const void* q;       // [S, H, w, D], strides q_ss, q_sh, q_sw; unit on D
  const void* k_pool;  // [NB, BL, H, D] contiguous
  const void* v_pool;
  const int* rows;     // [S, MB]
  const int* pos;      // [S]
  void* o;             // [S, H, w, D], strides o_ss, o_sh, o_sw
  float* part_acc;     // [S, n_chunks, H, w, D] (n_chunks > 1)
  float* part_ml;      // [S, n_chunks, H, w, 2]: (m, l)
  int S, H, w, D, NB, BL, MB;
  int hg, n_hg;        // heads per CTA, head groups
  int dpc, n_dg, dch;  // column chunks per CTA, column groups, per head
  int P, L, n_chunks;  // positions per stage and per chunk, chunks
  long long q_ss, q_sh, q_sw, o_ss, o_sh, o_sw;
  float scale;
};

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T as f32
template <typename T>
__device__ __forceinline__ void unpack(float (&f)[16 / sizeof(T)],
                                       const uint4& x) {
  const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) f[i] = to_f(e[i]);
}

// N consecutive elements of T at p (N * sizeof(T) bytes, aligned to that)
template <typename T, int N>
__device__ __forceinline__ void load_n(float (&f)[N], const T* p) {
  if constexpr (N * sizeof(T) == 16) {
    unpack<T>(f, *reinterpret_cast<const uint4*>(p));
  } else if constexpr (N * sizeof(T) == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
  } else {
    static_assert(N * sizeof(T) == 4, "4, 8 or 16 bytes");
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float (&f)[N]) {
  T e[N];
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = from_f<T>(f[i]);
  if constexpr (N * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
  } else if constexpr (N * sizeof(T) == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(e);
  } else {
    *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(e);
  }
}

// output columns a lane holds: 4 (128 a warp), 2 at more than 8 rows
template <int WR>
struct Rows {
  static constexpr int CPL = WR <= 8 ? 4 : 2;
  static constexpr int DV = 32 * CPL;
};

// the reachable end of slot s's chain: positions >= it are never allowed
__device__ __forceinline__ int chain_end(const DecodeParams& p, int pos) {
  const long long reach = static_cast<long long>(pos) + p.w;
  const int cap = p.MB * p.BL;
  return reach < 0 ? 0 : reach < cap ? static_cast<int>(reach) : cap;
}

__device__ __forceinline__ bool live_block(const DecodeParams& p, int blk) {
  return blk != kTrash && blk > 0 && blk < p.NB;
}

template <typename T, int WR>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1), 1)
    paged_decode(const __grid_constant__ DecodeParams p) {
  using R = Rows<WR>;
  constexpr int CPL = R::CPL;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const int row_elems = p.hg * p.D;  // one position of the stage
  const uint32_t sb = static_cast<uint32_t>(p.P * row_elems * sizeof(T));
  const uint32_t bars = base + kStages * 2 * sb;
  auto k_stage = [&](int st) { return base + st * 2 * sb; };
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (kStages + st); };

  const int n_cw = blockDim.x / 32 - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int x = blockIdx.x;
  const int chunk = x % p.n_chunks;
  x /= p.n_chunks;
  const int dg = x % p.n_dg;
  x /= p.n_dg;
  const int g = x % p.n_hg;
  const int s = x / p.n_hg;
  const int h0 = g * p.hg;
  const int nh = min(p.hg, p.H - h0);
  const int pos = p.pos[s];
  const int t_end = chain_end(p, pos);
  const int c0 = chunk * p.L;
  // a chunk past the reachable end has nothing to read; the combine skips
  // it (a single chunk still writes its zeros)
  if (c0 >= t_end && p.n_chunks > 1) return;
  const int c1 = max(c0, min(c0 + p.L, t_end));
  const int n_st = (c1 - c0 + p.P - 1) / p.P;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);      // the producer's arrival (+ the bytes)
      mbar_init(empty(st), n_cw);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int* row_s = p.rows + static_cast<long long>(s) * p.MB;
  if (warp == n_cw) {
    // ---------------------------------------------------------- producer
    if (lane != 0) return;
    const size_t es = sizeof(T);
    const char* kp = static_cast<const char*>(p.k_pool);
    const char* vp = static_cast<const char*>(p.v_pool);
    for (int k = 0; k < n_st; ++k) {
      const int st = k % kStages;
      mbar_wait(empty(st), ((k / kStages) & 1) ^ 1);
      const int t0 = c0 + k * p.P, t1 = min(t0 + p.P, c1);
      // pass 0 counts the bytes of the stage's live runs, pass 1 copies
      for (int pass = 0; pass < 2; ++pass) {
        uint32_t bytes = 0;
        for (int t = t0; t < t1;) {
          const int bi = t / p.BL;
          const int e = min(t1, (bi + 1) * p.BL);
          const int blk = row_s[bi];
          if (live_block(p, blk)) {
            // whole heads: the run is one span; a head group: a span each
            const int spans = nh == p.H ? 1 : e - t;
            const int len = nh == p.H ? e - t : 1;
            for (int i = 0; i < spans; ++i) {
              const int tt = t + i;
              const uint32_t n =
                  static_cast<uint32_t>(len * nh * p.D * es);
              bytes += 2 * n;
              if (pass == 1) {
                const size_t off =
                    ((static_cast<size_t>(blk) * p.BL + tt % p.BL) * p.H +
                     h0) * p.D * es;
                const uint32_t dst = k_stage(st) + (tt - t0) * row_elems * es;
                bulk_copy(dst, kp + off, n, full(st));
                bulk_copy(dst + sb, vp + off, n, full(st));
              }
            }
          }
          t = e;
        }
        if (pass == 0) {
          if (bytes == 0) {  // all trash: nothing to copy, same stage list
            mbar_arrive(full(st));
            break;
          }
          mbar_expect_tx(full(st), bytes);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int hl = warp / p.dpc;
  const int dz = dg * p.dpc + warp % p.dpc;
  const int h = h0 + hl;
  const bool active = hl < nh && dz < p.dch;
  const int w = p.w;
  const int tp = lane >> 1, half = lane & 1;  // scores: position, half of D
  const int half_d = p.D / 2;
  const int nvec = half_d / V;
  // rotate the vector order per lane so a quarter-warp's 16-byte reads land
  // on distinct banks
  const int rot = (nvec >= 8 ? (lane & 7) : tp) % nvec;
  const int oc = dz * R::DV + CPL * lane;  // output columns of this lane
  const bool o_on = active && oc < p.D;
  const float c2 = p.scale * kLog2e;
  const T* qh = static_cast<const T*>(p.q) + s * p.q_ss +
                (active ? h : h0) * p.q_sh + half * half_d;

  float m[WR], l[WR], acc[WR][CPL];
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[r][e] = 0.f;
  }

  for (int k = 0; k < n_st; ++k) {
    const int st = k % kStages;
    // the position's table entry is read while the stage's copy lands
    const int tg = c0 + k * p.P + tp;
    const bool live = tp < p.P && tg < c1 && live_block(p, row_s[tg / p.BL]);
    mbar_wait(full(st), (k / kStages) & 1);
    if (active) {
      const T* ks = reinterpret_cast<const T*>(sbase + st * 2 * sb) +
                    tp * row_elems + hl * p.D + half * half_d;
      float sc[WR];
#pragma unroll
      for (int r = 0; r < WR; ++r) sc[r] = 0.f;
      if (live) {
        for (int j = 0; j < nvec; ++j) {
          int jj = j + rot;
          jj = jj >= nvec ? jj - nvec : jj;
          float kf[V];
          unpack<T>(kf, *reinterpret_cast<const uint4*>(ks + jj * V));
#pragma unroll
          for (int r = 0; r < WR; ++r) {
            if (r < w) {
              float qf[V];
              unpack<T>(qf, __ldg(reinterpret_cast<const uint4*>(
                                qh + r * p.q_sw + jj * V)));
#pragma unroll
              for (int e = 0; e < V; ++e) sc[r] = fmaf(qf[e], kf[e], sc[r]);
            }
          }
        }
      }
      float pb[WR];
#pragma unroll
      for (int r = 0; r < WR; ++r) {
        pb[r] = 0.f;
        if (r < w) {
          const float sr = sc[r] + __shfl_xor_sync(0xffffffffu, sc[r], 1);
          const bool ok = live && tg <= pos + r;
          float mx = ok ? sr : kNeg;
#pragma unroll
          for (int off = 2; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float mn = fmaxf(m[r], mx);
          const float corr = ex2((m[r] - mn) * c2);
          m[r] = mn;
          const float pr = ok ? ex2(fmaf(sr, c2, -mn * c2)) : 0.f;
          l[r] = l[r] * corr + pr;
          pb[r] = to_f(from_f<T>(pr));  // the unnormalised p in v's dtype
#pragma unroll
          for (int e = 0; e < CPL; ++e) acc[r][e] *= corr;
        }
      }
      // PV over the stage's live positions (a warp-uniform walk)
      const uint32_t live_mask = __ballot_sync(0xffffffffu, live);
      const T* vs = reinterpret_cast<const T*>(sbase + st * 2 * sb + sb) +
                    hl * p.D + oc;
      for (int t = 0; t < p.P; ++t) {
        if (!((live_mask >> (2 * t)) & 1u)) continue;
        float vv[CPL];
        if (o_on) load_n<T, CPL>(vv, vs + t * row_elems);
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          if (r < w) {
            const float pt = __shfl_sync(0xffffffffu, pb[r], 2 * t);
            if (o_on) {
#pragma unroll
              for (int e = 0; e < CPL; ++e)
                acc[r][e] = fmaf(pt, vv[e], acc[r][e]);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
  if (!active) return;

  // l is a per-lane share (one position, both halves): sum the positions
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int off = 2; off < 32; off <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  if (p.n_chunks == 1) {
    if (!o_on) return;
    T* ob = static_cast<T*>(p.o) + s * p.o_ss + h * p.o_sh + oc;
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      if (r < w) {
        const float den = fmaxf(l[r], 1e-35f);
        float y[CPL];
#pragma unroll
        for (int e = 0; e < CPL; ++e) y[e] = acc[r][e] / den;
        store_n<T, CPL>(ob + r * p.o_sw, y);
      }
    }
    return;
  }
  const long long row0 =
      ((static_cast<long long>(s) * p.n_chunks + chunk) * p.H + h) * w;
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    if (r < w) {
      if (o_on) {
        float* pa = p.part_acc + (row0 + r) * p.D + oc;
#pragma unroll
        for (int e = 0; e < CPL; ++e) pa[e] = acc[r][e];
      }
      if (lane == 0 && dz == 0) {
        p.part_ml[2 * (row0 + r)] = m[r];
        p.part_ml[2 * (row0 + r) + 1] = l[r];
      }
    }
  }
}

constexpr int kCombineThreads = 256;

// a block-wide reduction in a fixed order (the same tree every launch);
// every thread gets the result
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by the previous reduction
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int i = 1; i < kCombineThreads / 32; ++i)
    x = kMax ? fmaxf(x, red[i]) : x + red[i];
  return x;
}

// Merge one (slot, head, row)'s chunk partials: o = sum_c f_c acc_c /
// max(sum_c f_c l_c, 1e-35), f_c = 2^((m_c - max m) * scale * log2 e). The
// chunks past the reachable end wrote nothing and are not read. Threads
// split the chunks (the max, the factors f_c into shared memory, the
// denominator), then the columns, and at head dims up to 256 also the
// chunks again in 256 / hd groups summed in group order: a fixed order, so
// two launches give the same bits.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    paged_combine(const __grid_constant__ DecodeParams p) {
  extern __shared__ float f[];  // n_chunks factors, then the group sums
  __shared__ float red[kCombineThreads / 32];
  const int tid = threadIdx.x;
  const int r = blockIdx.x % p.w;
  const int h = (blockIdx.x / p.w) % p.H;
  const int s = blockIdx.x / (p.w * p.H);
  const int n_live = (chain_end(p, p.pos[s]) + p.L - 1) / p.L;
  const float c2 = p.scale * kLog2e;
  // (s, c, h, r) is row (s * n_chunks + c) * H * w + h * w + r
  const long long row0 =
      (static_cast<long long>(s) * p.n_chunks * p.H + h) * p.w + r;
  const long long step = static_cast<long long>(p.H) * p.w;

  float mx = kNeg;
  for (int c = tid; c < n_live; c += kCombineThreads)
    mx = fmaxf(mx, p.part_ml[2 * (row0 + c * step)]);
  mx = block_reduce<true>(mx, red);
  float dp = 0.f;
  for (int c = tid; c < n_live; c += kCombineThreads) {
    const long long a = row0 + c * step;
    const float fc = ex2((p.part_ml[2 * a] - mx) * c2);
    f[c] = fc;
    dp = fmaf(fc, p.part_ml[2 * a + 1], dp);
  }
  const float den = fmaxf(block_reduce<false>(dp, red), 1e-35f);  // syncs f

  const int G = p.D <= kCombineThreads ? kCombineThreads / p.D : 1;
  const int per = kCombineThreads / G, g = tid / per;
  float* sums = f + p.n_chunks;  // [G][per]
  T* ob = static_cast<T*>(p.o) + s * p.o_ss + h * p.o_sh + r * p.o_sw;
  for (int col = tid % per; col < p.D; col += per) {
    float num = 0.f;
#pragma unroll 4
    for (int c = g; c < n_live; c += G)
      num = fmaf(f[c], p.part_acc[(row0 + c * step) * p.D + col], num);
    if (G == 1) {
      ob[col] = from_f<T>(num / den);
      continue;
    }
    sums[tid] = num;  // G > 1: every thread runs this one column
    __syncthreads();
    if (g == 0) {
      for (int i = 1; i < G; ++i) num += sums[i * per + col];
      ob[col] = from_f<T>(num / den);
    }
  }
}

template <typename T, int WR>
int launch(const DecodeParams& p, cudaStream_t s) {
  auto kernel = paged_decode<T, WR>;
  // the shared-memory opt-in, once per instance and device
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(opted & (1ull << (dev & 63)))) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted |= 1ull << (dev & 63);
  }
  const long long sb =
      static_cast<long long>(p.P) * p.hg * p.D * static_cast<int>(sizeof(T));
  const long long smem = 128 + kStages * 2 * sb + 2 * kStages * 8;
  const long long grid =
      static_cast<long long>(p.S) * p.n_hg * p.n_dg * p.n_chunks;
  if (smem > kSmemMax || grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<int>(grid), 32 * (p.hg * p.dpc + 1),
           static_cast<int>(smem), s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_chunks == 1) return static_cast<int>(e);
  const int combine_smem =
      (p.n_chunks + kCombineThreads) * static_cast<int>(sizeof(float));
  if (combine_smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  paged_combine<T><<<p.S * p.H * p.w, kCombineThreads, combine_smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const DecodeParams& p, cudaStream_t s) {
  if (p.w == 1) return launch<T, 1>(p, s);
  if (p.w <= 8) return launch<T, 8>(p, s);
  return launch<T, 16>(p, s);
}

}  // namespace

extern "C" {

// Launch the decode kernel (and, with n_chunks > 1, the combine) on
// `stream` on device `device`. dtype: 0 = bf16, 1 = f32 (q, the pools and o).
// q and o are [S, H, w, D] with the given strides (elements; unit stride on
// D, 16-byte rows); the pools [NB, BL, H, D] contiguous and 16-byte aligned
// with D a multiple of 32; rows [S, MB] and pos [S] int32. The plan (hg
// heads and dpc column chunks of 128 columns, 64 at w > 8, per CTA; P
// positions per stage; chunks of L positions, n_chunks of them covering
// MB * BL) is paged_attention.decode_plan's; part_acc [S, n_chunks, H, w, D]
// and part_ml [S, n_chunks, H, w, 2] f32 scratch (unused at one chunk).
// Returns 0 or a cudaError_t.
int mmlspark_paged_decode_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* rows,
    const int* pos, void* o, float* part_acc, float* part_ml, int dtype,
    int S, int H, int w, int D, int NB, int BL, int MB, long long q_ss,
    long long q_sh, long long q_sw, long long o_ss, long long o_sh,
    long long o_sw, float scale, int hg, int dpc, int P, int L, int n_chunks,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dv = w <= 8 ? Rows<8>::DV : Rows<16>::DV;
  const int dch = (D + dv - 1) / dv;
  if ((dtype != 0 && dtype != 1) || S < 1 || H < 1 || w < 1 || w > 16 ||
      D < 32 || D % 32 != 0 || NB < 1 || BL < 1 || MB < 1 ||
      static_cast<long long>(MB) * BL + w > 0x3fffffffLL || hg < 1 ||
      hg > H || dpc < 1 || dpc > dch || hg * dpc > kMaxWarps ||
      (hg > 1 && dpc != dch) || P < 1 || P > 16 || L < P || L % P != 0 ||
      n_chunks < 1 || static_cast<long long>(L) * n_chunks <
                          static_cast<long long>(MB) * BL ||
      (n_chunks > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p;
  p.q = q, p.k_pool = k_pool, p.v_pool = v_pool;
  p.rows = rows, p.pos = pos, p.o = o;
  p.part_acc = part_acc, p.part_ml = part_ml;
  p.S = S, p.H = H, p.w = w, p.D = D, p.NB = NB, p.BL = BL, p.MB = MB;
  p.hg = hg, p.n_hg = (H + hg - 1) / hg;
  p.dpc = dpc, p.dch = dch, p.n_dg = (dch + dpc - 1) / dpc;
  p.P = P, p.L = L, p.n_chunks = n_chunks;
  p.q_ss = q_ss, p.q_sh = q_sh, p.q_sw = q_sw;
  p.o_ss = o_ss, p.o_sh = o_sh, p.o_sw = o_sw;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_rows<__nv_bfloat16>(p, st)
                    : launch_rows<float>(p, st);
}

// Launch only the combine on `stream` on device `device`: merge the
// n_chunks chunk partials of K3's window kernel (paged_attn.cu), part_acc
// [S, n_chunks, H, w, D] and part_ml [S, n_chunks, H, w, 2] f32, into o
// [S, H, w, D] (strides in elements, unit on D) in `dtype` (0 = bf16, 1 =
// f32), reading each slot's chunks below its reachable end (pos[s] + w,
// capped at MB * BL), in chunk order. Returns 0 or a cudaError_t.
int mmlspark_paged_combine_launch(const int* pos, void* o,
                                  const float* part_acc,
                                  const float* part_ml, int dtype, int S,
                                  int H, int w, int D, int BL, int MB,
                                  long long o_ss, long long o_sh,
                                  long long o_sw, float scale, int L,
                                  int n_chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = (n_chunks + kCombineThreads) * static_cast<int>(
                                                      sizeof(float));
  if ((dtype != 0 && dtype != 1) || S < 1 || H < 1 || w < 1 || D < 1 ||
      BL < 1 || MB < 1 || L < 1 || n_chunks < 2 || part_acc == nullptr ||
      part_ml == nullptr || smem > 48 * 1024 ||
      static_cast<long long>(L) * n_chunks <
          static_cast<long long>(MB) * BL ||
      static_cast<long long>(S) * H * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p;
  memset(&p, 0, sizeof(p));
  p.pos = pos, p.o = o;
  p.part_acc = const_cast<float*>(part_acc);
  p.part_ml = const_cast<float*>(part_ml);
  p.S = S, p.H = H, p.w = w, p.D = D, p.BL = BL, p.MB = MB;
  p.L = L, p.n_chunks = n_chunks;
  p.o_ss = o_ss, p.o_sh = o_sh, p.o_sw = o_sw;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    paged_combine<__nv_bfloat16><<<S * H * w, kCombineThreads, smem, st>>>(p);
  else
    paged_combine<float><<<S * H * w, kCombineThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* mmlspark_paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
