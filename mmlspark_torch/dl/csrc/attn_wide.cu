// The wide-head-dim instances of the CUDA attention kernels: K2a, K2b, K2c
// and K2c-lse (the forward), K2d and K2e (the fused backward, causal or
// not) and K3's window kernel, for any head dim wider than the widest
// instance built for its dtype in flash_attn.cu, flash_bwd.cu and
// paged_attn.cu (256 in bf16, 128 in f32), hand-written for Hopper
// (sm_90a). They compute exactly what those kernels compute (see their
// notes: the masks, the causal rule on global offsets, the rounding points,
// o = acc / max(l, 1e-35), lse = -1e30 for a row with no allowed key, trash
// chain entries skipped whole), so the wrappers pick them by head dim alone.
//
// Replaces, for head dims above the built ones, the Pallas TPU kernels
// `_flash_kernel` (mmlspark_tpu/dl/pallas_attention.py:77),
// `_flash_kernel_lse` (:126), `_flash_kernel_causal_packed` (:142),
// `_bwd_dq_kernel` (:350), `_bwd_dkv_kernel` (:388) and `_paged_kernel`
// (mmlspark_tpu/dl/pallas_paged_attention.py:89). The reference pads every
// head dim to 128 lanes and holds a whole row in VMEM; here the wrappers pad
// to a multiple of 128 (`kernel_head_dim`) and the kernels split D.
//
// What bounds them on an H100: operations (4, 6 or 8 x D per allowed
// pair), as for the built instances. A whole D cannot sit in one CTA: at
// D = 512 a warpgroup's 64-row bf16 O accumulator alone would be 256 f32
// registers a thread, and a 128-row Q tile 128 KB of shared memory.
//
// Design (kept): a thread-block cluster along D. D is cut into units of
// two 128-byte TMA boxes (128 columns in bf16, 64 in f32), one per
// consumer warpgroup, beside a producer warp that loads the item's tiles
// once and streams 32-row tiles through a ring of TMA stages on mbarriers.
// A work item is 64 rows of one head (K2e: 64 keys); a cluster of CTAs
// takes it, two units a CTA (K2e one: its dK and dV take 128 registers a
// thread, and two warpgroups spilled at 168), at most 16 units: D <= 2048
// in bf16, 1024 in f32. Per tile the CTA computes its partial S = Q_c K_c^T
// over its own columns (and dP = dO_c V_c^T in the backward), each
// warpgroup half of the keys over both units; the cluster sums the CTAs'
// partials in rank order, so every unit holds the same bits of S; each
// unit then runs the softmax (or p and ds) and its own product:
// O_u += P V_u, dQ_u += dS K_u, dV_u += P^T dO_u and dK_u += dS^T Q_u. So
// shared memory and registers scale with a unit, not with D, and S is
// computed once per (row tile, key tile). The cluster's CTA count is the
// wrapper's plan (flash_attention.wide_plan); the launchers refuse a plan
// whose CTAs do not cover D's units.
//  - The exchange: each warp writes its slice of the CTA's partial, a
//    named barrier, one thread's lanes arrive on every CTA's barrier
//    releasing at cluster scope, and each thread reads the other CTAs'
//    partials through distributed shared memory. Tried and dropped
//    (PERF.md §6): pushing the partials by bulk copies, and in the bf16
//    forward at two CTAs (D <= 512) every CTA computing the whole S
//    (design B, 1.5x the products), which was no faster than the
//    exchange beyond the times' spread.
//  - A tile's partial is posted before the previous tile's products run
//    and read after them, so a wait overlaps a tile's products.
//  - The partials are double-buffered; a buffer is written again only
//    after every CTA has read it (each posts exchange n + 1 after reading
//    n - 1). The lse is written by unit 0, K2d owns dq and K2e dk/dv,
//    there are no atomics, and every sum has a fixed order: two launches
//    give the same bits.
//  - bf16: every product on wgmma (S and dP SS from the swizzled tiles,
//    K-major; P and dS rounded to bf16 as the register A operand of
//    m64n128 products, V, K, dO and Q read MN-major through the
//    descriptor), the online softmax in exp2, the key mask's validity
//    words per tile, the causal reach and the longest-first order of
//    flash_fwd.cuh and flash_bwd.cu.
//  - f32: the same kernels with TMA's f32 boxes; wgmma takes no f32
//    operands, so each warp runs its products as mma.sync m16n8k8 in
//    3xTF32 (an operand split into two TF32 parts, three products: about
//    2^-21 of a product lost where f32 loses 2^-24), whose accumulators
//    have the wgmma accumulator's layout (the softmax, the masks and the
//    exchange are shared with bf16). A register-tiled FMA loop on the CUDA
//    cores came first and took as long (about 40 % of their 67 TFLOP/s).
// What binds them now (PERF.md §6, `tools/probe_wide_variants.py`): the
// cross-SM round trip of an exchange a tile (a release at cluster scope,
// then the remote reads) beside about a microsecond of products a tile,
// though one exchange for two tiles (64-key tiles in two stages) was no
// faster; in f32, `mma.sync` in 3xTF32.
//
// The first design, kept for wider heads (bf16 above 2048, f32 above
// 1024: more than 16 units) as the split
// kernels below: a grid axis of D chunks of 128 columns, each CTA
// recomputing S (and dP) over the whole D on the CUDA cores from f32
// staged tiles and writing only its chunk ((D / 128 + 1) / 2 times the
// operations). Layout: 128 threads, 8 per row (a thread holds columns
// part + 8 i of a chunk, i < 16), 16 rows of a tile per CTA; tiles of 32
// keys in the forward and K2d, of 16 query rows in K2e. The only limit on
// D is the grid's z-extent (65,535 chunks).

#include "flash_common.cuh"

namespace {


constexpr int kThreads = 128;
constexpr int kDC = 128;                // columns per D chunk
constexpr int kTPR = 8;                 // threads per row
constexpr int kCols = kDC / kTPR;       // columns a thread holds: part + 8 i
constexpr int kRows = kThreads / kTPR;  // rows per CTA
constexpr int kBK = 32;                 // keys per tile (forward, K2d)
constexpr int kBQ = 16;                 // query rows per tile (K2e)
constexpr int kTrash = 0;               // paged_kv.TRASH_BLOCK

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
// x rounded to T and back: the plain versions' casts (p.astype(v), ...)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// the 8 partial sums of a row (its 8 consecutive lanes), in every lane
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// Stage `n` rows of one D chunk (columns c0 .. c0 + 127) as f32 into `dst`
// [n][kDC]: row j from src[j] (+ c0), or zeros where src[j] is null (a dead
// key or a row past T), in 16-byte vectors.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* const* src, int n,
                                      int c0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NV = kDC / V;
  for (int i = threadIdx.x; i < n * NV; i += kThreads) {
    const int r = i / NV, c = (i % NV) * V;
    float f[V];
    if (src[r] == nullptr) {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = 0.f;
    } else {
      const uint4 x = *reinterpret_cast<const uint4*>(src[r] + c0 + c);
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = to_f(e[k]);
    }
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(dst + r * kDC + c + k) =
          make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
  }
}

// this thread's 16 columns of a chunk of one row (zeros for a null row)
template <typename T>
__device__ __forceinline__ void load_cols(float (&x)[kCols], const T* row,
                                          int c0, int part) {
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    x[i] = row == nullptr ? 0.f : to_f(row[c0 + part + kTPR * i]);
}

// ================================================================== split
// The first design's kernels, for head dims beyond a cluster.

// ------------------------------------------------------ the two key sources

// K2a/K2b/K2c: q, k, v, o as strided [B, H, T, D] views, a [B, T] key mask
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // null = all valid
  void* o;
  float* lse;           // [B*H, T] (K2b, K2c-lse); null otherwise
  int H, T, nc;
  int BH, D, units;     // the cluster kernels: B * H, the head dim, units
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st, mask_sb;
  long long qk_shift;   // q_offset - k_offset
  int causal;
  float scale;
};

template <typename T>
struct Dense {
  const FlashParams& p;
  int b, h, bh;
  __device__ Dense(const FlashParams& p_, int x)
      : p(p_), b(x / p_.H), h(x % p_.H), bh(x) {}
  __device__ int rows() const { return p.T; }
  __device__ const T* q_row(int r) const {
    return r >= p.T ? nullptr
                    : static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                          r * p.q_st;
  }
  __device__ T* o_row(int r) const {
    return static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + r * p.o_st;
  }
  __device__ bool live(int key) const {
    return key < p.T &&
           (p.mask == nullptr ||
            p.mask[static_cast<long long>(b) * p.mask_sb + key] != 0);
  }
  __device__ const T* k_row(int key) const {
    return live(key) ? static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh +
                           key * p.k_st
                     : nullptr;
  }
  __device__ const T* v_row(int key) const {
    return live(key) ? static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh +
                           key * p.v_st
                     : nullptr;
  }
  // a live key is allowed for `row` (causal: k_offset + key <= q_offset + row)
  __device__ bool allowed(int row, int key) const {
    return row < p.T &&
           (!p.causal || static_cast<long long>(key) <= row + p.qk_shift);
  }
  // the key tiles a CTA whose last row is `last` visits
  __device__ int n_tiles(int last) const {
    const int n = (p.T + kBK - 1) / kBK;
    if (!p.causal) return n;
    const long long reach = static_cast<long long>(last) + p.qk_shift;
    if (reach < 0) return 0;
    return reach / kBK + 1 < n ? static_cast<int>(reach / kBK + 1) : n;
  }
  __device__ float* lse_row() const {
    return p.lse == nullptr ? nullptr
                            : p.lse + static_cast<long long>(bh) * p.T;
  }
};

// K3's window kernel: q [S, H, w, D] strided, pools [NB, BL, H, D]
// contiguous, the block table rows [S, MB] and pos [S]
struct PagedParams {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* rows;
  const int* pos;
  void* o;
  int H, w, NB, BL, MB, D, nc;
  int S, R, units;      // the cluster kernel: slots, rows of a pool box, units
  long long q_ss, q_sh, q_sw, o_ss, o_sh, o_sw;
  float scale;
};

template <typename T>
struct Paged {
  const PagedParams& p;
  int s, h, pos, t_end;
  __device__ Paged(const PagedParams& p_, int x)
      : p(p_), s(x / p_.H), h(x % p_.H), pos(p_.pos[x / p_.H]) {
    // positions past the last row's limit are never allowed
    const long long reach = static_cast<long long>(pos) + p.w;
    const int cap = p.MB * p.BL;
    t_end = reach < cap ? static_cast<int>(reach) : cap;
  }
  __device__ int rows() const { return p.w; }
  __device__ const T* q_row(int r) const {
    return r >= p.w ? nullptr
                    : static_cast<const T*>(p.q) + s * p.q_ss + h * p.q_sh +
                          r * p.q_sw;
  }
  __device__ T* o_row(int r) const {
    return static_cast<T*>(p.o) + s * p.o_ss + h * p.o_sh + r * p.o_sw;
  }
  // the pool row of chain position t, or -1 (trash, out of range, past end)
  __device__ long long pool_row(int t) const {
    if (t >= t_end) return -1;
    const int blk = p.rows[static_cast<long long>(s) * p.MB + t / p.BL];
    if (blk == kTrash || blk < 0 || blk >= p.NB) return -1;
    return (static_cast<long long>(blk) * p.BL + t % p.BL) * p.H + h;
  }
  __device__ const T* k_row(int t) const {
    const long long r = pool_row(t);
    return r < 0 ? nullptr : static_cast<const T*>(p.k_pool) + r * p.D;
  }
  __device__ const T* v_row(int t) const {
    const long long r = pool_row(t);
    return r < 0 ? nullptr : static_cast<const T*>(p.v_pool) + r * p.D;
  }
  __device__ bool allowed(int row, int t) const {
    return row < p.w && static_cast<long long>(t) <= pos + row;
  }
  __device__ int n_tiles(int) const { return (t_end + kBK - 1) / kBK; }
  __device__ float* lse_row() const { return nullptr; }
};

// ------------------------------------------------------------------ forward

template <typename T, template <typename> class Src, typename P>
__global__ void __launch_bounds__(kThreads)
    split_fwd(const __grid_constant__ P p) {
  __shared__ __align__(16) float ks[kBK * kDC];
  __shared__ __align__(16) float vs[kBK * kDC];
  __shared__ const T* krow[kBK];
  __shared__ const T* vrow[kBK];

  const Src<T> src(p, blockIdx.x);
  const int tid = threadIdx.x, part = tid % kTPR;
  const int row0 = blockIdx.y * kRows;
  const int row = row0 + tid / kTPR;
  const int cz = blockIdx.z, nc = p.nc;
  const T* qr = src.q_row(row);

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  const int n_tiles = src.n_tiles(row0 + kRows - 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed
    bool any = false;
    if (tid < kBK) {
      krow[tid] = src.k_row(k0 + tid);
      vrow[tid] = src.v_row(k0 + tid);
      any = krow[tid] != nullptr;
    }
    if (!__syncthreads_or(any)) continue;  // no live key: the identity

    // S over every chunk, this CTA's own last (its V chunk is staged with
    // it, and stays for the PV product)
    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      const int c = (cz + 1 + cc) % nc;
      if (cc > 0) __syncthreads();
      stage<T>(ks, krow, kBK, c * kDC);
      if (cc == nc - 1) stage<T>(vs, vrow, kBK, cz * kDC);
      __syncthreads();
      float qc[kCols];
      load_cols<T>(qc, qr, c * kDC, part);
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          dot = fmaf(qc[i], ks[j * kDC + part + kTPR * i], dot);
        s[j] += dot;
      }
    }
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float sum = row_sum(s[j]);  // every lane shuffles
      const bool ok = krow[j] != nullptr && src.allowed(row, k0 + j);
      s[j] = ok ? sum * p.scale : kNeg;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const bool ok = krow[j] != nullptr && src.allowed(row, k0 + j);
      s[j] = ok ? expf(s[j] - mn) : 0.f;
      ps += s[j];
      s[j] = round_to<T>(s[j]);  // the unnormalised p in v's dtype
    }
    l = l * corr + ps;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kBK; ++j)
        a = fmaf(s[j], vs[j * kDC + part + kTPR * i], a);
      acc[i] = a;
    }
  }

  if (row < src.rows()) {
    const float den = fmaxf(l, 1e-35f);
    T* orow = src.o_row(row) + cz * kDC;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      orow[part + kTPR * i] = from_f<T>(acc[i] / den);
    float* lse = src.lse_row();
    if (lse != nullptr && cz == 0 && part == 0)
      lse[row] = l > 0.f ? m + logf(l) : kNeg;
  }
}

// ----------------------------------------------------------------- backward

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const uint8_t* mask;
  const float* lse;   // [B*H, T]
  const float* dsum;  // [B*H, T]
  void* dq;
  void* dk;
  void* dv;
  int H, T, nc;
  int BH, D, units;     // the cluster kernels: B * H, the head dim, units
  long long st[21];   // q k v dO dq dk dv: (batch, head, row) each
  long long mask_sb, qk_shift;
  int causal;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* bwd_row(const BwdParams& p, int t,
                                            int b, int h, int r) {
  const void* base = t == 0 ? p.q : t == 1 ? p.k : t == 2 ? p.v : p.dout;
  return static_cast<const T*>(base) + b * p.st[3 * t] +
         h * p.st[3 * t + 1] + static_cast<long long>(r) * p.st[3 * t + 2];
}

template <typename T>
__device__ __forceinline__ T* bwd_out(const BwdParams& p, int t, void* base,
                                      int b, int h, int r) {
  return static_cast<T*>(base) + b * p.st[3 * t] + h * p.st[3 * t + 1] +
         static_cast<long long>(r) * p.st[3 * t + 2];
}

__device__ __forceinline__ bool bwd_key_live(const BwdParams& p, int b,
                                             int key) {
  return key < p.T &&
         (p.mask == nullptr ||
          p.mask[static_cast<long long>(b) * p.mask_sb + key] != 0);
}

// K2d: dq for 16 rows of one (b, h), D chunk blockIdx.z
template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_dq(const __grid_constant__ BwdParams p) {
  __shared__ __align__(16) float ks[kBK * kDC];
  __shared__ __align__(16) float vs[kBK * kDC];
  __shared__ const T* krow[kBK];
  __shared__ const T* vrow[kBK];

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, part = tid % kTPR;
  const int row0 = blockIdx.y * kRows;
  const int row = row0 + tid / kTPR;
  const bool in = row < p.T;
  const int cz = blockIdx.z, nc = p.nc;
  const T* qr = in ? bwd_row<T>(p, 0, b, h, row) : nullptr;
  const T* dr = in ? bwd_row<T>(p, 3, b, h, row) : nullptr;
  const long long ro = static_cast<long long>(bh) * p.T + row;
  const float lse = in ? p.lse[ro] : 0.f;
  const float dsum = in ? p.dsum[ro] : 0.f;

  float dq[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dq[i] = 0.f;

  int n_tiles = (p.T + kBK - 1) / kBK;
  if (p.causal) {
    const long long reach = static_cast<long long>(row0 + kRows - 1) +
                            p.qk_shift;
    n_tiles = reach < 0 ? 0
              : reach / kBK + 1 < n_tiles ? static_cast<int>(reach / kBK + 1)
                                          : n_tiles;
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    bool any = false;
    if (tid < kBK) {
      const bool live = bwd_key_live(p, b, k0 + tid);
      krow[tid] = live ? bwd_row<T>(p, 1, b, h, k0 + tid) : nullptr;
      vrow[tid] = live ? bwd_row<T>(p, 2, b, h, k0 + tid) : nullptr;
      any = live;
    }
    if (!__syncthreads_or(any)) continue;

    // S and dP over every chunk, this CTA's own last: its K chunk stays
    float s[kBK], dp[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = dp[j] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      const int c = (cz + 1 + cc) % nc;
      if (cc > 0) __syncthreads();
      stage<T>(ks, krow, kBK, c * kDC);
      stage<T>(vs, vrow, kBK, c * kDC);
      __syncthreads();
      float qc[kCols], dc[kCols];
      load_cols<T>(qc, qr, c * kDC, part);
      load_cols<T>(dc, dr, c * kDC, part);
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        float a = 0.f, d = 0.f;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          a = fmaf(qc[i], ks[j * kDC + part + kTPR * i], a);
          d = fmaf(dc[i], vs[j * kDC + part + kTPR * i], d);
        }
        s[j] += a;
        dp[j] += d;
      }
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float sj = row_sum(s[j]), dj = row_sum(dp[j]);
      const bool ok = in && krow[j] != nullptr &&
                      (!p.causal ||
                       static_cast<long long>(k0 + j) <= row + p.qk_shift);
      const float pj = ok ? expf(sj * p.scale - lse) : 0.f;
      s[j] = round_to<T>(pj * (dj - dsum) * p.scale);  // ds in k's dtype
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      float a = dq[i];
#pragma unroll
      for (int j = 0; j < kBK; ++j)
        a = fmaf(s[j], ks[j * kDC + part + kTPR * i], a);
      dq[i] = a;
    }
  }
  if (in) {
    T* out = bwd_out<T>(p, 4, p.dq, b, h, row) + cz * kDC;
#pragma unroll
    for (int i = 0; i < kCols; ++i) out[part + kTPR * i] = from_f<T>(dq[i]);
  }
}

// K2e: dk and dv for 16 keys of one (b, h), D chunk blockIdx.z
template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_dkv(const __grid_constant__ BwdParams p) {
  __shared__ __align__(16) float qs[kBQ * kDC];
  __shared__ __align__(16) float ds_[kBQ * kDC];  // dO's chunk
  __shared__ const T* qrow[kBQ];
  __shared__ const T* drow[kBQ];
  __shared__ float lse_s[kBQ], dsum_s[kBQ];

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, part = tid % kTPR;
  const int key0 = blockIdx.y * kRows;
  const int key = key0 + tid / kTPR;
  const bool live = bwd_key_live(p, b, key);
  const int cz = blockIdx.z, nc = p.nc;
  const T* kr = live ? bwd_row<T>(p, 1, b, h, key) : nullptr;
  const T* vr = live ? bwd_row<T>(p, 2, b, h, key) : nullptr;

  float dk[kCols], dv[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dk[i] = dv[i] = 0.f;

  // causal: the first q tile with a row that may see a key of this CTA
  int qt0 = 0;
  if (p.causal) {
    const long long first = static_cast<long long>(key0) - p.qk_shift;
    qt0 = first <= 0 ? 0
          : first >= p.T ? (p.T + kBQ - 1) / kBQ
                         : static_cast<int>(first / kBQ);
  }
  const int n_qt = (p.T + kBQ - 1) / kBQ;
  const bool cta_live = __syncthreads_or(live);
  for (int qt = cta_live ? qt0 : n_qt; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    if (tid < kBQ) {
      const int r = q0 + tid;
      const bool in = r < p.T;
      qrow[tid] = in ? bwd_row<T>(p, 0, b, h, r) : nullptr;
      drow[tid] = in ? bwd_row<T>(p, 3, b, h, r) : nullptr;
      const long long ro = static_cast<long long>(bh) * p.T + r;
      lse_s[tid] = in ? p.lse[ro] : 0.f;
      dsum_s[tid] = in ? p.dsum[ro] : 0.f;
    }
    float s[kBQ], dp[kBQ];
#pragma unroll
    for (int r = 0; r < kBQ; ++r) s[r] = dp[r] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      const int c = (cz + 1 + cc) % nc;
      __syncthreads();  // (first pass: the row pointers are written)
      stage<T>(qs, qrow, kBQ, c * kDC);
      stage<T>(ds_, drow, kBQ, c * kDC);
      __syncthreads();
      float kc[kCols], vc[kCols];
      load_cols<T>(kc, kr, c * kDC, part);
      load_cols<T>(vc, vr, c * kDC, part);
#pragma unroll
      for (int r = 0; r < kBQ; ++r) {
        float a = 0.f, d = 0.f;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          a = fmaf(kc[i], qs[r * kDC + part + kTPR * i], a);
          d = fmaf(vc[i], ds_[r * kDC + part + kTPR * i], d);
        }
        s[r] += a;
        dp[r] += d;
      }
    }
#pragma unroll
    for (int r = 0; r < kBQ; ++r) {
      const float sr = row_sum(s[r]), dr = row_sum(dp[r]);
      const int row = q0 + r;
      const bool ok = live && row < p.T &&
                      (!p.causal ||
                       static_cast<long long>(key) <= row + p.qk_shift);
      const float pr = ok ? expf(sr * p.scale - lse_s[r]) : 0.f;
      s[r] = round_to<T>(pr * (dr - dsum_s[r]) * p.scale);  // ds in q's dtype
      dp[r] = round_to<T>(pr);                              // p in dO's
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      float a = dk[i], d = dv[i];
#pragma unroll
      for (int r = 0; r < kBQ; ++r) {
        a = fmaf(s[r], qs[r * kDC + part + kTPR * i], a);
        d = fmaf(dp[r], ds_[r * kDC + part + kTPR * i], d);
      }
      dk[i] = a;
      dv[i] = d;
    }
  }
  if (key < p.T) {
    T* ok = bwd_out<T>(p, 5, p.dk, b, h, key) + cz * kDC;
    T* ov = bwd_out<T>(p, 6, p.dv, b, h, key) + cz * kDC;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      ok[part + kTPR * i] = from_f<T>(dk[i]);
      ov[part + kTPR * i] = from_f<T>(dv[i]);
    }
  }
}

// ------------------------------------------------------------------- launch

bool bad_dim(int D) { return D < kDC || D % kDC != 0 || D / kDC > 65535; }

template <typename T>
int split_launch_fwd(const FlashParams& p, int BH, cudaStream_t s) {
  const dim3 grid(BH, (p.T + kRows - 1) / kRows, p.nc);
  split_fwd<T, Dense, FlashParams><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int split_launch_bwd(const BwdParams& p, int dkv, int BH, cudaStream_t s) {
  const dim3 grid(BH, (p.T + kRows - 1) / kRows, p.nc);
  if (dkv)
    split_dkv<T><<<grid, kThreads, 0, s>>>(p);
  else
    split_dq<T><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int split_launch_paged(const PagedParams& p, int SH, cudaStream_t s) {
  const dim3 grid(SH, (p.w + kRows - 1) / kRows, p.nc);
  split_fwd<T, Paged, PagedParams><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ================================================================ cluster
// The kernels the wrappers run up to 16 units (see the note at the top).

constexpr int kMaxCluster = 16;        // CTAs of a cluster: the H100's
                                       // non-portable limit
constexpr int kItemRows = 64;          // rows of a work item (K2e: keys)
constexpr int kTileRows = 32;          // rows of a streamed tile (keys;
                                       // K2e: q rows)
constexpr int kBoxBytes = 128;         // a TMA box row: the swizzle atom's
constexpr int kUnitRow = 2 * kBoxBytes;  // a unit's row: two boxes
constexpr int kUnitTile = kTileRows * kUnitRow;  // a unit's streamed tile
constexpr int kUnitItem = kItemRows * kUnitRow;  // a unit's item tile

// one row of a unit: two 128-byte boxes of CW columns
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int CW = 64;
  static constexpr int CODE = 0;
};
template <>
struct Elem<float> {
  static constexpr int CW = 32;
  static constexpr int CODE = 1;
};

// One kernel's shape and shared memory: U units a CTA (a consumer
// warpgroup each, and a producer warp); ITEM item tiles (kItemRows rows,
// every unit), STAGES stages of two streamed tiles, the exchange buffers
// (two, of N floats a thread, per warp), META bytes a stage, then the
// barriers (full and empty per stage, the item's full, the exchange's
// full per buffer).
template <typename T, int U_, int ITEM, int STAGES_, int N, int META>
struct Layout {
  static constexpr int U = U_, STAGES = STAGES_;
  static constexpr int THREADS = U * kWgThreads + 32;
  static constexpr int TILE = U * kUnitTile;       // one streamed tile
  static constexpr int ITEM_TILE = U * kUnitItem;  // one item tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int XCH = N * 32 * 4;  // one warp's exchange buffer
  static constexpr int O_STAGES = ITEM * ITEM_TILE;
  static constexpr int O_PART = O_STAGES + STAGES * STAGE;
  static constexpr int O_P = O_PART + 2 * 4 * XCH;
  static constexpr int O_META = O_P;
  static constexpr int O_BARS = O_META + STAGES * META;
  static constexpr int SMEM = 1024 + O_BARS + (2 * STAGES + 3) * 8;
  static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
};
// Two units a CTA, except K2e in bf16 (its dK and dV take 128 registers a
// thread); K2e runs without a producer warp (see wide_dkv). The forward's
// item tile is Q and its exchange S alone.
template <typename T>
using FwdLayout = Layout<T, 2, 1, 3, kTileRows / 2, 16>;
template <typename T>
using DqLayout = Layout<T, 2, 2, 3, kTileRows, 16>;
template <typename T>
using DkvLayout = Layout<T, sizeof(T) == 4 ? 2 : 1, 2, 3, kTileRows,
                         2 * kTileRows * 4>;

// ------------------------------------------------------ cluster helpers

extern __shared__ __align__(1024) uint8_t smem_raw[];  // every kernel's

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `addr` in the CTA of rank `rank`
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// arrive on an mbarrier of any CTA of the cluster, releasing this
// thread's (and, after a __syncwarp, its warp's) writes at cluster scope
__device__ __forceinline__ void arrive_remote(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: what arrive_remote released
// is visible after it
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == kSpinLimit) __trap();
  }
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts4(uint32_t a, float x, float y, float z,
                                     float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(x), "f"(y), "f"(z), "f"(w)
               : "memory");
}

// The score exchange: S (and dP) summed over every CTA of the cluster.
// Warpgroup u of a CTA computes key columns [u BK / U, (u + 1) BK / U) of
// the CTA's partial S over all U of its units, so the CTA's partial is
// whole once each warpgroup has written its slice. post: each warp writes
// its threads' slice of the N partial floats (the wgmma accumulator
// layout; x holds N / 16 parts of 16 floats, S then dP) to the CTA's
// buffer; after a named barrier of the consumer warps one warp arrives on
// full[buf] of every CTA (lane r on CTA r's, releasing the CTA's writes at
// cluster scope). finish: every thread waits for its own full[buf] (one
// arrival per CTA), then reads the same N positions of every CTA's buffer
// and sums them, rank 0 first: every unit holds the same bits. A buffer
// is written again two exchanges later: a CTA posts exchange n + 1 only
// after full[buf] of exchange n completed, which needs every CTA's named
// barrier of exchange n, which every warp passes only after reading
// exchange n - 1. The kernels post a tile's partial, run the previous
// tile's products, then finish this tile's sum, so a wait overlaps a
// tile's products. With one CTA (nc = 1) it is the warpgroups' exchange
// of their halves.
struct Xch {
  uint32_t part;   // this CTA's buffers: [buf][warp][N/4][32] float4
  uint32_t full;   // barriers [buf]
  int nc, rank;    // the CTAs of the cluster, this CTA's rank
};

// post: this warp's slice of the CTA's partial into the buffer of exchange
// n, and its arrivals
template <int N, int U>
__device__ __forceinline__ void post(const float (&x)[N], const Xch& e,
                                     int wg, int warp, int lane, int n) {
  constexpr int XCH = N * 32 * 4;
  constexpr int SL = 4 / U;  // float4s of a part a warpgroup computes
  const int buf = n & 1;
  const uint32_t slot = e.part + (buf * 4 + warp) * XCH + lane * 16;
#pragma unroll
  for (int pt = 0; pt < N / 16; ++pt)
#pragma unroll
    for (int q = 0; q < SL; ++q) {
      const int i = 4 * pt + SL * wg + q;
      sts4(slot + i * 512, x[4 * i], x[4 * i + 1], x[4 * i + 2],
           x[4 * i + 3]);
    }
  // every consumer warp of the CTA has written (a named barrier), then one
  // warp's lane r arrives on CTA r's full[buf]: one release a CTA
  asm volatile("bar.sync 1, %0;\n" ::"r"(U * kWgThreads) : "memory");
  if (wg == 0 && warp == 0 && lane < e.nc)
    arrive_remote(at_rank(e.full + 8u * buf, lane));
}

// finish: the sum of exchange n over every CTA, rank 0 first, into x
template <int N>
__device__ __forceinline__ void finish(float (&x)[N], const Xch& e, int warp,
                                       int lane, int n) {
  constexpr int XCH = N * 32 * 4;
  constexpr int G = 1;  // CTAs read at once
  const int buf = n & 1;
  const uint32_t slot = e.part + (buf * 4 + warp) * XCH + lane * 16;
  wait_cluster(e.full + 8u * buf, (n >> 1) & 1);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
  for (int r0 = 0; r0 < e.nc; r0 += G) {
    float4 v[G][N / 4];
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (r0 + g < e.nc) {
        const int r = r0 + g;
#pragma unroll
        for (int i = 0; i < N / 4; ++i)
          v[g][i] = r == e.rank ? lds4(slot + i * 512)
                                : ld_cluster4(at_rank(slot, r) + i * 512);
      }
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (r0 + g < e.nc) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          x[4 * i] += v[g][i].x;
          x[4 * i + 1] += v[g][i].y;
          x[4 * i + 2] += v[g][i].z;
          x[4 * i + 3] += v[g][i].w;
        }
      }
  }
}

// ---------------------------------------------------------- the products
// Every product of a warpgroup reads unit tiles: R rows of two 128-byte
// boxes, box b at + b R 128, rows swizzled by TMA's 128-byte pattern; a
// tile of U units holds unit u at + u R 256. scores: x (64 x N, the wgmma
// accumulator layout: rows 16 warp + g and + 8, columns 8 j + 2 t4 + e) =
// A (64 rows at a) B^T (N rows at b, from row b0) over the columns of the
// CTA's nu units. accum: acc (64 rows x one unit's columns) += X B, X (64 x
// NK) in the accumulator layout (rounded to T first) and B the NK rows of
// a unit tile at b. Both in the wgmma accumulator layout for either type.

__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <typename T, int U>
struct Engine;

template <int U>
struct Engine<__nv_bfloat16, U> {
  static constexpr int ACC = 64;  // m64n128 accumulator floats a thread

  template <int N>
  __device__ static void scores(float (&x)[N / 2], uint32_t a, int ra,
                                uint32_t b, int rb, int b0, int nu, int,
                                int) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) x[i] = 0.f;
    keep(x);
    wg_fence();
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < nu)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t da = kmajor<128>(a + u * ra * kUnitRow, ra, kk);
        const uint64_t db =
            kmajor<128>(b + u * rb * kUnitRow + b0 * kBoxBytes, rb, kk);
        if constexpr (N == 16)
          wgmma_ss_n16(x, da, db, u + kk > 0);
        else
          wgmma_ss<N>(x, da, db, u + kk > 0);
      }
    wg_commit();
    wg_wait0();
    keep(x);
  }

  template <int NK>
  __device__ static void accum(float (&acc)[ACC], const float (&x)[NK / 2],
                               uint32_t b, int) {
    uint32_t xa[NK / 16][4];
    to_a_frags<NK>(xa, x);
    keep(acc);
    keep(xa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma_rs<128, 128>(acc, xa[kk], b, NK, kk, 0);
    wg_commit();
    wg_wait0();
    keep(acc);
    keep(xa);
  }

  // rows r_lo and r_hi of the accumulator times c_lo and c_hi
  __device__ static void scale_rows(float (&acc)[ACC], float c_lo,
                                    float c_hi) {
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j) {
      acc[4 * j] *= c_lo;
      acc[4 * j + 1] *= c_lo;
      acc[4 * j + 2] *= c_hi;
      acc[4 * j + 3] *= c_hi;
    }
  }

  // acc / den at rows r_lo, r_lo + 8 (those below Tq), columns c0 + ...
  __device__ static void store(__nv_bfloat16* o, long long st,
                               const float (&acc)[ACC], float den_lo,
                               float den_hi, int r_lo, int Tq, int c0,
                               int t4) {
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j) {
      const int c = c0 + 8 * j + 2 * t4;
      if (r_lo < Tq)
        *reinterpret_cast<uint32_t*>(o + r_lo * st + c) =
            pack_bf16(acc[4 * j] / den_lo, acc[4 * j + 1] / den_lo);
      if (r_hi < Tq)
        *reinterpret_cast<uint32_t*>(o + r_hi * st + c) =
            pack_bf16(acc[4 * j + 2] / den_hi, acc[4 * j + 3] / den_hi);
    }
  }
};

// f32 on the tensor cores in 3xTF32: each operand x splits into two TF32
// parts, hi = tf32(x) and lo = tf32(x - hi), and a product takes
// a_lo b_hi + a_hi b_lo + a_hi b_hi (mma.sync m16n8k8, f32 sums): about
// 2^-21 of each product's size is lost, where one f32 product loses 2^-24
// (wgmma takes no f32, and the CUDA cores' FMA loop this replaces ran at
// about 40 % of their 67 TFLOP/s, slower than the plain versions' cuBLAS
// products, PERF.md §6). A warp's m16n8 accumulators hold rows 16 warp + g
// and + 8 and columns 8 n + 2 t4 (+ 1), the wgmma accumulator's layout,
// so S and the softmax are shared with bf16. Operands are read from the
// swizzled f32 tiles one word a thread (no bank conflict: 8 rows of one
// 16-byte column chunk, or 8 chunks of a row, a warp); an X from the
// accumulator layout is the A operand as it stands, its keys taken in the
// order 2 t4, 2 t4 + 1 of each 8 and B's rows read in the same order.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (m16n8) += A B in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// a word of shared memory at shared address a, as a plain load the
// compiler may schedule (the mbarrier waits are its fences)
__device__ __forceinline__ float lds1(uint32_t a) {
  return *reinterpret_cast<const float*>(smem_raw + (a - smem_u32(smem_raw)));
}

// the word of column c (0-63) of row r in an f32 unit tile of `rows` rows
__device__ __forceinline__ uint32_t f32_at(uint32_t base, int rows, int r,
                                           int c) {
  const int q = c >> 2;
  return base + (q >> 3) * rows * kBoxBytes + r * kBoxBytes +
         (((q & 7) ^ (r & 7)) << 4) + (c & 3) * 4;
}

template <int U>
struct Engine<float, U> {
  static constexpr int ACC = 32;  // 8 m16n8 accumulators: 64 columns

  template <int N>
  __device__ static void scores(float (&x)[N / 2], uint32_t a, int ra,
                                uint32_t b, int rb, int b0, int nu, int warp,
                                int lane) {
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = 16 * warp + g;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) x[i] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= nu) break;
      const uint32_t au = a + u * ra * kUnitRow;
      const uint32_t bu = b + u * rb * kUnitRow;
#pragma unroll 1
      for (int ks = 0; ks < 8; ++ks) {  // columns 8 ks .. 8 ks + 7
        uint32_t ah[4], al[4];
        split_tf32(lds1(f32_at(au, ra, r0, 8 * ks + t4)), ah[0], al[0]);
        split_tf32(lds1(f32_at(au, ra, r0 + 8, 8 * ks + t4)), ah[1], al[1]);
        split_tf32(lds1(f32_at(au, ra, r0, 8 * ks + t4 + 4)), ah[2], al[2]);
        split_tf32(lds1(f32_at(au, ra, r0 + 8, 8 * ks + t4 + 4)), ah[3],
                   al[3]);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int key = b0 + 8 * j + g;
          mma3(&x[4 * j], ah, al, lds1(f32_at(bu, rb, key, 8 * ks + t4)),
               lds1(f32_at(bu, rb, key, 8 * ks + t4 + 4)));
        }
      }
    }
  }

  template <int NK>
  __device__ static void accum(float (&acc)[ACC], const float (&x)[NK / 2],
                               uint32_t b, int lane) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int kk = 0; kk < NK / 8; ++kk) {  // keys 8 kk .. 8 kk + 7
      uint32_t ah[4], al[4];
      split_tf32(x[4 * kk], ah[0], al[0]);      // row g, key 2 t4
      split_tf32(x[4 * kk + 2], ah[1], al[1]);  // row g + 8, key 2 t4
      split_tf32(x[4 * kk + 1], ah[2], al[2]);  // row g, key 2 t4 + 1
      split_tf32(x[4 * kk + 3], ah[3], al[3]);  // row g + 8, key 2 t4 + 1
      const int k = 8 * kk + 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        // the loads of at most 4 accumulators ahead: K2e's registers
        if (n == 4) asm volatile("" ::: "memory");
        mma3(&acc[4 * n], ah, al, lds1(f32_at(b, NK, k, 8 * n + g)),
             lds1(f32_at(b, NK, k + 1, 8 * n + g)));
      }
    }
  }

  __device__ static void scale_rows(float (&acc)[ACC], float c_lo,
                                    float c_hi) {
#pragma unroll
    for (int n = 0; n < ACC / 4; ++n) {
      acc[4 * n] *= c_lo;
      acc[4 * n + 1] *= c_lo;
      acc[4 * n + 2] *= c_hi;
      acc[4 * n + 3] *= c_hi;
    }
  }

  __device__ static void store(float* o, long long st,
                               const float (&acc)[ACC], float den_lo,
                               float den_hi, int r_lo, int Tq, int c0,
                               int t4) {
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int n = 0; n < ACC / 4; ++n) {
      const int c = c0 + 8 * n + 2 * t4;
      if (r_lo < Tq)
        *reinterpret_cast<float2*>(o + r_lo * st + c) =
            make_float2(acc[4 * n] / den_lo, acc[4 * n + 1] / den_lo);
      if (r_hi < Tq)
        *reinterpret_cast<float2*>(o + r_hi * st + c) =
            make_float2(acc[4 * n + 2] / den_hi, acc[4 * n + 3] / den_hi);
    }
  }
};

// the unit tiles of the CTA's nu units, `rows` rows, at dst (unit u at
// + u rows 256): the TMA loads of each unit's two boxes, the CTA's columns
// from c0, at row r0 of head h, batch (or pool block) b
template <typename T>
__device__ __forceinline__ void load_units(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int rows, int nu,
                                           int c0, int r0, int h, int b) {
  constexpr int CW = Elem<T>::CW;
  for (int u = 0; u < nu; ++u)
#pragma unroll
    for (int bx = 0; bx < 2; ++bx)
      tma_load(dst + u * rows * kUnitRow + bx * rows * kBoxBytes, map, bar,
               c0 + (2 * u + bx) * CW, r0, h, b);
}

// ------------------------------------------------------ the forward

// one work item: batch (paged: slot), head, first row, the key tiles
// [0, kt1), rows at or past Tq neither read nor written, the causal shift
// (key c is allowed for row r iff c <= r + shift), limits clamped into
// [-1, lim_max]
struct Item {
  int b, h, q0, kt1, Tq, lim_max;
  long long shift;
};

__device__ __forceinline__ int row_limit(const Item& it, int row) {
  const long long lim = static_cast<long long>(row) + it.shift;
  return lim < -1 ? -1 : lim > it.lim_max ? it.lim_max
                                          : static_cast<int>(lim);
}

// K2a/K2b/K2c: dense [B, H, T, D] views, the key mask
template <typename T>
struct DenseKeys {
  using Params = FlashParams;

  __device__ static bool causal(const Params& p) { return p.causal != 0; }

  // item w: causal takes every head's last q tile first (longest first),
  // otherwise a head's q tiles are neighbours and share its K and V in L2
  __device__ static void item(const Params& p, int w, Item& it) {
    const int n_qt = (p.T + kItemRows - 1) / kItemRows;
    int bh, qt;
    if (p.causal) {
      qt = n_qt - 1 - w / p.BH;
      bh = w % p.BH;
    } else {
      bh = w / n_qt;
      qt = w % n_qt;
    }
    it.b = bh / p.H;
    it.h = bh % p.H;
    it.q0 = qt * kItemRows;
    const int n = (p.T + kTileRows - 1) / kTileRows;
    it.kt1 = n;
    if (p.causal) {
      const long long reach =
          static_cast<long long>(it.q0) + kItemRows - 1 + p.qk_shift;
      it.kt1 = reach < 0 ? 0
               : reach / kTileRows + 1 < n
                   ? static_cast<int>(reach / kTileRows + 1)
                   : n;
    }
    it.Tq = p.T;
    it.lim_max = p.T;
    it.shift = p.qk_shift;
  }

  __device__ static uint32_t tile_word(const Params& p, const Item& it,
                                       int k0, int lane) {
    const int key = k0 + lane;
    return __ballot_sync(
        0xffffffffu,
        key < p.T &&
            (p.mask == nullptr ||
             p.mask[static_cast<long long>(it.b) * p.mask_sb + key] != 0));
  }

  // K's and V's nu units from column c0 to kd and vd
  __device__ static void copy_tile(const Params&, const Item& it, int k0,
                                   int lane, uint32_t kd, uint32_t vd,
                                   uint32_t bar, const CUtensorMap* tk,
                                   const CUtensorMap* tv, int c0, int nu) {
    if (lane != 0) return;
    mbar_expect_tx(bar, 2 * nu * kUnitTile);
    load_units<T>(kd, tk, bar, kTileRows, nu, c0, k0, it.h, it.b);
    load_units<T>(vd, tv, bar, kTileRows, nu, c0, k0, it.h, it.b);
  }

  __device__ static T* out(const Params& p, const Item& it) {
    return static_cast<T*>(p.o) + it.b * p.o_sb + it.h * p.o_sh;
  }
  __device__ static long long out_stride(const Params& p) { return p.o_st; }
  __device__ static float* lse(const Params& p, const Item& it) {
    return p.lse == nullptr
               ? nullptr
               : p.lse + static_cast<long long>(it.b * p.H + it.h) * p.T;
  }
};

// K3's window kernel: q [S, H, w, D], the pools [NB, BL, H, D] through the
// block table; a trash entry, an id outside [1, NB) or a position past the
// table reads pool block NB, out of the map: zeros, no bytes from memory
template <typename T>
struct PagedKeys {
  using Params = PagedParams;

  __device__ static bool causal(const Params&) { return true; }

  __device__ static bool live(const Params& p, int blk) {
    return blk != kTrash && blk > 0 && blk < p.NB;
  }

  // item w: every (slot, head)'s last q tile first
  __device__ static void item(const Params& p, int w, Item& it) {
    const int n_qt = (p.w + kItemRows - 1) / kItemRows;
    const int SH = p.S * p.H;
    const int qt = n_qt - 1 - w / SH;
    it.b = (w % SH) / p.H;
    it.h = (w % SH) % p.H;
    it.q0 = qt * kItemRows;
    const int pos = p.pos[it.b];
    const long long cap = static_cast<long long>(p.MB) * p.BL;
    const long long last = min(it.q0 + kItemRows, p.w);
    const long long reach = min(static_cast<long long>(pos) + last, cap);
    it.kt1 = reach <= 0 ? 0
                        : static_cast<int>((reach + kTileRows - 1) /
                                           kTileRows);
    it.Tq = p.w;
    it.lim_max = static_cast<int>(cap);
    it.shift = pos;
  }

  __device__ static uint32_t tile_word(const Params& p, const Item& it,
                                       int k0, int lane) {
    const int t = k0 + lane;
    return __ballot_sync(
        0xffffffffu,
        t < p.MB * p.BL &&
            live(p, p.rows[static_cast<long long>(it.b) * p.MB + t / p.BL]));
  }

  // one box of R positions a pool block, the lanes taking blocks in turn;
  // K's and V's nu units from column c0 to kd and vd
  __device__ static void copy_tile(const Params& p, const Item& it, int k0,
                                   int lane, uint32_t kd, uint32_t vd,
                                   uint32_t bar, const CUtensorMap* tk,
                                   const CUtensorMap* tv, int c0, int nu) {
    constexpr int CW = Elem<T>::CW;
    if (lane == 0) mbar_expect_tx(bar, 2 * nu * kUnitTile);
    __syncwarp();
    const int* row_s = p.rows + static_cast<long long>(it.b) * p.MB;
    for (int j = lane; j < kTileRows / p.R; j += 32) {
      const int t = k0 + j * p.R;
      const int bi = t / p.BL;
      const int blk = bi < p.MB ? row_s[bi] : kTrash;
      const int nb = live(p, blk) ? blk : p.NB;
      const uint32_t off = j * p.R * kBoxBytes;
      for (int u = 0; u < nu; ++u)
#pragma unroll
        for (int bx = 0; bx < 2; ++bx) {
          const uint32_t at = u * kUnitTile + bx * kTileRows * kBoxBytes + off;
          const int col = c0 + (2 * u + bx) * CW;
          tma_load(kd + at, tk, bar, col, t % p.BL, it.h, nb);
          tma_load(vd + at, tv, bar, col, t % p.BL, it.h, nb);
        }
    }
  }

  __device__ static T* out(const Params& p, const Item& it) {
    return static_cast<T*>(p.o) + it.b * p.o_ss + it.h * p.o_sh;
  }
  __device__ static long long out_stride(const Params& p) { return p.o_sw; }
  __device__ static float* lse(const Params&, const Item&) { return nullptr; }
};

// The forward: a cluster of nc CTAs per work item (64 rows of one head),
// CTA r owning units 2r and 2r + 1 (one consumer warpgroup each; the last
// CTA one when the count is odd: its second warpgroup computes its half of
// S and writes nothing) and a
// producer warp that loads the item's Q unit tiles once, then streams K
// and V unit tiles of 32 keys through a ring of 3 stages with their
// validity words. Per tile warpgroup u computes its half of the keys of
// the CTA's partial S over both units, the exchange sums the CTAs', and
// each unit runs the online softmax and O_u += P V_u on the sum.
template <typename T, class Src>
__global__ void __launch_bounds__(2 * kWgThreads + 32, 1)
    wide_fwd(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const typename Src::Params p) {
  using L = FwdLayout<T>;
  constexpr int U = L::U, BK = kTileRows, KS = BK / U;
  using E = Engine<T, U>;
  constexpr int COLS = 2 * Elem<T>::CW;
  const int rank = blockIdx.x % p.nc;
  const int c0 = rank * U * COLS;             // this CTA's first column
  const int nu = min(U, p.units - rank * U);  // and its units
  constexpr int STAGES = L::STAGES;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, kv_s = base + L::O_STAGES;
  uint32_t* const meta =
      reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + L::O_META);
  const uint32_t bars = base + L::O_BARS;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const uint32_t ifull = bars + 8u * 2 * STAGES;
  const Xch xch{base + L::O_PART, ifull + 8, p.nc, rank};

  const int tid = threadIdx.x;
  Item it;
  Src::item(p, blockIdx.x / p.nc, it);
  const bool causal = Src::causal(p);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);       // the producer's arrival (+ the bytes)
      mbar_init(empty(s), 4 * U);  // lane 0 of each consumer warp
    }
    mbar_init(ifull, 1);
    for (int i = 0; i < 2; ++i) mbar_init(xch.full + 8 * i, p.nc);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers exist before any remote arrival

  if (tid >= U * kWgThreads) {
    // ------------------------------------------------------------ producer
    const int lane = tid - U * kWgThreads;
    if (lane == 0) {
      mbar_expect_tx(ifull, nu * kUnitItem);
      load_units<T>(q_s, &tq, ifull, kItemRows, nu, c0, it.q0, it.h, it.b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < it.kt1; ++kt) {
      const int k0 = kt * BK;
      const uint32_t wv = Src::tile_word(p, it, k0, lane);
      if (lane == 0) {
        mbar_wait(empty(stage), phase ^ 1);
        meta[4 * stage] = wv;
      }
      __syncwarp();
      if (wv) {
        const uint32_t kd = kv_s + stage * L::STAGE;
        Src::copy_tile(p, it, k0, lane, kd, kd + L::TILE, full(stage), &tk,
                       &tv, c0, nu);
      }
      else if (lane == 0)
        mbar_arrive(full(stage));  // no valid key: no copy, same list
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int wg = tid / kWgThreads, t = tid % kWgThreads;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale2 = p.scale * kLog2e;
    const int r_lo = it.q0 + warp * 16 + g, r_hi = r_lo + 8;
    const long long reach_first = it.q0 + it.shift;
    const long long reach_last = it.q0 + kItemRows - 1 + it.shift;
    // causal: key column 8j + e of this thread's pairs is allowed iff
    // 8j + e <= row limit - k0 - 2 * t4
    const int lim_lo = row_limit(it, r_lo) - 2 * t4;
    const int lim_hi = row_limit(it, r_hi) - 2 * t4;

    float acc[E::ACC];
#pragma unroll
    for (int i = 0; i < E::ACC; ++i) acc[i] = 0.f;
    float m_lo = kNeg, m_hi = kNeg;  // running max of the raw scores
    float l_lo = 0.f, l_hi = 0.f;    // this thread's share of the sum
    // the previous active tile's P, its row corrections and its stage: its
    // O += P V runs after this tile's partial is posted
    float pv[BK / 2], pc_lo = 1.f, pc_hi = 1.f;
    int p_stage = -1;
    auto flush_pv = [&]() {
      E::scale_rows(acc, pc_lo, pc_hi);
      if (wg < nu)
        E::template accum<BK>(
            acc, pv, kv_s + p_stage * L::STAGE + L::TILE + wg * kUnitTile,
            lane);
      release(empty(p_stage), lane);
    };
    mbar_wait(ifull, 0);
    int stage = 0, n_x = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < it.kt1; ++kt) {
      const int k0 = kt * BK;
      // a pending tile in the stage this one needs (the tiles between were
      // all skipped): its product first, or the producer could not refill
      if (p_stage == stage) flush_pv(), p_stage = -1;
      mbar_wait(full(stage), phase);
      const uint32_t w = meta[4 * stage];
      // every warpgroup of the cluster takes the same branch: the words
      // and the reach depend on the item and the tile alone
      if (w != 0 && (!causal || k0 <= reach_last)) {
        const uint32_t ks = kv_s + stage * L::STAGE;
        float s[BK / 2], sp[KS / 2];
        E::template scores<KS>(sp, q_s, kItemRows, ks, BK, wg * KS, nu, warp,
                               lane);
#pragma unroll
        for (int i = 0; i < KS / 2; ++i) s[wg * KS / 2 + i] = sp[i];
        post<BK / 2, U>(s, xch, wg, warp, lane, n_x);
        if (p_stage >= 0) flush_pv();
        finish<BK / 2>(s, xch, warp, lane, n_x++);
        const bool diag = causal && k0 + BK - 1 > reach_first;
        const bool all = !diag && w == 0xffffffffu;
        if (!all) {
          const int d_lo = lim_lo - k0, d_hi = lim_hi - k0;
          const uint32_t ws = w >> (2 * t4);
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool valid = (ws >> (8 * j + e)) & 1u;
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
            const float pa = ex2(fmaf(a, scale2, -ms_lo));
            const float pc = ex2(fmaf(c, scale2, -ms_hi));
            a = all || a > kNeg ? pa : 0.f;
            c = all || c > kNeg ? pc : 0.f;
            ps_lo += a;
            ps_hi += c;
          }
        }
        l_lo = l_lo * corr_lo + ps_lo;
        l_hi = l_hi * corr_hi + ps_hi;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) pv[i] = s[i];
        pc_lo = corr_lo;
        pc_hi = corr_hi;
        p_stage = stage;
      } else {
        release(empty(stage), lane);
      }
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    if (p_stage >= 0) flush_pv();
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    if (wg < nu)
      E::store(Src::out(p, it), Src::out_stride(p), acc,
               fmaxf(l_lo, 1e-35f), fmaxf(l_hi, 1e-35f), r_lo, it.Tq,
               c0 + wg * COLS, t4);
    // the lse once, from unit 0; natural-log units, -1e30 for no key
    float* lse = Src::lse(p, it);
    if (lse != nullptr && c0 + wg == 0 && t4 == 0) {
      if (r_lo < it.Tq)
        lse[r_lo] = l_lo > 0.f ? m_lo * p.scale + logf(l_lo) : kNeg;
      if (r_hi < it.Tq)
        lse[r_hi] = l_hi > 0.f ? m_hi * p.scale + logf(l_hi) : kNeg;
    }
  }
  cluster_sync();  // no CTA leaves while another may read its buffers
}

// ----------------------------------------------------- the backward

template <typename T>
__device__ __forceinline__ T* bwd_out_head(const BwdParams& p, int t,
                                           void* base, int b, int h) {
  return static_cast<T*>(base) + b * p.st[3 * t] + h * p.st[3 * t + 1];
}

// (b*h, tile) of work item w over n tiles a head: causal with the last
// tiles first (`last_first`) or the first tiles first, else head by head
__device__ __forceinline__ void bwd_item(const BwdParams& p, int w, int n,
                                         bool last_first, int& bh, int& t) {
  if (p.causal) {
    t = last_first ? n - 1 - w / p.BH : w / p.BH;
    bh = w % p.BH;
  } else {
    bh = w / n;
    t = w % n;
  }
}

// Each warpgroup's half (U = 2) of the keys of the CTA's partial S and dP
// into sd (S, then dP), over every unit of the CTA: the backward kernels'
// scores. a and da hold the 64-row tiles of Q and dO (K2e: K and V), b and
// db the 32-row ones of K and V (K2e: Q and dO).
template <typename T, int U>
__device__ __forceinline__ void bwd_scores(float (&sd)[kTileRows],
                                           uint32_t a, uint32_t da,
                                           uint32_t b, uint32_t db, int wg,
                                           int nu, int warp, int lane) {
  constexpr int KS = kTileRows / U;
  float sp[KS / 2];
  Engine<T, U>::template scores<KS>(sp, a, kItemRows, b, kTileRows, wg * KS,
                                    nu, warp, lane);
#pragma unroll
  for (int i = 0; i < KS / 2; ++i) sd[wg * KS / 2 + i] = sp[i];
  Engine<T, U>::template scores<KS>(sp, da, kItemRows, db, kTileRows,
                                    wg * KS, nu, warp, lane);
#pragma unroll
  for (int i = 0; i < KS / 2; ++i) sd[kTileRows / 2 + wg * KS / 2 + i] = sp[i];
}

// K2d: dq for 64 q rows of one (b, h); units as the forward's. The item's
// Q and dO unit tiles load once; K and V tiles of 32 keys stream through a
// ring of 3 stages with their validity words. Per tile the warpgroups
// compute the CTA's partial S and dP (half the keys each), the exchange
// sums both, and each unit runs dQ_u += dS K_u.
template <typename T>
__global__ void __launch_bounds__(DqLayout<T>::THREADS, 1)
    wide_dq(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using L = DqLayout<T>;
  constexpr int U = L::U, BK = kTileRows;
  using E = Engine<T, U>;
  constexpr int COLS = 2 * Elem<T>::CW;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t item_s = base, kv_s = base + L::O_STAGES;
  uint32_t* const meta =
      reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + L::O_META);
  const uint32_t bars = base + L::O_BARS;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::STAGES + s); };
  const uint32_t ifull = bars + 8u * 2 * L::STAGES;
  const int rank = blockIdx.x % p.nc;
  const Xch xch{base + L::O_PART, ifull + 8, p.nc, rank};

  const int tid = threadIdx.x;
  const int c0 = rank * U * COLS;
  const int nu = min(U, p.units - rank * U);
  const int T_ = p.T;
  const int n_qt = (T_ + kItemRows - 1) / kItemRows;
  const int n_kt = (T_ + BK - 1) / BK;
  int bh, qt;
  bwd_item(p, blockIdx.x / p.nc, n_qt, true, bh, qt);
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kItemRows;
  int n_tiles = n_kt;
  if (p.causal) {
    const long long reach =
        static_cast<long long>(q0) + kItemRows - 1 + p.qk_shift;
    n_tiles = reach < 0 ? 0
              : reach / BK + 1 < n_kt ? static_cast<int>(reach / BK + 1)
                                      : n_kt;
  }

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * U);
    }
    mbar_init(ifull, 1);
    for (int i = 0; i < 2; ++i) mbar_init(xch.full + 8 * i, p.nc);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (tid >= U * kWgThreads) {
    // ------------------------------------------------------------ producer
    const int lane = tid - U * kWgThreads;
    if (lane == 0) {
      mbar_expect_tx(ifull, 2 * nu * kUnitItem);
      load_units<T>(item_s, &tq, ifull, kItemRows, nu, c0, q0, h, b);
      load_units<T>(item_s + L::ITEM_TILE, &tdo, ifull, kItemRows, nu, c0,
                    q0, h, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * BK;
      const uint32_t wv =
          __ballot_sync(0xffffffffu, bwd_key_live(p, b, k0 + lane));
      if (lane == 0) {
        mbar_wait(empty(stage), phase ^ 1);
        meta[4 * stage] = wv;
        if (wv) {
          const uint32_t ks = kv_s + stage * L::STAGE;
          mbar_expect_tx(full(stage), 2 * nu * kUnitTile);
          load_units<T>(ks, &tk, full(stage), BK, nu, c0, k0, h, b);
          load_units<T>(ks + L::TILE, &tv, full(stage), BK, nu, c0, k0, h, b);
        } else {
          mbar_arrive(full(stage));
        }
      }
      __syncwarp();
      if (++stage == L::STAGES) stage = 0, phase ^= 1;
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int wg = tid / kWgThreads, t = tid % kWgThreads;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale2 = p.scale * kLog2e;
    const uint32_t qa = item_s, da = item_s + L::ITEM_TILE;
    const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
    const long long reach_first = q0 + p.qk_shift;
    const long long reach_last = q0 + kItemRows - 1 + p.qk_shift;
    auto limit = [&](int row) {
      const long long lim = static_cast<long long>(row) + p.qk_shift;
      return lim < -1 ? -1 : lim > T_ ? T_ : static_cast<int>(lim);
    };
    const int lim_lo = limit(r_lo) - 2 * t4, lim_hi = limit(r_hi) - 2 * t4;
    const float* lse = p.lse + static_cast<long long>(bh) * T_;
    const float* dsum = p.dsum + static_cast<long long>(bh) * T_;
    const float l2_lo = r_lo < T_ ? lse[r_lo] * kLog2e : 0.f;
    const float l2_hi = r_hi < T_ ? lse[r_hi] * kLog2e : 0.f;
    const float ds_lo = r_lo < T_ ? dsum[r_lo] : 0.f;
    const float ds_hi = r_hi < T_ ? dsum[r_hi] : 0.f;

    float acc[E::ACC];
#pragma unroll
    for (int i = 0; i < E::ACC; ++i) acc[i] = 0.f;
    // the previous active tile's dS and stage: its dQ += dS K runs after
    // this tile's partials are posted
    float dsp[BK / 2];
    int p_stage = -1;
    auto flush_dq = [&]() {
      if (wg < nu)
        E::template accum<BK>(acc, dsp,
                              kv_s + p_stage * L::STAGE + wg * kUnitTile,
                              lane);
      release(empty(p_stage), lane);
    };
    mbar_wait(ifull, 0);
    int stage = 0, n_x = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * BK;
      if (p_stage == stage) flush_dq(), p_stage = -1;  // as the forward's
      mbar_wait(full(stage), phase);
      const uint32_t w = meta[4 * stage];
      if (w != 0 && (!p.causal || k0 <= reach_last)) {
        const uint32_t ks = kv_s + stage * L::STAGE;
        float sd[BK];  // S, then dP
        bwd_scores<T, U>(sd, qa, da, ks, ks + L::TILE, wg, nu, warp, lane);
        post<BK, U>(sd, xch, wg, warp, lane, n_x);
        if (p_stage >= 0) flush_dq();
        finish<BK>(sd, xch, warp, lane, n_x++);
        float(&s)[BK / 2] = *reinterpret_cast<float(*)[BK / 2]>(&sd[0]);
        float(&dp)[BK / 2] = *reinterpret_cast<float(*)[BK / 2]>(&sd[BK / 2]);
        const bool diag = p.causal && k0 + BK - 1 > reach_first;
        const bool all = !diag && w == 0xffffffffu;
        const int d_lo = lim_lo - k0, d_hi = lim_hi - k0;
        const uint32_t ws = w >> (2 * t4);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool valid = (ws >> (8 * j + e)) & 1u;
            const bool ok_lo = all || (valid && (!diag || 8 * j + e <= d_lo));
            const bool ok_hi = all || (valid && (!diag || 8 * j + e <= d_hi));
            const float p_lo =
                ok_lo ? ex2(fmaf(s[4 * j + e], scale2, -l2_lo)) : 0.f;
            const float p_hi =
                ok_hi ? ex2(fmaf(s[4 * j + 2 + e], scale2, -l2_hi)) : 0.f;
            s[4 * j + e] = p_lo * (dp[4 * j + e] - ds_lo) * p.scale;  // ds
            s[4 * j + 2 + e] = p_hi * (dp[4 * j + 2 + e] - ds_hi) * p.scale;
          }
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) dsp[i] = s[i];
        p_stage = stage;
      } else {
        release(empty(stage), lane);
      }
      if (++stage == L::STAGES) stage = 0, phase ^= 1;
    }
    if (p_stage >= 0) flush_dq();
    if (wg < nu)
      E::store(bwd_out_head<T>(p, 4, p.dq, b, h), p.st[14], acc, 1.f, 1.f,
               r_lo, T_, c0 + wg * COLS, t4);
  }
  cluster_sync();
}

// K2e: dk and dv for 64 keys of one (b, h); units as the forward's (one a
// CTA in bf16), and no producer warp: its dK and dV take 64 (bf16: 128)
// registers a thread, and the 9 warps of a 2-unit CTA with a producer
// held a thread to 168 and spilled, where 8 allow 255. The item's K and V
// unit tiles load once; Q and dO tiles of 32 rows stream through a ring
// of 3 stages, warp 0 refilling a stage once every warp has released it,
// with the tile's lse (times log2 e; +inf past T, so p = 0 there) and
// dsum. Per tile the warpgroups compute the CTA's partial S^T and dP^T
// (half the q rows each), the exchange sums both, and each unit runs
// dV_u += P^T dO_u and dK_u += dS^T Q_u. An item with no valid key loads
// nothing and writes zeros.
template <typename T>
__global__ void __launch_bounds__(DkvLayout<T>::U * kWgThreads, 1)
    wide_dkv(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using L = DkvLayout<T>;
  constexpr int U = L::U, BQ = kTileRows;
  using E = Engine<T, U>;
  constexpr int COLS = 2 * Elem<T>::CW;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t item_s = base, q_s = base + L::O_STAGES;
  float* const meta =
      reinterpret_cast<float*>(smem_raw + (base - raw) + L::O_META);
  const uint32_t bars = base + L::O_BARS;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::STAGES + s); };
  const uint32_t ifull = bars + 8u * 2 * L::STAGES;
  const int rank = blockIdx.x % p.nc;
  const Xch xch{base + L::O_PART, ifull + 8, p.nc, rank};

  const int tid = threadIdx.x;
  const int c0 = rank * U * COLS;
  const int nu = min(U, p.units - rank * U);
  const int T_ = p.T;
  const int n_kt = (T_ + kItemRows - 1) / kItemRows;
  const int n_qt = (T_ + BQ - 1) / BQ;
  int bh, kt;
  bwd_item(p, blockIdx.x / p.nc, n_kt, false, bh, kt);
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = kt * kItemRows;
  // causal: the first q tile whose last row reaches key k0
  int qt0 = 0;
  if (p.causal) {
    const long long first = static_cast<long long>(k0) - p.qk_shift;
    qt0 = first <= 0 ? 0
          : first / BQ < n_qt ? static_cast<int>(first / BQ)
                              : n_qt;
  }
  bool any = false;  // a valid key in the item, the same in every thread
  for (int i = tid & 31; i < kItemRows; i += 32)
    any |= bwd_key_live(p, b, k0 + i);
  any = __any_sync(0xffffffffu, any);

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * U);
    }
    mbar_init(ifull, 1);
    for (int i = 0; i < 2; ++i) mbar_init(xch.full + 8 * i, p.nc);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  // warp 0 fills stage j % STAGES with q tile qt0 + j, once every warp
  // has released it from tile j - STAGES
  const float* const lse = p.lse + static_cast<long long>(bh) * T_;
  const float* const dsum = p.dsum + static_cast<long long>(bh) * T_;
  auto fill = [&](int j, int lane) {
    const int stage = j % L::STAGES, q0 = (qt0 + j) * BQ;
    if (j >= L::STAGES) mbar_wait(empty(stage), ((j / L::STAGES) & 1) ^ 1);
    float* m = meta + stage * 2 * BQ;
    const int r = q0 + lane;
    m[lane] = r < T_ ? lse[r] * kLog2e : __int_as_float(0x7f800000);
    m[BQ + lane] = r < T_ ? dsum[r] : 0.f;
    __syncwarp();
    if (lane == 0) {
      const uint32_t qs = q_s + stage * L::STAGE;
      mbar_expect_tx(full(stage), 2 * nu * kUnitTile);
      load_units<T>(qs, &tq, full(stage), BQ, nu, c0, q0, h, b);
      load_units<T>(qs + L::TILE, &tdo, full(stage), BQ, nu, c0, q0, h, b);
    }
  };
  if (any && tid < 32) {
    if (tid == 0) {
      mbar_expect_tx(ifull, 2 * nu * kUnitItem);
      load_units<T>(item_s, &tk, ifull, kItemRows, nu, c0, k0, h, b);
      load_units<T>(item_s + L::ITEM_TILE, &tv, ifull, kItemRows, nu, c0, k0,
                    h, b);
    }
    for (int j = 0; j < L::STAGES && qt0 + j < n_qt; ++j) fill(j, tid);
  }
  {
    // ----------------------------------------------------------- consumers
    const int wg = tid / kWgThreads, t = tid % kWgThreads;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale2 = p.scale * kLog2e;
    const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
    float dk[E::ACC], dv[E::ACC];
#pragma unroll
    for (int i = 0; i < E::ACC; ++i) dk[i] = dv[i] = 0.f;
    if (any) {
      const uint32_t ka = item_s, va = item_s + L::ITEM_TILE;
      const bool kval_lo = bwd_key_live(p, b, key_lo);
      const bool kval_hi = bwd_key_live(p, b, key_hi);
      // causal: the first local query row that may attend a key, clamped
      // into [0, T]; query column 8j + e of this thread's pairs may see
      // its key iff 8j + e >= that row - q0 - 2 * t4
      auto first_row = [&](int key) {
        const long long f = static_cast<long long>(key) - p.qk_shift;
        return f < 0 ? 0 : f > T_ ? T_ : static_cast<int>(f);
      };
      const int f_lo = first_row(key_lo) - 2 * t4;
      const int f_hi = first_row(key_hi) - 2 * t4;
      const int f_first = first_row(k0), f_last = first_row(k0 + 63);
      // this unit's dV += P^T dO and dK += dS^T Q, then the stage is free
      auto products = [&](const float (&pt)[BQ / 2], const float (&ds)[BQ / 2],
                          int st) {
        const uint32_t qs = q_s + st * L::STAGE;
        if (wg < nu) {
          E::template accum<BQ>(dv, pt, qs + L::TILE + wg * kUnitTile, lane);
          E::template accum<BQ>(dk, ds, qs + wg * kUnitTile, lane);
        }
        release(empty(st), lane);
      };
      mbar_wait(ifull, 0);
      int stage = 0, n_x = 0;
      uint32_t phase = 0;
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        mbar_wait(full(stage), phase);
        if (!p.causal || q0 + BQ - 1 >= f_first) {
          const uint32_t qs = q_s + stage * L::STAGE;
          const uint32_t dos = qs + L::TILE;
          float sd[BQ];  // S^T, then dP^T: rows keys, columns q rows
          bwd_scores<T, U>(sd, ka, va, qs, dos, wg, nu, warp, lane);
          post<BQ, U>(sd, xch, wg, warp, lane, n_x);
          finish<BQ>(sd, xch, warp, lane, n_x++);
          float(&st)[BQ / 2] = *reinterpret_cast<float(*)[BQ / 2]>(&sd[0]);
          float(&dpt)[BQ / 2] =
              *reinterpret_cast<float(*)[BQ / 2]>(&sd[BQ / 2]);
          const float* m = meta + stage * 2 * BQ;
          const bool diag = p.causal && q0 < f_last;
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
          products(st, dpt, stage);
        } else {
          release(empty(stage), lane);
        }
        if (tid < 32 && qt + L::STAGES < n_qt)
          fill(qt - qt0 + L::STAGES, lane);
        if (++stage == L::STAGES) stage = 0, phase ^= 1;
      }
    }
    if (wg < nu) {
      E::store(bwd_out_head<T>(p, 5, p.dk, b, h), p.st[17], dk, 1.f, 1.f,
               key_lo, T_, c0 + wg * COLS, t4);
      E::store(bwd_out_head<T>(p, 6, p.dv, b, h), p.st[20], dv, 1.f, 1.f,
               key_lo, T_, c0 + wg * COLS, t4);
    }
  }
  cluster_sync();
}

// ------------------------------------------------------ cluster launch

// a rank-4 tensor map over a strided [B, H, T, D] view of T's type
// (strides in elements), boxes of 128 bytes of columns by `rows` rows,
// 128-byte swizzle; rows past T read as zeros. Cached as encode_view's.
int encode_wide(CUtensorMap* map, const void* ptr, int dtype, int B, int H,
                int T, int D, long long sb, long long sh, long long st,
                int rows) {
  const int es = dtype == 0 ? 2 : 4;
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.ptr = ptr, key.b = B, key.h = H, key.t = T;
  key.sb = sb, key.sh = sh, key.st = st, key.rows = rows;
  key.d = 2 * static_cast<long long>(D) + dtype;
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
  const long long given[3] = {st * es, sh * es, sb * es};
  cuuint64_t strides[3];
  cuuint64_t span = static_cast<cuuint64_t>(D) * es;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? span : static_cast<cuuint64_t>(given[i]);
    span = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBoxBytes / es),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map,
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kErrEncodeBase - static_cast<int>(res);
  MapSlot& slot = g_maps[g_next_slot];
  g_next_slot = (g_next_slot + 1) % kMapSlots;
  slot.key = key, slot.map = *map, slot.used = true;
  return 0;
}

// Launch `kernel` (arguments `args`) over `ctas` CTAs of `threads` in
// clusters of nc along x, with `smem` bytes of dynamic shared memory (the
// most a CTA may have is opted in once per kernel and device). Returns a
// cudaError_t.
int cluster_launch(const void* kernel, void** args, int nc, long long ctas,
                   int threads, int smem, unsigned long long& opted,
                   cudaStream_t s) {
  if (ctas < 1 || ctas > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    // clusters of 9-16 CTAs: the H100's non-portable sizes
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted |= bit;
  }
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(static_cast<unsigned>(ctas), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the head dim's units (128 columns in bf16, 64 in f32), and whether the
// wrapper's plan of nc CTAs of U units covers them exactly within
// kMaxCluster (the plan is the wrapper's, flash_attention.wide_plan; this
// only refuses one that does not fit the kernel)
template <typename T, typename P>
bool take_plan(P& p, int U) {
  constexpr int cols = 2 * Elem<T>::CW;
  p.units = p.D / cols;
  return p.D % cols == 0 && p.nc >= 1 && p.nc <= kMaxCluster &&
         (p.nc - 1) * U < p.units && p.units <= p.nc * U;
}

template <typename T>
int cluster_fwd(FlashParams p, int B, cudaStream_t s) {
  using L = FwdLayout<T>;
  const int dt = Elem<T>::CODE;
  if (!take_plan<T>(p, L::U)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = encode_wide(&tq, p.q, dt, B, p.H, p.T, p.D, p.q_sb, p.q_sh,
                        p.q_st, kItemRows);
  if (err == 0)
    err = encode_wide(&tk, p.k, dt, B, p.H, p.T, p.D, p.k_sb, p.k_sh, p.k_st,
                      kTileRows);
  if (err == 0)
    err = encode_wide(&tv, p.v, dt, B, p.H, p.T, p.D, p.v_sb, p.v_sh, p.v_st,
                      kTileRows);
  if (err != 0) return err;
  static unsigned long long opted = 0;
  void* args[] = {&tq, &tk, &tv, &p};
  const long long items =
      static_cast<long long>(p.BH) * ((p.T + kItemRows - 1) / kItemRows);
  return cluster_launch(
      reinterpret_cast<const void*>(wide_fwd<T, DenseKeys<T>>), args, p.nc,
      items * p.nc, L::THREADS, L::SMEM, opted, s);
}

template <typename T>
int cluster_paged(PagedParams p, cudaStream_t s) {
  using L = FwdLayout<T>;
  const int dt = Elem<T>::CODE;
  if (!take_plan<T>(p, L::U)) return static_cast<int>(cudaErrorInvalidValue);
  // boxes of R = gcd(BL, 32) positions of a pool block
  int R = kTileRows;
  while (p.BL % R != 0) R >>= 1;
  p.R = R;
  CUtensorMap tq, tk, tv;
  const long long st = static_cast<long long>(p.H) * p.D;
  int err = encode_wide(&tq, p.q, dt, p.S, p.H, p.w, p.D, p.q_ss, p.q_sh,
                        p.q_sw, kItemRows);
  if (err == 0)
    err = encode_wide(&tk, p.k_pool, dt, p.NB, p.H, p.BL, p.D, p.BL * st,
                      p.D, st, R);
  if (err == 0)
    err = encode_wide(&tv, p.v_pool, dt, p.NB, p.H, p.BL, p.D, p.BL * st,
                      p.D, st, R);
  if (err != 0) return err;
  static unsigned long long opted = 0;
  void* args[] = {&tq, &tk, &tv, &p};
  const long long items = static_cast<long long>(p.S) * p.H *
                          ((p.w + kItemRows - 1) / kItemRows);
  return cluster_launch(
      reinterpret_cast<const void*>(wide_fwd<T, PagedKeys<T>>), args, p.nc,
      items * p.nc, L::THREADS, L::SMEM, opted, s);
}

template <typename T>
int cluster_bwd(BwdParams p, int dkv, int B, cudaStream_t s) {
  const int dt = Elem<T>::CODE;
  if (!take_plan<T>(p, dkv ? DkvLayout<T>::U : DqLayout<T>::U))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long(&st)[21] = p.st;
  // K2d: Q and dO are the item's tiles, K and V stream; K2e the reverse
  const int rq = dkv ? kTileRows : kItemRows;
  const int rk = dkv ? kItemRows : kTileRows;
  CUtensorMap tq, tdo, tk, tv;
  int err = encode_wide(&tq, p.q, dt, B, p.H, p.T, p.D, st[0], st[1], st[2],
                        rq);
  if (err == 0)
    err = encode_wide(&tdo, p.dout, dt, B, p.H, p.T, p.D, st[9], st[10],
                      st[11], rq);
  if (err == 0)
    err = encode_wide(&tk, p.k, dt, B, p.H, p.T, p.D, st[3], st[4], st[5],
                      rk);
  if (err == 0)
    err = encode_wide(&tv, p.v, dt, B, p.H, p.T, p.D, st[6], st[7], st[8],
                      rk);
  if (err != 0) return err;
  void* args[] = {&tq, &tdo, &tk, &tv, &p};
  const long long items =
      static_cast<long long>(p.BH) * ((p.T + kItemRows - 1) / kItemRows);
  if (dkv) {
    using L = DkvLayout<T>;
    static unsigned long long opted = 0;
    return cluster_launch(reinterpret_cast<const void*>(wide_dkv<T>), args,
                          p.nc, items * p.nc, L::U * kWgThreads, L::SMEM,
                          opted, s);
  }
  using L = DqLayout<T>;
  static unsigned long long opted = 0;
  return cluster_launch(reinterpret_cast<const void*>(wide_dq<T>), args,
                        p.nc, items * p.nc, L::THREADS, L::SMEM, opted, s);
}
bool bad_grid(long long x, long long rows) {
  return x > 0x7fffffffLL || (rows + kRows - 1) / kRows > 65535;
}

}  // namespace

extern "C" {

// The forward (K2a: lse null, causal 0; K2b: lse a contiguous [B, H, T]
// f32 buffer; K2c: causal 1, with or without the lse) at a head dim D that
// is a multiple of 128. ctas > 0: the cluster kernel in clusters of that
// many CTAs (flash_attention.wide_plan; refused unless they cover D's
// units, two a CTA); 0: the split kernel, in D / 128 chunks. Arguments as
// mmlspark_flash_launch's (flash_attn.cu); q, k, v rows need 16-byte
// alignment. Returns 0, the launch's cudaError_t or a negative code of the
// tensor-map encoding.
int mmlspark_wide_flash_launch(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    float* lse, int dtype, int B, int H, int T, int D, long long q_sb,
    long long q_sh, long long q_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st, long long mask_sb,
    float scale, int causal, long long q_offset, long long k_offset,
    int ctas, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || T < 1 ||
      bad_grid(static_cast<long long>(B) * H, T))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p;
  p.q = q, p.k = k, p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.o = o, p.lse = lse;
  p.H = H, p.T = T, p.BH = B * H, p.D = D;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_st = q_st;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_st = k_st;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_st = v_st;
  p.o_sb = o_sb, p.o_sh = o_sh, p.o_st = o_st;
  p.mask_sb = mask_sb;
  p.qk_shift = q_offset - k_offset;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas > 0) {
    p.nc = ctas;
    return dtype == 0 ? cluster_fwd<__nv_bfloat16>(p, B, s)
                      : cluster_fwd<float>(p, B, s);
  }
  if (bad_dim(D)) return static_cast<int>(cudaErrorInvalidValue);
  p.nc = D / kDC;
  return dtype == 0 ? split_launch_fwd<__nv_bfloat16>(p, B * H, s)
                    : split_launch_fwd<float>(p, B * H, s);
}

// K2d (dkv 0) or K2e (dkv 1) at a head dim D that is a multiple of 128,
// `ctas` as for mmlspark_wide_flash_launch (K2e in bf16: one unit a CTA).
// Arguments as
// mmlspark_flash_bwd_launch's (flash_bwd.cu).
int mmlspark_wide_bwd_launch(
    int dkv, const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const float* lse, const float* dsum, void* dq,
    void* dk, void* dv, int dtype, int B, int H, int T, int D,
    const long long* strides, long long mask_sb, float scale, int causal,
    long long q_offset, long long k_offset, int ctas, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || (dkv != 0 && dkv != 1) || B < 1 ||
      H < 1 || T < 1 || bad_grid(static_cast<long long>(B) * H, T))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = q, p.k = k, p.v = v, p.dout = dout;
  p.mask = static_cast<const uint8_t*>(mask);
  p.lse = lse, p.dsum = dsum;
  p.dq = dq, p.dk = dk, p.dv = dv;
  p.H = H, p.T = T, p.BH = B * H, p.D = D;
  for (int i = 0; i < 21; ++i) p.st[i] = strides[i];
  p.mask_sb = mask_sb;
  p.qk_shift = q_offset - k_offset;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas > 0) {
    p.nc = ctas;
    return dtype == 0 ? cluster_bwd<__nv_bfloat16>(p, dkv, B, s)
                      : cluster_bwd<float>(p, dkv, B, s);
  }
  if (bad_dim(D)) return static_cast<int>(cudaErrorInvalidValue);
  p.nc = D / kDC;
  return dtype == 0 ? split_launch_bwd<__nv_bfloat16>(p, dkv, B * H, s)
                    : split_launch_bwd<float>(p, dkv, B * H, s);
}

// K3's window kernel at a pool head dim D that is a multiple of 128,
// `ctas` as for mmlspark_wide_flash_launch. Arguments as
// mmlspark_paged_launch's (paged_attn.cu); the pools contiguous and
// 16-byte aligned.
int mmlspark_wide_paged_launch(const void* q, const void* k_pool,
                               const void* v_pool, const int* rows,
                               const int* pos, void* o, int dtype, int S,
                               int H, int w, int D, int NB, int BL, int MB,
                               long long q_ss, long long q_sh, long long q_sw,
                               long long o_ss, long long o_sh, long long o_sw,
                               float scale, int ctas, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || S < 1 || H < 1 || w < 1 || NB < 1 ||
      BL < 1 || MB < 1 || bad_grid(static_cast<long long>(S) * H, w) ||
      static_cast<long long>(MB) * BL + w > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  PagedParams p;
  p.q = q, p.k_pool = k_pool, p.v_pool = v_pool;
  p.rows = rows, p.pos = pos, p.o = o;
  p.H = H, p.w = w, p.NB = NB, p.BL = BL, p.MB = MB, p.D = D, p.S = S;
  p.q_ss = q_ss, p.q_sh = q_sh, p.q_sw = q_sw;
  p.o_ss = o_ss, p.o_sh = o_sh, p.o_sw = o_sw;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas > 0) {
    p.nc = ctas;
    return dtype == 0 ? cluster_paged<__nv_bfloat16>(p, s)
                      : cluster_paged<float>(p, s);
  }
  if (bad_dim(D)) return static_cast<int>(cudaErrorInvalidValue);
  p.nc = D / kDC;
  return dtype == 0 ? split_launch_paged<__nv_bfloat16>(p, S * H, s)
                    : split_launch_paged<float>(p, S * H, s);
}

const char* mmlspark_wide_error_string(int err) {
  return launch_error_string(err);
}

}  // extern "C"
