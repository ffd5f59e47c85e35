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
// The split over D. The softmax needs S = Q K^T summed over the whole head
// dim before any output column exists, so the split is inside the kernels:
// the grid gains a D-chunk axis (blockIdx.z) of kDC = 128 columns (128
// divides every padded width above 256, and 256 in f32). Each CTA reduces S
// (and in the backward dP = dO V^T) over every chunk, staging one 32 x 128
// f32 tile of K (V) at a time in shared memory and walking the chunks so
// that its own comes last, then writes only its own chunk: O in the
// forward, dQ in K2d, dK and dV in K2e. The masks, the lse and dsum are the
// same in every chunk; only chunk 0 writes the lse. Every output element has
// one writer and no atomics, so two launches give the same bits.
//
// What bounds it: operations. Each of the D / 128 CTAs of a row tile
// recomputes S over the whole D, so the products cost (D / 128 + 1) / 2
// times the unsplit kernel's at the same tiles, on the CUDA cores (FMA from
// shared memory in f32, 67 TFLOP/s on an H100 SXM, NVIDIA data sheet) rather
// than the tensor cores. Right and simple first: these instances carry no
// path the repo ships (every shipped model has a head dim of 256 or less);
// their times are recorded in PERF.md and not gated.
//
// Layout: 128 threads, 8 per row (a thread holds columns part + 8 i of a
// chunk, i < 16: the 8 threads of a row read 8 consecutive banks), 16 rows
// of a tile per CTA. Tiles of 32 keys in the forward and K2d, of 16 query
// rows in K2e (16 keys per CTA). The only limit on D is the grid's
// z-extent (65,535 chunks); shared memory does not grow with D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // the TPU kernels' _NEG
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
    wide_fwd(const __grid_constant__ P p) {
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
    wide_dq(const __grid_constant__ BwdParams p) {
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
    wide_dkv(const __grid_constant__ BwdParams p) {
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
int launch_fwd(const FlashParams& p, int BH, cudaStream_t s) {
  const dim3 grid(BH, (p.T + kRows - 1) / kRows, p.nc);
  wide_fwd<T, Dense, FlashParams><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const BwdParams& p, int dkv, int BH, cudaStream_t s) {
  const dim3 grid(BH, (p.T + kRows - 1) / kRows, p.nc);
  if (dkv)
    wide_dkv<T><<<grid, kThreads, 0, s>>>(p);
  else
    wide_dq<T><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_paged(const PagedParams& p, int SH, cudaStream_t s) {
  const dim3 grid(SH, (p.w + kRows - 1) / kRows, p.nc);
  wide_fwd<T, Paged, PagedParams><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool bad_grid(long long x, long long rows) {
  return x > 0x7fffffffLL || (rows + kRows - 1) / kRows > 65535;
}

}  // namespace

extern "C" {

// The forward (K2a: lse null, causal 0; K2b: lse a contiguous [B, H, T]
// f32 buffer; K2c: causal 1, with or without the lse) at a head dim D that
// is a multiple of 128, in D / 128 chunks. Arguments as
// mmlspark_flash_launch's (flash_attn.cu); q, k, v rows need 16-byte
// alignment. Returns 0 or the launch's cudaError_t.
int mmlspark_wide_flash_launch(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    float* lse, int dtype, int B, int H, int T, int D, long long q_sb,
    long long q_sh, long long q_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st, long long mask_sb,
    float scale, int causal, long long q_offset, long long k_offset,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || T < 1 || bad_dim(D) ||
      bad_grid(static_cast<long long>(B) * H, T))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p;
  p.q = q, p.k = k, p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.o = o, p.lse = lse;
  p.H = H, p.T = T, p.nc = D / kDC;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_st = q_st;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_st = k_st;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_st = v_st;
  p.o_sb = o_sb, p.o_sh = o_sh, p.o_st = o_st;
  p.mask_sb = mask_sb;
  p.qk_shift = q_offset - k_offset;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_fwd<__nv_bfloat16>(p, B * H, s)
                    : launch_fwd<float>(p, B * H, s);
}

// K2d (dkv 0) or K2e (dkv 1) at a head dim D that is a multiple of 128.
// Arguments as mmlspark_flash_bwd_launch's (flash_bwd.cu).
int mmlspark_wide_bwd_launch(
    int dkv, const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const float* lse, const float* dsum, void* dq,
    void* dk, void* dv, int dtype, int B, int H, int T, int D,
    const long long* strides, long long mask_sb, float scale, int causal,
    long long q_offset, long long k_offset, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || T < 1 || bad_dim(D) ||
      bad_grid(static_cast<long long>(B) * H, T))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = q, p.k = k, p.v = v, p.dout = dout;
  p.mask = static_cast<const uint8_t*>(mask);
  p.lse = lse, p.dsum = dsum;
  p.dq = dq, p.dk = dk, p.dv = dv;
  p.H = H, p.T = T, p.nc = D / kDC;
  for (int i = 0; i < 21; ++i) p.st[i] = strides[i];
  p.mask_sb = mask_sb;
  p.qk_shift = q_offset - k_offset;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bwd<__nv_bfloat16>(p, dkv, B * H, s)
                    : launch_bwd<float>(p, dkv, B * H, s);
}

// K3's window kernel at a pool head dim D that is a multiple of 128.
// Arguments as mmlspark_paged_launch's (paged_attn.cu).
int mmlspark_wide_paged_launch(const void* q, const void* k_pool,
                               const void* v_pool, const int* rows,
                               const int* pos, void* o, int dtype, int S,
                               int H, int w, int D, int NB, int BL, int MB,
                               long long q_ss, long long q_sh, long long q_sw,
                               long long o_ss, long long o_sh, long long o_sw,
                               float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || S < 1 || H < 1 || w < 1 || NB < 1 ||
      BL < 1 || MB < 1 || bad_dim(D) ||
      bad_grid(static_cast<long long>(S) * H, w) ||
      static_cast<long long>(MB) * BL + w > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  PagedParams p;
  p.q = q, p.k_pool = k_pool, p.v_pool = v_pool;
  p.rows = rows, p.pos = pos, p.o = o;
  p.H = H, p.w = w, p.NB = NB, p.BL = BL, p.MB = MB, p.D = D;
  p.nc = D / kDC;
  p.q_ss = q_ss, p.q_sh = q_sh, p.q_sw = q_sw;
  p.o_ss = o_ss, p.o_sh = o_sh, p.o_sw = o_sw;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_paged<__nv_bfloat16>(p, S * H, s)
                    : launch_paged<float>(p, S * H, s);
}

const char* mmlspark_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
