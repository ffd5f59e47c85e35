// K2d and K2e: the fused flash-attention backward (key mask; causal or
// not), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` (K2d,
// mmlspark_tpu/dl/pallas_attention.py:350, launched at :462) and
// `_bwd_dkv_kernel` (K2e, :388, launched at :483), with their causal
// branches, which `_flash_backward` (:435) runs for the custom VJP of
// `flash_attention` and `flash_attention_lse`. For q, k, v, dO [B, H, T, D] (any batch, head and
// row strides; unit stride on D), a key mask [B, T] (nonzero = valid; null
// = all valid), and per-row f32 lse and dsum [B, H, T] (contiguous), with
// scale = D^-0.5:
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
// Design (right and simple first; wgmma, TMA, ldmatrix and pipelining are
// later work):
//  - bf16: one CTA of 4 warps, each warp owning 16 rows of the CTA's tile,
//    all products as mma.sync.m16n8k16 bf16 -> f32. The score accumulator's
//    register layout is the A operand of the next product, so p and ds
//    never leave registers (K2a's trick for its PV product).
//    K2d: a CTA per (b*h, 64-row q tile) loops over 64-key tiles, as K2a.
//    K2e: a CTA per (b*h, 64-key tile) loops over 64-row q tiles and
//    computes the transposed products s^T = k . q^T and dp^T = v . dO^T, so
//    its rows are keys and p^T, ds^T are again A operands in registers. No
//    atomics: each CTA owns its dk/dv rows, the result is deterministic,
//    and the TPU's two-kernel split is kept.
//    The CTA's own tile (q and dO in K2d, k and v in K2e) is staged in
//    shared memory once and its A fragments are read from there at each
//    use: with them in registers beside the accumulators, K2e at D=128
//    would need ~256 registers a thread. Streamed tiles are staged
//    row-major with 8 elements of padding a row (conflict-free 32-bit
//    fragment loads); the operands that the last product needs transposed
//    (k in K2d; dO and q in K2e) are read as two 16-bit loads per register,
//    which the padding also keeps conflict-free. At D=128 the four tiles
//    take 69.6 KB: dynamic shared memory.
//  - f32 (the tight check of the same algorithm): 4 threads per row, 32-row
//    tiles, plain FMA in f32, one key (K2d) or query (K2e) at a time.
//  - Key tiles with no valid key are skipped in K2d (their p is 0, so the
//    skip is exact); a K2e CTA whose 64 keys are all invalid writes zeros.
//  - Causal: a K2d CTA loops only over the key tiles its last row reaches,
//    n_reach = clamp(floor((q0 + BQ - 1 + shift) / BK) + 1, 0, nk) with
//    shift = q_offset - k_offset (the forward's bound, flash_attn.cu); a K2e
//    CTA starts its q-tile loop at the first tile whose last row reaches
//    its first key, clamp(floor((k0 - shift) / BQ), 0, nq), the mirror of
//    `_block_reachable`. Both floors are signed and on 64-bit values, so
//    offsets need not be multiples of the tile and may exceed T. Inside a
//    tile each pair is tested on its global positions, as a compare of the
//    fragment's column with a per-thread constant (the forward's trick).
//  - The ragged tail is bounds-checked and staged as zeros (0 * garbage
//    cannot make NaN); rows past T of lse and dsum are never read.
//  - dq, dk and dv are written through their own strides, so the wrapper
//    hands back [B, H, T, D] views of [B, T, H, D] buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile16 = 16 * kWarps;  // rows per bf16 tile (q or keys)
constexpr int kTile32 = kThreads / 4; // rows per f32 tile (4 threads a row)

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
  int H, T;
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// two bf16 from two rows of a tile -> one fragment register (lo in the low
// half), for an operand read transposed
__device__ __forceinline__ uint32_t ld_pair(const bf16* lo, const bf16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

// two f32 -> one register of two bf16 (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// rows [r0, r0 + kTile16) of a [T, D] head (row stride st) into a padded
// [kTile16][D + 8] tile; rows past T become zeros
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long st, int r0, int T,
                                           int tid) {
  constexpr int KP = D + 8, VEC = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < kTile16 * VEC; i += kThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T)
      x = *reinterpret_cast<const uint4*>(src + (r0 + r) * st + c);
    *reinterpret_cast<uint4*>(&dst[r * KP + c]) = x;
  }
}

// A fragment (16 rows of this warp x 16 columns at kk*16) of a padded tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int warp, int g, int t4, int kk) {
  constexpr int KP = D + 8;
  const bf16* x = &tile[(warp * 16 + g) * KP + kk * 16 + t4 * 2];
  a[0] = ld32(x);
  a[1] = ld32(x + 8 * KP);
  a[2] = ld32(x + 8);
  a[3] = ld32(x + 8 * KP + 8);
}

// c[8][4] (16 rows x 64 columns) += A(tile rows of this warp) . B^T, with B
// the 64 rows of `other`: the score-shaped products s, dp (K2d) and s^T,
// dp^T (K2e)
template <int D>
__device__ __forceinline__ void scores(float (&c)[8][4], const bf16* mine,
                                       const bf16* other, int warp, int g,
                                       int t4) {
  constexpr int KP = D + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<D>(a, mine, warp, g, t4, kk);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const bf16* r = &other[(n * 8 + g) * KP + kk * 16 + t4 * 2];
      mma_bf16(c[n], a, ld32(r), ld32(r + 8));
    }
  }
}

// acc[D/8][4] (16 rows x D) += X . Y, X the 16 x 64 score-shaped registers
// rounded to bf16, Y the padded [64][D + 8] tile (rows = X's columns)
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[8][4],
                                           const bf16* y, int g, int t4) {
  constexpr int KP = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                           pack_bf16(x[2 * j][2], x[2 * j][3]),
                           pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* c = &y[(j * 16 + t4 * 2) * KP + n * 8 + g];
      mma_bf16(acc[n], a, ld_pair(c, c + KP), ld_pair(c + 8 * KP, c + 9 * KP));
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long st,
                                           const float (&acc)[D / 8][4],
                                           int r_lo, int T, int t4) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r_lo < T)
      *reinterpret_cast<uint32_t*>(base + r_lo * st + c) =
          pack_bf16(acc[n][0], acc[n][1]);
    if (r_hi < T)
      *reinterpret_cast<uint32_t*>(base + r_hi * st + c) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
constexpr int smem_bf16() {
  return 4 * kTile16 * (D + 8) * 2 + 2 * kTile16 * 4 + kTile16;
}

// K2d: dq for one (b*h, 64-row q tile)
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads) bwd_dq_bf16(const Params p) {
  constexpr int KP = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kTile16 * KP;
  bf16* ks = dos + kTile16 * KP;
  bf16* vs = ks + kTile16 * KP;
  uint8_t* allowed = reinterpret_cast<uint8_t*>(vs + kTile16 * KP);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int T = p.T;
  const int q0 = blockIdx.y * kTile16;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;

  const bf16* kb = head_ptr<const bf16>(p.k, p, kK, b, h);
  const bf16* vb = head_ptr<const bf16>(p.v, p, kV, b, h);
  const float* lse = p.lse + static_cast<long long>(bh) * T;
  const float* dsum = p.dsum + static_cast<long long>(bh) * T;
  const float lse_lo = r_lo < T ? lse[r_lo] : 0.f;
  const float lse_hi = r_hi < T ? lse[r_hi] : 0.f;
  const float dsum_lo = r_lo < T ? dsum[r_lo] : 0.f;
  const float dsum_hi = r_hi < T ? dsum[r_hi] : 0.f;
  stage_rows<D>(qs, head_ptr<const bf16>(p.q, p, kQ, b, h), p.st[kQ][2], q0,
                T, tid);
  stage_rows<D>(dos, head_ptr<const bf16>(p.dout, p, kDO, b, h),
                p.st[kDO][2], q0, T, tid);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // causal: the last local key each of this thread's rows may attend
  const int lim_lo = row_limit(p, r_lo), lim_hi = row_limit(p, r_hi);
  int n_tiles = (T + kTile16 - 1) / kTile16;
  if (kCausal) n_tiles = reach_tiles(p, q0 + kTile16 - 1, kTile16, n_tiles);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile16;
    __syncthreads();  // the previous tile is consumed
    const bool ok = tid < kTile16 && key_valid(p, b, k0 + tid);
    if (tid < kTile16) allowed[tid] = ok;
    if (!__syncthreads_or(ok)) continue;  // all keys invalid: p = 0
    stage_rows<D>(ks, kb, p.st[kK][2], k0, T, tid);
    stage_rows<D>(vs, vb, p.st[kV][2], k0, T, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
    scores<D>(s, qs, ks, warp, g, t4);
    scores<D>(dp, dos, vs, warp, g, t4);
    // causal: key n * 8 + e of this thread's columns is allowed for a row
    // iff n * 8 + e <= that row's limit less k0 + t4 * 2
    const int d_lo = lim_lo - k0 - t4 * 2, d_hi = lim_hi - k0 - t4 * 2;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = allowed[n * 8 + t4 * 2 + e];
        const bool ok_lo = valid && (!kCausal || n * 8 + e <= d_lo);
        const bool ok_hi = valid && (!kCausal || n * 8 + e <= d_hi);
        const float pl = ok_lo ? expf(s[n][e] * p.scale - lse_lo) : 0.f;
        const float ph = ok_hi ? expf(s[n][2 + e] * p.scale - lse_hi) : 0.f;
        s[n][e] = pl * (dp[n][e] - dsum_lo) * p.scale;  // ds
        s[n][2 + e] = ph * (dp[n][2 + e] - dsum_hi) * p.scale;
      }
    }
    accumulate<D>(acc, s, ks, g, t4);  // dq += ds . k
  }
  store_rows<D>(head_ptr<bf16>(p.dq, p, kDQ, b, h), p.st[kDQ][2], acc, r_lo,
                T, t4);
}

// K2e: dk and dv for one (b*h, 64-key tile)
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads) bwd_dkv_bf16(const Params p) {
  constexpr int KP = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kso = reinterpret_cast<bf16*>(smem);
  bf16* vso = kso + kTile16 * KP;
  bf16* qs = vso + kTile16 * KP;
  bf16* dos = qs + kTile16 * KP;
  float* lse_s = reinterpret_cast<float*>(dos + kTile16 * KP);
  float* dsum_s = lse_s + kTile16;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int T = p.T;
  const int k0 = blockIdx.y * kTile16;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const bool kval_lo = key_valid(p, b, key_lo);
  const bool kval_hi = key_valid(p, b, key_hi);
  const bool any = __syncthreads_or(tid < kTile16 &&
                                    key_valid(p, b, k0 + tid));
  // causal: the first local q row that may see each of this thread's keys
  const int f_lo = key_first_row(p, key_lo), f_hi = key_first_row(p, key_hi);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  if (any) {  // else every p of this tile is 0: write zeros
    const bf16* qb = head_ptr<const bf16>(p.q, p, kQ, b, h);
    const bf16* dob = head_ptr<const bf16>(p.dout, p, kDO, b, h);
    const float* lse = p.lse + static_cast<long long>(bh) * T;
    const float* dsum = p.dsum + static_cast<long long>(bh) * T;
    stage_rows<D>(kso, head_ptr<const bf16>(p.k, p, kK, b, h), p.st[kK][2],
                  k0, T, tid);
    stage_rows<D>(vso, head_ptr<const bf16>(p.v, p, kV, b, h), p.st[kV][2],
                  k0, T, tid);
    const int n_tiles = (T + kTile16 - 1) / kTile16;
    const int qt0 = kCausal ? first_q_tile(p, k0, kTile16, n_tiles) : 0;
    for (int qt = qt0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile16;
      __syncthreads();  // the previous tile is consumed
      stage_rows<D>(qs, qb, p.st[kQ][2], q0, T, tid);
      stage_rows<D>(dos, dob, p.st[kDO][2], q0, T, tid);
      if (tid < kTile16) {
        const bool in = q0 + tid < T;
        lse_s[tid] = in ? lse[q0 + tid] : 0.f;
        dsum_s[tid] = in ? dsum[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[8][4], dp[8][4];  // rows: this warp's 16 keys; columns: q
      scores<D>(s, kso, qs, warp, g, t4);
      scores<D>(dp, vso, dos, warp, g, t4);
      // causal: query n * 8 + e of this thread's columns may see a key iff
      // n * 8 + e >= that key's first row less q0 + t4 * 2
      const int d_lo = f_lo - q0 - t4 * 2, d_hi = f_hi - q0 - t4 * 2;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + t4 * 2 + e;
          const bool qv = q0 + c < T;
          const bool ok_lo =
              kval_lo && qv && (!kCausal || n * 8 + e >= d_lo);
          const bool ok_hi =
              kval_hi && qv && (!kCausal || n * 8 + e >= d_hi);
          const float l = lse_s[c], d = dsum_s[c];
          const float pl = ok_lo ? expf(s[n][e] * p.scale - l) : 0.f;
          const float ph = ok_hi ? expf(s[n][2 + e] * p.scale - l) : 0.f;
          s[n][e] = pl;  // p^T, for dv
          s[n][2 + e] = ph;
          dp[n][e] = pl * (dp[n][e] - d) * p.scale;  // ds^T, for dk
          dp[n][2 + e] = ph * (dp[n][2 + e] - d) * p.scale;
        }
      }
      accumulate<D>(dv, s, dos, g, t4);  // dv += p^T . dO
      accumulate<D>(dk, dp, qs, g, t4);  // dk += ds^T . q
    }
  }
  store_rows<D>(head_ptr<bf16>(p.dk, p, kDK, b, h), p.st[kDK][2], dk, key_lo,
                T, t4);
  store_rows<D>(head_ptr<bf16>(p.dv, p, kDV, b, h), p.st[kDV][2], dv, key_lo,
                T, t4);
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

template <int D, bool kCausal>
cudaError_t launch(const Params& p, int dkv, int dtype, int bh,
                   cudaStream_t s) {
  if (dtype == 1) {
    const dim3 grid(bh, (p.T + kTile32 - 1) / kTile32);
    if (dkv)
      bwd_dkv_f32<D, kCausal><<<grid, kThreads, 0, s>>>(p);
    else
      bwd_dq_f32<D, kCausal><<<grid, kThreads, 0, s>>>(p);
    return cudaGetLastError();
  }
  // above 48 KB (D=128) only after raising the kernel's dynamic limit
  const dim3 grid(bh, (p.T + kTile16 - 1) / kTile16);
  constexpr int bytes = smem_bf16<D>();
  constexpr cudaFuncAttribute kMax =
      cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if (dkv) {
    err = cudaFuncSetAttribute(bwd_dkv_bf16<D, kCausal>, kMax, bytes);
    if (err == cudaSuccess)
      bwd_dkv_bf16<D, kCausal><<<grid, kThreads, bytes, s>>>(p);
  } else {
    err = cudaFuncSetAttribute(bwd_dq_bf16<D, kCausal>, kMax, bytes);
    if (err == cudaSuccess)
      bwd_dq_bf16<D, kCausal><<<grid, kThreads, bytes, s>>>(p);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kCausal>
cudaError_t launch_dim(const Params& p, int dkv, int dtype, int D, int bh,
                       cudaStream_t s) {
  switch (D) {
    case 32: return launch<32, kCausal>(p, dkv, dtype, bh, s);
    case 64: return launch<64, kCausal>(p, dkv, dtype, bh, s);
    case 128: return launch<128, kCausal>(p, dkv, dtype, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch K2d (dkv = 0: writes dq) or K2e (dkv = 1: writes dk and dv) on
// `stream` (a cudaStream_t from PyTorch) on device `device`. dtype: 0 =
// bf16, 1 = f32 (q, k, v, dO and the gradients all of it). `strides` holds
// 21 element strides: batch, head and row of q, k, v, dO, dq, dk, dv (the
// pointers of the outputs a launch does not write may be null). lse and
// dsum are contiguous [B, H, T] f32. D must be 32, 64 or 128 with unit
// stride. causal 1 masks on the global positions q_offset + r and
// k_offset + c (the forward's). Returns the cudaError_t of the launch.
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
  p.H = H;
  p.T = T;
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.mask_sb = mask_sb;
  p.qk_shift = q_offset - k_offset;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      causal ? launch_dim<true>(p, dkv, dtype, D, B * H, s)
             : launch_dim<false>(p, dkv, dtype, D, B * H, s));
}

const char* mmlspark_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
