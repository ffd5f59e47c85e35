// K2a, K2b and K2c: the flash-attention forward with a key mask, the same
// forward with a per-row logsumexp output, and the causal forward,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_flash_kernel`
// (mmlspark_tpu/dl/pallas_attention.py:77, launched at :337; K2a, and with
// causal=True the streaming causal forward "causal K2a", whose
// `_block_reachable` (:64) skips the k-blocks above the diagonal),
// `_flash_kernel_lse` (:126, launched at :320 with with_lse=True; it wraps
// `_flash_kernel` and adds the lse) and `_flash_kernel_causal_packed`
// (K2c, :142, launched at :297 without the lse; the causal forward over
// only the reachable k-blocks; launched at :285 with the lse, which the
// causal training forward saves). The template flags kLse and kCausal
// select K2b and K2c, so the kernels keep separate names in a profile; both
// flags together are K2c with the lse, which is also the port of the causal
// branch of `_flash_kernel_lse` (:320): one loop bound covers the packed and
// the streaming kernel. For q, k, v [B, H, T, D] (any batch, head
// and row strides; unit stride on D) and a key mask [B, T] (nonzero = valid;
// null = all valid) it computes, per (b, h) and query row,
//   s   = (q . k^T) * D^-0.5 in f32, invalid keys set to -1e30;
//   online softmax over key tiles: m = running max, l = running sum of
//   p = exp(s - m) with p zeroed again at invalid keys (a fully masked tile
//   would otherwise give exp(0) = 1), acc = acc * corr + p.astype(v) @ v in
//   f32 with the UNNORMALISED p rounded to v's dtype (the TPU kernel's
//   `p.astype(v_ref.dtype)`);
//   o   = acc / max(l, 1e-35) in v's dtype, so a fully masked row is 0;
//   K2b also writes lse = m + log(max(l, 1e-35)) in f32 to a contiguous
//   [B, H, T] buffer: -1e30 for a fully masked row (m = -1e30, l = 0), as on
//   the TPU. The fused backward (flash_bwd.cu) recomputes p from it. With
//   kCausal a row with no allowed key gets the same -1e30 and o = 0,
//   whether its CTA visits no key tile at all (m and l keep their initial
//   -1e30 and 0) or visits tiles where every pair is masked, as
//   `_flash_kernel_causal_packed` writes them (:195-198).
// Keys past T (the ragged last tile) are invalid and staged as zeros.
// Causal (K2c): positions are global, query row r at q_offset + r and key c
// at k_offset + c (the offsets are the caller's ints and may exceed T, as a
// ring shard's coordinates do); a pair is allowed iff the key is valid and
// k_offset + c <= q_offset + r, masked like an invalid key (-1e30, p = 0 by
// a select), so a row with no allowed key is exactly 0 and a key after a
// row's position never touches its max, its sum or its output.
//
// What bounds it on an H100: operations. The two products are 4*B*H*T^2*D
// flops (2.75e11 at B=32, H=8, T=2048, D=64: 0.28 ms at 989 TFLOP/s bf16
// dense, NVIDIA H100 SXM data sheet) against 4*B*H*T*D*2 bytes of q/k/v/o
// (0.27 GB: 0.08 ms at 3.35 TB/s). K2c does 4*P*D over the allowed pairs P,
// T(T+1)/2 per (b, h) at q_offset = k_offset: operations bind at long T;
// at the generate prefill's [32, 8, 128, 64] the bytes of q/k/v/o do.
//
// Design (right and simple first; wgmma, TMA and warp specialisation are
// later work):
//  - bf16: one CTA of 4 warps per (b*h, 64-row q tile); each warp owns 16
//    query rows and keeps its Q fragments, the 16 x 64 score tile, the
//    running max/sum and the 16 x D f32 accumulator in registers. Both
//    products run on the tensor cores as mma.sync.m16n8k16 bf16 -> f32; the
//    score accumulator's layout is the A-operand layout of the next product,
//    so P never leaves registers. K tiles are staged row-major and V tiles
//    transposed in shared memory (padded rows: conflict-free fragment loads).
//  - f32 (the tight check of the same algorithm): 4 threads per query row,
//    32-row q tiles, 32-key tiles, plain FMA in f32.
//  - The TPU grid's sequential k axis (m/l/acc carried in VMEM scratch)
//    becomes a loop over key tiles inside the CTA.
//  - The mask is read as [B, T] through b = bh / H, and the ragged tail by
//    bounds checks: no padded copies of q/k/v or of the mask.
//  - A key tile whose keys are all invalid is skipped: its update is the
//    identity (m and l unchanged, corr = 1, p = 0), so skipping is exact and
//    saves the padded tail of short documents.
//  - Causal: a CTA loops only over the key tiles its last row can reach,
//    n_reach = clamp(floor((q_offset + q0 + BQ - 1 - k_offset) / BK) + 1,
//    0, n_tiles). That one bound is both TPU kernels' pruning: K2c's
//    packed n_reach and the streaming kernel's per-cell skip. At
//    q_offset = k_offset it halves the work of a long row (the bound counts
//    T(T+1)/2 pairs per (b, h)).
//  - The output is written through its own strides, so the wrapper can hand
//    back a [B, H, T, D] view of a [B, T, H, D] buffer and the head merge
//    after attention needs no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kNeg = -1e30f;  // the TPU kernel's _NEG
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B, T] with batch stride mask_sb; null = all valid
  void* o;
  float* lse;  // [B*H, T] f32 (K2b); unused by K2a
  int H, T;
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

constexpr int kWarps = kThreads / 32;
constexpr int kBQ16 = 16 * kWarps;  // query rows per CTA
constexpr int kBK16 = 64;           // keys per tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// two f32 -> one register of two bf16 (round to nearest even), lo in the
// low half as mma.sync's fragments expect
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

template <int D, bool kLse, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KP = D + 8;      // K tile row pitch (elements)
  constexpr int VP = kBK16 + 8;  // V^T tile row pitch (elements)
  __shared__ __align__(16) __nv_bfloat16 ks[kBK16 * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VP];
  __shared__ uint8_t allowed[kBK16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int T = p.T;
  const int r_lo = blockIdx.y * kBQ16 + warp * 16 + g;
  const int r_hi = r_lo + 8;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;

  // A fragments of this warp's 16 query rows, for every 16-wide D step
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    const __nv_bfloat16* lo = qb + r_lo * p.q_st + c;
    const __nv_bfloat16* hi = qb + r_hi * p.q_st + c;
    qf[kk][0] = r_lo < T ? ld32(lo) : 0u;
    qf[kk][1] = r_hi < T ? ld32(hi) : 0u;
    qf[kk][2] = r_lo < T ? ld32(lo + 8) : 0u;
    qf[kk][3] = r_hi < T ? ld32(hi + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = kNeg, m_hi = kNeg;  // running max of rows r_lo, r_hi
  float l_lo = 0.f, l_hi = 0.f;    // this thread's share of the running sum

  // causal: the last local key each of this thread's rows may attend
  const int lim_lo = row_limit(p, r_lo), lim_hi = row_limit(p, r_hi);
  int n_tiles = (T + kBK16 - 1) / kBK16;
  if (kCausal)
    n_tiles = reach_tiles(p, blockIdx.y * kBQ16 + kBQ16 - 1, kBK16, n_tiles);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK16;
    __syncthreads();  // the previous tile is consumed
    const bool ok = tid < kBK16 && key_valid(p, b, k0 + tid);
    if (tid < kBK16) allowed[tid] = ok;
    if (!__syncthreads_or(ok)) continue;  // all keys invalid: identity

    constexpr int VEC = D / 8;  // 16-byte vectors per row
    for (int i = tid; i < kBK16 * VEC; i += kThreads) {
      const int r = i / VEC, c = (i % VEC) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < T)
        x = *reinterpret_cast<const uint4*>(kb + (k0 + r) * p.k_st + c);
      *reinterpret_cast<uint4*>(&ks[r * KP + c]) = x;
    }
    // V transposed: consecutive threads take consecutive keys, so the
    // scalar stores into a V^T row do not collide on a bank
    for (int i = tid; i < kBK16 * VEC; i += kThreads) {
      const int r = i % kBK16, c = (i / kBK16) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < T)
        x = *reinterpret_cast<const uint4*>(vb + (k0 + r) * p.v_st + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * VP + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys
    float s[kBK16 / 8][4];
#pragma unroll
    for (int n = 0; n < kBK16 / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[(n * 8 + g) * KP + kk * 16 + t4 * 2];
        mma_bf16(s[n], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], ld32(kr),
                 ld32(kr + 8));
      }
    }

    // causal: key n * 8 + e of this thread's columns is allowed for a row
    // iff n * 8 + e <= that row's limit less k0 + t4 * 2, a compare with a
    // constant once the loops unroll
    const int d_lo = lim_lo - k0 - t4 * 2, d_hi = lim_hi - k0 - t4 * 2;
    float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
    for (int n = 0; n < kBK16 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + t4 * 2 + e;
        const bool ok_lo = allowed[c] && (!kCausal || n * 8 + e <= d_lo);
        const bool ok_hi = allowed[c] && (!kCausal || n * 8 + e <= d_hi);
        s[n][e] = ok_lo ? s[n][e] * p.scale : kNeg;
        s[n][2 + e] = ok_hi ? s[n][2 + e] * p.scale : kNeg;
        mx_lo = fmaxf(mx_lo, s[n][e]);
        mx_hi = fmaxf(mx_hi, s[n][2 + e]);
      }
    }
    // the 4 threads of a fragment row hold its 64 scores between them
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = expf(m_lo - mn_lo), corr_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int n = 0; n < kBK16 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + t4 * 2 + e;
        const bool ok_lo = allowed[c] && (!kCausal || n * 8 + e <= d_lo);
        const bool ok_hi = allowed[c] && (!kCausal || n * 8 + e <= d_hi);
        s[n][e] = ok_lo ? expf(s[n][e] - mn_lo) : 0.f;
        s[n][2 + e] = ok_hi ? expf(s[n][2 + e] - mn_hi) : 0.f;
        ps_lo += s[n][e];
        ps_hi += s[n][2 + e];
      }
    }
    l_lo = l_lo * corr_lo + ps_lo;
    l_hi = l_hi * corr_hi + ps_hi;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr_lo;
      acc[n][1] *= corr_lo;
      acc[n][2] *= corr_hi;
      acc[n][3] *= corr_hi;
    }

    // O += P V with P rounded to bf16: score n-tiles 2j and 2j+1 are the
    // A fragment of the j-th 16-key step
#pragma unroll
    for (int j = 0; j < kBK16 / 16; ++j) {
      const uint32_t a0 = pack_bf16(s[2 * j][0], s[2 * j][1]);
      const uint32_t a1 = pack_bf16(s[2 * j][2], s[2 * j][3]);
      const uint32_t a2 = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vr = &vt[(n * 8 + g) * VP + j * 16 + t4 * 2];
        mma_bf16(acc[n], a0, a1, a2, a3, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float den_lo = fmaxf(l_lo, 1e-35f), den_hi = fmaxf(l_hi, 1e-35f);
  if (kLse && t4 == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * T;
    if (r_lo < T) lse[r_lo] = m_lo + logf(den_lo);
    if (r_hi < T) lse[r_hi] = m_hi + logf(den_hi);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r_lo < T)
      *reinterpret_cast<uint32_t*>(ob + r_lo * p.o_st + c) =
          pack_bf16(acc[n][0] / den_lo, acc[n][1] / den_lo);
    if (r_hi < T)
      *reinterpret_cast<uint32_t*>(ob + r_hi * p.o_st + c) =
          pack_bf16(acc[n][2] / den_hi, acc[n][3] / den_hi);
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int kBQ32 = kThreads / 4;  // 4 threads per query row
constexpr int kBK32 = 32;

template <int D, bool kLse, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const Params p) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  constexpr int DP = D / 4;  // dims per thread: part, part + 4, ...
  __shared__ __align__(16) float ks[kBK32 * D];
  __shared__ __align__(16) float vs[kBK32 * D];
  __shared__ uint8_t allowed[kBK32];

  const int tid = threadIdx.x;
  const int part = tid & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int T = p.T;
  const int row = blockIdx.y * kBQ32 + (tid >> 2);

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  float q[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    q[i] = row < T ? qb[row * p.q_st + part + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  const int lim = row_limit(p, row);  // causal: last allowed local key
  int n_tiles = (T + kBK32 - 1) / kBK32;
  if (kCausal)
    n_tiles = reach_tiles(p, blockIdx.y * kBQ32 + kBQ32 - 1, kBK32, n_tiles);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();
    const bool ok = tid < kBK32 && key_valid(p, b, k0 + tid);
    if (tid < kBK32) allowed[tid] = ok;
    if (!__syncthreads_or(ok)) continue;
    for (int i = tid; i < kBK32 * D / 4; i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < T) {
        kx = *reinterpret_cast<const float4*>(kb + (k0 + r) * p.k_st + c);
        vx = *reinterpret_cast<const float4*>(vb + (k0 + r) * p.v_st + c);
      }
      *reinterpret_cast<float4*>(&ks[r * D + c]) = kx;
      *reinterpret_cast<float4*>(&vs[r * D + c]) = vx;
    }
    __syncthreads();

    const int d = lim - k0;  // causal: key j is allowed iff j <= d
    auto pair_ok = [&](int j) { return allowed[j] && (!kCausal || j <= d); };
    float s[kBK32];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i)
        dot = fmaf(q[i], ks[j * D + part + 4 * i], dot);
      // the four partial dots of the row; every thread gets the same sum
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[j] = pair_ok(j) ? dot * p.scale : kNeg;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      s[j] = pair_ok(j) ? expf(s[j] - mn) : 0.f;
      ps += s[j];
    }
    l = l * corr + ps;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kBK32; ++j)
        a = fmaf(s[j], vs[j * D + part + 4 * i], a);
      acc[i] = a;
    }
  }

  if (row < T) {
    const float den = fmaxf(l, 1e-35f);
#pragma unroll
    for (int i = 0; i < DP; ++i)
      ob[row * p.o_st + part + 4 * i] = acc[i] / den;
    if (kLse && part == 0)
      p.lse[static_cast<long long>(bh) * T + row] = m + logf(den);
  }
}

template <int D, bool kLse, bool kCausal>
cudaError_t launch_dtype(const Params& p, int dtype, int bh, cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid(bh, (p.T + kBQ16 - 1) / kBQ16);
    flash_fwd_bf16<D, kLse, kCausal><<<grid, kThreads, 0, s>>>(p);
  } else {
    const dim3 grid(bh, (p.T + kBQ32 - 1) / kBQ32);
    flash_fwd_f32<D, kLse, kCausal><<<grid, kThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

template <bool kLse, bool kCausal>
cudaError_t launch_dim(const Params& p, int dtype, int D, int bh,
                       cudaStream_t s) {
  switch (D) {
    case 32: return launch_dtype<32, kLse, kCausal>(p, dtype, bh, s);
    case 64: return launch_dtype<64, kLse, kCausal>(p, dtype, bh, s);
    case 128: return launch_dtype<128, kLse, kCausal>(p, dtype, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch K2a (lse null, causal 0), K2b (lse a contiguous [B, H, T] f32
// buffer) or K2c (causal 1; q_offset/k_offset the global positions of row
// 0 and key 0), with or without the lse, on `stream` (a cudaStream_t from
// PyTorch) on device `device`. dtype: 0 = bf16, 1 = f32 (q, k, v and o all
// of it). Strides are in elements; D must be 32, 64 or 128 with unit
// stride. Returns the cudaError_t of the launch.
int mmlspark_flash_launch(const void* q, const void* k, const void* v,
                          const void* mask, void* o, float* lse, int dtype,
                          int B, int H,
                          int T, int D, long long q_sb, long long q_sh,
                          long long q_st, long long k_sb, long long k_sh,
                          long long k_st, long long v_sb, long long v_sh,
                          long long v_st, long long o_sb, long long o_sh,
                          long long o_st, long long mask_sb, float scale,
                          int causal, long long q_offset, long long k_offset,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || T < 1 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.o = o;
  p.lse = lse;
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
  if (causal)
    return static_cast<int>(
        lse == nullptr ? launch_dim<false, true>(p, dtype, D, B * H, s)
                       : launch_dim<true, true>(p, dtype, D, B * H, s));
  return static_cast<int>(lse == nullptr
                              ? launch_dim<false, false>(p, dtype, D, B * H, s)
                              : launch_dim<true, false>(p, dtype, D, B * H, s));
}

const char* mmlspark_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
