// K3: paged window attention over the block table, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (mmlspark_tpu/dl/pallas_paged_attention.py:89, launched by `_paged_pallas`
// at :199). For each slot s, head h and window row i (w rows per slot: w = 1
// for decode, k + 1 for the speculative verify window, the bucketed suffix
// for a prefill window) it computes softmax attention of q [S, H, w, hd] over
// the slot's chain of pool blocks:
//   chain position t lives in block rows[s, t / BL] at offset t % BL of the
//   pools k, v [NB, BL, H, hd]; a chain entry equal to the trash block (0) is
//   skipped whole, whatever pos says (so is an id outside [0, NB), which the
//   host table never holds); key t is allowed for row i iff t <= pos[s] + i;
//   s = (q . k) * hd^-0.5 in f32, -1e30 outside, p = exp(s - m) zeroed again
//   by a select, the running max and sum in f32, acc += p.astype(v) @ v in
//   f32, o = acc / max(l, 1e-35) in v's dtype, so a slot whose row is all
//   trash (an inactive slot, a padded prefill row) writes exactly 0.
//
// What bounds it on an H100: bytes. Decode (w = 1) reads each reached K/V
// row once for 4*hd flops per head and row: 2 flops per byte in bf16, far
// below the ~295 at which the tensor cores would bind; a long prefill window
// (w = 4096 over a 4096-token chain) is 4*P*hd flops over the allowed pairs P
// against the same bytes, and there operations bind.
//
// Design (right and simple first; split-KV flash-decoding, TMA and wgmma
// are later work):
//  - Head dims 32, 64, 128 and 256 (bf16; f32 up to 128). D = 256 takes
//    32-key tiles and reads q's fragments at each use instead of holding
//    them in registers.
//  - One CTA of 4 warps per (slot * head, 64-row window tile). A window is
//    tiled, so the one kernel serves decode, the verify window and prefill
//    windows up to w = 4096; the TPU kernel keeps all H*w rows in VMEM at
//    once, which this card's shared memory cannot at w = 4096.
//  - The TPU's scalar-prefetched table driving each BlockSpec becomes a
//    lookup per key: for each 64-key tile of chain positions, 64 threads
//    read the table entry of their key into shared memory (any BL >= 1;
//    the engine runs 8, 16 and 128), then the tile's K rows are staged
//    row-major and its V rows transposed from wherever the table puts them.
//    No dense gather of the chain.
//  - A tile whose keys are all trash or past the last reachable position is
//    skipped: its update is the identity. The loop stops at the tile holding
//    pos[s] + (the tile's last row).
//  - bf16: both products are mma.sync.m16n8k16 bf16 -> f32 as in K2a, with
//    the score accumulator as the PV product's A operand; decode uses 1 of
//    the 64 rows of a CTA's tile (15 of 16 rows of each mma wasted): recorded,
//    not fixed here. f32: 4 threads per window row, 32-row tiles, 32-key
//    tiles, plain FMA.
//  - q is read through its strides (a view of the fused qkv projection) and
//    o is written through its own (the wrapper hands back a [S, H, w, hd]
//    view of a [S, w, H, hd] buffer, so the head merge needs no copy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kNeg = -1e30f;  // the TPU kernel's _NEG
constexpr int kThreads = 128;
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

constexpr int kWarps = kThreads / 32;
constexpr int kBQ16 = 16 * kWarps;  // window rows per CTA

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

template <int D>
__global__ void __launch_bounds__(kThreads) paged_bf16(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  // chain positions per tile: 64, or 32 at D = 256, where the K and V^T
  // tiles of 64 would take 70 KB of static shared memory (48 KB at most)
  constexpr int kBK16 = D == 256 ? 32 : 64;
  // q's A fragments stay in registers up to D = 128; at D = 256 (64
  // registers beside the 128 of the output accumulator) they are read from
  // q through the cache at each use
  constexpr bool kQRegs = D <= 128;
  constexpr int KP = D + 8;      // K tile row pitch (elements)
  constexpr int VP = kBK16 + 8;  // V^T tile row pitch (elements)
  __shared__ __align__(16) __nv_bfloat16 ks[kBK16 * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VP];
  __shared__ long long krow[kBK16];
  __shared__ uint8_t live[kBK16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int s = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int w = p.w;
  const int row0 = blockIdx.y * kBQ16;
  const int r_lo = row0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const int t_end = chain_end(p, p.pos[s], min(w - 1, row0 + kBQ16 - 1));
  // the last chain position each of this thread's rows may attend, clamped
  // below t_end (beyond it no key is live)
  const int lim_lo = min(p.pos[s] + min(r_lo, w), t_end);
  const int lim_hi = min(p.pos[s] + min(r_hi, w), t_end);

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                            s * p.q_ss + h * p.q_sh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k_pool);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v_pool);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + s * p.o_ss +
                      h * p.o_sh;

  // the A fragment of q's 16 columns at kk * 16
  auto q_frag = [&](uint32_t(&f)[4], int kk) {
    const int c = kk * 16 + t4 * 2;
    const __nv_bfloat16* lo = qb + r_lo * p.q_sw + c;
    const __nv_bfloat16* hi = qb + r_hi * p.q_sw + c;
    f[0] = r_lo < w ? ld32(lo) : 0u;
    f[1] = r_hi < w ? ld32(hi) : 0u;
    f[2] = r_lo < w ? ld32(lo + 8) : 0u;
    f[3] = r_hi < w ? ld32(hi + 8) : 0u;
  };
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag(qf[kk], kk);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = kNeg, m_hi = kNeg;
  float l_lo = 0.f, l_hi = 0.f;

  const int n_tiles = (t_end + kBK16 - 1) / kBK16;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = kt * kBK16;
    __syncthreads();  // the previous tile is consumed
    long long r = -1;
    if (tid < kBK16) {
      r = pool_row(p, s, h, t0 + tid, t_end);
      krow[tid] = r;
      live[tid] = r >= 0;
    }
    if (!__syncthreads_or(r >= 0)) continue;  // all trash or past the end

    constexpr int VEC = D / 8;  // 16-byte vectors per row
    for (int i = tid; i < kBK16 * VEC; i += kThreads) {
      const int rr = i / VEC, c = (i % VEC) * 8;
      const long long pr = krow[rr];
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (pr >= 0) x = *reinterpret_cast<const uint4*>(kp + pr * D + c);
      *reinterpret_cast<uint4*>(&ks[rr * KP + c]) = x;
    }
    for (int i = tid; i < kBK16 * VEC; i += kThreads) {
      const int rr = i % kBK16, c = (i / kBK16) * 8;
      const long long pr = krow[rr];
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (pr >= 0) x = *reinterpret_cast<const uint4*>(vp + pr * D + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * VP + rr] = e[j];
    }
    __syncthreads();

    float sc[kBK16 / 8][4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int n = 0; n < kBK16 / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const __nv_bfloat16* kr = &ks[(n * 8 + g) * KP + kk * 16 + t4 * 2];
          mma_bf16(sc[n], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                   ld32(kr), ld32(kr + 8));
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kBK16 / 8; ++n)
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t f[4];
        q_frag(f, kk);
#pragma unroll
        for (int n = 0; n < kBK16 / 8; ++n) {
          const __nv_bfloat16* kr = &ks[(n * 8 + g) * KP + kk * 16 + t4 * 2];
          mma_bf16(sc[n], f[0], f[1], f[2], f[3], ld32(kr), ld32(kr + 8));
        }
      }
    }

    // key n * 8 + e of this thread's columns is allowed for a row iff
    // n * 8 + e <= that row's limit less t0 + t4 * 2
    const int d_lo = lim_lo - t0 - t4 * 2, d_hi = lim_hi - t0 - t4 * 2;
    float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
    for (int n = 0; n < kBK16 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + t4 * 2 + e;
        const bool ok_lo = live[c] && n * 8 + e <= d_lo;
        const bool ok_hi = live[c] && n * 8 + e <= d_hi;
        sc[n][e] = ok_lo ? sc[n][e] * p.scale : kNeg;
        sc[n][2 + e] = ok_hi ? sc[n][2 + e] * p.scale : kNeg;
        mx_lo = fmaxf(mx_lo, sc[n][e]);
        mx_hi = fmaxf(mx_hi, sc[n][2 + e]);
      }
    }
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
        const bool ok_lo = live[c] && n * 8 + e <= d_lo;
        const bool ok_hi = live[c] && n * 8 + e <= d_hi;
        sc[n][e] = ok_lo ? expf(sc[n][e] - mn_lo) : 0.f;
        sc[n][2 + e] = ok_hi ? expf(sc[n][2 + e] - mn_hi) : 0.f;
        ps_lo += sc[n][e];
        ps_hi += sc[n][2 + e];
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

#pragma unroll
    for (int j = 0; j < kBK16 / 16; ++j) {
      const uint32_t a0 = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      const uint32_t a1 = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      const uint32_t a2 = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
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
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r_lo < w)
      *reinterpret_cast<uint32_t*>(ob + r_lo * p.o_sw + c) =
          pack_bf16(acc[n][0] / den_lo, acc[n][1] / den_lo);
    if (r_hi < w)
      *reinterpret_cast<uint32_t*>(ob + r_hi * p.o_sw + c) =
          pack_bf16(acc[n][2] / den_hi, acc[n][3] / den_hi);
  }
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

template <int D>
cudaError_t launch_dtype(const Params& p, int dtype, int sh, cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid(sh, (p.w + kBQ16 - 1) / kBQ16);
    paged_bf16<D><<<grid, kThreads, 0, s>>>(p);
    return cudaGetLastError();
  }
  // f32 is built for D <= 128: its K and V tiles of 32 rows would take
  // 64 KB of static shared memory at D = 256 (48 KB at most)
  if constexpr (D > 128) {
    return cudaErrorInvalidValue;
  } else {
    const dim3 grid(sh, (p.w + kBQ32 - 1) / kBQ32);
    paged_f32<D><<<grid, kThreads, 0, s>>>(p);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// Launch K3 on `stream` (a cudaStream_t from PyTorch) on device `device`.
// dtype: 0 = bf16, 1 = f32 (q, the pools and o all of it). q and o are
// [S, H, w, D] with the given strides (elements; unit stride on D); the
// pools [NB, BL, H, D] contiguous; rows [S, MB] and pos [S] int32
// contiguous. D must be 32, 64, 128 or (bf16 only) 256. Returns the
// cudaError_t of the launch.
int mmlspark_paged_launch(const void* q, const void* k_pool,
                          const void* v_pool, const int* rows, const int* pos,
                          void* o, int dtype, int S, int H, int w, int D,
                          int NB, int BL, int MB, long long q_ss,
                          long long q_sh, long long q_sw, long long o_ss,
                          long long o_sh, long long o_sw, float scale,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || S < 1 || H < 1 || w < 1 || NB < 1 ||
      BL < 1 || MB < 1 || static_cast<long long>(S) * H > 0x7fffffffLL ||
      static_cast<long long>(MB) * BL + w > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_dtype<32>(p, dtype, S * H, st));
    case 64: return static_cast<int>(launch_dtype<64>(p, dtype, S * H, st));
    case 128: return static_cast<int>(launch_dtype<128>(p, dtype, S * H, st));
    case 256: return static_cast<int>(launch_dtype<256>(p, dtype, S * H, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* mmlspark_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
