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
// flags together are K2c with the lse (K2c-lse), which is also the port of
// the causal branch of `_flash_kernel_lse` (:320): one loop bound covers the
// packed and the streaming kernel. For q, k, v [B, H, T, D] (any batch,
// head and row strides; unit stride on D) and a key mask [B, T] (nonzero =
// valid; null = all valid) it computes, per (b, h) and query row,
//   s   = (q . k^T) * scale in f32 (scale = D^-0.5 of the caller's true head
//   dim), invalid keys set to -1e30;
//   online softmax over key tiles: m = running max, l = running sum of
//   p = exp(s - m) with p zeroed again at invalid keys (a fully masked tile
//   would otherwise give exp(0) = 1), acc = acc * corr + p.astype(v) @ v in
//   f32 with the UNNORMALISED p rounded to v's dtype (the TPU kernel's
//   `p.astype(v_ref.dtype)`);
//   o   = acc / max(l, 1e-35) in v's dtype, so a fully masked row is 0;
//   K2b also writes lse = m + log(max(l, 1e-35)) in f32, natural-log units,
//   to a contiguous [B, H, T] buffer: -1e30 for a fully masked row, as on
//   the TPU. The fused backward (flash_bwd.cu) recomputes p from it. With
//   kCausal a row with no allowed key gets the same -1e30 and o = 0,
//   whether its CTA visits no key tile at all or only tiles where every
//   pair is masked, as `_flash_kernel_causal_packed` writes them (:195-198).
// Keys past T (the ragged last tile) are invalid.
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
// at the generate prefill's [32, 8, 128, 64] the bytes of q/k/v/o do. Only
// wgmma reaches the tensor cores' full rate on Hopper; beside it the
// exponentials (one per score, on the 16-per-clock MUFU) cost about as much
// as both products at D = 64.
//
// The first design was right and simple: 4 warps per 64-row q
// tile, mma.sync m16n8k16, K and V staged by plain loads with V transposed
// by hand, two block barriers per tile and no copy in flight during the
// products. It took 2.9803 ms (K2a [32, 8, 2048, 64] with the documents'
// mask), 0.6947 ms (K2b [8, 8, 2048, 64]), 0.0279 ms (K2c [32, 8, 128,
// 64]) and 0.4607 ms (K2c-lse [8, 8, 2048, 64]) on an NVIDIA H100 80GB HBM3
// at 700 W (`chip_smoke.py`), 3.0x SDPA's time for K2a.
//
// Design now, bf16 (the f32 path below is the tight check of the same
// algorithm and keeps the simple design). The kernel body is in
// flash_fwd.cuh, shared with K3's window kernel (paged_attn.cu), which
// runs it with a paged key source; this file's `Dense` source supplies the
// dense K and V tiles, the key mask's validity words and the epilogue:
//  - A persistent grid, one CTA per SM, walks the work items (b*h, 128-row
//    q tile). A CTA is two consumer warpgroups, which own 64 query rows of
//    an item each, and one producer warp, 288 threads at one CTA per SM,
//    and ptxas uses 155-168 registers a thread with no spill at D <= 128.
//    An attempt with a producer warpgroup (384 threads, setmaxnreg 24/240)
//    spilled at D = 128 with 128-key tiles.
//    D = 128 takes 64-key tiles (BK/2 + D/2 accumulator registers a
//    thread) and D = 256 32-key tiles (O alone is 128 registers a thread;
//    S = Q K^T reduces over D in four 64-column boxes and O += P V is two
//    m64n128 products, one per half of D). At 288 threads ptxas holds a
//    thread to 168 registers, the share of a 384-thread CTA, and D = 256
//    spilled there, so D = 256 alone runs a whole producer warpgroup with
//    setmaxnreg (24 for it, 240 for the consumers: no spill). The
//    consumers run a plain loop: a ping-pong of the two
//    warpgroups (turns on named barriers) and an overlap inside each (a
//    tile's S = Q K^T issued beside the last P V, the softmax while it
//    runs) were both slower than this loop when timed against it on an
//    NVIDIA H100; neither is kept (`PERF.md` §6).
//  - Copies by TMA: the producer loads each item's Q tile into one of two
//    Q buffers (so the next item's Q arrives while this one is consumed)
//    and keeps a ring of 4 stages of K and V tiles (128 keys; 64 at
//    D = 128; 3 stages of 32 keys at D = 256, where the two Q buffers
//    take 128 KB of the 227 KB) in flight across items, each buffer and
//    stage with a full and an empty mbarrier; one item's epilogue
//    overlaps the next one's copies. Tensor maps over the caller's
//    strided [B, H, T, D] views (dims D, T, H, B) are encoded on the host
//    (the last 32 are cached: encoding costs more host time than the
//    launch) and passed as __grid_constant__ parameters; rows past T come
//    zero-filled from TMA's out-of-bounds
//    handling, so the loop has no bounds checks. Tiles land with TMA's
//    128-byte swizzle (64-byte at D = 32); D = 128 is two 64-column boxes,
//    D = 256 four. The helpers shared with the backward (mbarriers, TMA,
//    wgmma, the tensor-map cache) are in flash_common.cuh.
//  - f32 runs up to D = 128 (its 32-row K and V tiles live in static
//    shared memory, 64 KB at D = 256); the wrapper refuses f32 above.
//  - Both products on wgmma: S = Q K^T as m64n<BK>k16 with Q and K read from
//    shared memory through descriptors (K-major); P is rounded to bf16 in
//    registers (the accumulator's layout is the A-fragment layout) and fed
//    as the register A operand of O += P V (m64nDk16), with V read in its
//    row-major (MN-major) layout through the descriptor's transpose bit:
//    nothing is transposed in shared memory.
//  - Online softmax in registers with exp2: the running max m is kept on
//    the raw scores, and p = 2^(s * c - m * c) with c = scale * log2(e) is
//    one FFMA and the exp2 per score; masked pairs score -1e30 and p is
//    re-zeroed by a select. A tile whose pairs are all allowed (every key
//    valid, off the causal diagonal) takes neither select. The lse is
//    m * scale + log(l) in natural-log units, and exactly -1e30 for a row
//    with l = 0 (no allowed key), so no sentinel passes through the exp2
//    domain.
//  - The key mask: the producer reads a tile's mask bytes with one warp,
//    writes the tile's validity as BK/32 32-bit words into the stage's
//    slot before it arrives on the full barrier, and posts every tile: a
//    tile with no valid key arrives without a copy, and the consumers skip
//    its products (its update is the identity). So both sides walk the
//    same tile list by construction, and the validity reaches the consumers
//    through the mbarrier's release/acquire, with no block barrier.
//  - Causal: producer and consumers loop to the same n_reach, taken for the
//    CTA's last row; a consumer warpgroup skips a tile none of its rows can
//    reach and runs the per-pair compare only on tiles that cross its
//    diagonal. Causal items go longest first (every head's last q tile,
//    then the one before), which balances the persistent CTAs; otherwise a
//    head's q tiles are neighbours in the walk and share its K and V in
//    L2. A warpgroup whose rows all lie past T skips the products.
//  - The output is written through its own strides, so the wrapper can hand
//    back a [B, H, T, D] view of a [B, T, H, D] buffer and the head merge
//    after attention needs no copy.
//  - A wait that does not complete within ~2^24 polls traps, so a fault in
//    a copy ends the launch with an error instead of hanging the card.

#include "flash_dense.cuh"

namespace {

constexpr int kThreads = 128;   // the f32 path's CTA

template <int D, bool kLse, bool kCausal>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  fwd_bf16_body<D, Dense<D, kLse, kCausal>>(tq, tk, tv, p);
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

// ------------------------------------------------------------------ launch

template <int D, bool kLse, bool kCausal>
int launch_bf16(const Params& p, int B, cudaStream_t s) {
  // the shared-memory opt-in, once per instance and device
  static unsigned long long opted = 0;
  return launch_dense<D, Tile<D>>(flash_fwd_bf16<D, kLse, kCausal>, opted,
                                  p, B, s);
}

template <int D, bool kLse, bool kCausal>
int launch_dtype(const Params& p, int dtype, int B, cudaStream_t s) {
  if (dtype == 0) return launch_bf16<D, kLse, kCausal>(p, B, s);
  // f32 (the tight check) is built for D <= 128: its CTA keeps a K and a V
  // tile of 32 rows in static shared memory (64 KB at D = 256, over the
  // 48 KB a static allocation may take)
  if constexpr (D > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const dim3 grid(B * p.H, (p.T + kBQ32 - 1) / kBQ32);
    flash_fwd_f32<D, kLse, kCausal><<<grid, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <bool kLse, bool kCausal>
int launch_dim(const Params& p, int dtype, int D, int B, cudaStream_t s) {
  switch (D) {
    case 32: return launch_dtype<32, kLse, kCausal>(p, dtype, B, s);
    case 64: return launch_dtype<64, kLse, kCausal>(p, dtype, B, s);
    case 128: return launch_dtype<128, kLse, kCausal>(p, dtype, B, s);
    case 256: return launch_dtype<256, kLse, kCausal>(p, dtype, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch K2a (lse null, causal 0), K2b (lse a contiguous [B, H, T] f32
// buffer) or K2c (causal 1; q_offset/k_offset the global positions of row
// 0 and key 0), with or without the lse, on `stream` (a cudaStream_t from
// PyTorch) on device `device`. dtype: 0 = bf16, 1 = f32 (q, k, v and o all
// of it). Strides are in elements; D must be 32, 64, 128 or (bf16 only)
// 256 with unit stride, and for bf16 the q/k/v base addresses and strides
// multiples of 16 bytes (the tensor maps' rule). Returns 0, a cudaError_t of the launch,
// or a negative code of the tensor-map encoding (see the error string).
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
  p.BH = B * H;
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
    return lse == nullptr ? launch_dim<false, true>(p, dtype, D, B, s)
                          : launch_dim<true, true>(p, dtype, D, B, s);
  return lse == nullptr ? launch_dim<false, false>(p, dtype, D, B, s)
                        : launch_dim<true, false>(p, dtype, D, B, s);
}

const char* mmlspark_flash_error_string(int err) {
  return launch_error_string(err);
}

// The bf16 forward's design, one line: grid and CTA shape, tiles, ring
// stages and dynamic shared memory per head dim.
const char* mmlspark_flash_design() {
  static char buf[448];
  snprintf(buf, sizeof(buf),
           "bf16 forward: persistent, one CTA per SM; %d threads = 2 "
           "consumer warpgroups + 1 TMA producer warp (D = 256: %d, a "
           "producer warpgroup, setmaxnreg 24/240); q tile %d rows, "
           "2 Q buffers; key tiles %d/%d/%d/%d, TMA ring of "
           "%d/%d/%d/%d stages, dynamic smem %d/%d/%d/%d B at D = "
           "32/64/128/256; wgmma m64n<key tile>k16 (S, SS) and m64nDk16 "
           "(PV, RS, V MN-major; two n128 at D = 256)",
           Tile<32>::THREADS, Tile<256>::THREADS, kBQ, Tile<32>::BK,
           Tile<64>::BK, Tile<128>::BK,
           Tile<256>::BK, Tile<32>::STAGES, Tile<64>::STAGES,
           Tile<128>::STAGES, Tile<256>::STAGES, Tile<32>::SMEM,
           Tile<64>::SMEM, Tile<128>::SMEM, Tile<256>::SMEM);
  return buf;
}

}  // extern "C"
