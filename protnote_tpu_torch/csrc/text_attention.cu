// Masked softmax attention of the label text tower (K8a) for Hopper (sm_90a).
//
// Replaces the core of protnote_tpu/models/text_transformer.py:_attention
// (lines 182-190), the XLA chain
//
//   scores = einsum(q, k, f32) / sqrt(hd) + bias          (f32)
//   probs  = bf16(softmax(scores))                         (f32 softmax)
//   ctx    = bf16(einsum(probs, v, f32))                   (f32 sums)
//
// with q, k, v (B, nh, T, hd) bf16 and the additive bias -1e9 on keys whose
// key_mask is 0 (bert), or on those and on future keys (gpt, causal).  The
// division by the constant sqrt(hd) is a multiply by its float32
// reciprocal, which is what jitted XLA compiles it into; the caller passes
// that reciprocal as `scale`.  Each step is rounded where JAX rounds:
// s = (q.k * scale) + bias, each op rounded on its own (no FMA); the f32 row
// max m, expf(s - m), the f32 row sum l and a correctly rounded division;
// the probabilities rounded to bf16 before P.V, whose f32 sums are rounded
// to bf16 on the way out.
//
// Design: one block per (batch row, head, 128-query tile), eight warps of 16
// query rows (two warpgroups of 64); the blocks of one (b, h) are
// neighbours in the grid, so they read its K and V from L2 together (at
// T <= 128 one block covers them all).  Scores never leave registers: each
// 16-row warp holds its score tile in the accumulator layout of m16n8k16
// (bf16 in, f32 accumulators), takes row maxima and sums with quad
// shuffles, and packs the bf16 probabilities straight into the A fragments
// of P.V (that accumulator layout is the A layout).  K and V stream through
// cp.async tiles of 64 keys, so shared memory does not grow with T.
// Normalising exactly without whole rows:
//   * T <= 128 (one pass, mma.sync): K and V of every key tile are
//     requested before the key mask is read; the warp forms its scores for
//     all keys (two tiles, 64 f32 a thread) with mma.sync, the K and V
//     fragments read by ldmatrix (.trans for V) from padded rows, then max,
//     expf, sum, divide and P.V;
//   * T > 128 (two passes, wgmma): pass 1 forms S tile by tile with a
//     running max and a rescaled running sum; pass 2 forms S again and
//     takes p = bf16(expf(s - m) / l) with the final m, so expf(s - m) is
//     exactly JAX's; l differs from JAX's sum of expf(s - m) by the order of
//     its terms and by the rounding of each rescale l * expf(m_old - m_new)
//     (a few ulps, inside the tolerance of the tests).  Each warpgroup
//     issues wgmma m64n64k16 with register A: Q's fragments against the K
//     tile, then the probabilities against the V tile, read MN-major; both
//     tiles lie 128-byte swizzled.  A two-slot ring, one barrier a step: the
//     next step's tiles load under this step's work.
// The division e / l takes the row's correctly rounded reciprocal r and
// corrects q = e * r twice with the exact remainder e - l q (an FMA): the
// correctly rounded quotient (Markstein), the value a true division gives,
// without a reciprocal and a range check for every element.
// Keys that add exactly 0 are skipped: a row with at least one kept key at
// or before it has m far above -1e9, so expf(-1e9 + x - m) is exactly 0 and
// the key tiles before the first kept key, after the last, and (causal)
// after the warp's last row drop out.  A row none of whose keys (up to
// itself, causal) is kept gets JAX's softmax over all T keys at -1e9, so a
// warp holding such a row walks every key tile.  In the two-pass form a
// warpgroup walks the tiles any of its four warps needs (a tile another
// warp skips adds exactly 0 to it).  Keys past T get -inf and zero-filled
// K/V rows; query rows past T are computed and not stored.
//
// What bounds it: bytes at T 128 (q, k, v read and ctx written, 134 MB at
// B 128 x H 1024: 0.040 ms at 3.35 TB/s, 8.6 GFLOP 0.009 ms at the bf16
// peak), though a block's loads and its compute overlap only through the
// other block on its SM; at T 512 the work of two passes: three T x T x hd
// products and, for every score, two expf (two MUFU ops) and ~28 float32
// instructions of the exact softmax.

#include "hopper.cuh"  // smem_u32, pack_bf16x2, div_rn, wgmma and its descriptors

namespace {

constexpr int WARPS = 8;             // 16 query rows each
constexpr int BQ = 16 * WARPS;       // query rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int BKEY = 64;             // keys per ring tile
constexpr int MAX_T = 512;
constexpr int HOLD_TILES = 2;        // T <= HOLD_TILES * BKEY: one pass
constexpr float MASKED = -1e9f;      // the JAX package's additive mask value

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a . b, m16n8k16, bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// asm operands of a warp's 16 x 64 f32 tile d[8][4] (m16n8k16 layout)
#define S8(s, j) "+f"(s[j][0]), "+f"(s[j][1]), "+f"(s[j][2]), "+f"(s[j][3])
#define S32(s) S8(s, 0), S8(s, 1), S8(s, 2), S8(s, 3), S8(s, 4), S8(s, 5), S8(s, 6), S8(s, 7)

// d (+)= a . b, wgmma m64n64k16, bf16 in, f32 accumulators: a from registers
// (the warp's m16n8k16 A fragment; the warpgroup's four warps make the 64
// rows), b through a descriptor of a 128-byte-swizzled tile; TNSP 0 reads b
// K-major (K as stored: keys x dims), 1 MN-major (V as stored: keys x
// dims).  d is the warp's 16 x 64 tile in the m16n8k16 accumulator layout.
// scale_d 0 overwrites.
template <int TNSP>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : S32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TNSP));
}
// keeps the compiler from moving tile reads or writes across a wgmma wait
__device__ __forceinline__ void fence_tile(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Which key tiles a warp whose rows start at w0 must see: [lo, hi).  first
// and last are the batch row's first and last kept keys (first = T: none).
template <bool CAUSAL>
__device__ __forceinline__ void warp_tiles(int w0, int T, int first, int last, int& lo, int& hi) {
  if (w0 >= T) {  // no row of the warp is stored
    lo = hi = 0;
    return;
  }
  const bool every_row_kept = CAUSAL ? first <= w0 : first < T;
  if (every_row_kept) {
    const int end = CAUSAL ? min(last, w0 + 15) : last;
    lo = first / BKEY;
    hi = end / BKEY + 1;
  } else {
    lo = 0;
    hi = (T + BKEY - 1) / BKEY;
  }
}

template <int HD, bool CAUSAL, bool ONE_PASS>
__global__ void __launch_bounds__(THREADS, 16 / WARPS)  // 16 warps an SM: 128 registers
masked_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ key_mask,
                        __nv_bfloat16* __restrict__ ctx, int nh, int T, float scale) {
  static_assert(HD == 64, "the fragments below cover 64-wide heads");
  constexpr int LD = HD + 8;         // padded bf16 row: ldmatrix without conflicts
  constexpr int TILE = BKEY * LD;    // elements of one K or V tile
  constexpr int ROW_CHUNKS = HD / 8;  // 16-byte chunks of one row
  // two [K, V] slots: the one-pass form's key tiles (padded rows), or the
  // two-pass form's ring (swizzled 8 KB tiles from the first 1024-byte
  // boundary; 4 x 8 KB + 1 KB fit in the slots' 36 KB)
  __shared__ __align__(128) __nv_bfloat16 ring[HOLD_TILES][2][TILE];
  __shared__ __align__(16) float kbias[MAX_T];  // 0, -1e9 (masked) or -inf (past T)
  __shared__ int span[2];                    // first and last kept key

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int qd = lane & 3;  // fragment column pair
  const int bh = blockIdx.y;
  const int b = bh / nh;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * T * HD;
  const int nkt = (T + BKEY - 1) / BKEY;
  const int* mask_row = key_mask + (size_t)b * T;

  // a 64-key tile of k or v from key kt * BKEY; keys past T read as zeros
  auto load_tile = [&](int slot, int which, int kt) {
    const __nv_bfloat16* src = which ? v : k;
    const uint32_t dst = smem_u32(&ring[slot][which][0]);
    for (int c = tid; c < BKEY * ROW_CHUNKS; c += THREADS) {
      const int row = c / ROW_CHUNKS;
      const int col = (c % ROW_CHUNKS) * 8;
      const int key = kt * BKEY + row;
      const bool ok = key < T;
      cp_async16(dst + (row * LD + col) * 2, src + base + (size_t)(ok ? key : 0) * HD + col, ok);
    }
  };

  if (ONE_PASS) {
    // every key tile has its own slot (slot = tile): K and V are on their
    // way while Q and the key mask are read
    for (int kt = 0; kt < nkt; ++kt) {
      load_tile(kt, 0, kt);
      load_tile(kt, 1, kt);
    }
    cp_async_commit();
  }

  // this warp's Q rows as m16n8k16 A fragments, four 16-deep k-steps
  const int w0 = q0 + warp * 16;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = w0 + g + 8 * (e & 1);
      const int col = kk * 16 + 2 * qd + 8 * (e >> 1);
      qa[kk][e] = r < T ? __ldg(reinterpret_cast<const uint32_t*>(q + base + (size_t)r * HD + col))
                        : 0u;
    }

  // the key bias and the span of kept keys
  if (tid == 0) {
    span[0] = T;
    span[1] = -1;
  }
  __syncthreads();
  int first = T, last = -1;
  for (int j = tid; j < nkt * BKEY; j += THREADS) {
    const bool kept = j < T && __ldg(mask_row + j) > 0;
    kbias[j] = j >= T ? -INFINITY : kept ? 0.f : MASKED;
    if (kept) {
      first = min(first, j);
      last = max(last, j);
    }
  }
  first = __reduce_min_sync(0xffffffffu, first);
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) {
    atomicMin(&span[0], first);
    atomicMax(&span[1], last);
  }
  __syncthreads();
  first = span[0];
  last = span[1];
  int lo, hi, blo = nkt, bhi = 0, glo = nkt, ghi = 0;
  warp_tiles<CAUSAL>(w0, T, first, last, lo, hi);
#pragma unroll 1
  for (int w = 0; w < WARPS; ++w) {
    int l_, h_;
    warp_tiles<CAUSAL>(q0 + w * 16, T, first, last, l_, h_);
    if (l_ < h_) {
      blo = min(blo, l_);
      bhi = max(bhi, h_);
      if (w / 4 == warp / 4) {  // the warpgroup's tiles: its wgmma runs for all four warps
        glo = min(glo, l_);
        ghi = max(ghi, h_);
      }
    }
  }
  const int n = bhi > blo ? bhi - blo : 0;  // key tiles the block streams

  // the warp's 16 x 64 score tile against key tile kt in `slot`, scaled and
  // biased: s[j][e] is row g + 8 (e >> 1), key kt * 64 + 8 j + 2 qd + (e & 1)
  auto scores = [&](int slot, int kt, float (&s)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t kbase = smem_u32(&ring[slot][0][0]);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        // matrices: keys jp*16 + {0-7, 0-7, 8-15, 8-15} x dims kk*16 + {0-7, 8-15, ...}
        const int mi = lane >> 3;
        const int key = jp * 16 + (mi >> 1) * 8 + (lane & 7);
        const int col = kk * 16 + (mi & 1) * 8;
        uint32_t bf[4];
        ldsm_x4(bf, kbase + (key * LD + col) * 2);
        mma_bf16(s[2 * jp], qa[kk], bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], bf[2], bf[3]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kt * BKEY + 8 * j + 2 * qd;
      const float2 kb = *reinterpret_cast<const float2*>(&kbias[key]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float bias = (e & 1) ? kb.y : kb.x;
        if (CAUSAL && key + (e & 1) > w0 + g + 8 * (e >> 1)) bias = fminf(bias, MASKED);
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), bias);
      }
    }
  };

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // o += bf16(p) . V for the key tile in `slot`; p[j][e] as s[j][e]
  auto pv = [&](int slot, const float (&p)[8][4]) {
    const uint32_t vbase = smem_u32(&ring[slot][1][0]);
#pragma unroll
    for (int kk = 0; kk < BKEY / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        // matrices: keys kk*16 + {0-7, 8-15, 0-7, 8-15} x dims dp*16 + {0-7, 0-7, 8-15, 8-15}
        const int mi = lane >> 3;
        const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
        const int col = dp * 16 + (mi >> 1) * 8;
        uint32_t bf[4];
        ldsm_x4_trans(bf, vbase + (key * LD + col) * 2);
        mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (ONE_PASS) {
    cp_async_wait<0>();
    __syncthreads();  // every tile landed
    float s[HOLD_TILES][8][4];
#pragma unroll
    for (int kt = 0; kt < HOLD_TILES; ++kt) {
      if (kt < nkt && kt >= lo && kt < hi) {
        scores(kt, kt, s[kt]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[kt][j][e]);
      }
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
#pragma unroll
    for (int kt = 0; kt < HOLD_TILES; ++kt) {
      if (kt < nkt && kt >= lo && kt < hi) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[kt][j][e] = expf(__fsub_rn(s[kt][j][e], m[e >> 1]));
            l[e >> 1] = __fadd_rn(l[e >> 1], s[kt][j][e]);
          }
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    const float r[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
    for (int kt = 0; kt < HOLD_TILES; ++kt) {
      if (kt < nkt && kt >= lo && kt < hi) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[kt][j][e] = div_rn(s[kt][j][e], l[e >> 1], r[e >> 1]);
        pv(kt, s[kt]);
      }
    }
  } else {
    // wgmma form: the K and V tiles lie 128-byte swizzled (rows of 64 bf16,
    // 16-byte chunk c of row r at chunk c ^ (r & 7)) on 1024-byte atoms
    // inside the ring; tile (slot, which) at sw0 + (2 slot + which) * 8 KB
    static_assert(4 * BKEY * HD * 2 + 1024 <= sizeof(ring), "four swizzled tiles fit");
    const uint32_t sw0 = (smem_u32(&ring[0][0][0]) + 1023u) & ~1023u;
    auto tile_addr = [&](int slot, int which) { return sw0 + (2 * slot + which) * (BKEY * HD * 2); };
    auto load_sw = [&](int slot, int which, int kt) {
      const __nv_bfloat16* src = which ? v : k;
      const uint32_t dst = tile_addr(slot, which);
      for (int c = tid; c < BKEY * ROW_CHUNKS; c += THREADS) {
        const int row = c / ROW_CHUNKS;
        const int ck = c % ROW_CHUNKS;
        const int key = kt * BKEY + row;
        const bool ok = key < T;
        cp_async16(dst + row * 128 + ((ck ^ (row & 7)) << 4),
                   src + base + (size_t)(ok ? key : 0) * HD + ck * 8, ok);
      }
    };
    // the warpgroup's 64 x 64 score tile, scaled and biased (layout as scores())
    auto scores_wg = [&](int slot, int kt, float (&s)[8][4]) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const uint64_t dk = smem_desc(tile_addr(slot, 0));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) wgmma_n64<0>(s, qa[kk], dk + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_tile(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = kt * BKEY + 8 * j + 2 * qd;
        const float2 kb = *reinterpret_cast<const float2*>(&kbias[key]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float bias = (e & 1) ? kb.y : kb.x;
          if (CAUSAL && key + (e & 1) > w0 + g + 8 * (e >> 1)) bias = fminf(bias, MASKED);
          s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), bias);
        }
      }
    };
    // o += bf16(p) . V through wgmma, V read MN-major (keys x dims as stored)
    auto pv_wg = [&](int slot, const float (&p)[8][4]) {
      uint32_t pa[BKEY / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKEY / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
        pa[kk][1] = pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
        pa[kk][2] = pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      }
      const uint32_t vaddr = tile_addr(slot, 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKEY / 16; ++kk)
        wgmma_n64<1>(o, pa[kk], smem_desc(vaddr + kk * 16 * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_tile(o);
      // the products read pa while in flight: it stays live until here
#pragma unroll
      for (int kk = 0; kk < BKEY / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
    };
    // steps 0 .. n-1: pass 1 over K tiles; n .. 2n-1: pass 2 over K and V;
    // step t in slot t & 1; the warpgroup walks [glo, ghi)
    auto issue = [&](int step) {
      if (step >= 2 * n) return;
      const int slot = step & 1;
      const bool second = step >= n;
      const int kt = blo + (second ? step - n : step);
      load_sw(slot, 0, kt);
      if (second) load_sw(slot, 1, kt);
    };
    issue(0);
    cp_async_commit();
    float r[2] = {0.f, 0.f};
    for (int step = 0; step < 2 * n; ++step) {
      cp_async_wait<0>();
      fence_async_smem();  // the copies' writes, made visible to wgmma (async proxy)
      // this step's tiles landed for every thread, and every warp is done
      // with the other slot (step - 1), which the next issue refills
      __syncthreads();
      issue(step + 1);
      cp_async_commit();
      const int slot = step & 1;
      const bool second = step >= n;
      const int kt = blo + (second ? step - n : step);
      if (second && step == n) {
        r[0] = __frcp_rn(l[0]);
        r[1] = __frcp_rn(l[1]);
      }
      if (kt >= glo && kt < ghi) {
        float s[8][4];
        scores_wg(slot, kt, s);
        if (!second) {
          float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float mn = fmaxf(m[rr], quad_max(mt[rr]));
            // the running sum, rescaled to the new max (0 before any key)
            l[rr] = __fmul_rn(l[rr], expf(__fsub_rn(m[rr], mn)));
            m[rr] = mn;
          }
          float lt[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              lt[e >> 1] = __fadd_rn(lt[e >> 1], expf(__fsub_rn(s[j][e], m[e >> 1])));
          l[0] = __fadd_rn(l[0], quad_sum(lt[0]));
          l[1] = __fadd_rn(l[1], quad_sum(lt[1]));
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = div_rn(expf(__fsub_rn(s[j][e], m[e >> 1])), l[e >> 1], r[e >> 1]);
          pv_wg(slot, s);
        }
      }
    }
  }

  // ctx rows of this warp, rounded to bf16
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w0 + g + 8 * h;
      if (r < T)
        *reinterpret_cast<uint32_t*>(ctx + base + (size_t)r * HD + 8 * j + 2 * qd) =
            pack_bf16x2(o[j][2 * h], o[j][2 * h + 1]);
    }
}

template <int HD, bool CAUSAL>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const int* key_mask, __nv_bfloat16* ctx, int B, int nh, int T, float scale,
                   cudaStream_t s) {
  const dim3 grid((T + BQ - 1) / BQ, B * nh);  // a (b, h)'s query tiles side by side
  if (T <= HOLD_TILES * BKEY)
    masked_attention_kernel<HD, CAUSAL, true><<<grid, THREADS, 0, s>>>(q, k, v, key_mask, ctx,
                                                                      nh, T, scale);
  else
    masked_attention_kernel<HD, CAUSAL, false><<<grid, THREADS, 0, s>>>(q, k, v, key_mask, ctx,
                                                                       nh, T, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, ctx: (B, nh, T, hd) bf16, contiguous, 16-byte aligned; key_mask:
// (B, T) int32, nonzero = a real token.  hd is 64; 1 <= T <= 512.  scale:
// float32(1 / sqrt(hd)).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int masked_attention(const void* q, const void* k, const void* v,
                                const void* key_mask, void* ctx, int B, int nh, int T, int hd,
                                int causal, float scale, void* stream) {
  if (B < 1 || nh < 1 || T < 1 || T > MAX_T) return (int)cudaErrorInvalidValue;
  // every tower the port loads (E5/XLM-R large and base, BERT, BioGPT) has
  // 64-wide heads
  if (hd != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* q_ = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* k_ = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* v_ = static_cast<const __nv_bfloat16*>(v);
  const int* m_ = static_cast<const int*>(key_mask);
  __nv_bfloat16* c_ = static_cast<__nv_bfloat16*>(ctx);
  return (int)(causal ? launch<64, true>(q_, k_, v_, m_, c_, B, nh, T, scale, s)
                      : launch<64, false>(q_, k_, v_, m_, c_, B, nh, T, scale, s));
}
