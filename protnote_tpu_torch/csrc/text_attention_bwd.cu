// Backward of the label text tower's masked softmax attention (K8a-bwd) for
// Hopper (sm_90a).
//
// Replaces what JAX derives by autodiff from the core of
// protnote_tpu/models/text_transformer.py:_attention (lines 182-190) when
// the tower trains.  With q, k, v, dctx (B, nh, T, 64) bf16, the key mask
// (B, T) int32 and, for gpt, the causal flag, the VJP that jax.vjp of that
// core gives (its jaxpr at bfloat16, on the CPU) is, per (b, h):
//
//   h    = (q.k in f32) * scale + bias       (bias -1e9 where a key is not kept)
//   m    = max_j h,  y = exp(h - m),  z = sum_j y
//   P    = bf16(y / z)                        (the forward's probabilities)
//   dV   = bf16(P^T . f32(dctx))              (f32 sums)
//   dP   = bf16(f32(dctx) . v^T)              (f32 sums, rounded to bf16)
//   D    = sum_j (dP * z^-2) * y
//   dS   = ((dP / z) + (-D)) * y * scale     (f32; scale = 1/sqrt(hd) = 1/8
//                                             exactly, JAX divides by 8.0)
//   dQ   = bf16(dS . k),  dK = bf16(dS^T . q) (f32 products of the f32 dS
//                                             with the bf16 operands)
//
// A row none of whose keys is kept (the filler rows of a padded chunk) has
// h = -1e9 on every key, so y = 1 and it gets the gradient of JAX's uniform
// softmax, not NaN.  Nothing is skipped: masked keys give y = 0 exactly.
//
// Two forms, chosen by T alone (ops/text_attention.py:backward_launches):
//
// T <= 128, one kernel (attn_bwd_one_pass, TMA + wgmma): a block a (b, h),
// whose whole score matrix fits in the block.  One thread asks TMA for Q, K,
// V and dctx (four 128 x 64 boxes through 3-D maps (64, T, B * nh): rows
// past T arrive as zeros, 16 KB each, 128-byte swizzled); two warpgroups of
// 64 query rows each form S = Q K^T and dP = dctx V^T with wgmma m64n128k16
// (both operands through descriptors, K-major as stored).  From those, in
// registers and in one pass over the whole row (no running rescale): h, the
// row max, y, z, P = bf16(y / z), D and dS, with JAX's operations in its
// order (D = sum (dP * (1 / z^2)) * y).  dQ = dS K takes dS straight from
// the accumulators as register A (hi and lo: two products), B = K read
// MN-major through the transpose bit.  P and dS (hi, lo) go to shared
// memory as [query][key] halves of 64 keys, 128-byte swizzled; after one
// block barrier each warpgroup forms its 64 keys' dV = P^T dctx and dK =
// dS^T Q (hi + lo) with wgmma m64n64k16, A = P or dS read MN-major (the
// transpose bit of A) and B = dctx or Q read MN-major; its three 64-row
// outputs go back through its own P and dS halves, which only its products
// read, as TMA stores (rows past T are not written).  That is 7 products
// of 128 x 128 x 64 (the two S-shaped ones, dV, dQ and dK twice) and one
// pass of exponentials; m, z and D never leave registers.  Keys and query
// rows past T: their K, V, Q and dctx rows are TMA's zeros and their key
// bias -inf, so y, P and dS are exactly 0 in their key columns and dS 0 in
// their query rows; nothing past T is stored.  Shared memory: 64 KB of
// inputs, 32 KB of P, 64 KB of dS: one block an SM (8 warps).
//
// 128 < T <= 512, two kernels on mma.sync (m16n8k16, bf16 in, f32
// accumulators), with the fragment patterns of the forward's one-pass form
// (csrc/text_attention.cu): Q.K^T, dctx.V^T, P^T.dctx are bf16 products as
// in JAX; dS, which JAX keeps in float32 into dQ and dK, is split into
// hi = bf16(dS) and lo = bf16(dS - hi), two products each (~16 bits of dS,
// its float32 value within 2^-17).  No atomics:
//  * attn_bwd_dq: a block owns 64 query rows of one (b, h), a warp 16.  Pass
//    1 walks the key tiles (64 keys of K and V in shared memory) forming h
//    and dP in registers, with a running max and rescaled sums of y and of
//    dP * y (z, and D * z^2); pass 2 forms h and dP again, dS with the final
//    m, z, D, and dQ += dS . K.  It writes m, z and D of each row.
//  * attn_bwd_dkdv: a block owns 64 keys, a warp 16, and walks the query
//    tiles: S^T = K . Q^T and dP^T = V . dctx^T in registers, P^T and dS^T
//    from the saved m, z, D, then dV += P^T . dctx and dK += dS^T . Q.
// m, z and D come from sums in another order than JAX's (the tensor cores'
// order; in the two-kernel form also the running rescale), a few ulps off
// its values.
//
// What bounds it on this card: at T 128 (B 128 x 16 heads) the function
// reads q, k, v, dctx and writes dq, dk, dv: 7 x 33.5 MB = 235 MB, 0.070 ms
// at 3.35 TB/s; its 5 products of 128 x 128 x 64 per (b, h) are 21.5 GFLOP,
// 0.022 ms at 989 TFLOP/s.  The one-pass kernel forms 7 (dS's two halves)
// and a block's loads, its products, its exponentials and its stores run
// one after the other: with one block an SM (160 KB of shared memory, 255
// registers a thread) nothing overlaps them but the next block's start.  On
// an H100 80GB HBM3 at 700 W (chip_variants.py --k8a-bwd, B 128 x 16 heads x
// T 128) it takes ~0.15 ms, SDPA's backward ~0.26-0.27, the two kernels
// ~0.57-0.61; taking out the loads, the stores or expf and the divisions
// saves ~0.02 ms each.  Its outputs first went out as 4-byte stores from the
// accumulators, half of its then ~0.19 ms: hence the TMA stores.  The
// two-kernel form above 128 forms 11 such products (h and dP twice in the
// first kernel, once more in the second) with the exponentials of three
// passes, and reads K and V (or Q and dctx) from L2 once per 64-row block.

#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 64;         // head width
constexpr int MAX_T = 512;     // label text is truncated at 510 tokens
constexpr int WARPS = 4;       // 16 rows (queries or keys) each
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16 * WARPS;  // rows of a block, rows of a streamed tile
constexpr int LD = HD + 8;     // padded bf16 row: ldmatrix without conflicts
constexpr float MASKED = -1e9f;

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows [row0, row0 + 64) of a (T, 64) bf16 matrix into a padded tile; rows
// at or past T are zero
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int T) {
  for (int c = threadIdx.x; c < TILE * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + col));
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// a warp's 16 rows from r0 of a (T, 64) bf16 matrix as m16n8k16 A fragments,
// four 16-deep k-steps (rows at or past T zero)
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4], const __nv_bfloat16* src, int r0,
                                       int T, int g, int qd) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1);
      const int col = kk * 16 + 2 * qd + 8 * (e >> 1);
      a[kk][e] = r < T ? __ldg(reinterpret_cast<const uint32_t*>(src + (size_t)r * HD + col)) : 0u;
    }
}

// s = a . tile^T: the warp's 16 rows against the 64 rows of `tile` (as
// stored, [row][LD]); s[j][e] is row g + 8 (e >> 1), tile row 8 j + 2 qd +
// (e & 1)
__device__ __forceinline__ void prod_nt(float (&s)[8][4], const uint32_t (&a)[HD / 16][4],
                                        uint32_t tile, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int row = jp * 16 + (mi >> 1) * 8 + (lane & 7);
      const int col = kk * 16 + (mi & 1) * 8;
      uint32_t bf[4];
      ldsm_x4(bf, tile + (row * LD + col) * 2);
      mma_bf16(s[2 * jp], a[kk], bf[0], bf[1]);
      mma_bf16(s[2 * jp + 1], a[kk], bf[2], bf[3]);
    }
}

// the A fragments of a 16 x 64 tile held in the accumulator layout
__device__ __forceinline__ void to_a(uint32_t (&pa)[4][4], const float (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// o += p . tile: p (16 x 64, A fragments over the tile's 64 rows) times the
// tile as stored ([row][LD], 64 columns); o[j][e] is row g + 8 (e >> 1),
// column 8 j + 2 qd + (e & 1)
__device__ __forceinline__ void prod_nn(float (&o)[8][4], const uint32_t (&pa)[4][4],
                                        uint32_t tile, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      const int row = kk * 16 + (mi & 1) * 8 + (lane & 7);
      const int col = dp * 16 + (mi >> 1) * 8;
      uint32_t bf[4];
      ldsm_x4_trans(bf, tile + (row * LD + col) * 2);
      mma_bf16(o[2 * dp], pa[kk], bf[0], bf[1]);
      mma_bf16(o[2 * dp + 1], pa[kk], bf[2], bf[3]);
    }
}

// x = hi + lo with hi = bf16(x), lo = bf16(x - hi): the A fragments of both
__device__ __forceinline__ void split_a(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                        const float (&x)[8][4]) {
  float h[8][4], l[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[j][e] = bf16_round(x[j][e]);
      l[j][e] = __fsub_rn(x[j][e], h[j][e]);
    }
  to_a(hi, h);
  to_a(lo, l);
}

// a warp's 16 x 64 tile o as bf16 rows r0.. of a (T, 64) matrix
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&o)[8][4], int r0,
                                           int T, int g, int qd) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r < T)
        *reinterpret_cast<uint32_t*>(dst + (size_t)r * HD + 8 * j + 2 * qd) =
            pack_bf16x2(o[j][2 * h], o[j][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// dQ and the row statistics: grid (ceil(T / 64), nh, B)

template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dctx,
            const int* __restrict__ key_mask, __nv_bfloat16* __restrict__ dq,
            float* __restrict__ stats, int nh, int T, float scale) {
  __shared__ __align__(128) __nv_bfloat16 Ks[TILE * LD], Vs[TILE * LD];
  __shared__ float kbias[MAX_T];  // 0, -1e9 (masked) or -inf (past T)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int b = blockIdx.z, hh = blockIdx.y;
  const int w0 = blockIdx.x * TILE + warp * 16;
  const size_t base = ((size_t)b * nh + hh) * T * HD;
  const int nkt = (T + TILE - 1) / TILE;
  const int* mask_row = key_mask + (size_t)b * T;
  for (int j = tid; j < nkt * TILE; j += THREADS)
    kbias[j] = j >= T ? -INFINITY : __ldg(mask_row + j) > 0 ? 0.f : MASKED;
  uint32_t qa[HD / 16][4], ga[HD / 16][4];
  load_a(qa, q + base, w0, T, g, qd);
  load_a(ga, dctx + base, w0, T, g, qd);

  // h and bf16(dP) of the warp's rows against key tile kt
  auto tile_scores = [&](int kt, float (&s)[8][4], float (&dp)[8][4]) {
    __syncthreads();  // the previous tile is read
    load_tile(Ks, k + base, kt * TILE, T);
    load_tile(Vs, v + base, kt * TILE, T);
    __syncthreads();
    prod_nt(s, qa, smem_u32(Ks), lane);
    prod_nt(dp, ga, smem_u32(Vs), lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * TILE + 8 * j + 2 * qd + (e & 1);
        float bias = kbias[key];
        if (CAUSAL && key > w0 + g + 8 * (e >> 1)) bias = fminf(bias, MASKED);
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), bias);
        dp[j][e] = bf16_round(dp[j][e]);
      }
  };

  // pass 1: the running max, z and u = sum dP * y of rows g (r 0), g + 8 (r 1)
  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  float s[8][4], dp[8][4];
  for (int kt = 0; kt < nkt; ++kt) {
    tile_scores(kt, s, dp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float mn = fmaxf(m[r], quad_max(mt));  // finite: key 0 is < T
      const float c = expf(__fsub_rn(m[r], mn));
      z[r] = __fmul_rn(z[r], c);
      u[r] = __fmul_rn(u[r], c);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float y = expf(__fsub_rn(s[j][e], mn));
          z[r] = __fadd_rn(z[r], y);
          u[r] = __fadd_rn(u[r], __fmul_rn(dp[j][e], y));
        }
      m[r] = mn;
    }
  }
  float D[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    z[r] = quad_sum(z[r]);
    D[r] = __fmul_rn(quad_sum(u[r]), __fdiv_rn(1.0f, __fmul_rn(z[r], z[r])));
  }

  // pass 2: dS with the final m, z, D; dQ += dS . K (dS as hi + lo)
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    tile_scores(kt, s, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float y = expf(__fsub_rn(s[j][e], m[r]));
        s[j][e] = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(dp[j][e], z[r]), -D[r]), y), scale);
      }
    uint32_t hi[4][4], lo[4][4];
    split_a(hi, lo, s);
    prod_nn(o, hi, smem_u32(Ks), lane);
    prod_nn(o, lo, smem_u32(Ks), lane);
  }
  store_rows(dq + base, o, w0, T, g, qd);
  if (qd == 0) {
    const size_t plane = (size_t)gridDim.z * nh * T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = w0 + g + 8 * r;
      if (i < T) {
        const size_t at = ((size_t)b * nh + hh) * T + i;
        stats[at] = m[r];
        stats[plane + at] = z[r];
        stats[2 * plane + at] = D[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV: grid (ceil(T / 64), nh, B)

template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dctx,
              const int* __restrict__ key_mask, const float* __restrict__ stats,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int nh, int T,
              float scale) {
  __shared__ __align__(128) __nv_bfloat16 Qs[TILE * LD], Gs[TILE * LD];
  __shared__ float Ms[TILE], Zs[TILE], Ds[TILE], qbias[TILE];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int b = blockIdx.z, hh = blockIdx.y;
  const int j0 = blockIdx.x * TILE + warp * 16;  // the warp's first key
  const size_t base = ((size_t)b * nh + hh) * T * HD;
  const size_t srow = ((size_t)b * nh + hh) * T;
  const size_t plane = (size_t)gridDim.z * nh * T;
  const int* mask_row = key_mask + (size_t)b * T;
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_a(ka, k + base, j0, T, g, qd);
  load_a(va, v + base, j0, T, g, qd);
  float kb[2];  // the bias of the warp's keys g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = j0 + g + 8 * r;
    kb[r] = key >= T ? -INFINITY : __ldg(mask_row + key) > 0 ? 0.f : MASKED;
  }

  float adv[8][4], adk[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adv[j][e] = adk[j][e] = 0.f;
  const int nqt = (T + TILE - 1) / TILE;
  for (int it = 0; it < nqt; ++it) {
    const int i0 = it * TILE;
    __syncthreads();  // the previous tile is read
    load_tile(Qs, q + base, i0, T);
    load_tile(Gs, dctx + base, i0, T);
    for (int e = tid; e < TILE; e += THREADS) {
      const bool in = i0 + e < T;
      Ms[e] = in ? stats[srow + i0 + e] : 0.f;
      Zs[e] = in ? stats[plane + srow + i0 + e] : 1.f;
      Ds[e] = in ? stats[2 * plane + srow + i0 + e] : 0.f;
      qbias[e] = in ? 0.f : -INFINITY;
    }
    __syncthreads();
    // S^T and dP^T: st[j][e] is key j0 + g + 8 (e >> 1), query i0 + 8 j + 2 qd + (e & 1)
    float st[8][4], dpt[8][4];
    prod_nt(st, ka, smem_u32(Qs), lane);
    prod_nt(dpt, va, smem_u32(Gs), lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qi = 8 * j + 2 * qd + (e & 1);
        float bias = fminf(kb[r], qbias[qi]);
        if (CAUSAL && j0 + g + 8 * r > i0 + qi) bias = fminf(bias, MASKED);
        const float h = __fadd_rn(__fmul_rn(st[j][e], scale), bias);
        const float y = expf(__fsub_rn(h, Ms[qi]));
        const float zq = Zs[qi];
        st[j][e] = bf16_round(__fdiv_rn(y, zq));  // P^T
        const float d = bf16_round(dpt[j][e]);
        dpt[j][e] = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(d, zq), -Ds[qi]), y), scale);  // dS^T
      }
    uint32_t pa[4][4], hi[4][4], lo[4][4];
    to_a(pa, st);
    prod_nn(adv, pa, smem_u32(Gs), lane);
    split_a(hi, lo, dpt);
    prod_nn(adk, hi, smem_u32(Qs), lane);
    prod_nn(adk, lo, smem_u32(Qs), lane);
  }
  store_rows(dv + base, adv, j0, T, g, qd);
  store_rows(dk + base, adk, j0, T, g, qd);
}

// ---------------------------------------------------------------------------
// T <= 128: the one-pass kernel, one block a (b, h)

constexpr int OP_T = 128;                 // the one-pass form's largest T
constexpr int OP_THREADS = 256;           // two warpgroups of 64 query rows
constexpr int OP_TILE = OP_T * HD * 2;    // one 128 x 64 bf16 box: 16 KB
constexpr int OP_HALF = OP_T * 64 * 2;    // 128 queries x 64 keys of P or dS: 16 KB
constexpr int OP_Q = 0, OP_K = OP_TILE, OP_V = 2 * OP_TILE, OP_G = 3 * OP_TILE;
constexpr int OP_P = 4 * OP_TILE;         // P: halves of keys 0-63, 64-127
constexpr int OP_HI = OP_P + 2 * OP_HALF;  // bf16(dS)
constexpr int OP_LO = OP_HI + 2 * OP_HALF;  // bf16(dS - hi)
constexpr int OP_BIAS = OP_LO + 2 * OP_HALF;  // float key bias [128]
constexpr int OP_BAR = OP_BIAS + OP_T * 4;
constexpr int OP_SMEM = 1024 + OP_BAR + 16;  // + alignment slack
static_assert(OP_SMEM <= 232448, "shared memory");

// wgmma m64n64k16 with A and B through descriptors; TA / TB: read A / B
// MN-major (the transpose bits).  d[4j + e]: row g + 8 (e >> 1) of the
// warp's 16, column 8 j + 2 q + (e & 1).  scale_d 0 overwrites.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// the same with A from registers (the warp's m16n8k16 A fragment), B read
// MN-major
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// a warpgroup's 64 x 64 tile d (wgmma layout) as bf16 into a 64-row box at
// `box`, 128-byte swizzled as TMA stores it (row r's 16-byte chunk j at
// j ^ (r & 7); r & 7 = g)
__device__ __forceinline__ void stage_tile(uint32_t box, const float (&d)[32], int warp, int g,
                                           int qd) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st_shared(box + r * 128 + ((j ^ g) << 4) + 4 * qd,
                pack_bf16x2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));
  }
}

template <bool CAUSAL>
__global__ void __launch_bounds__(OP_THREADS, 1)
attn_bwd_one_pass(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_g,
                  const __grid_constant__ CUtensorMap tm_dq,
                  const __grid_constant__ CUtensorMap tm_dk,
                  const __grid_constant__ CUtensorMap tm_dv, const int* __restrict__ key_mask,
                  int nh, int T, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  float* kbias = reinterpret_cast<float*>(smem + OP_BIAS);  // 0, -1e9 (masked) or -inf (past T)
  const uint32_t bar = base + OP_BAR;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / nh;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, 4 * OP_TILE);
    tma_load_3d(base + OP_Q, &tm_q, 0, 0, bh, bar);
    tma_load_3d(base + OP_K, &tm_k, 0, 0, bh, bar);
    tma_load_3d(base + OP_V, &tm_v, 0, 0, bh, bar);
    tma_load_3d(base + OP_G, &tm_g, 0, 0, bh, bar);
  }
  const int* mask_row = key_mask + (size_t)b * T;
  for (int j = tid; j < OP_T; j += OP_THREADS)
    kbias[j] = j >= T ? -INFINITY : __ldg(mask_row + j) > 0 ? 0.f : MASKED;
  __syncthreads();  // the barrier's init and the key bias
  mbar_wait(bar, 0);

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = wg * 64 + warp * 16 + g;  // the thread's query rows: row0, row0 + 8

  // ---- S = Q K^T and dP = dctx V^T: the warpgroup's 64 rows x 128 keys ---
  float s[64], dp[64];
  {
    const uint64_t dqa = smem_desc(base + OP_Q + wg * 64 * 128);
    const uint64_t dga = smem_desc(base + OP_G + wg * 64 * 128);
    const uint64_t dkb = smem_desc(base + OP_K), dvb = smem_desc(base + OP_V);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) Mma<128>::ss(s, dqa + 2 * kk, dkb + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) Mma<128>::ss(dp, dga + 2 * kk, dvb + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
  }

  // ---- the row statistics, P and dS: s[4j + e] is row row0 + 8 (e >> 1),
  // key 8 j + 2 qd + (e & 1) ----------------------------------------------
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 kb = *reinterpret_cast<const float2*>(&kbias[8 * j + 2 * qd]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * qd + (e & 1);
      float bias = (e & 1) ? kb.y : kb.x;
      if (CAUSAL && key > row0 + 8 * (e >> 1)) bias = fminf(bias, MASKED);
      s[4 * j + e] = __fadd_rn(__fmul_rn(s[4 * j + e], scale), bias);
      m[e >> 1] = fmaxf(m[e >> 1], s[4 * j + e]);
    }
  }
  m[0] = quad_max(m[0]);  // finite: key 0 is < T
  m[1] = quad_max(m[1]);
  float z[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = expf(__fsub_rn(s[i], m[(i >> 1) & 1]));  // y
    z[(i >> 1) & 1] = __fadd_rn(z[(i >> 1) & 1], s[i]);
  }
  z[0] = quad_sum(z[0]);
  z[1] = quad_sum(z[1]);
  const float iz2[2] = {__fdiv_rn(1.0f, __fmul_rn(z[0], z[0])),
                        __fdiv_rn(1.0f, __fmul_rn(z[1], z[1]))};
  const float rz[2] = {__frcp_rn(z[0]), __frcp_rn(z[1])};
  float D[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    dp[i] = bf16_round(dp[i]);
    D[r] = __fadd_rn(D[r], __fmul_rn(__fmul_rn(dp[i], iz2[r]), s[i]));
  }
  D[0] = quad_sum(D[0]);
  D[1] = quad_sum(D[1]);
  // P to shared memory, dS = ((dP / z) + (-D)) * y * scale into dp; row
  // `row` of a [query][64-key] half at row * 128, 16-byte chunk c of keys
  // 8c.. at chunk c ^ (row & 7) (the swizzle TMA writes; row & 7 = g)
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t half = base + OP_P + (j >> 3) * OP_HALF + ((((j & 7) ^ g)) << 4) + 4 * qd;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      st_shared(half + (row0 + 8 * h) * 128,
                pack_bf16x2(div_rn(s[i], z[h], rz[h]), div_rn(s[i + 1], z[h], rz[h])));
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dp[i + e] = __fmul_rn(__fmul_rn(__fadd_rn(div_rn(dp[i + e], z[h], rz[h]), -D[h]), s[i + e]),
                              scale);
    }
  }
  // dS as hi = bf16(dS) and lo = bf16(dS - hi): the A fragments of dQ's
  // products (k-step kk: keys 16 kk ..; the accumulator layout is the A
  // layout), and their bf16 pairs in shared memory for dK's
  uint32_t hi[8][4], lo[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // a0..a3: (g, 2q) (g + 8, 2q) (g, 2q + 8) (g + 8, 2q + 8)
      const int i = 4 * (2 * kk + (f >> 1)) + 2 * (f & 1);
      const float h0 = bf16_round(dp[i]), h1 = bf16_round(dp[i + 1]);
      hi[kk][f] = pack_bf16x2(h0, h1);
      lo[kk][f] = pack_bf16x2(__fsub_rn(dp[i], h0), __fsub_rn(dp[i + 1], h1));
      const int j = 2 * kk + (f >> 1);
      const uint32_t at = (j >> 3) * OP_HALF + (row0 + 8 * (f & 1)) * 128 + (((j & 7) ^ g) << 4) +
                          4 * qd;
      st_shared(base + OP_HI + at, hi[kk][f]);
      st_shared(base + OP_LO + at, lo[kk][f]);
    }

  // ---- dQ = dS K (hi + lo): K read MN-major, a k-step 16 keys ------------
  float aq[32], av[32], ak[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs_n64_t(aq, hi[kk], smem_desc(base + OP_K + kk * 16 * 128), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs_n64_t(aq, lo[kk], smem_desc(base + OP_K + kk * 16 * 128), 1);
  wgmma_commit();
  fence_async_smem();  // P and dS in shared memory, made visible to wgmma
  __syncthreads();     // every row's P and dS is written

  // ---- the warpgroup's 64 keys: dV = P^T dctx, dK = dS^T Q (hi + lo), A
  // and B read MN-major, a k-step 16 queries ---------------------------------
  const uint32_t mine = wg * OP_HALF;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss_n64<1, 1>(av, smem_desc(base + OP_P + mine + kk * 16 * 128),
                       smem_desc(base + OP_G + kk * 16 * 128), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss_n64<1, 1>(ak, smem_desc(base + OP_HI + mine + kk * 16 * 128),
                       smem_desc(base + OP_Q + kk * 16 * 128), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss_n64<1, 1>(ak, smem_desc(base + OP_LO + mine + kk * 16 * 128),
                       smem_desc(base + OP_Q + kk * 16 * 128), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(aq);
  fence_acc(av);
  fence_acc(ak);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)  // dQ's register operands stay live until here
#pragma unroll
    for (int f = 0; f < 4; ++f) asm volatile("" : "+r"(hi[kk][f]), "+r"(lo[kk][f])::"memory");

  // ---- the outputs through shared memory and TMA: the warpgroup's own P
  // and dS halves (read by its products alone) are free once they are done;
  // rows past T are not written ----------------------------------------------
  const uint32_t out_q = base + OP_P + mine, out_v = out_q + OP_HALF / 2;
  const uint32_t out_k = base + OP_HI + mine;
  stage_tile(out_q, aq, warp, g, qd);
  stage_tile(out_v, av, warp, g, qd);
  stage_tile(out_k, ak, warp, g, qd);
  fence_async_smem();  // the staged tiles, made visible to TMA
  warpgroup_barrier(1 + wg);
  if (tid % 128 == 0) {
    tma_store_3d(&tm_dq, out_q, 0, wg * 64, bh);
    tma_store_3d(&tm_dv, out_v, 0, wg * 64, bh);
    tma_store_3d(&tm_dk, out_k, 0, wg * 64, bh);
    bulk_commit();
    bulk_wait_all();  // the stores leave before the block
  }
}

template <bool CAUSAL>
cudaError_t launch_one_pass(const void* q, const void* k, const void* v, const void* g,
                            const int* mask, __nv_bfloat16* dq, __nv_bfloat16* dk,
                            __nv_bfloat16* dv, int B, int nh, int T, float scale, cudaStream_t s) {
  // q, k, v, dctx loaded in 128-row boxes; dq, dk, dv stored in a
  // warpgroup's 64-row boxes
  CUtensorMap maps[7];
  memset(maps, 0, sizeof(maps));
  const void* ptr[7] = {q, k, v, g, dq, dk, dv};
  for (int i = 0; i < 7; ++i)
    if (reinterpret_cast<uintptr_t>(ptr[i]) % 16 != 0 ||
        !make_map_3d(&maps[i], ptr[i], MapType::BF16, (uint64_t)B * nh, T, HD, i < 4 ? OP_T : 64,
                     HD, true))
      return cudaErrorInvalidValue;
  auto kernel = attn_bwd_one_pass<CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         OP_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<B * nh, OP_THREADS, OP_SMEM, s>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
                                             maps[6], mask, nh, T, scale);
  return cudaGetLastError();
}

template <bool CAUSAL>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const __nv_bfloat16* g, const int* mask, __nv_bfloat16* dq,
                   __nv_bfloat16* dk, __nv_bfloat16* dv, float* stats, int B, int nh, int T,
                   float scale, cudaStream_t s) {
  const dim3 grid((T + TILE - 1) / TILE, nh, B);
  attn_bwd_dq<CAUSAL><<<grid, THREADS, 0, s>>>(q, k, v, g, mask, dq, stats, nh, T, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv<CAUSAL><<<grid, THREADS, 0, s>>>(q, k, v, g, mask, stats, dk, dv, nh, T, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dctx, dq, dk, dv: (B, nh, T, 64) bf16, contiguous, 16-byte
// aligned; key_mask (B, T) int32.  T <= 128: the one-pass kernel, one
// launch (stats unused, may be null); 128 < T <= 512: the two kernels, with
// stats 3 * B * nh * T float32 scratch (each row's m, z, D).  On `stream`;
// returns the CUDA error (0 on success).  two_kernels forces the two-kernel
// form at any T (stats required).
static int backward(const void* q, const void* k, const void* v, const void* dctx,
                    const void* key_mask, void* dq, void* dk, void* dv, void* stats, int B,
                    int nh, int T, int hd, int causal, float scale, void* stream,
                    bool two_kernels) {
  if (B < 1 || nh < 1 || T < 1 || T > MAX_T || hd != HD ||
      ((two_kernels || T > OP_T) && stats == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* m_ = static_cast<const int*>(key_mask);
  __nv_bfloat16* dq_ = static_cast<__nv_bfloat16*>(dq);
  __nv_bfloat16* dk_ = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dv_ = static_cast<__nv_bfloat16*>(dv);
  if (!two_kernels && T <= OP_T) {
    auto one_pass = causal ? launch_one_pass<true> : launch_one_pass<false>;
    return (int)one_pass(q, k, v, dctx, m_, dq_, dk_, dv_, B, nh, T, scale, s);
  }
  const __nv_bfloat16* q_ = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* k_ = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* v_ = static_cast<const __nv_bfloat16*>(v);
  const __nv_bfloat16* g_ = static_cast<const __nv_bfloat16*>(dctx);
  float* st = static_cast<float*>(stats);
  return (int)(causal ? launch<true>(q_, k_, v_, g_, m_, dq_, dk_, dv_, st, B, nh, T, scale, s)
                      : launch<false>(q_, k_, v_, g_, m_, dq_, dk_, dv_, st, B, nh, T, scale, s));
}

extern "C" int masked_attention_backward(const void* q, const void* k, const void* v,
                                         const void* dctx, const void* key_mask, void* dq,
                                         void* dk, void* dv, void* stats, int B, int nh, int T,
                                         int hd, int causal, float scale, void* stream) {
  return backward(q, k, v, dctx, key_mask, dq, dk, dv, stats, B, nh, T, hd, causal, scale, stream,
                  false);
}

// The two-kernel form at any T <= 512: the comparison the card tests and
// chip_variants.py --k8a-bwd make at T <= 128, where the port's wrapper
// launches the one-pass kernel.
extern "C" int masked_attention_backward_two_kernels(const void* q, const void* k, const void* v,
                                                     const void* dctx, const void* key_mask,
                                                     void* dq, void* dk, void* dv, void* stats,
                                                     int B, int nh, int T, int hd, int causal,
                                                     float scale, void* stream) {
  return backward(q, k, v, dctx, key_mask, dq, dk, dv, stats, B, nh, T, hd, causal, scale, stream,
                  true);
}
