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
// Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulators), with the fragment patterns of the forward's one-pass form
// (csrc/text_attention.cu): Q.K^T, dctx.V^T, P^T.dctx are bf16 products as
// in JAX; dS, which JAX keeps in float32 into dQ and dK, is split into
// hi = bf16(dS) and lo = bf16(dS - hi), two products each (~16 bits of dS,
// its float32 value within 2^-17).  Two kernels, no atomics:
//  * attn_bwd_dq: a block owns 64 query rows of one (b, h), a warp 16.  Pass
//    1 walks the key tiles (64 keys of K and V in shared memory) forming h
//    and dP in registers, with a running max and rescaled sums of y and of
//    dP * y (z, and D * z^2); pass 2 forms h and dP again, dS with the final
//    m, z, D, and dQ += dS . K.  It writes m, z and D of each row.
//  * attn_bwd_dkdv: a block owns 64 keys, a warp 16, and walks the query
//    tiles: S^T = K . Q^T and dP^T = V . dctx^T in registers, P^T and dS^T
//    from the saved m, z, D, then dV += P^T . dctx and dK += dS^T . Q.
// m, z and D come from sums in another order than JAX's (the running
// rescale, the tensor cores' order), a few ulps off its values.
//
// What bounds it on this card: at T 128 (B 128 x 16 heads) the function
// reads q, k, v, dctx and writes dq, dk, dv: 7 x 33.5 MB = 235 MB, 0.070 ms
// at 3.35 TB/s; its 5 products of 128 x 128 x 64 per (b, h) are 21.5 GFLOP,
// 0.022 ms at 989 TFLOP/s.  These kernels form 11 such products (h and dP
// twice in the first kernel, once more in the second; dS's two halves) on
// mma.sync, with the exponentials of three passes; K and V (or Q and
// dctx) are read from L2 once per 64-row block.

#include "hopper.cuh"  // smem_u32, pack_bf16x2, ldsm_x4_trans

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
// aligned; key_mask (B, T) int32; stats: 3 * B * nh * T float32 scratch
// (each row's m, z, D).  Two launches on `stream`.  Returns the CUDA error
// (0 on success).
extern "C" int masked_attention_backward(const void* q, const void* k, const void* v,
                                         const void* dctx, const void* key_mask, void* dq,
                                         void* dk, void* dv, void* stats, int B, int nh, int T,
                                         int hd, int causal, float scale, void* stream) {
  if (B < 1 || nh < 1 || T < 1 || T > MAX_T || hd != HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* q_ = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* k_ = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* v_ = static_cast<const __nv_bfloat16*>(v);
  const __nv_bfloat16* g_ = static_cast<const __nv_bfloat16*>(dctx);
  const int* m_ = static_cast<const int*>(key_mask);
  __nv_bfloat16* dq_ = static_cast<__nv_bfloat16*>(dq);
  __nv_bfloat16* dk_ = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dv_ = static_cast<__nv_bfloat16*>(dv);
  float* st = static_cast<float*>(stats);
  return (int)(causal ? launch<true>(q_, k_, v_, g_, m_, dq_, dk_, dv_, st, B, nh, T, scale, s)
                      : launch<false>(q_, k_, v_, g_, m_, dq_, dk_, dv_, st, B, nh, T, scale, s));
}
