// K8a f32 and K8a-bwd f32 in their first design, which the port no longer
// uses: every product on the FMA pipe, a block's score rows in a (64, T)
// shared buffer, tiles staged with plain loads between two barriers, and a
// backward of two kernels at every T (seven products).  Kept as it was for
// chip_variants.py --k8a-f32, which times it against the kept kernels
// (csrc/text_attention_f32.cu) in turns; its entry points keep their
// signatures.
//
// Masked softmax attention of the label text tower in float32 (K8a and
// K8a-bwd under MIXED_PRECISION False) for Hopper (sm_90a).
//
// Replaces the core of protnote_tpu/models/text_transformer.py:_attention
// (lines 182-190) at float32, where the einsums run at Precision.HIGHEST and
// nothing is rounded to bf16:
//
//   s    = (q.k in f32) * scale + bias        (each op rounded on its own)
//   m    = max_j s,  y = expf(s - m),  z = sum_j y
//   p    = y / z                               (a correctly rounded division)
//   ctx  = p.v                                 (f32 sums)
//
// with q, k, v (B, nh, T, 64) float32, `scale` the float32 reciprocal of
// sqrt(64) that jitted XLA multiplies by, and the additive bias -1e9 on keys
// whose key_mask is 0 and, causal (gpt), on keys after the query.  A row none
// of whose keys is kept gets JAX's uniform softmax over all T keys.
// And its backward, the float32 VJP that jax.vjp of the core gives:
//
//   dV = p^T.dctx,  dP = dctx.v^T,  D = sum_j (dP * z^-2) * y
//   dS = ((dP / z) + (-D)) * y * scale,  dQ = dS.k,  dK = dS^T.q
//
// Everything runs on the FMA pipe: the products have depth 64 (q.k, dctx.v)
// or at most 512 (p.v, dS.k, dS^T.q, p^T.dctx), one float32 FMA chain an
// output in a fixed order, well inside 1e-5 of the plain float32 version
// without a split onto the tensor cores.  The order of every sum is fixed
// (tests/test_torch_tower_f32.py emulates it in numpy against JAX): a dot
// product runs over its depth in order, a row's max, sum and D are lane
// partial sums over the keys j = lane + 32 t in order, then a butterfly
// (xor 16, 8, 4, 2, 1).
//
// Design (a first, simple form): 256 threads a block, 64-wide float32
// tiles in shared memory at a row pitch of 68 floats; each thread holds a
// 4 x 4 (or 2 x 4) register tile of an output, its rows ty + 16 i and
// columns tx + 16 j (or tx * 4 + j), so a warp's float4 reads of a tile
// fall in distinct banks.
// * forward: a block a (b, h, 64 queries): the scores of every key tile
//   into a (64, T) row buffer, then a warp a row for the exact softmax,
//   then p.v over the V tiles;
// * dQ: a block a (b, h, 32 queries): s and dP of every key tile into two
//   (32, T) buffers, a warp a row for m, y, z, D and dS (m, z and D also
//   written out), then dS.k over the K tiles;
// * dK and dV: a block a (b, h, 64 keys) walks the query tiles, recomputes
//   s^T and dP^T from q, dctx and the rows' m, z, D (the same FMA chains,
//   so y and p are the forward's bits), and adds p^T.dctx and dS^T.q.
// No atomics: every call gives the same bits.
//
// What bounds it: operations.  The forward's two products are 4 T^2 64
// float32 operations a (b, h): at 128 x 16 heads x T 128 that is 8.6 GFLOP,
// 0.128 ms at 67 TFLOP/s (the bytes, 134 MB, take 0.040 ms); the backward's
// five necessary products 0.320 ms.  This design runs seven (s and dP are
// formed twice) and stages every tile through shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;            // head width
constexpr int LD = HD + 4;        // row pitch of a shared 64-wide tile (floats)
constexpr int BK = 64;            // keys (or queries) a tile
constexpr int MAX_T = 512;
constexpr int THREADS = 256;
constexpr float MASKED = -1e9f;   // the JAX package's additive mask value

__device__ __forceinline__ float comp(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

__host__ __device__ __forceinline__ int padded(int T) { return (T + BK - 1) / BK * BK; }

// rows [r0, r0 + n) of a (T, 64) matrix into a shared tile at pitch LD,
// rows at or past T zero-filled; the block's threads read float4s in order
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int n, int T) {
  for (int i = threadIdx.x; i < n * (HD / 4); i += THREADS) {
    const int r = i / (HD / 4), c = i % (HD / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) v = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * HD) + c);
    *reinterpret_cast<float4*>(dst + r * LD + 4 * c) = v;
  }
}

// acc[i][j] += sum over d in order of A[ty + 16 i][d] * B[tx + 16 j][d]: both
// operands' rows lie along the 64-deep sum (q.k, dctx.v), one FMA chain an
// output
template <int I, int J>
__device__ __forceinline__ void dot_nt(float (&acc)[I][J], const float* A, const float* B,
                                       int ty, int tx) {
#pragma unroll 4
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    float4 a[I], b[J];
#pragma unroll
    for (int i = 0; i < I; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + 4 * d4);
#pragma unroll
    for (int j = 0; j < J; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + 4 * d4);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd)
#pragma unroll
      for (int i = 0; i < I; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] = fmaf(comp(a[i], dd), comp(b[j], dd), acc[i][j]);
  }
}

// acc[i][j] += sum over r in [0, 64) in order of A[ty + 16 i][a0 + r] *
// B[r][4 tx + j]: A's rows along the sum (p, dS, p^T, dS^T at pitch lda), B
// a 64-row tile whose rows are the sum's index (v, k, dctx, q)
template <int I>
__device__ __forceinline__ void dot_nn(float (&acc)[I][4], const float* A, int lda, int a0,
                                       const float* B, int ty, int tx) {
#pragma unroll 2
  for (int r4 = 0; r4 < BK / 4; ++r4) {
    float4 a[I], b[4];
#pragma unroll
    for (int i = 0; i < I; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * lda + a0 + 4 * r4);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) b[rr] = *reinterpret_cast<const float4*>(B + (4 * r4 + rr) * LD + 4 * tx);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int i = 0; i < I; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(comp(a[i], rr), comp(b[rr], j), acc[i][j]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kbias[j] of every key: 0 (kept), -1e9 (masked); keys past T -inf
__device__ __forceinline__ void load_key_bias(float* kbias, const int* __restrict__ mask, int T) {
  for (int j = threadIdx.x; j < padded(T); j += THREADS)
    kbias[j] = j >= T ? -INFINITY : mask[j] != 0 ? 0.f : MASKED;
}

// the score of (query q, key k) from its q.k sum: (sum * scale) + bias, the
// bias -1e9 on a masked key or (causal) a key after the query; -inf past T
__device__ __forceinline__ float score(float dot, float scale, const float* kbias, int q, int k,
                                      bool causal) {
  float bias = kbias[k];
  if (causal && k > q && bias == 0.f) bias = MASKED;
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// a row's max over its T keys and y = expf(s - m) in place; returns z
__device__ __forceinline__ float softmax_row(float* s, int T, float& m_out) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int j = lane; j < T; j += 32) m = fmaxf(m, s[j]);
  m = warp_max(m);
  float z = 0.f;
  for (int j = lane; j < T; j += 32) {
    const float y = expf(__fsub_rn(s[j], m));
    s[j] = y;
    z = __fadd_rn(z, y);
  }
  m_out = m;
  return warp_sum(z);
}

// ---------------------------------------------------------------------------
// forward: a block a (b, h, 64 queries)

__global__ void __launch_bounds__(THREADS)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ key_mask,
             float* __restrict__ ctx, int nh, int T, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Tp = padded(T), sld = Tp + 4;
  float* Qs = smem;                 // 64 x LD
  float* KV = Qs + BK * LD;         // 64 x LD: a K tile, then a V tile
  float* S = KV + BK * LD;          // 64 x sld: scores, then probabilities
  float* kbias = S + BK * sld;      // Tp
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BK;
  const size_t base = ((size_t)b * nh + h) * T * HD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_key_bias(kbias, key_mask + (size_t)b * T, T);
  load_tile(Qs, q + base, q0, BK, T);
  for (int k0 = 0; k0 < Tp; k0 += BK) {
    __syncthreads();
    load_tile(KV, k + base, k0, BK, T);
    __syncthreads();
    float acc[4][4] = {};
    dot_nt(acc, Qs, KV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = ty + 16 * i, kj = k0 + tx + 16 * j;
        S[qi * sld + kj] = score(acc[i][j], scale, kbias, q0 + qi, kj, causal);
      }
  }
  __syncthreads();
  for (int r = warp; r < BK; r += THREADS / 32) {
    float* row = S + r * sld;
    float m;
    const float z = softmax_row(row, T, m);
    for (int j = lane; j < Tp; j += 32) row[j] = j < T ? __fdiv_rn(row[j], z) : 0.f;
  }
  float out[4][4] = {};
  for (int k0 = 0; k0 < Tp; k0 += BK) {
    __syncthreads();
    load_tile(KV, v + base, k0, BK, T);
    __syncthreads();
    dot_nn(out, S, sld, k0, KV, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < T)
      *reinterpret_cast<float4*>(ctx + base + (size_t)qi * HD + 4 * tx) =
          make_float4(out[i][0], out[i][1], out[i][2], out[i][3]);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ: a block a (b, h, 32 queries); writes each row's m, z and D

constexpr int BQ_DQ = 32;

__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dctx,
                const int* __restrict__ key_mask, float* __restrict__ dq,
                float* __restrict__ stats, int nh, int T, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Tp = padded(T), sld = Tp + 4;
  float* Qs = smem;                 // 32 x LD
  float* Gs = Qs + BQ_DQ * LD;      // 32 x LD: dctx
  float* KV = Gs + BQ_DQ * LD;      // 64 x LD
  float* S = KV + BK * LD;          // 32 x sld: s, then y
  float* P = S + BQ_DQ * sld;       // 32 x sld: dP, then dS
  float* kbias = P + BQ_DQ * sld;   // Tp
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ_DQ;
  const size_t bh = (size_t)b * nh + h, base = bh * T * HD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_key_bias(kbias, key_mask + (size_t)b * T, T);
  load_tile(Qs, q + base, q0, BQ_DQ, T);
  load_tile(Gs, dctx + base, q0, BQ_DQ, T);
  for (int k0 = 0; k0 < Tp; k0 += BK) {
    __syncthreads();
    load_tile(KV, k + base, k0, BK, T);
    __syncthreads();
    float acc[2][4] = {};
    dot_nt(acc, Qs, KV, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = ty + 16 * i, kj = k0 + tx + 16 * j;
        S[qi * sld + kj] = score(acc[i][j], scale, kbias, q0 + qi, kj, causal);
      }
    __syncthreads();
    load_tile(KV, v + base, k0, BK, T);
    __syncthreads();
    float dp[2][4] = {};
    dot_nt(dp, Gs, KV, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) P[(ty + 16 * i) * sld + k0 + tx + 16 * j] = dp[i][j];
  }
  __syncthreads();
  for (int r = warp; r < BQ_DQ; r += THREADS / 32) {
    float* y = S + r * sld;
    float* ds = P + r * sld;
    float m;
    const float z = softmax_row(y, T, m);
    const float rz2 = __fdiv_rn(1.f, __fmul_rn(z, z));
    float D = 0.f;
    for (int j = lane; j < T; j += 32) D = __fadd_rn(D, __fmul_rn(__fmul_rn(ds[j], rz2), y[j]));
    D = warp_sum(D);
    for (int j = lane; j < Tp; j += 32)
      ds[j] = j < T ? __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(ds[j], z), -D), y[j]), scale) : 0.f;
    const int qi = q0 + r;
    if (lane == 0 && qi < T) {
      const size_t n = (size_t)gridDim.z * nh * T, at = bh * T + qi;
      stats[at] = m;
      stats[n + at] = z;
      stats[2 * n + at] = D;
    }
  }
  float out[2][4] = {};
  for (int k0 = 0; k0 < Tp; k0 += BK) {
    __syncthreads();
    load_tile(KV, k + base, k0, BK, T);
    __syncthreads();
    dot_nn(out, P, sld, k0, KV, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < T)
      *reinterpret_cast<float4*>(dq + base + (size_t)qi * HD + 4 * tx) =
          make_float4(out[i][0], out[i][1], out[i][2], out[i][3]);
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: a block a (b, h, 64 keys) over the query tiles

__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dctx,
                  const int* __restrict__ key_mask, const float* __restrict__ stats,
                  float* __restrict__ dk, float* __restrict__ dv, int nh, int T, int causal,
                  float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;                 // 64 x LD each
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* Gs = Qs + BK * LD;
  float* PT = Gs + BK * LD;         // p^T: keys x queries
  float* DT = PT + BK * LD;         // dS^T
  float* rows = DT + BK * LD;       // m, z, D of the tile's 64 queries
  float* kbias = rows + 3 * BK;     // Tp
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const int Tp = padded(T);
  const size_t bh = (size_t)b * nh + h, base = bh * T * HD, n = (size_t)gridDim.z * nh * T;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_key_bias(kbias, key_mask + (size_t)b * T, T);
  load_tile(Ks, k + base, k0, BK, T);
  load_tile(Vs, v + base, k0, BK, T);
  float gk[4][4] = {}, gv[4][4] = {};
  for (int q0 = 0; q0 < Tp; q0 += BK) {
    __syncthreads();
    load_tile(Qs, q + base, q0, BK, T);
    load_tile(Gs, dctx + base, q0, BK, T);
    for (int i = threadIdx.x; i < 3 * BK; i += THREADS) {
      const int r = i % BK, qi = q0 + r;
      rows[i] = qi < T ? stats[(i / BK) * n + bh * T + qi] : 0.f;
    }
    __syncthreads();
    float st[4][4] = {}, dp[4][4] = {};
    dot_nt(st, Ks, Qs, ty, tx);
    dot_nt(dp, Vs, Gs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = ty + 16 * i, qc = tx + 16 * j, kk = k0 + kr, qq = q0 + qc;
        float p = 0.f, ds = 0.f;
        if (kk < T && qq < T) {
          const float m = rows[qc], z = rows[BK + qc], D = rows[2 * BK + qc];
          const float y = expf(__fsub_rn(score(st[i][j], scale, kbias, qq, kk, causal), m));
          p = __fdiv_rn(y, z);
          ds = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(dp[i][j], z), -D), y), scale);
        }
        PT[kr * LD + qc] = p;
        DT[kr * LD + qc] = ds;
      }
    __syncthreads();
    dot_nn(gv, PT, LD, 0, Gs, ty, tx);
    dot_nn(gk, DT, LD, 0, Qs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty + 16 * i;
    if (kk < T) {
      const size_t at = base + (size_t)kk * HD + 4 * tx;
      *reinterpret_cast<float4*>(dk + at) = make_float4(gk[i][0], gk[i][1], gk[i][2], gk[i][3]);
      *reinterpret_cast<float4*>(dv + at) = make_float4(gv[i][0], gv[i][1], gv[i][2], gv[i][3]);
    }
  }
}

size_t fwd_smem(int T) { return (size_t)(2 * BK * LD + BK * (padded(T) + 4) + padded(T)) * 4; }
size_t dq_smem(int T) {
  return (size_t)(2 * BQ_DQ * LD + BK * LD + 2 * BQ_DQ * (padded(T) + 4) + padded(T)) * 4;
}
size_t dkdv_smem(int T) { return (size_t)(6 * BK * LD + 3 * BK + padded(T)) * 4; }

// shared memory above 48 KB: allowed once a kernel, at the largest T
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t check_shape(int B, int nh, int T, int hd) {
  return (B < 1 || nh < 1 || T < 1 || T > MAX_T || hd != HD) ? cudaErrorInvalidValue
                                                               : cudaSuccess;
}

}  // namespace

// q, k, v, ctx: (B, nh, T, 64) float32, contiguous, 16-byte aligned;
// key_mask: (B, T) int32, nonzero = a real token; 1 <= T <= 512.  scale:
// float32(1 / sqrt(64)).  One launch; returns the CUDA error (0 on success).
extern "C" int masked_attention_f32(const void* q, const void* k, const void* v,
                                    const void* key_mask, void* ctx, int B, int nh, int T,
                                    int hd, int causal, float scale, void* stream) {
  cudaError_t err = check_shape(B, nh, T, hd);
  static const cudaError_t allowed = allow_smem(attn_fwd_f32, fwd_smem(MAX_T));
  if (err == cudaSuccess) err = allowed;
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BK - 1) / BK, nh, B);
  attn_fwd_f32<<<grid, THREADS, fwd_smem(T), reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(key_mask), static_cast<float*>(ctx), nh, T, causal != 0, scale);
  return (int)cudaGetLastError();
}

// q, k, v, dctx, dq, dk, dv: (B, nh, T, 64) float32, contiguous, 16-byte
// aligned; key_mask (B, T) int32; stats: (3, B * nh * T) float32 scratch
// (each row's m, z and D, written by the dQ kernel and read by the dK/dV
// kernel).  Two launches; returns the CUDA error (0 on success).
extern "C" int masked_attention_backward_f32(const void* q, const void* k, const void* v,
                                             const void* dctx, const void* key_mask, void* dq,
                                             void* dk, void* dv, void* stats, int B, int nh,
                                             int T, int hd, int causal, float scale,
                                             void* stream) {
  cudaError_t err = check_shape(B, nh, T, hd);
  static const cudaError_t allowed = [] {
    const cudaError_t e = allow_smem(attn_bwd_dq_f32, dq_smem(MAX_T));
    return e != cudaSuccess ? e : allow_smem(attn_bwd_dkdv_f32, dkdv_smem(MAX_T));
  }();
  if (err == cudaSuccess) err = allowed;
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* g_ = static_cast<const float*>(dctx);
  const int* m_ = static_cast<const int*>(key_mask);
  float* st = static_cast<float*>(stats);
  attn_bwd_dq_f32<<<dim3((T + BQ_DQ - 1) / BQ_DQ, nh, B), THREADS, dq_smem(T), s>>>(
      q_, k_, v_, g_, m_, static_cast<float*>(dq), st, nh, T, causal != 0, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_f32<<<dim3((T + BK - 1) / BK, nh, B), THREADS, dkdv_smem(T), s>>>(
      q_, k_, v_, g_, m_, st, static_cast<float*>(dk), static_cast<float*>(dv), nh, T,
      causal != 0, scale);
  return (int)cudaGetLastError();
}
