// K7-BN's first design, which the port no longer uses: six launches a
// forward (a one-thread count kernel, two column-sum passes over x with a
// tail after each, the apply) and three a backward (the gradient sums over
// x, y and dy, a tail, dx), bf16 pairs at a contiguous row pitch.  Kept as
// it was for chip_variants.py --k7-bn, which times it against the kept
// kernels in turns.
//
// Train-mode masked BatchNorm + ReLU of the ProteInfer encoder (K7-BN), its
// forward and backward, for Hopper (sm_90a).
//
// Replaces protnote_tpu/models/layers.py:batchnorm_apply(train=True,
// reduce_axes=(0, 1), mask, count) (line 102) followed by jax.nn.relu, as
// protnote_tpu/models/proteinfer.py:proteinfer_embed (lines 176-203) runs it
// on each block's (B, T, C) activations.  x is (R, C) bf16 with R = B * T
// and row b * T + t; the mask of row (b, t) is m = [t < lengths[b]] * em[b]
// (em the example mask, or 1).  With the JAX count rule,
//   n_valid = max(sum m, 1),  n = max(rows * t_ref, 1),
//   rows = sum em (or B),  t_ref = max(lengths * em) (or max(lengths)),
//   mean = sum(m x) / n,
//   var  = (sum(m (x - mean)^2) + (n - n_valid) mean^2) / n   (two passes),
//   inv  = rsqrt(var + eps) * scale,  shift = bias - mean * inv,
//   y    = relu(bf16(x * inv + shift))            (every row, as JAX does),
// and the running statistics move by `momentum` toward mean and the unbiased
// var * n / max(n - 1, 1).
//
// Backward, with gz = dy where y > 0 (the bf16 output) and 0 elsewhere, over
// every row: G = sum gz (= dbias), Gx = sum gz (x - mean), dscale = Gx rstd,
//   dx = bf16(inv gz + m / n (-inv G - scale rstd^3 Gx (x - mean))),
// the autodiff of the forward (the variance's derivative through the mean is
// zero under the count rule: sum m (x - mean) = (n - n_valid) mean).
//
// Every column sum is taken per row chunk into a partial buffer and the
// chunks are added in order by a one-thread-per-column tail (no atomics, the
// same bits every call).  Products and sums of the affine are rounded one at
// a time (__fmul_rn/__fadd_rn), as the plain PyTorch version computes them.
//
// What bounds it: device memory.  The forward reads x three times and writes
// y; the backward reads x, y and dy twice and writes dx.  A thread moves a
// bf16 pair (4 bytes: the encoder's 1,100 and 550 channels are not multiples
// of 8), a warp 64 consecutive columns of a row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;     // warps of a column-sum block, each on its own rows
constexpr int COLS = 64;     // columns of a column-sum block: a bf16 pair a lane
constexpr int EW_THREADS = 256;

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float row_mask(const int* lengths, const float* em, long long r,
                                          int T) {
  const int b = static_cast<int>(r / T), t = static_cast<int>(r - static_cast<long long>(b) * T);
  if (t >= lengths[b]) return 0.f;
  return em != nullptr ? em[b] : 1.f;
}

// counts[0] = n (the JAX count), counts[1] = n_valid.
__global__ void bn_counts_kernel(const int* lengths, const float* em, float* counts, int B,
                                 int T) {
  float rows = 0.f, t_ref = 0.f, valid = 0.f;
  for (int b = 0; b < B; ++b) {
    const float e = em != nullptr ? em[b] : 1.f;
    const float len = static_cast<float>(lengths[b]);
    rows += e;
    t_ref = fmaxf(t_ref, __fmul_rn(len, e));
    valid += __fmul_rn(static_cast<float>(min(max(lengths[b], 0), T)), e);
  }
  counts[0] = fmaxf(__fmul_rn(rows, t_ref), 1.f);
  counts[1] = fmaxf(valid, 1.f);
}

// Block (column group, chunk): per-column sums over the chunk's rows into
// row `chunk` of part (chunks, C).  Forward: sum m x, or with CENTERED
// sum m (x - mean)^2.  GRAD (backward): sum gz into part, sum gz (x - mean)
// into part2, over every row.
template <int MODE>  // 0: sum m x, 1: sum m (x - mean)^2, 2: the gradient sums
__global__ void __launch_bounds__(WARPS * 32)
col_sums_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                const __nv_bfloat16* __restrict__ dy, const int* __restrict__ lengths,
                const float* __restrict__ em, const float* __restrict__ mean,
                float* __restrict__ part, float* __restrict__ part2, long long R, int T, int C,
                long long rows_per_chunk) {
  __shared__ float s[2][WARPS][COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * COLS + 2 * lane;
  const long long r0 = blockIdx.y * rows_per_chunk;
  const long long r1 = min(R, r0 + rows_per_chunk);
  float a0 = 0.f, a1 = 0.f, g0 = 0.f, g1 = 0.f;
  if (c < C) {
    const float mu0 = MODE > 0 ? mean[c] : 0.f, mu1 = MODE > 0 ? mean[c + 1] : 0.f;
    for (long long r = r0 + warp; r < r1; r += WARPS) {
      const size_t off = static_cast<size_t>(r) * C + c;
      if (MODE == 2) {
        const float2 yy = load2(y + off);
        const float2 gg = load2(dy + off);
        const float gz0 = yy.x > 0.f ? gg.x : 0.f, gz1 = yy.y > 0.f ? gg.y : 0.f;
        if (gz0 == 0.f && gz1 == 0.f) continue;
        const float2 v = load2(x + off);
        a0 += gz0;
        a1 += gz1;
        g0 += __fmul_rn(gz0, __fsub_rn(v.x, mu0));
        g1 += __fmul_rn(gz1, __fsub_rn(v.y, mu1));
      } else {
        const float m = row_mask(lengths, em, r, T);
        if (m == 0.f) continue;
        const float2 v = load2(x + off);
        if (MODE == 0) {
          a0 += __fmul_rn(v.x, m);
          a1 += __fmul_rn(v.y, m);
        } else {
          const float d0 = __fsub_rn(v.x, mu0), d1 = __fsub_rn(v.y, mu1);
          a0 += __fmul_rn(__fmul_rn(d0, d0), m);
          a1 += __fmul_rn(__fmul_rn(d1, d1), m);
        }
      }
    }
  }
  s[0][warp][2 * lane] = a0;
  s[0][warp][2 * lane + 1] = a1;
  s[1][warp][2 * lane] = g0;
  s[1][warp][2 * lane + 1] = g1;
  __syncthreads();
  if (warp != 0 || c >= C) return;
  float* out = part + static_cast<size_t>(blockIdx.y) * C;
  float* out2 = part2 + static_cast<size_t>(blockIdx.y) * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v = s[0][0][2 * lane + i], w = s[1][0][2 * lane + i];
    for (int k = 1; k < WARPS; ++k) {
      v += s[0][k][2 * lane + i];
      w += s[1][k][2 * lane + i];
    }
    out[c + i] = v;
    if (MODE == 2) out2[c + i] = w;
  }
}

__device__ __forceinline__ float chunk_sum(const float* part, int chunks, int C, int c) {
  float v = 0.f;
  for (int k = 0; k < chunks; ++k) v += part[static_cast<size_t>(k) * C + c];
  return v;
}

// mean = sum(m x) / n.
__global__ void mean_tail_kernel(const float* part, int chunks, const float* counts,
                                 float* mean, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C) mean[c] = __fdiv_rn(chunk_sum(part, chunks, C, c), counts[0]);
}

// var, rstd, inv, shift and the running statistics (stats rows: mean, var,
// rstd, inv, shift).
__global__ void var_tail_kernel(const float* part, int chunks, const float* counts,
                                const float* scale, const float* bias, const float* run_mean,
                                const float* run_var, float momentum, float keep, float eps,
                                float* stats, float* new_mean, float* new_var, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float n = counts[0], nv = counts[1];
  const float mu = stats[c];
  const float var = __fdiv_rn(
      __fadd_rn(chunk_sum(part, chunks, C, c), __fmul_rn(__fsub_rn(n, nv), __fmul_rn(mu, mu))),
      n);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  const float inv = __fmul_rn(rstd, scale[c]);
  stats[C + c] = var;
  stats[2 * C + c] = rstd;
  stats[3 * C + c] = inv;
  stats[4 * C + c] = __fsub_rn(bias[c], __fmul_rn(mu, inv));
  const float unbiased = __fmul_rn(var, __fdiv_rn(n, fmaxf(__fsub_rn(n, 1.f), 1.f)));
  new_mean[c] = __fadd_rn(__fmul_rn(keep, run_mean[c]), __fmul_rn(momentum, mu));
  new_var[c] = __fadd_rn(__fmul_rn(keep, run_var[c]), __fmul_rn(momentum, unbiased));
}

// y = relu(bf16(x * inv + shift)), a bf16 pair a thread.
__global__ void bn_relu_apply_kernel(const __nv_bfloat16* __restrict__ x,
                                     const float* __restrict__ stats,
                                     __nv_bfloat16* __restrict__ y, long long pairs, int C) {
  const float* inv = stats + 3 * C;
  const float* shift = stats + 4 * C;
  const int half = C / 2;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < pairs;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = 2 * static_cast<int>(p % half);
    const float2 v = load2(x + 2 * p);
    const float lo = __bfloat162float(__float2bfloat16_rn(__fadd_rn(__fmul_rn(v.x, inv[c]),
                                                                    shift[c])));
    const float hi = __bfloat162float(__float2bfloat16_rn(__fadd_rn(__fmul_rn(v.y, inv[c + 1]),
                                                                    shift[c + 1])));
    reinterpret_cast<__nv_bfloat162*>(y)[p] = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
  }
}

// dscale = Gx rstd, dbias = G, and the dx coefficients
// k2 = -inv G / n, k3 = -scale rstd^3 Gx / n (coef rows: k2, k3).
__global__ void grad_tail_kernel(const float* part, const float* part2, int chunks,
                                 const float* counts, const float* scale, const float* stats,
                                 float* dscale, float* dbias, float* coef, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float n = counts[0];
  const float G = chunk_sum(part, chunks, C, c), Gx = chunk_sum(part2, chunks, C, c);
  const float rstd = stats[2 * C + c], inv = stats[3 * C + c];
  dbias[c] = G;
  dscale[c] = __fmul_rn(Gx, rstd);
  coef[c] = -__fdiv_rn(__fmul_rn(inv, G), n);
  coef[C + c] = -__fdiv_rn(__fmul_rn(__fmul_rn(scale[c], __fmul_rn(__fmul_rn(rstd, rstd), rstd)),
                                     Gx), n);
}

// dx = bf16(inv gz + m (k2 + k3 (x - mean))).
__global__ void bn_dx_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ y,
                             const __nv_bfloat16* __restrict__ dy, const int* __restrict__ lengths,
                             const float* __restrict__ em, const float* __restrict__ stats,
                             const float* __restrict__ coef, __nv_bfloat16* __restrict__ dx,
                             long long pairs, int T, int C) {
  const float* mean = stats;
  const float* inv = stats + 3 * C;
  const int half = C / 2;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < pairs;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = p / half;
    const int c = 2 * static_cast<int>(p - r * half);
    const float m = row_mask(lengths, em, r, T);
    const float2 v = load2(x + 2 * p), yy = load2(y + 2 * p), gg = load2(dy + 2 * p);
    float out[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float xv = i ? v.y : v.x;
      const float gz = (i ? yy.y : yy.x) > 0.f ? (i ? gg.y : gg.x) : 0.f;
      const float k = __fmul_rn(m, __fadd_rn(coef[c + i],
                                             __fmul_rn(coef[C + c + i],
                                                       __fsub_rn(xv, mean[c + i]))));
      out[i] = __fadd_rn(__fmul_rn(inv[c + i], gz), k);
    }
    reinterpret_cast<__nv_bfloat162*>(dx)[p] = __floats2bfloat162_rn(out[0], out[1]);
  }
}

bool shapes_ok(long long R, int T, int C, int chunks, long long rows_per_chunk) {
  return R > 0 && T > 0 && C > 0 && C % 2 == 0 && chunks > 0 && rows_per_chunk > 0 &&
         static_cast<long long>(chunks) * rows_per_chunk >= R;
}

unsigned ew_blocks(long long pairs) {
  const long long b = (pairs + EW_THREADS - 1) / EW_THREADS;
  return static_cast<unsigned>(b < 8192 ? b : 8192);
}

}  // namespace

// Forward: y (R, C) bf16; stats (5, C) f32 = mean, var, rstd, inv, shift;
// counts (2,) f32 = n, n_valid; new_mean, new_var (C,) f32 the running
// statistics; part (chunks, C) f32 scratch.  em may be null.
extern "C" int masked_bn_relu_forward(const void* x, const void* lengths, const void* em,
                                      const void* scale, const void* bias,
                                      const void* run_mean, const void* run_var, float momentum,
                                      float keep, float eps, void* part, void* counts,
                                      void* stats, void* new_mean, void* new_var, void* y, int B,
                                      int T, int C, int chunks, long long rows_per_chunk,
                                      void* stream) {
  const long long R = static_cast<long long>(B) * T;
  if (B <= 0 || !shapes_ok(R, T, C, chunks, rows_per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* x_ = static_cast<const __nv_bfloat16*>(x);
  const int* len = static_cast<const int*>(lengths);
  const float* em_ = static_cast<const float*>(em);
  float* part_ = static_cast<float*>(part);
  float* counts_ = static_cast<float*>(counts);
  float* stats_ = static_cast<float*>(stats);
  const dim3 grid((C + COLS - 1) / COLS, chunks);
  const unsigned tail = (C + 255) / 256;
  bn_counts_kernel<<<1, 1, 0, s>>>(len, em_, counts_, B, T);
  col_sums_kernel<0><<<grid, WARPS * 32, 0, s>>>(x_, nullptr, nullptr, len, em_, nullptr, part_,
                                                 nullptr, R, T, C, rows_per_chunk);
  mean_tail_kernel<<<tail, 256, 0, s>>>(part_, chunks, counts_, stats_, C);
  col_sums_kernel<1><<<grid, WARPS * 32, 0, s>>>(x_, nullptr, nullptr, len, em_, stats_, part_,
                                                 nullptr, R, T, C, rows_per_chunk);
  var_tail_kernel<<<tail, 256, 0, s>>>(
      part_, chunks, counts_, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(run_mean), static_cast<const float*>(run_var), momentum, keep,
      eps, stats_, static_cast<float*>(new_mean), static_cast<float*>(new_var), C);
  const long long pairs = R * C / 2;
  bn_relu_apply_kernel<<<ew_blocks(pairs), EW_THREADS, 0, s>>>(
      x_, stats_, static_cast<__nv_bfloat16*>(y), pairs, C);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dx (R, C) bf16, dscale and dbias (C,) f32, from x, the forward's
// y and its stats and counts, and dy; part and part2 (chunks, C) and coef
// (2, C) f32 scratch.
extern "C" int masked_bn_relu_backward(const void* x, const void* y, const void* dy,
                                       const void* lengths, const void* em, const void* scale,
                                       const void* stats, const void* counts, void* part,
                                       void* part2, void* coef, void* dscale, void* dbias,
                                       void* dx, int B, int T, int C, int chunks,
                                       long long rows_per_chunk, void* stream) {
  const long long R = static_cast<long long>(B) * T;
  if (B <= 0 || !shapes_ok(R, T, C, chunks, rows_per_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* x_ = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* y_ = static_cast<const __nv_bfloat16*>(y);
  const __nv_bfloat16* dy_ = static_cast<const __nv_bfloat16*>(dy);
  const float* stats_ = static_cast<const float*>(stats);
  float* coef_ = static_cast<float*>(coef);
  col_sums_kernel<2><<<dim3((C + COLS - 1) / COLS, chunks), WARPS * 32, 0, s>>>(
      x_, y_, dy_, nullptr, nullptr, stats_, static_cast<float*>(part),
      static_cast<float*>(part2), R, T, C, rows_per_chunk);
  grad_tail_kernel<<<(C + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(part2), chunks,
      static_cast<const float*>(counts), static_cast<const float*>(scale), stats_,
      static_cast<float*>(dscale), static_cast<float*>(dbias), coef_, C);
  const long long pairs = R * C / 2;
  bn_dx_kernel<<<ew_blocks(pairs), EW_THREADS, 0, s>>>(
      x_, y_, dy_, static_cast<const int*>(lengths), static_cast<const float*>(em), stats_,
      coef_, static_cast<__nv_bfloat16*>(dx), pairs, T, C);
  return static_cast<int>(cudaGetLastError());
}
