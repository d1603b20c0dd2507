// Masked BatchNorm + ReLU over the (pair rows x H) pre-activations of the
// training scorer, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU op chain protnote_tpu/ops/streaming_train.py:_bn_relu
// (the jax.custom_vjp: forward _bn_relu_fwd_impl, backward _bn_relu_bwd) and
// the unfused branch of pair_logits_dense_decomposed, which computes the same
// function.  z is (N, H) bf16 with N = B * L pair rows, rows (N,) f32 the
// pair mask em[b] * lm[l], n the masked pair count n_b * n_l (a device
// scalar), r the running mean (a constant shift, no gradient).
//
// Forward, two passes over z:
//   1. column sums of zc = f32(z) - r and rows * zc^2 (times rows), per row
//      chunk into a partial buffer, then a one-thread-per-column tail that
//      adds the chunks in order and forms mean = s1 + r,
//      var = max(s2 - s1^2, 0), inv = scale / sqrt(var + eps),
//      shift = bias - mean * inv;
//   2. y = bf16(relu(f32(z) * inv + shift)), elementwise.
// Backward, two passes over (z, dy):
//   1. with g = dy where f32(z) * inv + shift > 0 (the forward expression,
//      rounded the same way) and xhat = (f32(z) - mean) * istd, the column
//      sums G1 = sum g and G2 = sum g * xhat (= dbias and dscale), again per
//      row chunk and then a tail;
//   2. dz = bf16(istd * scale * (g - rows / n * (G1 + G2 * xhat))).
// Every product and sum is rounded separately (__fmul_rn/__fadd_rn), so
// the gate and the outputs are the plain PyTorch version's expressions.
//
// What bounds it: device memory.  At the default width one (N, H) bf16
// tensor is 6.3 GB (N = 1,027,264, H = 3072); the forward reads z twice and
// writes y once (19 GB), the backward reads z and dy twice and writes dz
// (31.5 GB), so about 15 ms a layer at 3.35 TB/s.  Each thread moves 16
// bytes (8 bf16) per access, a warp covers 256 consecutive columns of a row,
// the reductions keep their sums in registers and write one partial per
// row chunk (no atomics, so the sums are reproducible), and the elementwise
// passes keep each thread's per-column values in registers while it walks
// down the rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float EPS = 1e-5f;      // BN_EPS of the JAX package
constexpr int VEC = 8;            // bf16 per 16-byte access
constexpr int COLS = 32 * VEC;    // columns per block: one warp-row of 16-byte loads
constexpr int RED_WARPS = 8;      // warps of a reduction block, each on its own rows
constexpr int EW_THREADS = 128;  // elementwise block: 128 threads x 8 columns
constexpr int EW_ROW_BLOCKS = 1024;  // elementwise grid rows; each block loops over rows

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&v);
  }
  return u;
}

// The forward's pre-activation f32(z) * inv + shift, rounded in two steps.
__device__ __forceinline__ float affine(float z, float inv, float shift) {
  return __fadd_rn(__fmul_rn(z, inv), shift);
}

// Adds a block's per-warp column sums (RED_WARPS x COLS, two arrays) into
// partial row `chunk` of out0/out1 (each (chunks, H)).
__device__ __forceinline__ void block_column_sums(float (*s0)[COLS], float (*s1)[COLS],
                                                  const float* a0, const float* a1,
                                                  float* out0, float* out1, int chunk,
                                                  int c0, int H) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    s0[warp][lane * VEC + e] = a0[e];
    s1[warp][lane * VEC + e] = a1[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < COLS; c += blockDim.x) {
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int w = 0; w < RED_WARPS; ++w) {
      t0 = __fadd_rn(t0, s0[w][c]);
      t1 = __fadd_rn(t1, s1[w][c]);
    }
    out0[(size_t)chunk * H + c0 + c] = t0;
    out1[(size_t)chunk * H + c0 + c] = t1;
  }
}

// Forward pass 1: per row chunk, column sums of rows * zc and rows * zc^2.
__global__ void __launch_bounds__(RED_WARPS * 32)
bn_moments_kernel(const __nv_bfloat16* __restrict__ z, const float* __restrict__ rows,
                  const float* __restrict__ shift_r, float* __restrict__ part1,
                  float* __restrict__ part2, long long N, int H, long long rows_per_chunk) {
  __shared__ float s0[RED_WARPS][COLS];
  __shared__ float s1[RED_WARPS][COLS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * COLS;
  const int col = c0 + lane * VEC;
  const long long first = (long long)blockIdx.y * rows_per_chunk;
  const long long last = min(first + rows_per_chunk, N);
  float r[VEC], a1[VEC], a2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    r[e] = shift_r[col + e];
    a1[e] = 0.f;
    a2[e] = 0.f;
  }
#pragma unroll 4
  for (long long i = first + warp; i < last; i += RED_WARPS) {
    const uint4 u = *reinterpret_cast<const uint4*>(z + i * H + col);
    const float m = rows[i];
    float f[VEC];
    unpack8(u, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float zc = __fsub_rn(f[e], r[e]);
      const float zm = __fmul_rn(zc, m);
      a1[e] = __fadd_rn(a1[e], zm);
      a2[e] = __fadd_rn(a2[e], __fmul_rn(zm, zc));
    }
  }
  block_column_sums(s0, s1, a1, a2, part1, part2, blockIdx.y, c0, H);
}

// Forward tail: one thread per column adds the chunks in order.
__global__ void bn_moments_tail_kernel(const float* __restrict__ part1,
                                       const float* __restrict__ part2, int chunks,
                                       const float* __restrict__ n_ptr,
                                       const float* __restrict__ shift_r,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias,
                                       float* __restrict__ mean, float* __restrict__ var,
                                       float* __restrict__ istd, float* __restrict__ inv,
                                       float* __restrict__ shift, int H) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  float t1 = 0.f, t2 = 0.f;
  for (int k = 0; k < chunks; ++k) {
    t1 = __fadd_rn(t1, part1[(size_t)k * H + c]);
    t2 = __fadd_rn(t2, part2[(size_t)k * H + c]);
  }
  const float n = *n_ptr;
  const float s1 = __fdiv_rn(t1, n);
  const float s2 = __fdiv_rn(t2, n);
  const float m = __fadd_rn(s1, shift_r[c]);
  const float v = fmaxf(__fsub_rn(s2, __fmul_rn(s1, s1)), 0.f);
  const float is = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(v, EPS)));
  const float iv = __fmul_rn(is, scale[c]);
  mean[c] = m;
  var[c] = v;
  istd[c] = is;
  inv[c] = iv;
  shift[c] = __fsub_rn(bias[c], __fmul_rn(m, iv));
}

// Forward pass 2: y = bf16(relu(f32(z) * inv + shift)).  Each thread owns 8
// columns, keeps their affine in registers and walks down the rows.
__global__ void __launch_bounds__(EW_THREADS)
bn_relu_apply_kernel(const __nv_bfloat16* __restrict__ z, const float* __restrict__ inv,
                     const float* __restrict__ shift, __nv_bfloat16* __restrict__ y,
                     long long N, int H) {
  const int vpr = H / VEC;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= vpr) return;
  float iv[VEC], sh[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    iv[e] = inv[cv * VEC + e];
    sh[e] = shift[cv * VEC + e];
  }
  const uint4* zv = reinterpret_cast<const uint4*>(z);
  uint4* yv = reinterpret_cast<uint4*>(y);
#pragma unroll 4
  for (long long r = blockIdx.x; r < N; r += gridDim.x) {
    const long long v = r * vpr + cv;
    float f[VEC];
    unpack8(zv[v], f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = fmaxf(affine(f[e], iv[e], sh[e]), 0.f);
    yv[v] = pack8(f);
  }
}

// Backward pass 1: per row chunk, column sums of g and g * xhat.
__global__ void __launch_bounds__(RED_WARPS * 32)
bn_grad_sums_kernel(const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ dy,
                    const float* __restrict__ mean, const float* __restrict__ istd,
                    const float* __restrict__ inv, const float* __restrict__ shift,
                    float* __restrict__ part1, float* __restrict__ part2, long long N, int H,
                    long long rows_per_chunk) {
  __shared__ float s0[RED_WARPS][COLS];
  __shared__ float s1[RED_WARPS][COLS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * COLS;
  const int col = c0 + lane * VEC;
  const long long first = (long long)blockIdx.y * rows_per_chunk;
  const long long last = min(first + rows_per_chunk, N);
  float mu[VEC], is[VEC], iv[VEC], sh[VEC], g1[VEC], g2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    mu[e] = mean[col + e];
    is[e] = istd[col + e];
    iv[e] = inv[col + e];
    sh[e] = shift[col + e];
    g1[e] = 0.f;
    g2[e] = 0.f;
  }
#pragma unroll 4
  for (long long i = first + warp; i < last; i += RED_WARPS) {
    float zf[VEC], df[VEC];
    unpack8(*reinterpret_cast<const uint4*>(z + i * H + col), zf);
    unpack8(*reinterpret_cast<const uint4*>(dy + i * H + col), df);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float g = affine(zf[e], iv[e], sh[e]) > 0.f ? df[e] : 0.f;
      const float xhat = __fmul_rn(__fsub_rn(zf[e], mu[e]), is[e]);
      g1[e] = __fadd_rn(g1[e], g);
      g2[e] = __fadd_rn(g2[e], __fmul_rn(g, xhat));
    }
  }
  block_column_sums(s0, s1, g1, g2, part1, part2, blockIdx.y, c0, H);
}

// Backward tail: G1 (dbias) and G2 (dscale) per column, chunks in order.
__global__ void bn_grad_sums_tail_kernel(const float* __restrict__ part1,
                                         const float* __restrict__ part2, int chunks,
                                         float* __restrict__ G1, float* __restrict__ G2,
                                         int H) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  float t1 = 0.f, t2 = 0.f;
  for (int k = 0; k < chunks; ++k) {
    t1 = __fadd_rn(t1, part1[(size_t)k * H + c]);
    t2 = __fadd_rn(t2, part2[(size_t)k * H + c]);
  }
  G1[c] = t1;
  G2[c] = t2;
}

// Backward pass 2: dz = bf16(istd * scale * (g - rows / n * (G1 + G2 * xhat))).
// Each thread owns 8 columns, keeps their seven per-column values in
// registers and walks down the rows.
__global__ void __launch_bounds__(EW_THREADS)
bn_relu_dz_kernel(const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ dy,
                  const float* __restrict__ rows, const float* __restrict__ n_ptr,
                  const float* __restrict__ scale, const float* __restrict__ mean,
                  const float* __restrict__ istd, const float* __restrict__ inv,
                  const float* __restrict__ shift, const float* __restrict__ G1,
                  const float* __restrict__ G2, __nv_bfloat16* __restrict__ dz,
                  long long N, int H) {
  const int vpr = H / VEC;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= vpr) return;
  const float n = *n_ptr;
  float iv[VEC], sh[VEC], mu[VEC], is[VEC], g1[VEC], g2[VEC], coef[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int c = cv * VEC + e;
    iv[e] = inv[c];
    sh[e] = shift[c];
    mu[e] = mean[c];
    is[e] = istd[c];
    g1[e] = G1[c];
    g2[e] = G2[c];
    coef[e] = __fmul_rn(istd[c], scale[c]);
  }
  const uint4* zv = reinterpret_cast<const uint4*>(z);
  const uint4* dv = reinterpret_cast<const uint4*>(dy);
  uint4* out_v = reinterpret_cast<uint4*>(dz);
#pragma unroll 2
  for (long long r = blockIdx.x; r < N; r += gridDim.x) {
    const long long v = r * vpr + cv;
    const float mn = __fdiv_rn(rows[r], n);
    float zf[VEC], df[VEC], out[VEC];
    unpack8(zv[v], zf);
    unpack8(dv[v], df);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float g = affine(zf[e], iv[e], sh[e]) > 0.f ? df[e] : 0.f;
      const float xhat = __fmul_rn(__fsub_rn(zf[e], mu[e]), is[e]);
      const float inner = __fadd_rn(g1[e], __fmul_rn(g2[e], xhat));
      out[e] = __fmul_rn(coef[e], __fsub_rn(g, __fmul_rn(mn, inner)));
    }
    out_v[v] = pack8(out);
  }
}

dim3 elementwise_grid(long long N, int H) {
  const int vpr = H / VEC;
  return dim3((unsigned)std::min(N, (long long)EW_ROW_BLOCKS),
              (unsigned)((vpr + EW_THREADS - 1) / EW_THREADS));
}

int elementwise_threads(int H) { return std::min(EW_THREADS, H / VEC); }

bool shapes_ok(long long N, int H, int chunks, long long rows_per_chunk) {
  return N > 0 && H > 0 && H % COLS == 0 && chunks > 0 && chunks <= 65535 &&
         rows_per_chunk > 0 && (long long)chunks * rows_per_chunk >= N;
}

}  // namespace

// Forward: moments, the affine, and y.  part1/part2 are (chunks, H) f32
// scratch; mean/var/istd/inv/shift are (H,) f32 outputs.  Returns a CUDA error
// code (0 on success).
extern "C" int bn_relu_forward(const void* z, const void* rows, const void* n,
                               const void* running_mean, const void* scale,
                               const void* bias, void* part1, void* part2, void* mean,
                               void* var, void* istd, void* inv, void* shift, void* y,
                               long long N,
                               int H, int chunks, long long rows_per_chunk, void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  bn_moments_kernel<<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(rows),
      static_cast<const float*>(running_mean), static_cast<float*>(part1),
      static_cast<float*>(part2), N, H, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_moments_tail_kernel<<<(H + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2), chunks,
      static_cast<const float*>(n), static_cast<const float*>(running_mean),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(mean), static_cast<float*>(var), static_cast<float*>(istd),
      static_cast<float*>(inv), static_cast<float*>(shift), H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_relu_apply_kernel<<<elementwise_grid(N, H), elementwise_threads(H), 0, s>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(y), N, H);
  return (int)cudaGetLastError();
}

// Backward: G1/G2 ((H,) f32 outputs, = dbias/dscale) and dz (N, H) bf16.
extern "C" int bn_relu_backward(const void* z, const void* dy, const void* rows,
                                const void* n, const void* scale, const void* mean,
                                const void* istd, const void* inv, const void* shift,
                                void* part1, void* part2, void* G1, void* G2, void* dz,
                                long long N, int H, int chunks, long long rows_per_chunk,
                                void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* z_ = static_cast<const __nv_bfloat16*>(z);
  const __nv_bfloat16* dy_ = static_cast<const __nv_bfloat16*>(dy);
  bn_grad_sums_kernel<<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      z_, dy_, static_cast<const float*>(mean), static_cast<const float*>(istd),
      static_cast<const float*>(inv), static_cast<const float*>(shift),
      static_cast<float*>(part1), static_cast<float*>(part2), N, H, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_grad_sums_tail_kernel<<<(H + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2), chunks,
      static_cast<float*>(G1), static_cast<float*>(G2), H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_relu_dz_kernel<<<elementwise_grid(N, H), elementwise_threads(H), 0, s>>>(
      z_, dy_, static_cast<const float*>(rows), static_cast<const float*>(n),
      static_cast<const float*>(scale), static_cast<const float*>(mean),
      static_cast<const float*>(istd), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<const float*>(G1),
      static_cast<const float*>(G2), static_cast<__nv_bfloat16*>(dz), N, H);
  return (int)cudaGetLastError();
}
