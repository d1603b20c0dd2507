// Column passes over (N, H) pair-row tensors, shared by the masked
// BatchNorm kernels of the training scorer: bn_relu.cu (K5), streamed_bn.cu
// (K6) and pair_dense.cu.  The element type is bf16 or float32 (the float32
// forms, MIXED_PRECISION False): every value is computed in float32 and
// stored in the element type.
//
// Layout: a reduction block is RED_WARPS warps over COLS = 256 consecutive
// columns; lane l of a warp owns columns 8l..8l+7 of the block (one 16-byte
// access a row in bf16, two in float32) and keeps its sums in registers while its warp walks down
// every RED_WARPS-th row of one row chunk.  block_column_sums adds the
// warps' sums in warp order into one partial row of a (chunks, H) buffer,
// and column_sums_tail_kernel adds the chunks in chunk order: no atomics,
// so two runs give the same bits.  Elementwise passes give each thread 8
// columns (their per-column values in registers) and walk down the rows.
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn), so the
// kernels evaluate the plain PyTorch versions' expressions.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

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

// 8 consecutive elements as float32, and back in the element type (bf16
// rounded to nearest)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack8(f);
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// A float32 value rounded to the element type (to nearest for bf16; float32
// keeps it), where the plain versions cast to z's dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

// The forward's pre-activation f32(z) * inv + shift, rounded in two steps.
__device__ __forceinline__ float affine(float z, float inv, float shift) {
  return __fadd_rn(__fmul_rn(z, inv), shift);
}

// Adds a block's per-warp column sums (NA arrays of RED_WARPS x COLS in
// shared memory s) into partial row `chunk` of each out[k] ((chunks, H)).
template <int NA>
__device__ __forceinline__ void block_column_sums(float (*s)[RED_WARPS][COLS],
                                                  float (&acc)[NA][VEC],
                                                  float* const (&out)[NA], int chunk, int c0,
                                                  int H) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NA; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[k][warp][lane * VEC + e] = acc[k][e];
  __syncthreads();
  for (int c = threadIdx.x; c < COLS; c += blockDim.x) {
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < RED_WARPS; ++w) t = __fadd_rn(t, s[k][w][c]);
      out[k][(size_t)chunk * H + c0 + c] = t;
    }
  }
}

// Per row chunk, column sums of rows * zc and rows * zc^2 with
// zc = f32(z) - r: the shifted moments of K5's forward and K6's statistics.
template <typename T>
__global__ void __launch_bounds__(RED_WARPS * 32)
moments_kernel(const T* __restrict__ z, const float* __restrict__ rows,
               const float* __restrict__ shift_r, float* __restrict__ part1,
               float* __restrict__ part2, long long N, int H, long long rows_per_chunk) {
  __shared__ float s[2][RED_WARPS][COLS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * COLS;
  const int col = c0 + lane * VEC;
  const long long first = (long long)blockIdx.y * rows_per_chunk;
  const long long last = min(first + rows_per_chunk, N);
  float r[VEC], acc[2][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    r[e] = shift_r[col + e];
    acc[0][e] = 0.f;
    acc[1][e] = 0.f;
  }
#pragma unroll 4
  for (long long i = first + warp; i < last; i += RED_WARPS) {
    const float m = rows[i];
    float f[VEC];
    load8(z + i * H + col, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float zc = __fsub_rn(f[e], r[e]);
      const float zm = __fmul_rn(zc, m);
      acc[0][e] = __fadd_rn(acc[0][e], zm);
      acc[1][e] = __fadd_rn(acc[1][e], __fmul_rn(zm, zc));
    }
  }
  float* const out[2] = {part1, part2};
  block_column_sums<2>(s, acc, out, blockIdx.y, c0, H);
}

template <int NA>
struct ChunkSums {
  const float* part[NA];  // (chunks, H) each
  float* out[NA];         // (H,) each
};

// One thread per column adds the chunks of each partial buffer in order.
template <int NA>
__global__ void column_sums_tail_kernel(ChunkSums<NA> a, int chunks, int H) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    float t = 0.f;
    for (int j = 0; j < chunks; ++j) t = __fadd_rn(t, a.part[k][(size_t)j * H + c]);
    a.out[k][c] = t;
  }
}

// y = T(relu(f32(z) * inv + shift)): K5's forward pass 2 and K6's
// affine_relu.  Each thread owns 8 columns, keeps their affine in registers
// and walks down the rows.
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
affine_relu_kernel(const T* __restrict__ z, const float* __restrict__ inv,
                   const float* __restrict__ shift, T* __restrict__ y, long long N, int H) {
  const int vpr = H / VEC;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= vpr) return;
  float iv[VEC], sh[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    iv[e] = inv[cv * VEC + e];
    sh[e] = shift[cv * VEC + e];
  }
#pragma unroll 4
  for (long long r = blockIdx.x; r < N; r += gridDim.x) {
    const long long v = (r * vpr + cv) * VEC;
    float f[VEC];
    load8(z + v, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = fmaxf(affine(f[e], iv[e], sh[e]), 0.f);
    store8(y + v, f);
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
