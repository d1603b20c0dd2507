// The streamed exact-BatchNorm training scorer's passes over one label tile
// (K6), for Hopper (sm_90a).
//
// Replaces the TPU op chain protnote_tpu/ops/streaming_train.py:
// pair_logits_streaming_train (:270): the per-tile shifted moments of its
// statistics sweeps (:445-479, _shifted_moments :58-71), the fixed affine +
// ReLU with statistics taken by earlier sweeps (forward_to / from_z1,
// :360-368, :435-443) and the loss pass's last affine + ReLU fused with the
// output matvec (:481-511), each with its backward (JAX's autodiff of the
// checkpointed scans).  The hidden GEMMs around them are K4 / K4-bwd
// (pair_train.cu, pair_train_bwd.cu) and cuBLAS, as JAX leaves them to XLA.
// z is one tile's (N, H) bf16 pre-activation, N = B * tile pair rows, rows
// (N,) f32 the pair mask em[b] * lm[l] (0 on padded labels), inv/shift (H,)
// f32 the streamed affine, r (H,) f32 the detached running mean.
//
//   stream_moments           s1 = sum rows*(z-r), s2 = sum rows*(z-r)^2 (H,)
//   stream_moments_backward  dz = bf16(rows * (g1 + 2*g2*(z-r)))
//   affine_relu              y = bf16(relu(f32(z)*inv + shift))
//   affine_relu_backward     g = dy where f32(z)*inv + shift > 0 (the forward
//                            expression, rounded alike); dz = bf16(g*inv),
//                            dinv = sum g*z, dshift = sum g
//   stream_head              logit = sum_k bf16(h_k)*bf16(w_k) in f32 + b,
//                            h = relu(f32(z)*inv + shift): h is never stored
//   stream_head_backward     dh = bf16(dout*w) (JAX's transpose of the
//                            mixed-precision dot), g = dh where the gate is
//                            open, dz = bf16(g*inv), dinv = sum g*z,
//                            dshift = sum g, dw = sum f32(h)*dout (the
//                            wrapper rounds it to bf16), db = sum dout
//
// What bounds them: device memory.  At the path's shape (32 sequences x a
// 2,048-label tile, H 3072) z is 403 MB: the moments and the head read it
// once (0.120 ms at 3.35 TB/s), affine_relu and the two elementwise
// backwards read it and write as much (0.240), affine_relu's backward reads
// z and dy and writes dz (0.361).  The design moves each byte once: every
// pass is a single sweep with 16-byte accesses, the backward reductions
// write dz in the same sweep that takes their column sums, and the head
// keeps h in registers and reduces each row inside one warp.  Sums run in a
// fixed order (bn_columns.cuh: warps, then row chunks; the head's warp
// butterfly; one block for db), so two runs give the same bits.

#include "bn_columns.cuh"

namespace {

constexpr int HEAD_WARPS = 8;  // rows of a head block, one a warp
constexpr int SUM_THREADS = 256;  // the one block that adds dout for db

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dz = bf16(rows * (g1 + 2 * g2 * (f32(z) - r))), 8 columns a thread.
__global__ void __launch_bounds__(EW_THREADS)
moments_dz_kernel(const __nv_bfloat16* __restrict__ z, const float* __restrict__ rows,
                  const float* __restrict__ shift_r, const float* __restrict__ g1,
                  const float* __restrict__ g2, __nv_bfloat16* __restrict__ dz, long long N,
                  int H) {
  const int vpr = H / VEC;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= vpr) return;
  float r[VEC], a[VEC], b[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int c = cv * VEC + e;
    r[e] = shift_r[c];
    a[e] = g1[c];
    b[e] = __fmul_rn(2.f, g2[c]);
  }
  const uint4* zv = reinterpret_cast<const uint4*>(z);
  uint4* out_v = reinterpret_cast<uint4*>(dz);
#pragma unroll 4
  for (long long i = blockIdx.x; i < N; i += gridDim.x) {
    const long long v = i * vpr + cv;
    const float m = rows[i];
    float f[VEC];
    unpack8(zv[v], f);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      f[e] = __fmul_rn(m, __fadd_rn(a[e], __fmul_rn(b[e], __fsub_rn(f[e], r[e]))));
    out_v[v] = pack8(f);
  }
}

// affine_relu's backward in one sweep: dz for every row, and per row chunk
// the column sums of g * f32(z) (dinv) and g (dshift).
__global__ void __launch_bounds__(RED_WARPS * 32)
affine_relu_grad_kernel(const __nv_bfloat16* __restrict__ z,
                        const __nv_bfloat16* __restrict__ dy, const float* __restrict__ inv,
                        const float* __restrict__ shift, __nv_bfloat16* __restrict__ dz,
                        float* __restrict__ part_inv, float* __restrict__ part_shift,
                        long long N, int H, long long rows_per_chunk) {
  __shared__ float s[2][RED_WARPS][COLS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * COLS;
  const int col = c0 + lane * VEC;
  const long long first = (long long)blockIdx.y * rows_per_chunk;
  const long long last = min(first + rows_per_chunk, N);
  float iv[VEC], sh[VEC], acc[2][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    iv[e] = inv[col + e];
    sh[e] = shift[col + e];
    acc[0][e] = 0.f;
    acc[1][e] = 0.f;
  }
#pragma unroll 2
  for (long long i = first + warp; i < last; i += RED_WARPS) {
    float zf[VEC], df[VEC], out[VEC];
    unpack8(*reinterpret_cast<const uint4*>(z + i * H + col), zf);
    unpack8(*reinterpret_cast<const uint4*>(dy + i * H + col), df);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float g = affine(zf[e], iv[e], sh[e]) > 0.f ? df[e] : 0.f;
      out[e] = __fmul_rn(g, iv[e]);
      acc[0][e] = __fadd_rn(acc[0][e], __fmul_rn(g, zf[e]));
      acc[1][e] = __fadd_rn(acc[1][e], g);
    }
    *reinterpret_cast<uint4*>(dz + i * H + col) = pack8(out);
  }
  float* const outs[2] = {part_inv, part_shift};
  block_column_sums<2>(s, acc, outs, blockIdx.y, c0, H);
}

// logit[i] = sum_k bf16(relu(f32(z[i,k]) * inv[k] + shift[k])) * w[k] + b:
// a warp a row, lane l on columns 8l + 256j, the products summed in f32 in
// column order within a lane, then across lanes by a fixed butterfly.
__global__ void __launch_bounds__(HEAD_WARPS * 32)
stream_head_kernel(const __nv_bfloat16* __restrict__ z, const float* __restrict__ inv,
                   const float* __restrict__ shift, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ logits, long long N,
                   int H) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * HEAD_WARPS + warp;
  if (i >= N) return;
  float acc = 0.f;
  for (int c = lane * VEC; c < H; c += COLS) {
    float zf[VEC], wf[VEC];
    unpack8(*reinterpret_cast<const uint4*>(z + i * H + c), zf);
    unpack8(__ldg(reinterpret_cast<const uint4*>(w + c)), wf);
    const float4 iv0 = __ldg(reinterpret_cast<const float4*>(inv + c));
    const float4 iv1 = __ldg(reinterpret_cast<const float4*>(inv + c + 4));
    const float4 sh0 = __ldg(reinterpret_cast<const float4*>(shift + c));
    const float4 sh1 = __ldg(reinterpret_cast<const float4*>(shift + c + 4));
    const float iv[VEC] = {iv0.x, iv0.y, iv0.z, iv0.w, iv1.x, iv1.y, iv1.z, iv1.w};
    const float sh[VEC] = {sh0.x, sh0.y, sh0.z, sh0.w, sh1.x, sh1.y, sh1.z, sh1.w};
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float h = round_bf16(fmaxf(affine(zf[e], iv[e], sh[e]), 0.f));
      acc = __fadd_rn(acc, __fmul_rn(h, wf[e]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (lane == 0) logits[i] = __fadd_rn(acc, *b);
}

// stream_head's backward in one sweep: dz for every row, and per row chunk
// the column sums of g * f32(z) (dinv), g (dshift) and f32(h) * dout (dw).
__global__ void __launch_bounds__(RED_WARPS * 32)
stream_head_grad_kernel(const __nv_bfloat16* __restrict__ z, const float* __restrict__ inv,
                        const float* __restrict__ shift, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ dout, __nv_bfloat16* __restrict__ dz,
                        float* __restrict__ part_inv, float* __restrict__ part_shift,
                        float* __restrict__ part_w, long long N, int H,
                        long long rows_per_chunk) {
  __shared__ float s[3][RED_WARPS][COLS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * COLS;
  const int col = c0 + lane * VEC;
  const long long first = (long long)blockIdx.y * rows_per_chunk;
  const long long last = min(first + rows_per_chunk, N);
  float iv[VEC], sh[VEC], wf[VEC], acc[3][VEC];
  unpack8(*reinterpret_cast<const uint4*>(w + col), wf);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    iv[e] = inv[col + e];
    sh[e] = shift[col + e];
    acc[0][e] = 0.f;
    acc[1][e] = 0.f;
    acc[2][e] = 0.f;
  }
#pragma unroll 2
  for (long long i = first + warp; i < last; i += RED_WARPS) {
    const float d = dout[i];
    float zf[VEC], out[VEC];
    unpack8(*reinterpret_cast<const uint4*>(z + i * H + col), zf);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float x = affine(zf[e], iv[e], sh[e]);
      const float h = round_bf16(fmaxf(x, 0.f));
      const float g = x > 0.f ? round_bf16(__fmul_rn(d, wf[e])) : 0.f;
      out[e] = __fmul_rn(g, iv[e]);
      acc[0][e] = __fadd_rn(acc[0][e], __fmul_rn(g, zf[e]));
      acc[1][e] = __fadd_rn(acc[1][e], g);
      acc[2][e] = __fadd_rn(acc[2][e], __fmul_rn(h, d));
    }
    *reinterpret_cast<uint4*>(dz + i * H + col) = pack8(out);
  }
  float* const outs[3] = {part_inv, part_shift, part_w};
  block_column_sums<3>(s, acc, outs, blockIdx.y, c0, H);
}

// db = sum dout in one block: thread t adds rows t, t + 256, ... in order,
// then a fixed tree over the threads.
__global__ void __launch_bounds__(SUM_THREADS)
row_sum_kernel(const float* __restrict__ x, float* __restrict__ out, long long N) {
  __shared__ float s[SUM_THREADS];
  float t = 0.f;
  for (long long i = threadIdx.x; i < N; i += SUM_THREADS) t = __fadd_rn(t, x[i]);
  s[threadIdx.x] = t;
  __syncthreads();
  for (int half = SUM_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = s[0];
}

template <int NA>
int column_tail(ChunkSums<NA> sums, int chunks, int H, cudaStream_t s) {
  column_sums_tail_kernel<NA><<<(H + 255) / 256, 256, 0, s>>>(sums, chunks, H);
  return (int)cudaGetLastError();
}

}  // namespace

// The tile's shifted moments: s1, s2 (H,) f32; part1/part2 (chunks, H) f32
// scratch.  Returns a CUDA error code (0 on success).
extern "C" int stream_moments(const void* z, const void* rows, const void* running_mean,
                              void* part1, void* part2, void* s1, void* s2, long long N, int H,
                              int chunks, long long rows_per_chunk, void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  moments_kernel<<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(rows),
      static_cast<const float*>(running_mean), static_cast<float*>(part1),
      static_cast<float*>(part2), N, H, rows_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return column_tail<2>({{static_cast<const float*>(part1), static_cast<const float*>(part2)},
                         {static_cast<float*>(s1), static_cast<float*>(s2)}},
                        chunks, H, s);
}

// dz (N, H) bf16 from the cotangents g1, g2 (H,) f32 of s1 and s2.
extern "C" int stream_moments_backward(const void* z, const void* rows,
                                       const void* running_mean, const void* g1,
                                       const void* g2, void* dz, long long N, int H,
                                       void* stream) {
  if (!shapes_ok(N, H, 1, N)) return (int)cudaErrorInvalidValue;
  moments_dz_kernel<<<elementwise_grid(N, H), elementwise_threads(H), 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(rows),
      static_cast<const float*>(running_mean), static_cast<const float*>(g1),
      static_cast<const float*>(g2), static_cast<__nv_bfloat16*>(dz), N, H);
  return (int)cudaGetLastError();
}

// y (N, H) bf16 = relu(f32(z) * inv + shift).
extern "C" int affine_relu(const void* z, const void* inv, const void* shift, void* y,
                           long long N, int H, void* stream) {
  if (!shapes_ok(N, H, 1, N)) return (int)cudaErrorInvalidValue;
  affine_relu_kernel<<<elementwise_grid(N, H), elementwise_threads(H), 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(y), N, H);
  return (int)cudaGetLastError();
}

// dz (N, H) bf16, dinv and dshift (H,) f32 from dy (N, H) bf16.
extern "C" int affine_relu_backward(const void* z, const void* dy, const void* inv,
                                    const void* shift, void* dz, void* part_inv,
                                    void* part_shift, void* dinv, void* dshift, long long N,
                                    int H, int chunks, long long rows_per_chunk,
                                    void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  affine_relu_grad_kernel<<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const float*>(inv), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(dz), static_cast<float*>(part_inv),
      static_cast<float*>(part_shift), N, H, rows_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return column_tail<2>(
      {{static_cast<const float*>(part_inv), static_cast<const float*>(part_shift)},
       {static_cast<float*>(dinv), static_cast<float*>(dshift)}},
      chunks, H, s);
}

// logits (N,) f32; w (H,) bf16, b one f32 value on the device.
extern "C" int stream_head(const void* z, const void* inv, const void* shift, const void* w,
                           const void* b, void* logits, long long N, int H, void* stream) {
  if (!shapes_ok(N, H, 1, N)) return (int)cudaErrorInvalidValue;
  const long long blocks = (N + HEAD_WARPS - 1) / HEAD_WARPS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  stream_head_kernel<<<(unsigned)blocks, HEAD_WARPS * 32, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), static_cast<float*>(logits), N, H);
  return (int)cudaGetLastError();
}

// dz (N, H) bf16 and dinv, dshift, dw (H,) f32, db one f32 value, from the
// logits' cotangent dout (N,) f32; part (3, chunks, H) f32 scratch.
extern "C" int stream_head_backward(const void* z, const void* inv, const void* shift,
                                    const void* w, const void* dout, void* dz, void* part,
                                    void* dinv, void* dshift, void* dw, void* db, long long N,
                                    int H, int chunks, long long rows_per_chunk,
                                    void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const size_t plane = (size_t)chunks * H;
  stream_head_grad_kernel<<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(dout), static_cast<__nv_bfloat16*>(dz), p, p + plane,
      p + 2 * plane, N, H, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = (cudaError_t)column_tail<3>(
      {{p, p + plane, p + 2 * plane},
       {static_cast<float*>(dinv), static_cast<float*>(dshift), static_cast<float*>(dw)}},
      chunks, H, s);
  if (err != cudaSuccess) return (int)err;
  row_sum_kernel<<<1, SUM_THREADS, 0, s>>>(static_cast<const float*>(dout),
                                           static_cast<float*>(db), N);
  return (int)cudaGetLastError();
}
