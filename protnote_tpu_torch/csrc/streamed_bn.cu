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
//
// The float32 forms (the same names with _f32: z, dz, y float32 and the
// head's w float32, MIXED_PRECISION False) are the same kernels on float32
// elements with nothing rounded to bf16: neither h, w nor dh = dout * w in
// the head (JAX's float32 scan takes the dot at Precision.HIGHEST), 8
// columns a thread in two 16-byte accesses.  Every pass moves twice the
// bytes: z is 805 MB a tile, 0.240 ms a read at 3.35 TB/s.

#include "bn_columns.cuh"

namespace {

constexpr int HEAD_WARPS = 8;  // rows of a head block, one a warp
constexpr int SUM_THREADS = 256;  // the one block that adds dout for db

// dz = T(rows * (g1 + 2 * g2 * (f32(z) - r))), 8 columns a thread.
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
moments_dz_kernel(const T* __restrict__ z, const float* __restrict__ rows,
                  const float* __restrict__ shift_r, const float* __restrict__ g1,
                  const float* __restrict__ g2, T* __restrict__ dz, long long N, int H) {
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
#pragma unroll 4
  for (long long i = blockIdx.x; i < N; i += gridDim.x) {
    const long long v = (i * vpr + cv) * VEC;
    const float m = rows[i];
    float f[VEC];
    load8(z + v, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      f[e] = __fmul_rn(m, __fadd_rn(a[e], __fmul_rn(b[e], __fsub_rn(f[e], r[e]))));
    store8(dz + v, f);
  }
}

// affine_relu's backward in one sweep: dz for every row, and per row chunk
// the column sums of g * f32(z) (dinv) and g (dshift).
template <typename T>
__global__ void __launch_bounds__(RED_WARPS * 32)
affine_relu_grad_kernel(const T* __restrict__ z, const T* __restrict__ dy,
                        const float* __restrict__ inv, const float* __restrict__ shift,
                        T* __restrict__ dz, float* __restrict__ part_inv,
                        float* __restrict__ part_shift, long long N, int H,
                        long long rows_per_chunk) {
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
    load8(z + i * H + col, zf);
    load8(dy + i * H + col, df);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float g = affine(zf[e], iv[e], sh[e]) > 0.f ? df[e] : 0.f;
      out[e] = __fmul_rn(g, iv[e]);
      acc[0][e] = __fadd_rn(acc[0][e], __fmul_rn(g, zf[e]));
      acc[1][e] = __fadd_rn(acc[1][e], g);
    }
    store8(dz + i * H + col, out);
  }
  float* const outs[2] = {part_inv, part_shift};
  block_column_sums<2>(s, acc, outs, blockIdx.y, c0, H);
}

// logit[i] = sum_k T(relu(f32(z[i,k]) * inv[k] + shift[k])) * w[k] + b:
// a warp a row, lane l on columns 8l + 256j, the products summed in f32 in
// column order within a lane, then across lanes by a fixed butterfly.
template <typename T>
__global__ void __launch_bounds__(HEAD_WARPS * 32)
stream_head_kernel(const T* __restrict__ z, const float* __restrict__ inv,
                   const float* __restrict__ shift, const T* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ logits, long long N,
                   int H) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * HEAD_WARPS + warp;
  if (i >= N) return;
  float acc = 0.f;
  for (int c = lane * VEC; c < H; c += COLS) {
    float zf[VEC], wf[VEC], iv[VEC], sh[VEC];
    load8(z + i * H + c, zf);
    load8(w + c, wf);
    load8(inv + c, iv);
    load8(shift + c, sh);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float h = round_to<T>(fmaxf(affine(zf[e], iv[e], sh[e]), 0.f));
      acc = __fadd_rn(acc, __fmul_rn(h, wf[e]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (lane == 0) logits[i] = __fadd_rn(acc, *b);
}

// stream_head's backward in one sweep: dz for every row, and per row chunk
// the column sums of g * f32(z) (dinv), g (dshift) and f32(h) * dout (dw).
template <typename T>
__global__ void __launch_bounds__(RED_WARPS * 32)
stream_head_grad_kernel(const T* __restrict__ z, const float* __restrict__ inv,
                        const float* __restrict__ shift, const T* __restrict__ w,
                        const float* __restrict__ dout, T* __restrict__ dz,
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
  load8(w + col, wf);
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
    load8(z + i * H + col, zf);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float x = affine(zf[e], iv[e], sh[e]);
      const float h = round_to<T>(fmaxf(x, 0.f));
      const float g = x > 0.f ? round_to<T>(__fmul_rn(d, wf[e])) : 0.f;
      out[e] = __fmul_rn(g, iv[e]);
      acc[0][e] = __fadd_rn(acc[0][e], __fmul_rn(g, zf[e]));
      acc[1][e] = __fadd_rn(acc[1][e], g);
      acc[2][e] = __fadd_rn(acc[2][e], __fmul_rn(h, d));
    }
    store8(dz + i * H + col, out);
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
cudaError_t column_tail(ChunkSums<NA> sums, int chunks, int H, cudaStream_t s) {
  column_sums_tail_kernel<NA><<<(H + 255) / 256, 256, 0, s>>>(sums, chunks, H);
  return cudaGetLastError();
}

const float* F(const void* p) { return static_cast<const float*>(p); }
float* F(void* p) { return static_cast<float*>(p); }

// The entry points' bodies on elements of type T (bf16, or float32 for the
// _f32 forms).

template <typename T>
int moments(const void* z, const void* rows, const void* running_mean, void* part1,
            void* part2, void* s1, void* s2, long long N, int H, int chunks,
            long long rows_per_chunk, void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  moments_kernel<<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      static_cast<const T*>(z), F(rows), F(running_mean), F(part1), F(part2), N, H,
      rows_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)column_tail<2>({{F(part1), F(part2)}, {F(s1), F(s2)}}, chunks, H, s);
}

template <typename T>
int moments_backward(const void* z, const void* rows, const void* running_mean, const void* g1,
                     const void* g2, void* dz, long long N, int H, void* stream) {
  if (!shapes_ok(N, H, 1, N)) return (int)cudaErrorInvalidValue;
  moments_dz_kernel<T><<<elementwise_grid(N, H), elementwise_threads(H), 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), F(rows), F(running_mean), F(g1), F(g2), static_cast<T*>(dz), N,
      H);
  return (int)cudaGetLastError();
}

template <typename T>
int affine_relu_fwd(const void* z, const void* inv, const void* shift, void* y, long long N,
                    int H, void* stream) {
  if (!shapes_ok(N, H, 1, N)) return (int)cudaErrorInvalidValue;
  affine_relu_kernel<T><<<elementwise_grid(N, H), elementwise_threads(H), 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), F(inv), F(shift), static_cast<T*>(y), N, H);
  return (int)cudaGetLastError();
}

template <typename T>
int affine_relu_bwd(const void* z, const void* dy, const void* inv, const void* shift, void* dz,
                    void* part_inv, void* part_shift, void* dinv, void* dshift, long long N,
                    int H, int chunks, long long rows_per_chunk, void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  affine_relu_grad_kernel<T><<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(dy), F(inv), F(shift),
      static_cast<T*>(dz), F(part_inv), F(part_shift), N, H, rows_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)column_tail<2>({{F(part_inv), F(part_shift)}, {F(dinv), F(dshift)}}, chunks, H,
                             s);
}

template <typename T>
int head_fwd(const void* z, const void* inv, const void* shift, const void* w, const void* b,
             void* logits, long long N, int H, void* stream) {
  if (!shapes_ok(N, H, 1, N)) return (int)cudaErrorInvalidValue;
  const long long blocks = (N + HEAD_WARPS - 1) / HEAD_WARPS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  stream_head_kernel<T><<<(unsigned)blocks, HEAD_WARPS * 32, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), F(inv), F(shift), static_cast<const T*>(w), F(b), F(logits), N,
      H);
  return (int)cudaGetLastError();
}

template <typename T>
int head_bwd(const void* z, const void* inv, const void* shift, const void* w, const void* dout,
             void* dz, void* part, void* dinv, void* dshift, void* dw, void* db, long long N,
             int H, int chunks, long long rows_per_chunk, void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = F(part);
  const size_t plane = (size_t)chunks * H;
  stream_head_grad_kernel<T><<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      static_cast<const T*>(z), F(inv), F(shift), static_cast<const T*>(w), F(dout),
      static_cast<T*>(dz), p, p + plane, p + 2 * plane, N, H, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = column_tail<3>({{p, p + plane, p + 2 * plane}, {F(dinv), F(dshift), F(dw)}}, chunks, H,
                       s);
  if (err != cudaSuccess) return (int)err;
  row_sum_kernel<<<1, SUM_THREADS, 0, s>>>(F(dout), F(db), N);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

}  // namespace

// Each entry point returns a CUDA error code (0 on success).  The bf16
// forms take z, dy, dz, y and w in bf16, the _f32 forms in float32; the
// rest is float32 in both.

// The tile's shifted moments: s1, s2 (H,) f32; part1/part2 (chunks, H) f32
// scratch.
extern "C" int stream_moments(const void* z, const void* rows, const void* running_mean,
                              void* part1, void* part2, void* s1, void* s2, long long N, int H,
                              int chunks, long long rows_per_chunk, void* stream) {
  return moments<bf16>(z, rows, running_mean, part1, part2, s1, s2, N, H, chunks,
                       rows_per_chunk, stream);
}
extern "C" int stream_moments_f32(const void* z, const void* rows, const void* running_mean,
                                  void* part1, void* part2, void* s1, void* s2, long long N,
                                  int H, int chunks, long long rows_per_chunk, void* stream) {
  return moments<float>(z, rows, running_mean, part1, part2, s1, s2, N, H, chunks,
                        rows_per_chunk, stream);
}

// dz (N, H) from the cotangents g1, g2 (H,) f32 of s1 and s2.
extern "C" int stream_moments_backward(const void* z, const void* rows,
                                       const void* running_mean, const void* g1,
                                       const void* g2, void* dz, long long N, int H,
                                       void* stream) {
  return moments_backward<bf16>(z, rows, running_mean, g1, g2, dz, N, H, stream);
}
extern "C" int stream_moments_backward_f32(const void* z, const void* rows,
                                           const void* running_mean, const void* g1,
                                           const void* g2, void* dz, long long N, int H,
                                           void* stream) {
  return moments_backward<float>(z, rows, running_mean, g1, g2, dz, N, H, stream);
}

// y (N, H) = relu(f32(z) * inv + shift).
extern "C" int affine_relu(const void* z, const void* inv, const void* shift, void* y,
                           long long N, int H, void* stream) {
  return affine_relu_fwd<bf16>(z, inv, shift, y, N, H, stream);
}
extern "C" int affine_relu_f32(const void* z, const void* inv, const void* shift, void* y,
                               long long N, int H, void* stream) {
  return affine_relu_fwd<float>(z, inv, shift, y, N, H, stream);
}

// dz (N, H), dinv and dshift (H,) f32 from dy (N, H).
extern "C" int affine_relu_backward(const void* z, const void* dy, const void* inv,
                                    const void* shift, void* dz, void* part_inv,
                                    void* part_shift, void* dinv, void* dshift, long long N,
                                    int H, int chunks, long long rows_per_chunk,
                                    void* stream) {
  return affine_relu_bwd<bf16>(z, dy, inv, shift, dz, part_inv, part_shift, dinv, dshift, N, H,
                               chunks, rows_per_chunk, stream);
}
extern "C" int affine_relu_backward_f32(const void* z, const void* dy, const void* inv,
                                        const void* shift, void* dz, void* part_inv,
                                        void* part_shift, void* dinv, void* dshift,
                                        long long N, int H, int chunks,
                                        long long rows_per_chunk, void* stream) {
  return affine_relu_bwd<float>(z, dy, inv, shift, dz, part_inv, part_shift, dinv, dshift, N,
                                H, chunks, rows_per_chunk, stream);
}

// logits (N,) f32; w (H,) in z's type, b one f32 value on the device.
extern "C" int stream_head(const void* z, const void* inv, const void* shift, const void* w,
                           const void* b, void* logits, long long N, int H, void* stream) {
  return head_fwd<bf16>(z, inv, shift, w, b, logits, N, H, stream);
}
extern "C" int stream_head_f32(const void* z, const void* inv, const void* shift, const void* w,
                               const void* b, void* logits, long long N, int H, void* stream) {
  return head_fwd<float>(z, inv, shift, w, b, logits, N, H, stream);
}

// dz (N, H) and dinv, dshift, dw (H,) f32, db one f32 value, from the
// logits' cotangent dout (N,) f32; part (3, chunks, H) f32 scratch.
extern "C" int stream_head_backward(const void* z, const void* inv, const void* shift,
                                    const void* w, const void* dout, void* dz, void* part,
                                    void* dinv, void* dshift, void* dw, void* db, long long N,
                                    int H, int chunks, long long rows_per_chunk,
                                    void* stream) {
  return head_bwd<bf16>(z, inv, shift, w, dout, dz, part, dinv, dshift, dw, db, N, H, chunks,
                        rows_per_chunk, stream);
}
extern "C" int stream_head_backward_f32(const void* z, const void* inv, const void* shift,
                                        const void* w, const void* dout, void* dz, void* part,
                                        void* dinv, void* dshift, void* dw, void* db,
                                        long long N, int H, int chunks,
                                        long long rows_per_chunk, void* stream) {
  return head_bwd<float>(z, inv, shift, w, dout, dz, part, dinv, dshift, dw, db, N, H, chunks,
                         rows_per_chunk, stream);
}
