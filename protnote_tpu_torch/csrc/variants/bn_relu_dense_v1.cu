// K5's dense BatchNorm forms in their first design, which the port no
// longer uses: the forward takes the centred moments in two passes of
// bn_columns.cuh's moment kernel (shift 0, then shift mean), each with a
// tail, then the apply pass (five launches, z read three times); the
// backward's gradient sums and dz each draw the dropout hash and evaluate
// the gate's affine again (z and dy read twice).  Kept as it was for
// chip_variants.py --k5-dense, which times it against the kept kernels in
// turns and builds it with parts of its work taken out.  Its entry points'
// arguments are the first design's: bn_relu_dropout_forward(_f32) takes a
// (H,) zero shift and two (chunks, H) partial buffers,
// bn_relu_dropout_backward(_f32) two partial buffers.

#include "bn_columns.cuh"

namespace {

constexpr float EPS = 1e-5f;      // BN_EPS of the JAX package
constexpr uint32_t KEEP_ALL = 1u << 24;  // a threshold past every 24-bit draw

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The per-layer keys of the dropout hash from the seed's two words, and
// the divisor of a kept element with its correctly rounded reciprocal.
struct DropKey {
  uint32_t k0, k1, threshold;
  float keep, rkeep;
};

__device__ __forceinline__ DropKey drop_key(const long long* seed, int layer, uint32_t threshold,
                                            float keep) {
  DropKey d;
  d.k0 = fmix32((uint32_t)seed[0] ^ ((uint32_t)(layer + 1) * 0x9E3779B1u));
  d.k1 = fmix32((uint32_t)seed[1] + d.k0);
  d.threshold = threshold;
  d.keep = keep;
  d.rkeep = __frcp_rn(keep);
  return d;
}

// The row's half of the hash (the same for all its columns) and the
// column's (the same for all its rows): a thread keeps its 8 columns'.
__device__ __forceinline__ uint32_t row_hash(const DropKey& d, long long row) {
  return fmix32((uint32_t)row * 0x9E3779B1u ^ d.k0);
}

__device__ __forceinline__ uint32_t col_key(const DropKey& d, int col) {
  return (uint32_t)col * 0x85EBCA77u ^ d.k1;
}

__device__ __forceinline__ void col_keys(const DropKey& d, int col, uint32_t (&ck)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) ck[e] = col_key(d, col + e);
}

__device__ __forceinline__ bool keep_bit(const DropKey& d, uint32_t rh, uint32_t ck) {
  return (fmix32(rh ^ ck) >> 8) < d.threshold;
}

// dropout of one value v of type T (its own transpose): T(v / keep) where
// kept.  In bf16 the quotient is q = v r and one correction, q + fma(-q,
// keep, v) r, with r = rn(1 / keep): for a bf16 v and a bf16 keep it is the
// correctly rounded float32 quotient (tests/test_torch_dense_scorer.py
// checks every bf16 v against the true division for the rates it tries),
// without the division's slow path.  No such proof covers every float32 v,
// so float32 takes the true division.
template <typename T>
__device__ __forceinline__ float drop(const DropKey& d, uint32_t rh, uint32_t ck, float v);
template <>
__device__ __forceinline__ float drop<__nv_bfloat16>(const DropKey& d, uint32_t rh, uint32_t ck,
                                                     float v) {
  if (!keep_bit(d, rh, ck)) return 0.f;
  const float q = __fmul_rn(v, d.rkeep);
  return round_to<__nv_bfloat16>(__fmaf_rn(__fmaf_rn(-q, d.keep, v), d.rkeep, q));
}
template <>
__device__ __forceinline__ float drop<float>(const DropKey& d, uint32_t rh, uint32_t ck,
                                             float v) {
  return keep_bit(d, rh, ck) ? __fdiv_rn(v, d.keep) : 0.f;
}

// The centred moments' tails: first mean = sum / n (mode 0), then var and
// the affine from the second pass's sums (mode 1).
__global__ void centred_tail_kernel(const float* __restrict__ part, int chunks,
                                    const float* __restrict__ n_ptr,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias, float* __restrict__ mean,
                                    float* __restrict__ var, float* __restrict__ istd,
                                    float* __restrict__ inv, float* __restrict__ shift, int H,
                                    int mode) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  float t = 0.f;
  for (int k = 0; k < chunks; ++k) t = __fadd_rn(t, part[(size_t)k * H + c]);
  const float n = *n_ptr;
  if (mode == 0) {
    mean[c] = __fdiv_rn(t, n);
    return;
  }
  const float v = __fdiv_rn(t, n);
  const float is = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(v, EPS)));
  const float iv = __fmul_rn(is, scale[c]);
  var[c] = v;
  istd[c] = is;
  inv[c] = iv;
  shift[c] = __fsub_rn(bias[c], __fmul_rn(mean[c], iv));
}
// y = dropout(T(relu(f32(z) * inv + shift))) (BN), or
// y = dropout(relu(T(f32(z) + bias))) (no BN: inv unused, shift = bias).
// Each thread owns 8 columns (their affine and hash keys in registers) and
// walks down the rows, as affine_relu_kernel.
template <typename T, bool BN, bool DROP>
__global__ void __launch_bounds__(EW_THREADS)
act_dropout_kernel(const T* __restrict__ z, const float* __restrict__ inv,
                   const float* __restrict__ shift, const long long* __restrict__ seed,
                   int layer, uint32_t threshold, float keep, T* __restrict__ y,
                   long long N, int H) {
  const int vpr = H / VEC;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= vpr) return;
  float iv[VEC], sh[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    iv[e] = BN ? inv[cv * VEC + e] : 1.f;
    sh[e] = shift[cv * VEC + e];
  }
  DropKey dk;
  uint32_t ck[VEC];
  if (DROP) {
    dk = drop_key(seed, layer, threshold, keep);
    col_keys(dk, cv * VEC, ck);
  }
#pragma unroll 4
  for (long long r = blockIdx.x; r < N; r += gridDim.x) {
    const long long v = (r * vpr + cv) * VEC;
    float f[VEC];
    load8(z + v, f);
    const uint32_t rh = DROP ? row_hash(dk, r) : 0u;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float pre = BN ? affine(f[e], iv[e], sh[e]) : __fadd_rn(f[e], sh[e]);
      float a = fmaxf(round_to<T>(pre), 0.f);
      if (DROP) a = drop<T>(dk, rh, ck[e], a);
      f[e] = a;
    }
    store8(y + v, f);
  }
}

// The backward's dy through dropout's transpose, in place of dy.
template <typename T, bool DROP>
__device__ __forceinline__ void dropped_dy(const DropKey& dk, long long row,
                                           const uint32_t (&ck)[VEC], float (&df)[VEC]) {
  if (!DROP) return;
  const uint32_t rh = row_hash(dk, row);
#pragma unroll
  for (int e = 0; e < VEC; ++e) df[e] = drop<T>(dk, rh, ck[e], df[e]);
}

// Backward pass 1: per row chunk, column sums of g and g * xhat, with dy
// first sent through dropout's transpose when DROP.
template <typename T, bool DROP>
__global__ void __launch_bounds__(RED_WARPS * 32)
bn_grad_sums_kernel(const T* __restrict__ z, const T* __restrict__ dy,
                    const float* __restrict__ mean, const float* __restrict__ istd,
                    const float* __restrict__ inv, const float* __restrict__ shift,
                    const long long* __restrict__ seed, int layer, uint32_t threshold,
                    float keep, float* __restrict__ part1, float* __restrict__ part2, long long N,
                    int H, long long rows_per_chunk) {
  __shared__ float s[2][RED_WARPS][COLS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * COLS;
  const int col = c0 + lane * VEC;
  const long long first = (long long)blockIdx.y * rows_per_chunk;
  const long long last = min(first + rows_per_chunk, N);
  DropKey dk;
  uint32_t ck[VEC];
  if (DROP) {
    dk = drop_key(seed, layer, threshold, keep);
    col_keys(dk, col, ck);
  }
  float mu[VEC], is[VEC], iv[VEC], sh[VEC], g[2][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    mu[e] = mean[col + e];
    is[e] = istd[col + e];
    iv[e] = inv[col + e];
    sh[e] = shift[col + e];
    g[0][e] = 0.f;
    g[1][e] = 0.f;
  }
#pragma unroll(DROP ? 2 : 4)
  for (long long i = first + warp; i < last; i += RED_WARPS) {
    float zf[VEC], df[VEC];
    load8(z + i * H + col, zf);
    load8(dy + i * H + col, df);
    dropped_dy<T, DROP>(dk, i, ck, df);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float ge = affine(zf[e], iv[e], sh[e]) > 0.f ? df[e] : 0.f;
      const float xhat = __fmul_rn(__fsub_rn(zf[e], mu[e]), is[e]);
      g[0][e] = __fadd_rn(g[0][e], ge);
      g[1][e] = __fadd_rn(g[1][e], __fmul_rn(ge, xhat));
    }
  }
  float* const out[2] = {part1, part2};
  block_column_sums<2>(s, g, out, blockIdx.y, c0, H);
}
// Backward pass 2: dz = T(istd * scale * (g - rows / n * (G1 + G2 * xhat))),
// dy dropped first when DROP.  Each thread owns 8 columns, keeps their seven
// per-column values in registers and walks down the rows.
template <typename T, bool DROP>
__global__ void __launch_bounds__(EW_THREADS)
bn_relu_dz_kernel(const T* __restrict__ z, const T* __restrict__ dy,
                  const float* __restrict__ rows, const float* __restrict__ n_ptr,
                  const float* __restrict__ scale, const float* __restrict__ mean,
                  const float* __restrict__ istd, const float* __restrict__ inv,
                  const float* __restrict__ shift, const float* __restrict__ G1,
                  const float* __restrict__ G2, const long long* __restrict__ seed, int layer,
                  uint32_t threshold, float keep, T* __restrict__ dz, long long N, int H) {
  const int vpr = H / VEC;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= vpr) return;
  const float n = *n_ptr;
  DropKey dk;
  uint32_t ck[VEC];
  if (DROP) {
    dk = drop_key(seed, layer, threshold, keep);
    col_keys(dk, cv * VEC, ck);
  }
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
#pragma unroll 2
  for (long long r = blockIdx.x; r < N; r += gridDim.x) {
    const long long v = (r * vpr + cv) * VEC;
    const float mn = __fdiv_rn(rows[r], n);
    float zf[VEC], df[VEC], out[VEC];
    load8(z + v, zf);
    load8(dy + v, df);
    dropped_dy<T, DROP>(dk, r, ck, df);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float g = affine(zf[e], iv[e], sh[e]) > 0.f ? df[e] : 0.f;
      const float xhat = __fmul_rn(__fsub_rn(zf[e], mu[e]), is[e]);
      const float inner = __fadd_rn(g1[e], __fmul_rn(g2[e], xhat));
      out[e] = __fmul_rn(coef[e], __fsub_rn(g, __fmul_rn(mn, inner)));
    }
    store8(dz + v, out);
  }
}

}  // namespace

namespace {

template <typename T, bool BN>
cudaError_t launch_act(const void* z, const float* inv, const float* shift, const void* seed,
                       int layer, uint32_t threshold, float keep, void* y, long long N, int H,
                       cudaStream_t s) {
  const dim3 grid = elementwise_grid(N, H);
  const int threads = elementwise_threads(H);
  const T* z_ = static_cast<const T*>(z);
  const long long* seed_ = static_cast<const long long*>(seed);
  T* y_ = static_cast<T*>(y);
  if (threshold >= KEEP_ALL && BN)
    affine_relu_kernel<T><<<grid, threads, 0, s>>>(z_, inv, shift, y_, N, H);
  else if (threshold >= KEEP_ALL)
    act_dropout_kernel<T, false, false><<<grid, threads, 0, s>>>(z_, inv, shift, seed_, layer,
                                                                 threshold, keep, y_, N, H);
  else
    act_dropout_kernel<T, BN, true><<<grid, threads, 0, s>>>(z_, inv, shift, seed_, layer,
                                                             threshold, keep, y_, N, H);
  return cudaGetLastError();
}

bool drop_ok(int layer, int threshold, float keep) {
  return layer >= 0 && threshold > 0 && threshold <= (int)KEEP_ALL && keep > 0.f && keep <= 1.f;
}
// K5's backward on elements of type T: the gradient sums, their tail and
// dz; dy goes through dropout's transpose unless threshold keeps every
// element.
template <typename T, bool DROP>
cudaError_t launch_bn_backward(const void* z, const void* dy, const void* rows, const void* n,
                               const void* scale, const void* mean, const void* istd,
                               const void* inv, const void* shift, const void* seed,
                               void* part1, void* part2, void* G1, void* G2, void* dz,
                               long long N, int H, int chunks, long long rows_per_chunk,
                               int layer, uint32_t threshold, float keep, cudaStream_t s) {
  const T* z_ = static_cast<const T*>(z);
  const T* dy_ = static_cast<const T*>(dy);
  const long long* seed_ = static_cast<const long long*>(seed);
  bn_grad_sums_kernel<T, DROP><<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      z_, dy_, static_cast<const float*>(mean), static_cast<const float*>(istd),
      static_cast<const float*>(inv), static_cast<const float*>(shift), seed_, layer, threshold,
      keep, static_cast<float*>(part1), static_cast<float*>(part2), N, H, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  column_sums_tail_kernel<2><<<(H + 255) / 256, 256, 0, s>>>(
      ChunkSums<2>{{static_cast<const float*>(part1), static_cast<const float*>(part2)},
                   {static_cast<float*>(G1), static_cast<float*>(G2)}},
      chunks, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_relu_dz_kernel<T, DROP><<<elementwise_grid(N, H), elementwise_threads(H), 0, s>>>(
      z_, dy_, static_cast<const float*>(rows), static_cast<const float*>(n),
      static_cast<const float*>(scale), static_cast<const float*>(mean),
      static_cast<const float*>(istd), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<const float*>(G1),
      static_cast<const float*>(G2), seed_, layer, threshold, keep, static_cast<T*>(dz), N, H);
  return cudaGetLastError();
}

}  // namespace

namespace {

template <typename T>
int dense_bn_forward(const void* z, const void* rows, const void* n, const void* zero_shift,
                     const void* scale, const void* bias, const void* seed, void* part1,
                     void* part2, void* mean, void* var, void* istd, void* inv, void* shift,
                     void* y, long long N, int H, int chunks, long long rows_per_chunk,
                     int layer, int threshold, float keep, void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk) || !drop_ok(layer, threshold, keep))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* z_ = static_cast<const T*>(z);
  const float* rows_ = static_cast<const float*>(rows);
  float* p1 = static_cast<float*>(part1);
  float* p2 = static_cast<float*>(part2);
  float* mean_ = static_cast<float*>(mean);
  const dim3 red(H / COLS, chunks);
  const int tail = (H + 255) / 256;
  // pass 1: sum(rows * z) (part1; part2 unused), mean
  moments_kernel<<<red, RED_WARPS * 32, 0, s>>>(z_, rows_, static_cast<const float*>(zero_shift),
                                                p1, p2, N, H, rows_per_chunk);
  centred_tail_kernel<<<tail, 256, 0, s>>>(p1, chunks, static_cast<const float*>(n), nullptr,
                                           nullptr, mean_, nullptr, nullptr, nullptr, nullptr, H,
                                           0);
  // pass 2: sum(rows * (z - mean)^2) (part2), var and the affine
  moments_kernel<<<red, RED_WARPS * 32, 0, s>>>(z_, rows_, mean_, p1, p2, N, H, rows_per_chunk);
  centred_tail_kernel<<<tail, 256, 0, s>>>(
      p2, chunks, static_cast<const float*>(n), static_cast<const float*>(scale),
      static_cast<const float*>(bias), mean_, static_cast<float*>(var), static_cast<float*>(istd),
      static_cast<float*>(inv), static_cast<float*>(shift), H, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_act<T, true>(z, static_cast<const float*>(inv),
                                  static_cast<const float*>(shift), seed, layer,
                                  (uint32_t)threshold, keep, y, N, H, s);
}

template <typename T>
int dense_bn_backward(const void* z, const void* dy, const void* rows, const void* n,
                      const void* scale, const void* mean, const void* istd, const void* inv,
                      const void* shift, const void* seed, void* part1, void* part2, void* G1,
                      void* G2, void* dz, long long N, int H, int chunks,
                      long long rows_per_chunk, int layer, int threshold, float keep,
                      void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk) || !drop_ok(layer, threshold, keep))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t thr = (uint32_t)threshold;
  auto launch = thr >= KEEP_ALL ? launch_bn_backward<T, false> : launch_bn_backward<T, true>;
  return (int)launch(z, dy, rows, n, scale, mean, istd, inv, shift, seed, part1, part2, G1, G2,
                     dz, N, H, chunks, rows_per_chunk, layer, thr, keep, s);
}

}  // namespace

// The dense scorer's forward: the centred moments (two moment passes, the
// first with zero_shift (H,) zeros), the affine, and y with dropout (seed: two
// int64 words; a row-column's 24-bit draw below threshold keeps it, divided
// by keep).  Scratch and outputs as bn_relu_forward; z and y bf16.
extern "C" int bn_relu_dropout_forward(const void* z, const void* rows, const void* n,
                                       const void* zero_shift, const void* scale,
                                       const void* bias, const void* seed, void* part1,
                                       void* part2, void* mean, void* var, void* istd, void* inv,
                                       void* shift, void* y, long long N, int H, int chunks,
                                       long long rows_per_chunk, int layer, int threshold,
                                       float keep, void* stream) {
  return dense_bn_forward<__nv_bfloat16>(z, rows, n, zero_shift, scale, bias, seed, part1, part2,
                                         mean, var, istd, inv, shift, y, N, H, chunks,
                                         rows_per_chunk, layer, threshold, keep, stream);
}

// Its float32 form: z and y float32.
extern "C" int bn_relu_dropout_forward_f32(const void* z, const void* rows, const void* n,
                                           const void* zero_shift, const void* scale,
                                           const void* bias, const void* seed, void* part1,
                                           void* part2, void* mean, void* var, void* istd,
                                           void* inv, void* shift, void* y, long long N, int H,
                                           int chunks, long long rows_per_chunk, int layer,
                                           int threshold, float keep, void* stream) {
  return dense_bn_forward<float>(z, rows, n, zero_shift, scale, bias, seed, part1, part2, mean,
                                 var, istd, inv, shift, y, N, H, chunks, rows_per_chunk, layer,
                                 threshold, keep, stream);
}

// Its backward: G1/G2 ((H,) f32, = dbias/dscale) and dz, dy sent through
// dropout's transpose (the mask drawn again from seed and layer); z, dy and
// dz bf16.
extern "C" int bn_relu_dropout_backward(const void* z, const void* dy, const void* rows,
                                        const void* n, const void* scale, const void* mean,
                                        const void* istd, const void* inv, const void* shift,
                                        const void* seed, void* part1, void* part2, void* G1,
                                        void* G2, void* dz, long long N, int H, int chunks,
                                        long long rows_per_chunk, int layer, int threshold,
                                        float keep, void* stream) {
  return dense_bn_backward<__nv_bfloat16>(z, dy, rows, n, scale, mean, istd, inv, shift, seed,
                                          part1, part2, G1, G2, dz, N, H, chunks, rows_per_chunk,
                                          layer, threshold, keep, stream);
}

// Its float32 form: z, dy and dz float32.
extern "C" int bn_relu_dropout_backward_f32(const void* z, const void* dy, const void* rows,
                                            const void* n, const void* scale, const void* mean,
                                            const void* istd, const void* inv, const void* shift,
                                            const void* seed, void* part1, void* part2, void* G1,
                                            void* G2, void* dz, long long N, int H, int chunks,
                                            long long rows_per_chunk, int layer, int threshold,
                                            float keep, void* stream) {
  return dense_bn_backward<float>(z, dy, rows, n, scale, mean, istd, inv, shift, seed, part1,
                                  part2, G1, G2, dz, N, H, chunks, rows_per_chunk, layer,
                                  threshold, keep, stream);
}
