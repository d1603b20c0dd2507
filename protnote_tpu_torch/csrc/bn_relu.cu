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
// down the rows.  The moment pass, the fixed-order column sums and the
// elementwise affine + ReLU live in bn_columns.cuh, which the streamed
// scorer's kernels (streamed_bn.cu) share.
//
// The float32 forms (bn_relu_forward_f32, bn_relu_backward_f32: z, y, dy
// and dz float32, MIXED_PRECISION False) are the same kernels on float32
// elements, nothing rounded to bf16: 8 columns a thread in two 16-byte
// accesses, so every pass moves twice the bytes, ~7.5 ms forward and ~11.3
// ms backward a layer at the default width.

//
// The dense scorer's forms (ops/dense_scorer.py, the TPU chain
// protnote_tpu/ops/pair_scorer.py:56 output_mlp_apply with
// models/layers.py:76 batchnorm_apply's train branch and :151 dropout):
//   bn_relu_dropout_forward: the JAX dense BatchNorm's centred moments
//     (mean = sum(rows * z) / n; var = sum(rows * (z - mean)^2) / n) in one
//     read of z: each lane's register tiles of 8 rows x 8 columns give their
//     own centred statistics, merged by Chan's formula (a compensated mean,
//     warps in order, then the row chunks' partials in a fixed order); then
//     y = dropout(bf16(relu(f32(z) * inv + shift))).  Three launches; z read
//     twice and y written: 3 x 6.3 GB at the default width, a 5.65 ms floor
//     at 3.35 TB/s (the first design's two centred passes read z three
//     times: csrc/variants/bn_relu_dense_v1.cu);
//   bn_relu_dropout_backward: K5's backward with dy first sent through
//     dropout's transpose, two passes that each draw the hash, the sums
//     pass held at two blocks an SM (a sums pass that left gate-and-keep
//     as one bit an element for the dz pass ran slower: the dz pass is
//     bound by its memory traffic): z and dy read twice, dz written, 5 x
//     6.3 GB, a 9.42 ms floor, the floor of any form that completes the
//     column sums before dz;
//   bias_relu_dropout_forward: y = dropout(relu(bf16(f32(z) + bias))), the
//     output MLP without BatchNorm;
//   bias_relu_dropout_backward: dz = gate * dropout^T(dy) and dbias = its
//     column sums, in one pass over (z, dy) and a fixed-order tail.
// dropout(y) = keep ? bf16(f32(y) / keep_f) : 0, with keep_f the compute
// dtype's 1 - rate and keep a counter hash of (seed, layer, row, column)
// (keep_bit): nothing stores the mask, the backward draws it again, and
// ops/dense_scorer.py:keep_mask computes the same bits on the CPU.  A
// threshold of 2^24 keeps every element (no dropout).
//
// Their float32 forms (the same names with _f32, MIXED_PRECISION False) run
// the same kernels on float32 elements: nothing is rounded to bf16, and a
// kept element is the correctly rounded float32 quotient y / keep_f
// (__fdiv_rn, JAX's float32 x / keep).  Each pass moves twice the bytes.

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
// first sent through dropout's transpose when DROP.  MIN_BLOCKS: the blocks
// an SM must hold (the dense forms ask for 2, a budget of 128 registers a
// thread: faster than leaving it open (93-98 registers) or asking for 3 (85,
// spilling in float32) or 4 in chip_variants.py --k5-dense's turns).
template <typename T, bool DROP, int MIN_BLOCKS>
__global__ void __launch_bounds__(RED_WARPS * 32, MIN_BLOCKS)
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

// No BN, backward: dz = T(z + bias) > 0 ? dropout^T(dy) : 0 written, and
// its column sums per row chunk (dbias), one pass over (z, dy).
template <typename T, bool DROP>
__global__ void __launch_bounds__(RED_WARPS * 32)
bias_relu_grad_kernel(const T* __restrict__ z, const T* __restrict__ dy,
                      const float* __restrict__ bias, const long long* __restrict__ seed,
                      int layer, uint32_t threshold, float keep, T* __restrict__ dz,
                      float* __restrict__ part, long long N, int H, long long rows_per_chunk) {
  __shared__ float s[1][RED_WARPS][COLS];
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
  float b[VEC], acc[1][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    b[e] = bias[col + e];
    acc[0][e] = 0.f;
  }
#pragma unroll 2
  for (long long i = first + warp; i < last; i += RED_WARPS) {
    float zf[VEC], df[VEC];
    load8(z + i * H + col, zf);
    load8(dy + i * H + col, df);
    dropped_dy<T, DROP>(dk, i, ck, df);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float h = round_to<T>(__fadd_rn(zf[e], b[e]));
      df[e] = h > 0.f ? df[e] : 0.f;
      acc[0][e] = __fadd_rn(acc[0][e], df[e]);
    }
    store8(dz + i * H + col, df);
  }
  float* const out[1] = {part};
  block_column_sums<1>(s, acc, out, blockIdx.y, c0, H);
}

// ---------------------------------------------------------------------------
// The dense BatchNorm's moments in one read of z.
//
// A lane owns 8 columns; its warp takes tiles of MOM_ROWS consecutive rows of
// its row chunk (tile k of warp w starts at row first + (k * RED_WARPS + w) *
// MOM_ROWS) and the lane holds a tile's 8 x 8 values in registers.  Its
// running state is the count n (a scalar: the mask is per row), the mean as
// an unevaluated sum hi + lo (lo keeps what float32's hi cannot, so the mean
// stays exact to float32's width relative to the spread, whatever |mean| /
// std is), and M2, the masked sum of squared deviations from the mean.  A
// tile's own statistics are centred in registers about a shift p: with
// u = z - p, c = sum(m u) / w (w = sum m) and q = sum(m (u - c)^2).  The
// lane's first tile with a valid row takes p = its first valid row's value
// and becomes the state: n = w, hi + lo = p + c exactly (TwoSum, so hi is
// the tile's mean rounded), M2 = q.  Every later tile takes p = hi and
// merges by Chan's formula: a = w / (n + w), d = c - lo, mean += d a (hi
// and lo by an exact TwoSum), M2 += q + d^2 n a.  A tile with no valid row
// is skipped.  The warps' states merge in warp order through shared memory
// and each block writes one (n, hi, lo, M2) partial a column; the tail's
// TAIL_LANES lanes of a column each merge every TAIL_LANES-th chunk in
// order, then the lanes merge in a fixed tree.  No atomics, so two runs
// give the same bits; ops/dense_scorer.py:dense_moments_emulation performs
// the same operations in the same order on the CPU.

constexpr int MOM_ROWS = 8;     // rows of a lane's register tile
constexpr int TAIL_LANES = 16;  // the tail's lanes a column
constexpr int TAIL_COLS = 32;   // the tail's columns a block

// s + e = a + b exactly, s = a + b rounded (Knuth's TwoSum).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float v = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

// Chan's merge into the state (hi, lo, m2) of one column of a part whose
// mean is (hi + lo) + d and whose M2 is m2b, with a = nb / (na + nb) and
// b = na a from the counts.
__device__ __forceinline__ void chan_merge(float a, float b, float d, float m2b, float& hi,
                                           float& lo, float& m2) {
  float e;
  two_sum(hi, __fmul_rn(d, a), hi, e);
  lo = __fadd_rn(lo, e);
  m2 = __fadd_rn(__fadd_rn(m2, m2b), __fmul_rn(__fmul_rn(d, d), b));
}

// The merge of a whole state (nb; hb, lb, mb) into (na; hi, lo, m2): an
// empty part is skipped, an empty state replaced.
__device__ __forceinline__ void merge_state(float& na, float nb, float hb, float lb, float mb,
                                            float& hi, float& lo, float& m2) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb, hi = hb, lo = lb, m2 = mb;
    return;
  }
  const float a = __fdiv_rn(nb, __fadd_rn(na, nb));
  chan_merge(a, __fmul_rn(na, a), __fadd_rn(__fsub_rn(hb, hi), __fsub_rn(lb, lo)), mb, hi, lo,
             m2);
  na = __fadd_rn(na, nb);
}

// A tile's centred statistics for one column e: u[r][e] -= p, then c and q.
__device__ __forceinline__ void tile_stats(const float (&m)[MOM_ROWS],
                                           float (&u)[MOM_ROWS][VEC], int e, float p, float rw,
                                           float& c, float& q) {
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < MOM_ROWS; ++r) {
    u[r][e] = __fsub_rn(u[r][e], p);
    sum = __fadd_rn(sum, __fmul_rn(m[r], u[r][e]));
  }
  c = __fmul_rn(sum, rw);
  q = 0.f;
#pragma unroll
  for (int r = 0; r < MOM_ROWS; ++r) {
    const float v = __fsub_rn(u[r][e], c);
    q = __fadd_rn(q, __fmul_rn(__fmul_rn(v, v), m[r]));
  }
}

// Per row chunk (blockIdx.y) and 256-column block, the (n, hi, lo, M2)
// partial of each column: pn (chunks,), ph / pl / pm (chunks, H).
template <typename T>
__global__ void __launch_bounds__(RED_WARPS * 32)
dense_moments_kernel(const T* __restrict__ z, const float* __restrict__ rows,
                     float* __restrict__ pn, float* __restrict__ ph, float* __restrict__ pl,
                     float* __restrict__ pm, long long N, int H, long long rows_per_chunk) {
  __shared__ float s_n[RED_WARPS];
  __shared__ float s[3][RED_WARPS][COLS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * COLS;
  const int col = c0 + lane * VEC;
  const long long first = (long long)blockIdx.y * rows_per_chunk;
  const long long last = min(first + rows_per_chunk, N);
  float n = 0.f, hi[VEC], lo[VEC], m2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) hi[e] = lo[e] = m2[e] = 0.f;
  for (long long r0 = first + (long long)warp * MOM_ROWS; r0 < last;
       r0 += (long long)RED_WARPS * MOM_ROWS) {
    float m[MOM_ROWS], u[MOM_ROWS][VEC];
#pragma unroll
    for (int r = 0; r < MOM_ROWS; ++r) {  // rows past the chunk: the last row's, mask 0
      const long long i = min(r0 + r, last - 1);
      m[r] = r0 + r < last ? rows[i] : 0.f;
      load8(z + i * H + col, u[r]);
    }
    float w = 0.f;
#pragma unroll
    for (int r = 0; r < MOM_ROWS; ++r) w = __fadd_rn(w, m[r]);
    if (w == 0.f) continue;  // the same rows for every lane: no divergence
    const float rw = __frcp_rn(w);
    if (n == 0.f) {  // the lane's first tile: centred about its first valid row
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float p = 0.f, c, q;
#pragma unroll
        for (int r = MOM_ROWS - 1; r >= 0; --r) p = m[r] != 0.f ? u[r][e] : p;
        tile_stats(m, u, e, p, rw, c, q);
        two_sum(p, c, hi[e], lo[e]);
        m2[e] = q;
      }
    } else {
      const float a = __fdiv_rn(w, __fadd_rn(n, w));
      const float b = __fmul_rn(n, a);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float c, q;
        tile_stats(m, u, e, hi[e], rw, c, q);
        chan_merge(a, b, __fsub_rn(c, lo[e]), q, hi[e], lo[e], m2[e]);
      }
    }
    n = __fadd_rn(n, w);
  }
  if (lane == 0) s_n[warp] = n;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    s[0][warp][lane * VEC + e] = hi[e];
    s[1][warp][lane * VEC + e] = lo[e];
    s[2][warp][lane * VEC + e] = m2[e];
  }
  __syncthreads();
  const int c = threadIdx.x;  // one column a thread (blockDim.x == COLS)
  float bn = s_n[0], bh = s[0][0][c], bl = s[1][0][c], bm = s[2][0][c];
#pragma unroll
  for (int w = 1; w < RED_WARPS; ++w) merge_state(bn, s_n[w], s[0][w][c], s[1][w][c], s[2][w][c],
                                                  bh, bl, bm);
  const size_t o = (size_t)blockIdx.y * H + c0 + c;
  ph[o] = bh;
  pl[o] = bl;
  pm[o] = bm;
  if (blockIdx.x == 0 && c == 0) pn[blockIdx.y] = bn;
}

// The chunks' partials merged: block (TAIL_COLS, TAIL_LANES) over TAIL_COLS
// columns; lane j of a column merges chunks j, j + TAIL_LANES, ... in order,
// then lane j merges lane j + h for h = TAIL_LANES / 2, ..., 1.  Lane 0 then
// forms mean = hi + lo, var = M2 / n (n the clamped count), and the affine.
__global__ void __launch_bounds__(TAIL_COLS * TAIL_LANES)
dense_moments_tail_kernel(const float* __restrict__ pn, const float* __restrict__ ph,
                          const float* __restrict__ pl, const float* __restrict__ pm, int chunks,
                          const float* __restrict__ n_ptr, const float* __restrict__ scale,
                          const float* __restrict__ bias, float* __restrict__ mean,
                          float* __restrict__ var, float* __restrict__ istd,
                          float* __restrict__ inv, float* __restrict__ shift, int H) {
  __shared__ float s[4][TAIL_LANES][TAIL_COLS];
  const int tx = threadIdx.x, j = threadIdx.y;
  const int c = blockIdx.x * TAIL_COLS + tx;  // H is a multiple of TAIL_COLS
  float n = 0.f, hi = 0.f, lo = 0.f, m2 = 0.f;
  for (int k0 = j; k0 < chunks; k0 += 4 * TAIL_LANES) {
    float kn[4], kh[4], kl[4], km[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // four chunks' loads in flight
      const int k = k0 + t * TAIL_LANES;
      const size_t o = (size_t)min(k, chunks - 1) * H + c;
      kn[t] = k < chunks ? pn[k] : 0.f;
      kh[t] = ph[o], kl[t] = pl[o], km[t] = pm[o];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) merge_state(n, kn[t], kh[t], kl[t], km[t], hi, lo, m2);
  }
  for (int h = TAIL_LANES / 2; h > 0; h >>= 1) {
    s[0][j][tx] = n, s[1][j][tx] = hi, s[2][j][tx] = lo, s[3][j][tx] = m2;
    __syncthreads();
    if (j < h) merge_state(n, s[0][j + h][tx], s[1][j + h][tx], s[2][j + h][tx], s[3][j + h][tx],
                           hi, lo, m2);
    __syncthreads();
  }
  if (j != 0) return;
  const float mu = __fadd_rn(hi, lo);
  const float v = __fdiv_rn(m2, *n_ptr);
  const float is = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(v, EPS)));
  const float iv = __fmul_rn(is, scale[c]);
  mean[c] = mu;
  var[c] = v;
  istd[c] = is;
  inv[c] = iv;
  shift[c] = __fsub_rn(bias[c], __fmul_rn(mu, iv));
}

}  // namespace

namespace {

// K5's forward on elements of type T: moments, their tail, y.
template <typename T>
cudaError_t bn_forward(const void* z, const void* rows, const void* n, const void* running_mean,
                       const void* scale, const void* bias, void* part1, void* part2,
                       void* mean, void* var, void* istd, void* inv, void* shift, void* y,
                       long long N, int H, int chunks, long long rows_per_chunk,
                       cudaStream_t s) {
  moments_kernel<<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      static_cast<const T*>(z), static_cast<const float*>(rows),
      static_cast<const float*>(running_mean), static_cast<float*>(part1),
      static_cast<float*>(part2), N, H, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_moments_tail_kernel<<<(H + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2), chunks,
      static_cast<const float*>(n), static_cast<const float*>(running_mean),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(mean), static_cast<float*>(var), static_cast<float*>(istd),
      static_cast<float*>(inv), static_cast<float*>(shift), H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  affine_relu_kernel<<<elementwise_grid(N, H), elementwise_threads(H), 0, s>>>(
      static_cast<const T*>(z), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<T*>(y), N, H);
  return cudaGetLastError();
}

}  // namespace

// Forward: moments, the affine, and y.  z and y (N, H) bf16; part1/part2
// are (chunks, H) f32 scratch; mean/var/istd/inv/shift are (H,) f32
// outputs.  Returns a CUDA error code (0 on success).
extern "C" int bn_relu_forward(const void* z, const void* rows, const void* n,
                               const void* running_mean, const void* scale,
                               const void* bias, void* part1, void* part2, void* mean,
                               void* var, void* istd, void* inv, void* shift, void* y,
                               long long N,
                               int H, int chunks, long long rows_per_chunk, void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  return (int)bn_forward<__nv_bfloat16>(z, rows, n, running_mean, scale, bias, part1, part2,
                                        mean, var, istd, inv, shift, y, N, H, chunks,
                                        rows_per_chunk, reinterpret_cast<cudaStream_t>(stream));
}

// Its float32 form: z and y (N, H) float32, the rest as bn_relu_forward.
extern "C" int bn_relu_forward_f32(const void* z, const void* rows, const void* n,
                                   const void* running_mean, const void* scale,
                                   const void* bias, void* part1, void* part2, void* mean,
                                   void* var, void* istd, void* inv, void* shift, void* y,
                                   long long N, int H, int chunks, long long rows_per_chunk,
                                   void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  return (int)bn_forward<float>(z, rows, n, running_mean, scale, bias, part1, part2, mean, var,
                                istd, inv, shift, y, N, H, chunks, rows_per_chunk,
                                reinterpret_cast<cudaStream_t>(stream));
}

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
template <typename T, bool DROP, int MIN_BLOCKS>
cudaError_t launch_bn_backward(const void* z, const void* dy, const void* rows, const void* n,
                               const void* scale, const void* mean, const void* istd,
                               const void* inv, const void* shift, const void* seed,
                               void* part1, void* part2, void* G1, void* G2, void* dz,
                               long long N, int H, int chunks, long long rows_per_chunk,
                               int layer, uint32_t threshold, float keep, cudaStream_t s) {
  const T* z_ = static_cast<const T*>(z);
  const T* dy_ = static_cast<const T*>(dy);
  const long long* seed_ = static_cast<const long long*>(seed);
  bn_grad_sums_kernel<T, DROP, MIN_BLOCKS><<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
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

// Backward: G1/G2 ((H,) f32 outputs, = dbias/dscale) and dz (N, H) bf16.
extern "C" int bn_relu_backward(const void* z, const void* dy, const void* rows,
                                const void* n, const void* scale, const void* mean,
                                const void* istd, const void* inv, const void* shift,
                                void* part1, void* part2, void* G1, void* G2, void* dz,
                                long long N, int H, int chunks, long long rows_per_chunk,
                                void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  return (int)launch_bn_backward<__nv_bfloat16, false, 1>(
      z, dy, rows, n, scale, mean, istd, inv, shift, nullptr, part1, part2, G1, G2, dz, N, H,
      chunks, rows_per_chunk, 0, KEEP_ALL, 1.f, reinterpret_cast<cudaStream_t>(stream));
}

// Its float32 form: z, dy and dz (N, H) float32, the rest as
// bn_relu_backward.
extern "C" int bn_relu_backward_f32(const void* z, const void* dy, const void* rows,
                                    const void* n, const void* scale, const void* mean,
                                    const void* istd, const void* inv, const void* shift,
                                    void* part1, void* part2, void* G1, void* G2, void* dz,
                                    long long N, int H, int chunks, long long rows_per_chunk,
                                    void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk)) return (int)cudaErrorInvalidValue;
  return (int)launch_bn_backward<float, false, 1>(
      z, dy, rows, n, scale, mean, istd, inv, shift, nullptr, part1, part2, G1, G2, dz, N, H,
      chunks, rows_per_chunk, 0, KEEP_ALL, 1.f, reinterpret_cast<cudaStream_t>(stream));
}

namespace {

// The dense scorer's entry points on elements of type T (bf16, or float32
// for the _f32 forms).

template <typename T>
int dense_bn_forward(const void* z, const void* rows, const void* n, const void* scale,
                     const void* bias, const void* seed, void* part, void* mean, void* var,
                     void* istd, void* inv, void* shift, void* y, long long N, int H, int chunks,
                     long long rows_per_chunk, int layer, int threshold, float keep,
                     void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk) || !drop_ok(layer, threshold, keep))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t ch = (size_t)chunks * H;
  float* ph = static_cast<float*>(part);
  float* pl = ph + ch;
  float* pm = pl + ch;
  float* pn = pm + ch;
  dense_moments_kernel<<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      static_cast<const T*>(z), static_cast<const float*>(rows), pn, ph, pl, pm, N, H,
      rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dense_moments_tail_kernel<<<H / TAIL_COLS, dim3(TAIL_COLS, TAIL_LANES), 0, s>>>(
      pn, ph, pl, pm, chunks, static_cast<const float*>(n), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(mean), static_cast<float*>(var),
      static_cast<float*>(istd), static_cast<float*>(inv), static_cast<float*>(shift), H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_act<T, true>(z, static_cast<const float*>(inv),
                                  static_cast<const float*>(shift), seed, layer,
                                  (uint32_t)threshold, keep, y, N, H, s);
}

constexpr int DENSE_SUM_BLOCKS = 2;  // the dense backward's sums blocks an SM

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
  auto launch = thr >= KEEP_ALL ? launch_bn_backward<T, false, DENSE_SUM_BLOCKS>
                                 : launch_bn_backward<T, true, DENSE_SUM_BLOCKS>;
  return (int)launch(z, dy, rows, n, scale, mean, istd, inv, shift, seed, part1, part2, G1, G2,
                     dz, N, H, chunks, rows_per_chunk, layer, thr, keep, s);
}

template <typename T>
int dense_bias_forward(const void* z, const void* bias, const void* seed, void* y, long long N,
                       int H, int layer, int threshold, float keep, void* stream) {
  if (N <= 0 || H <= 0 || H % COLS != 0 || !drop_ok(layer, threshold, keep))
    return (int)cudaErrorInvalidValue;
  return (int)launch_act<T, false>(z, nullptr, static_cast<const float*>(bias), seed, layer,
                                   (uint32_t)threshold, keep, y, N, H,
                                   reinterpret_cast<cudaStream_t>(stream));
}

template <typename T>
int dense_bias_backward(const void* z, const void* dy, const void* bias, const void* seed,
                        void* part, void* dbias, void* dz, long long N, int H, int chunks,
                        long long rows_per_chunk, int layer, int threshold, float keep,
                        void* stream) {
  if (!shapes_ok(N, H, chunks, rows_per_chunk) || !drop_ok(layer, threshold, keep))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t thr = (uint32_t)threshold;
  auto kernel = thr >= KEEP_ALL ? bias_relu_grad_kernel<T, false> : bias_relu_grad_kernel<T, true>;
  kernel<<<dim3(H / COLS, chunks), RED_WARPS * 32, 0, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(dy), static_cast<const float*>(bias),
      static_cast<const long long*>(seed), layer, thr, keep, static_cast<T*>(dz),
      static_cast<float*>(part), N, H, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sums_tail_kernel<1><<<(H + 255) / 256, 256, 0, s>>>(
      ChunkSums<1>{{static_cast<const float*>(part)}, {static_cast<float*>(dbias)}}, chunks, H);
  return (int)cudaGetLastError();
}

}  // namespace

// The dense scorer's forward: the centred moments in one read of z
// (dense_moments_kernel and its tail), the affine, and y with dropout (seed:
// two int64 words; a row-column's 24-bit draw below threshold keeps it,
// divided by keep).  part: (3 * chunks * H + chunks) f32 scratch;
// mean/var/istd/inv/shift (H,) f32 outputs; z and y bf16.
extern "C" int bn_relu_dropout_forward(const void* z, const void* rows, const void* n,
                                       const void* scale, const void* bias, const void* seed,
                                       void* part, void* mean, void* var, void* istd, void* inv,
                                       void* shift, void* y, long long N, int H, int chunks,
                                       long long rows_per_chunk, int layer, int threshold,
                                       float keep, void* stream) {
  return dense_bn_forward<__nv_bfloat16>(z, rows, n, scale, bias, seed, part, mean, var, istd,
                                         inv, shift, y, N, H, chunks, rows_per_chunk, layer,
                                         threshold, keep, stream);
}

// Its float32 form: z and y float32.
extern "C" int bn_relu_dropout_forward_f32(const void* z, const void* rows, const void* n,
                                           const void* scale, const void* bias, const void* seed,
                                           void* part, void* mean, void* var, void* istd,
                                           void* inv, void* shift, void* y, long long N, int H,
                                           int chunks, long long rows_per_chunk, int layer,
                                           int threshold, float keep, void* stream) {
  return dense_bn_forward<float>(z, rows, n, scale, bias, seed, part, mean, var, istd, inv,
                                 shift, y, N, H, chunks, rows_per_chunk, layer, threshold, keep,
                                 stream);
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

// No BatchNorm: y = dropout(relu(bf16(f32(z) + bias))), bias (H,) f32 (the
// compute dtype's values); z and y bf16.
extern "C" int bias_relu_dropout_forward(const void* z, const void* bias, const void* seed,
                                         void* y, long long N, int H, int layer, int threshold,
                                         float keep, void* stream) {
  return dense_bias_forward<__nv_bfloat16>(z, bias, seed, y, N, H, layer, threshold, keep,
                                           stream);
}

// Its float32 form: y = dropout(relu(z + bias)), z and y float32.
extern "C" int bias_relu_dropout_forward_f32(const void* z, const void* bias, const void* seed,
                                             void* y, long long N, int H, int layer,
                                             int threshold, float keep, void* stream) {
  return dense_bias_forward<float>(z, bias, seed, y, N, H, layer, threshold, keep, stream);
}

// Its backward: dz (N, H) bf16 and dbias (H,) f32, the column sums per row
// chunk into part (chunks, H) and then added in chunk order.
extern "C" int bias_relu_dropout_backward(const void* z, const void* dy, const void* bias,
                                          const void* seed, void* part, void* dbias, void* dz,
                                          long long N, int H, int chunks,
                                          long long rows_per_chunk, int layer, int threshold,
                                          float keep, void* stream) {
  return dense_bias_backward<__nv_bfloat16>(z, dy, bias, seed, part, dbias, dz, N, H, chunks,
                                            rows_per_chunk, layer, threshold, keep, stream);
}

// Its float32 form: z, dy and dz float32.
extern "C" int bias_relu_dropout_backward_f32(const void* z, const void* dy, const void* bias,
                                              const void* seed, void* part, void* dbias,
                                              void* dz, long long N, int H, int chunks,
                                              long long rows_per_chunk, int layer,
                                              int threshold, float keep, void* stream) {
  return dense_bias_backward<float>(z, dy, bias, seed, part, dbias, dz, N, H, chunks,
                                    rows_per_chunk, layer, threshold, keep, stream);
}
