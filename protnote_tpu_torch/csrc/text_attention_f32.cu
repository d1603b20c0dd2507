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
// The products on the tensor cores (3xTF32).  Each operand x is split into
// x_hi = tf32(x) and x_lo = tf32(x - x_hi), each rounded as cvt.rna.tf32
// rounds (11 significant bits; the remainder exact in float32), and a . b
// is a_lo b_hi + a_hi b_lo + a_hi b_hi on mma.sync m16n8k8 (tf32 in, f32
// accumulators); the term a_lo b_lo and the rounding of x_lo lie below
// 2^-24 of |a b|.  The pieces are formed by two integer operations each:
// cvt.rna.tf32 runs on the slower conversion pipe, and with it both kernels
// ran 1.2-2x slower on an H100.  The tensor cores' adds are not float32's
// rounded adds, so every 16-deep stage of a product is summed from 0 (the
// cross products of its two k-steps first, then their hi products) and
// added into float32 accumulators rounded to nearest: the stages run over
// the depth in order (dims 16 s .. 16 s + 15 of q.k and dctx.v, keys of p.v
// and dS.k, queries of p^T.dctx and dS^T.q).
// mma.sync takes its fragments from plain shared-memory loads, so no operand
// is staged transposed: the depth order inside a stage is permuted so that a
// thread's loads are 16-byte vectors (four dims of a row), and the k-step's
// columns t, t + 4 of p or dS are the keys 2t, 2t + 1 that its accumulator
// tile holds.  Every float32 tile lies in shared memory as 64-float rows
// with 16-byte chunk c of row r at c ^ swz(r), which makes each product's
// loads free of bank conflicts.
//
// Order of the row statistics (tests/test_torch_tower_f32.py emulates it in
// numpy against JAX): a thread's partial of a row over a 64-key tile adds
// its keys 8 j + 2 t, 8 j + 2 t + 1 for j = 0..7 in order, from 0; the four
// threads of the row add theirs as (t0 + t1) + (t2 + t3); the tiles' sums
// are added in order.  At T <= 128 z and D are those sums with the row's
// final m; above 128 z is the running sum l, rescaled at each tile by
// expf(m_old - m_new) (as K8a's bf16 two-pass form), and y = expf(s - m)
// is still JAX's with the final m.
//
// Design.
// * forward (attn_fwd_f32): a block a (b, h, 64 queries), four warps of 16
//   query rows, two blocks an SM; Q's tile, then (after the key mask) only
//   the key tiles some warp needs, by cp.async.  T <= 128: every key tile
//   has its own slot and group, so the second K tile and the V tiles arrive
//   under the first tile's products; a warp holds its rows' scores (up to
//   128 keys) in accumulator registers, takes max, expf, sum and division
//   there, and feeds p to p.v from the same registers.  T > 128: two passes
//   over a two-slot ring (pass 1 the running max and sum from K tiles, pass
//   2 s again, p = expf(s - m) / l and p.v).  Key tiles that add exactly 0
//   are skipped with K8a bf16's rule (csrc/text_attention.cu: a row with a
//   kept key at or before it has m far above -1e9, so expf(-1e9 + x - m)
//   is 0).
// * backward at T <= 128 (attn_bwd_f32<., true>): one block a (b, h), eight
//   warps, K and V whole and the queries in two 64-row tiles, each its own
//   Q and dctx slot.  A tile's row phase: warp (i, kh) forms s and dP of its
//   16 rows against the 64 keys of half kh in registers; the pair of warps
//   of a row adds m, z and D through shared memory; p and dS go to two
//   (64, 128) buffers.  The column phase: warp w adds p^T.dctx and
//   dS^T.q for its 16 keys (over both tiles, in registers) and forms dQ of
//   16 rows x 32 dims from the dS buffer.  Five products, each once; 204 KB
//   of shared memory, one block an SM.
// * backward above 128: attn_bwd_dq_f32, a block a (b, h, 64 queries) over
//   a two-slot ring of K and V tiles in three passes (m and l; D; dS and
//   dQ, the row's m, z and D written out), then attn_bwd_f32<., false>, a
//   block a (b, h, 128 keys) walking the query tiles through a two-slot
//   ring with the rows' m, z and D: the row and column phases above without
//   the statistics' exchange and without dQ.
// No atomics: every call gives the same bits.
//
// What bounds it: bytes.  At 128 x 16 heads x T 128 the forward reads q, k,
// v and writes ctx, 268 MB: 0.080 ms at 3.35 TB/s; its two products, 8.6
// GFLOP, take 0.052 ms at the split's 165 TFLOP/s (495 / 3: three TF32
// products each) and 0.128 on the FMA pipe.  The backward moves 470 MB
// (0.140 ms) against five products' 0.130 ms.  On an H100 the forward takes
// about 0.23 ms there and the backward 0.61: the products through mma.sync
// at two warps an SM sub-partition set the pace (without the split's cross
// products 0.16 and 0.39 ms; without the tile loads 0.18 and 0.58;
// chip_variants.py --k8a-f32).

#include "hopper.cuh"  // smem_u32, div_rn

namespace {

constexpr int HD = 64;              // head width
constexpr int TILE = 64;            // keys or queries a tile
constexpr int TILE_F = TILE * HD;   // floats of a tile
constexpr int MAX_T = 512;
constexpr int WHOLE_T = 2 * TILE;   // T <= 128: one pass forward, one kernel backward
constexpr int PS = WHOLE_T + 8;     // row pitch of the p and dS buffers (floats)
constexpr int FWD_THREADS = 128;    // four warps of 16 query rows
constexpr int BWD_THREADS = 256;    // eight warps
constexpr float MASKED = -1e9f;     // the JAX package's additive mask value

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));  // 0: fill the 16 bytes with zeros
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n (0..3) of the thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// 16-byte chunk c of tile row r lies at chunk c ^ swz(r): the row pairs
// (r, r + 1), the rows 2t + e and the rows t + 4e of an 8-row group each
// reach eight distinct bank groups in the loads below
__device__ __forceinline__ int swz(int r) { return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2); }
__device__ __forceinline__ int at(int r, int c) { return r * HD + ((c ^ swz(r)) << 2); }

// rows [r0, r0 + n) of a (T, 64) float32 matrix into a swizzled tile by
// cp.async, rows at or past T zero-filled
template <int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int n, int T) {
  const uint32_t d = smem_u32(dst);
  for (int i = threadIdx.x; i < n * (HD / 4); i += NT) {
    const int r = i >> 4, c = i & 15;
    const bool ok = r0 + r < T;
    cp_async16(d + 4 * at(r, c), src + (size_t)(ok ? r0 + r : 0) * HD + 4 * c, ok);
  }
}

__device__ __forceinline__ float comp(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// x rounded to tf32 (10 fraction bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds it, by two integer operations on its bits
// (cvt takes the slower conversion pipe)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), the remainder exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a . b, m16n8k8, tf32 in, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the split A fragments of a 16-deep stage (two k-steps), in m16n8k8 order
// (rows g, g + 8 at column t, then at column t + 4)
struct AFrag {
  uint32_t h[2][4], l[2][4];
};

__device__ __forceinline__ void split_a(AFrag& a, const float (&v)[2][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[ks][i], a.h[ks][i], a.l[ks][i]);
}

// acc += one 16-deep stage of a . b (two k-steps), b's pieces [k-step][column
// t, t + 4]: summed from 0 (the cross products first, then the hi
// products) and added rounded to nearest
__device__ __forceinline__ void stage(float (&acc)[4], const AFrag& a, const uint32_t (&bh)[2][2],
                                      const uint32_t (&bl)[2][2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    mma_tf32(d, a.l[ks], bh[ks][0], bh[ks][1]);
    mma_tf32(d, a.h[ks], bl[ks][0], bl[ks][1]);
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) mma_tf32(d, a.h[ks], bh[ks][0], bh[ks][1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
}

// acc[j] += A[m0 + 16 rows] . B[8 j + 8 rows]^T over the 64 dims (q.k,
// dctx.v), both swizzled tiles, in stages of 16 dims; stage s's k-step ks
// takes dims 16 s + 4 t + 2 ks (column t) and + 1 (column t + 4)
__device__ __forceinline__ void product_rows(float (&acc)[8][4], const float* A, int m0,
                                             const float* B, int g, int t) {
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(A + at(m0 + g, 4 * s + t));
    const float4 y = *reinterpret_cast<const float4*>(A + at(m0 + g + 8, 4 * s + t));
    const float v[2][4] = {{x.x, y.x, x.y, y.y}, {x.z, y.z, x.w, y.w}};
    AFrag a;
    split_a(a, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 z = *reinterpret_cast<const float4*>(B + at(8 * j + g, 4 * s + t));
      uint32_t bh[2][2], bl[2][2];
      split(z.x, bh[0][0], bl[0][0]);
      split(z.y, bh[0][1], bl[0][1]);
      split(z.z, bh[1][0], bl[1][0]);
      split(z.w, bh[1][1], bl[1][1]);
      stage(acc[j], a, bh, bl);
    }
  }
}

// out[h][c] += one stage a . B for output n-tiles 4 (h0 + h) + c (their
// column g is dim 32 (h0 + h) + 4 g + c), B's rows the depth: the k-step
// ks's column t is row r0 + 8 ks + 2 t and column t + 4 row + 1 (PAIRS: the
// keys of an accumulator tile), or rows r0 + 8 ks + t and + 4
template <bool PAIRS, int H>
__device__ __forceinline__ void stage_cols(float (&out)[H][4][4], const AFrag& a, const float* B,
                                           int r0, int h0, int g, int t) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float4 z[2][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * ks + (PAIRS ? 2 * t + e : t + 4 * e);
        z[ks][e] = *reinterpret_cast<const float4*>(B + at(r, g + 8 * (h0 + h)));
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int e = 0; e < 2; ++e) split(comp(z[ks][e], c), bh[ks][e], bl[ks][e]);
      stage(out[h][c], a, bh, bl);
    }
  }
}

// A of keys 16 s .. 16 s + 15 from accumulator tiles x0, x1 (keys 8 j + 2 t
// and + 1 of rows g, g + 8): column t is key 2 t, column t + 4 key 2 t + 1
__device__ __forceinline__ void a_from_acc(AFrag& a, const float (&x0)[4], const float (&x1)[4]) {
  const float v[2][4] = {{x0[0], x0[2], x0[1], x0[3]}, {x1[0], x1[2], x1[1], x1[3]}};
  split_a(a, v);
}

// A of rows m0 + g, + 8 and keys k0 + 8 ks + 2 t, + 1 of a (query, key)
// buffer at pitch PS
__device__ __forceinline__ void a_from_rows(AFrag& a, const float* X, int m0, int k0, int g,
                                            int t) {
  float v[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const float2 x = *reinterpret_cast<const float2*>(X + (m0 + g) * PS + k0 + 8 * ks + 2 * t);
    const float2 y = *reinterpret_cast<const float2*>(X + (m0 + g + 8) * PS + k0 + 8 * ks + 2 * t);
    v[ks][0] = x.x;
    v[ks][1] = y.x;
    v[ks][2] = x.y;
    v[ks][3] = y.y;
  }
  split_a(a, v);
}

// A transposed, of keys c0 + g, + 8 (its rows) and queries r0 + 8 ks + t,
// + 4 (its depth) of a (query, key) buffer at pitch PS
__device__ __forceinline__ void a_from_cols(AFrag& a, const float* X, int c0, int r0, int g,
                                            int t) {
  float v[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const float* x = X + (r0 + 8 * ks + t) * PS + c0 + g;
    v[ks][0] = x[0];
    v[ks][1] = x[8];
    v[ks][2] = x[4 * PS];
    v[ks][3] = x[4 * PS + 8];
  }
  split_a(a, v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// accumulator tiles x[j] (keys 8 j + 2 t + (e & 1), rows g + 8 (e >> 1)):
// the thread's partial of each row over its keys, j then the pair, from 0
template <int NJ>
__device__ __forceinline__ void lane_sums(const float (&x)[NJ][4], float (&r)[2]) {
  r[0] = r[1] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    r[0] = __fadd_rn(__fadd_rn(r[0], x[j][0]), x[j][1]);
    r[1] = __fadd_rn(__fadd_rn(r[1], x[j][2]), x[j][3]);
  }
}

// the scores of accumulator tiles s[j]: (dot * scale) + bias, the bias of
// key key0 + i at kb[i] (0, -1e9, or -inf past T) and -1e9 (causal) on a
// kept key after the query; rows row0 + g, + 8
template <bool CAUSAL, int NJ>
__device__ __forceinline__ void to_scores(float (&s)[NJ][4], float scale, const float* kb,
                                          int key0, int row0, int g, int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * j + 2 * t + (e & 1);
      float bias = kb[i];
      if (CAUSAL && key0 + i > row0 + g + 8 * (e >> 1)) bias = fminf(bias, MASKED);
      s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), bias);
    }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&x)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// the running max and sum of rows g, g + 8 after one more key tile s
// (scores): m = max(m, tile max), l = l * expf(m_old - m) + the tile's sum
// of expf(s - m)
__device__ __forceinline__ void running(const float (&s)[8][4], float (&m)[2], float (&l)[2]) {
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mt[r]));
    l[r] = __fmul_rn(l[r], expf(__fsub_rn(m[r], mn)));  // 0 before any key
    m[r] = mn;
  }
  float y[8][4], lt[2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = expf(__fsub_rn(s[j][e], m[e >> 1]));
  lane_sums(y, lt);
  l[0] = __fadd_rn(l[0], quad_sum(lt[0]));
  l[1] = __fadd_rn(l[1], quad_sum(lt[1]));
}

// out (16 rows x 64 dims as o[h][c]: rows g (e 0, 1) and g + 8 (e 2, 3),
// dims 32 h + 8 t + c (e even) and + 4 (e odd)) to rows row0 + g, + 8 of a
// (T, 64) matrix, rows at or past T not stored; H the dims halves held
template <int H>
__device__ __forceinline__ void store_rows(float* dst, const float (&o)[H][4][4], int h0,
                                           int row0, int T, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(dst + (size_t)row * HD + 32 * (h0 + h) + 8 * t + 4 * e) =
            make_float4(o[h][0][2 * r + e], o[h][1][2 * r + e], o[h][2][2 * r + e],
                        o[h][3][2 * r + e]);
  }
}

// kb[i] for the keys key0 + i, i < n: 0 (kept), -1e9 (masked), -inf past T
template <int NT>
__device__ __forceinline__ void load_key_bias(float* kb, const int* __restrict__ mask, int key0,
                                              int n, int T) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const int j = key0 + i;
    kb[i] = j >= T ? -INFINITY : __ldg(mask + j) != 0 ? 0.f : MASKED;
  }
}

// Which key tiles a warp whose rows start at w0 must see: [lo, hi).  first
// and last are the batch row's first and last kept keys (first = T: none).
template <bool CAUSAL>
__device__ __forceinline__ void warp_tiles(int w0, int T, int first, int last, int& lo, int& hi) {
  if (w0 >= T) {  // no row of the warp is stored
    lo = hi = 0;
    return;
  }
  const bool every_row_kept = CAUSAL ? first <= w0 : first < T;
  if (every_row_kept) {
    const int end = CAUSAL ? min(last, w0 + 15) : last;
    lo = first / TILE;
    hi = end / TILE + 1;
  } else {
    lo = 0;
    hi = (T + TILE - 1) / TILE;
  }
}

// ---------------------------------------------------------------------------
// forward: a block a (b, h, 64 queries)

template <bool CAUSAL, bool ONE_PASS>
__global__ void __launch_bounds__(FWD_THREADS, 2)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ key_mask,
             float* __restrict__ ctx, int nh, int T, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // the block's 64 query rows
  float* Ks = Qs + TILE_F;    // two K tiles: one a key tile (one pass) or a ring of two
  float* Vs = Ks + 2 * TILE_F;  // the same for V
  __shared__ float kbias[MAX_T];
  __shared__ int span[2];  // first and last kept key

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, q0 = blockIdx.x * TILE;
  const size_t base = ((size_t)b * nh + blockIdx.y) * T * HD;
  const int nkt = (T + TILE - 1) / TILE;

  load_rows<FWD_THREADS>(Qs, q + base, q0, TILE, T);
  cp_async_commit();
  if (tid == 0) {
    span[0] = T;
    span[1] = -1;
  }
  __syncthreads();
  int first = T, last = -1;
  for (int j = tid; j < nkt * TILE; j += FWD_THREADS) {
    const bool kept = j < T && __ldg(key_mask + (size_t)b * T + j) != 0;
    kbias[j] = j >= T ? -INFINITY : kept ? 0.f : MASKED;
    if (kept) {
      first = min(first, j);
      last = max(last, j);
    }
  }
  first = __reduce_min_sync(0xffffffffu, first);
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) {
    atomicMin(&span[0], first);
    atomicMax(&span[1], last);
  }
  __syncthreads();
  first = span[0];
  last = span[1];
  const int w0 = q0 + 16 * warp;
  int lo, hi, blo = nkt, bhi = 0;
  warp_tiles<CAUSAL>(w0, T, first, last, lo, hi);
#pragma unroll 1
  for (int w = 0; w < FWD_THREADS / 32; ++w) {
    int l_, h_;
    warp_tiles<CAUSAL>(q0 + 16 * w, T, first, last, l_, h_);
    if (l_ < h_) {
      blo = min(blo, l_);
      bhi = max(bhi, h_);
    }
  }
  const int n = bhi > blo ? bhi - blo : 0;  // key tiles the block loads

  float o[2][4][4];
  zero(o[0]);
  zero(o[1]);
  if (ONE_PASS) {
    // groups: Q, each K tile, the V tiles
    for (int kt = blo; kt < bhi; ++kt) {
      load_rows<FWD_THREADS>(Ks + kt * TILE_F, k + base, kt * TILE, TILE, T);
      cp_async_commit();
    }
    for (int kt = blo; kt < bhi; ++kt)
      load_rows<FWD_THREADS>(Vs + kt * TILE_F, v + base, kt * TILE, TILE, T);
    cp_async_commit();
    float s[2][8][4];
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      if (kt < blo || kt >= bhi) continue;
      cp_async_wait(bhi - kt);  // Q and K tiles up to kt landed
      __syncthreads();
      if (kt >= lo && kt < hi) {
        zero(s[kt]);
        product_rows(s[kt], Qs, 16 * warp, Ks + kt * TILE_F, g, t);
        to_scores<CAUSAL, 8>(s[kt], scale, kbias + kt * TILE, kt * TILE, w0, g, t);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[kt][j][e]);
      }
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    float z[2] = {0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      if (kt < lo || kt >= hi) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[kt][j][e] = expf(__fsub_rn(s[kt][j][e], m[e >> 1]));
      float zt[2];
      lane_sums(s[kt], zt);
      z[0] = __fadd_rn(z[0], quad_sum(zt[0]));
      z[1] = __fadd_rn(z[1], quad_sum(zt[1]));
    }
    const float r[2] = {__frcp_rn(z[0]), __frcp_rn(z[1])};
    cp_async_wait(0);
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      if (kt < lo || kt >= hi) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[kt][j][e] = div_rn(s[kt][j][e], z[e >> 1], r[e >> 1]);
#pragma unroll
      for (int s2 = 0; s2 < TILE / 16; ++s2) {
        AFrag a;
        a_from_acc(a, s[kt][2 * s2], s[kt][2 * s2 + 1]);
#pragma unroll
        stage_cols<true, 2>(o, a, Vs + kt * TILE_F, 16 * s2, 0, g, t);
      }
    }
  } else {
    // steps 0 .. n-1: pass 1 over K tiles; n .. 2n-1: pass 2 over K and V;
    // step i in slot i & 1, loaded under step i - 1
    auto issue = [&](int step) {
      if (step >= 2 * n) return;
      const int slot = step & 1, kt = blo + (step < n ? step : step - n);
      load_rows<FWD_THREADS>(Ks + slot * TILE_F, k + base, kt * TILE, TILE, T);
      if (step >= n) load_rows<FWD_THREADS>(Vs + slot * TILE_F, v + base, kt * TILE, TILE, T);
    };
    issue(0);
    cp_async_commit();
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};
#pragma unroll 1
    for (int step = 0; step < 2 * n; ++step) {
      cp_async_wait(0);
      __syncthreads();  // this step's tiles landed; every warp is done with the other slot
      issue(step + 1);
      cp_async_commit();
      const int slot = step & 1;
      const bool second = step >= n;
      const int kt = blo + (second ? step - n : step);
      if (second && step == n) {
        r[0] = __frcp_rn(l[0]);
        r[1] = __frcp_rn(l[1]);
      }
      if (kt < lo || kt >= hi) continue;
      float s[8][4];
      zero(s);
      product_rows(s, Qs, 16 * warp, Ks + slot * TILE_F, g, t);
      to_scores<CAUSAL, 8>(s, scale, kbias + kt * TILE, kt * TILE, w0, g, t);
      if (!second) {
        running(s, m, l);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = div_rn(expf(__fsub_rn(s[j][e], m[e >> 1])), l[e >> 1], r[e >> 1]);
#pragma unroll
        for (int s2 = 0; s2 < TILE / 16; ++s2) {
          AFrag a;
          a_from_acc(a, s[2 * s2], s[2 * s2 + 1]);
          stage_cols<true, 2>(o, a, Vs + slot * TILE_F, 16 * s2, 0, g, t);
        }
      }
    }
    cp_async_wait(0);
  }
  store_rows<2>(ctx + base, o, 0, w0, T, g, t);
}

// ---------------------------------------------------------------------------
// backward: the row and column phases of a block of 128 keys (WHOLE: every
// key at T <= 128, with the rows' statistics and dQ; else the rows' m, z and
// D from attn_bwd_dq_f32)

constexpr int BWD_SMEM_FLOATS = 8 * TILE_F + 2 * TILE * PS + 12 * TILE;

// named barrier of the two warps (i, 0) and (i, 1) that share 16 query rows
__device__ __forceinline__ void pair_sync(int i) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + i) : "memory");
}

template <bool CAUSAL, bool WHOLE>
__global__ void __launch_bounds__(BWD_THREADS, 1)
attn_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dctx,
             const int* __restrict__ key_mask, const float* __restrict__ stats,
             float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int nh,
             int T, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // the block's 128 keys
  float* Vs = Ks + 2 * TILE_F;
  float* Qs = Vs + 2 * TILE_F;  // two slots of 64 query rows
  float* Gs = Qs + 2 * TILE_F;  // dctx, the same
  float* P = Gs + 2 * TILE_F;   // p of the tile's 64 queries x 128 keys, pitch PS
  float* DS = P + TILE * PS;    // dS, the same
  float* xch = DS + TILE * PS;  // [key half][m, z, D][64 rows]: the halves' partials
  float* rows = xch + 6 * TILE;  // [slot][m, z, D][64 rows] (not WHOLE)
  __shared__ float kb[WHOLE_T];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int mi = warp & 3, kh = warp >> 2;  // the row phase's 16 rows and key half
  const int b = blockIdx.z, k0 = blockIdx.x * WHOLE_T;
  const size_t bh = (size_t)b * nh + blockIdx.y, base = bh * T * HD;
  const size_t n_rows = (size_t)gridDim.z * nh * T;
  const int nqt = (T + TILE - 1) / TILE;

  // groups: K and Q tile 0 (and its statistics), V and dctx tile 0, then one
  // a later query tile (Q, statistics, dctx)
  auto issue_q = [&](int qt) {
    const int slot = qt & 1;
    load_rows<BWD_THREADS>(Qs + slot * TILE_F, q + base, qt * TILE, TILE, T);
    if (!WHOLE)
      for (int i = tid; i < 3 * TILE; i += BWD_THREADS) {
        const int row = qt * TILE + i % TILE;
        const bool ok = row < T;
        cp_async4(smem_u32(rows + slot * 3 * TILE + i),
                  stats + (i / TILE) * n_rows + bh * T + (ok ? row : 0), ok);
      }
  };
  auto issue_g = [&](int qt) {
    load_rows<BWD_THREADS>(Gs + (qt & 1) * TILE_F, dctx + base, qt * TILE, TILE, T);
  };
  load_rows<BWD_THREADS>(Ks, k + base, k0, WHOLE_T, T);
  issue_q(0);
  cp_async_commit();
  load_rows<BWD_THREADS>(Vs, v + base, k0, WHOLE_T, T);
  issue_g(0);
  cp_async_commit();
  int committed = 2;
  if (nqt > 1) {
    issue_q(1);
    issue_g(1);
    cp_async_commit();
    ++committed;
  }
  load_key_bias<BWD_THREADS>(kb, key_mask + (size_t)b * T, k0, WHOLE_T, T);

  float gv[2][4][4], gk[2][4][4];  // dV and dK of the column phase's 16 keys
  zero(gv[0]);
  zero(gv[1]);
  zero(gk[0]);
  zero(gk[1]);
  const int kc = 16 * warp;

#pragma unroll 1
  for (int qt = 0; qt < nqt; ++qt) {
    const int slot = qt & 1, q0 = qt * TILE;
    const float* Qt = Qs + slot * TILE_F;
    const float* Gt = Gs + slot * TILE_F;
    const int row0 = q0 + 16 * mi;  // the row phase's rows row0 + g, + 8

    // row phase: s and dP of 16 rows x 64 keys
    cp_async_wait(committed - 1 - (qt == 0 ? 0 : qt + 1));
    __syncthreads();
    float s[8][4], dp[8][4];
    zero(s);
    product_rows(s, Qt, 16 * mi, Ks + 64 * kh * HD, g, t);
    to_scores<CAUSAL, 8>(s, scale, kb + 64 * kh, k0 + 64 * kh, row0, g, t);
    if (qt == 0) {
      cp_async_wait(committed - 2);
      __syncthreads();
    }
    zero(dp);
    product_rows(dp, Gt, 16 * mi, Vs + 64 * kh * HD, g, t);

    float m[2], z[2], D[2], part[2];
    const float* st = rows + slot * 3 * TILE;
    if (WHOLE) {
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = quad_max(mt[r]);
        if (t == 0) xch[(3 * kh) * TILE + 16 * mi + g + 8 * r] = mt[r];
      }
      pair_sync(mi);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        m[r] = fmaxf(xch[16 * mi + g + 8 * r], xch[3 * TILE + 16 * mi + g + 8 * r]);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = st[16 * mi + g + 8 * r];
        z[r] = st[TILE + 16 * mi + g + 8 * r];
        D[r] = st[2 * TILE + 16 * mi + g + 8 * r];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(__fsub_rn(s[j][e], m[e >> 1]));  // y
    if (WHOLE) {
      lane_sums(s, part);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[r] = quad_sum(part[r]);
        if (t == 0) xch[(3 * kh + 1) * TILE + 16 * mi + g + 8 * r] = part[r];
      }
      pair_sync(mi);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        z[r] = __fadd_rn(xch[TILE + 16 * mi + g + 8 * r], xch[4 * TILE + 16 * mi + g + 8 * r]);
    }
    float rz[2], rz2[2];
    bool valid[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rz[r] = __frcp_rn(z[r]);
      rz2[r] = __fdiv_rn(1.f, __fmul_rn(z[r], z[r]));
      valid[r] = row0 + g + 8 * r < T;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 p = make_float2(0.f, 0.f);
        if (valid[r])
          p = make_float2(div_rn(s[j][2 * r], z[r], rz[r]), div_rn(s[j][2 * r + 1], z[r], rz[r]));
        *reinterpret_cast<float2*>(P + (16 * mi + g + 8 * r) * PS + 64 * kh + 8 * j + 2 * t) = p;
      }
    if (WHOLE) {
      part[0] = part[1] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[e >> 1] = __fadd_rn(part[e >> 1], __fmul_rn(__fmul_rn(dp[j][e], rz2[e >> 1]), s[j][e]));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[r] = quad_sum(part[r]);
        if (t == 0) xch[(3 * kh + 2) * TILE + 16 * mi + g + 8 * r] = part[r];
      }
      pair_sync(mi);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        D[r] = __fadd_rn(xch[2 * TILE + 16 * mi + g + 8 * r], xch[5 * TILE + 16 * mi + g + 8 * r]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 d = make_float2(0.f, 0.f);
        if (valid[r]) {
          d.x = __fmul_rn(__fmul_rn(__fadd_rn(div_rn(dp[j][2 * r], z[r], rz[r]), -D[r]),
                                    s[j][2 * r]), scale);
          d.y = __fmul_rn(__fmul_rn(__fadd_rn(div_rn(dp[j][2 * r + 1], z[r], rz[r]), -D[r]),
                                    s[j][2 * r + 1]), scale);
        }
        *reinterpret_cast<float2*>(DS + (16 * mi + g + 8 * r) * PS + 64 * kh + 8 * j + 2 * t) = d;
      }
    __syncthreads();

    // column phase: dV and dK of the warp's 16 keys over the tile's queries
#pragma unroll
    for (int s2 = 0; s2 < TILE / 16; ++s2) {
      AFrag a;
      a_from_cols(a, P, kc, 16 * s2, g, t);
      stage_cols<false, 2>(gv, a, Gt, 16 * s2, 0, g, t);
      a_from_cols(a, DS, kc, 16 * s2, g, t);
      stage_cols<false, 2>(gk, a, Qt, 16 * s2, 0, g, t);
    }
    if (WHOLE) {  // dQ of 16 rows x 32 dims over every key
      float gq[1][4][4];
      zero(gq[0]);
      const int hq = warp >> 2;
#pragma unroll 1
      for (int s3 = 0; s3 < (T + 15) / 16; ++s3) {
        AFrag a;
        a_from_rows(a, DS, 16 * mi, 16 * s3, g, t);
        stage_cols<true, 1>(gq, a, Ks, 16 * s3, hq, g, t);
      }
      store_rows<1>(dq + base, gq, hq, row0, T, g, t);
    }
    __syncthreads();  // the buffers and this slot are free
    if (!WHOLE && qt + 2 < nqt) {
      issue_q(qt + 2);
      issue_g(qt + 2);
      cp_async_commit();
      ++committed;
    }
  }
  store_rows<2>(dk + base, gk, 0, k0 + kc, T, g, t);
  store_rows<2>(dv + base, gv, 0, k0 + kc, T, g, t);
}

// ---------------------------------------------------------------------------
// backward above 128 tokens, dQ: a block a (b, h, 64 queries) in three
// passes over the key tiles; writes each row's m, z (the running sum) and D

template <bool CAUSAL>
__global__ void __launch_bounds__(FWD_THREADS, 2)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dctx,
                const int* __restrict__ key_mask, float* __restrict__ dq,
                float* __restrict__ stats, int nh, int T, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + TILE_F;
  float* Ks = Gs + TILE_F;      // a ring of two K tiles
  float* Vs = Ks + 2 * TILE_F;  // and of two V tiles
  __shared__ float kbias[MAX_T];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, q0 = blockIdx.x * TILE;
  const size_t bh = (size_t)b * nh + blockIdx.y, base = bh * T * HD;
  const int nkt = (T + TILE - 1) / TILE, w0 = q0 + 16 * warp;

  // step i: pass i / nkt (0: K; 1, 2: K and V) over key tile i % nkt, slot i & 1
  auto issue = [&](int step) {
    if (step >= 3 * nkt) return;
    const int slot = step & 1, kt = step % nkt;
    load_rows<FWD_THREADS>(Ks + slot * TILE_F, k + base, kt * TILE, TILE, T);
    if (step >= nkt) load_rows<FWD_THREADS>(Vs + slot * TILE_F, v + base, kt * TILE, TILE, T);
  };
  load_rows<FWD_THREADS>(Qs, q + base, q0, TILE, T);
  load_rows<FWD_THREADS>(Gs, dctx + base, q0, TILE, T);
  issue(0);
  cp_async_commit();
  load_key_bias<FWD_THREADS>(kbias, key_mask + (size_t)b * T, 0, nkt * TILE, T);

  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};
  float rz[2] = {0.f, 0.f}, rz2[2] = {0.f, 0.f};
  float gq[2][4][4];
  zero(gq[0]);
  zero(gq[1]);
#pragma unroll 1
  for (int step = 0; step < 3 * nkt; ++step) {
    cp_async_wait(0);
    __syncthreads();
    issue(step + 1);
    cp_async_commit();
    const int slot = step & 1, pass = step / nkt, kt = step % nkt;
    if (step == nkt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rz[r] = __frcp_rn(z[r]);
        rz2[r] = __fdiv_rn(1.f, __fmul_rn(z[r], z[r]));
      }
    float s[8][4];
    zero(s);
    product_rows(s, Qs, 16 * warp, Ks + slot * TILE_F, g, t);
    to_scores<CAUSAL, 8>(s, scale, kbias + kt * TILE, kt * TILE, w0, g, t);
    if (pass == 0) {
      running(s, m, z);
      continue;
    }
    float dp[8][4];
    zero(dp);
    product_rows(dp, Gs, 16 * warp, Vs + slot * TILE_F, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(__fsub_rn(s[j][e], m[e >> 1]));  // y of the final m
    if (pass == 1) {
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[e >> 1] = __fadd_rn(part[e >> 1], __fmul_rn(__fmul_rn(dp[j][e], rz2[e >> 1]), s[j][e]));
      D[0] = __fadd_rn(D[0], quad_sum(part[0]));
      D[1] = __fadd_rn(D[1], quad_sum(part[1]));
      continue;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = __fmul_rn(__fmul_rn(__fadd_rn(div_rn(dp[j][e], z[e >> 1], rz[e >> 1]),
                                                 -D[e >> 1]), s[j][e]), scale);  // dS
#pragma unroll
    for (int s2 = 0; s2 < TILE / 16; ++s2) {
      AFrag a;
      a_from_acc(a, dp[2 * s2], dp[2 * s2 + 1]);
      stage_cols<true, 2>(gq, a, Ks + slot * TILE_F, 16 * s2, 0, g, t);
    }
  }
  cp_async_wait(0);
  store_rows<2>(dq + base, gq, 0, w0, T, g, t);
  if (t == 0) {
    const size_t n_rows = (size_t)gridDim.z * nh * T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + g + 8 * r;
      if (row < T) {
        stats[bh * T + row] = m[r];
        stats[n_rows + bh * T + row] = z[r];
        stats[2 * n_rows + bh * T + row] = D[r];
      }
    }
  }
}

constexpr size_t FWD_SMEM = 5 * TILE_F * sizeof(float);
constexpr size_t BWD_SMEM = BWD_SMEM_FLOATS * sizeof(float);
constexpr size_t DQ_SMEM = 6 * TILE_F * sizeof(float);

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t check_shape(int B, int nh, int T, int hd) {
  return (B < 1 || nh < 1 || T < 1 || T > MAX_T || hd != HD) ? cudaErrorInvalidValue
                                                               : cudaSuccess;
}

template <bool CAUSAL>
cudaError_t launch_forward(const float* q, const float* k, const float* v, const int* mask, float* ctx,
                    int B, int nh, int T, float scale, cudaStream_t s) {
  const dim3 grid((T + TILE - 1) / TILE, nh, B);
  if (T <= WHOLE_T)
    attn_fwd_f32<CAUSAL, true><<<grid, FWD_THREADS, FWD_SMEM, s>>>(q, k, v, mask, ctx, nh, T,
                                                                   scale);
  else
    attn_fwd_f32<CAUSAL, false><<<grid, FWD_THREADS, FWD_SMEM, s>>>(q, k, v, mask, ctx, nh, T,
                                                                    scale);
  return cudaGetLastError();
}

template <bool CAUSAL>
cudaError_t launch_backward(const float* q, const float* k, const float* v, const float* g,
                     const int* mask, float* dq, float* dk, float* dv, float* stats, int B,
                     int nh, int T, float scale, cudaStream_t s) {
  if (T <= WHOLE_T) {
    attn_bwd_f32<CAUSAL, true><<<dim3(1, nh, B), BWD_THREADS, BWD_SMEM, s>>>(
        q, k, v, g, mask, nullptr, dq, dk, dv, nh, T, scale);
    return cudaGetLastError();
  }
  attn_bwd_dq_f32<CAUSAL><<<dim3((T + TILE - 1) / TILE, nh, B), FWD_THREADS, DQ_SMEM, s>>>(
      q, k, v, g, mask, dq, stats, nh, T, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_f32<CAUSAL, false><<<dim3((T + WHOLE_T - 1) / WHOLE_T, nh, B), BWD_THREADS, BWD_SMEM,
                                s>>>(q, k, v, g, mask, stats, nullptr, dk, dv, nh, T, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, ctx: (B, nh, T, 64) float32, contiguous, 16-byte aligned;
// key_mask: (B, T) int32, nonzero = a real token; 1 <= T <= 512.  scale:
// float32(1 / sqrt(64)).  One launch; returns the CUDA error (0 on success).
extern "C" int masked_attention_f32(const void* q, const void* k, const void* v,
                                    const void* key_mask, void* ctx, int B, int nh, int T,
                                    int hd, int causal, float scale, void* stream) {
  cudaError_t err = check_shape(B, nh, T, hd);
  static const cudaError_t allowed = [] {
    cudaError_t e = allow_smem(attn_fwd_f32<false, true>, FWD_SMEM);
    if (e == cudaSuccess) e = allow_smem(attn_fwd_f32<false, false>, FWD_SMEM);
    if (e == cudaSuccess) e = allow_smem(attn_fwd_f32<true, true>, FWD_SMEM);
    if (e == cudaSuccess) e = allow_smem(attn_fwd_f32<true, false>, FWD_SMEM);
    return e;
  }();
  if (err == cudaSuccess) err = allowed;
  if (err != cudaSuccess) return (int)err;
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const int* m_ = static_cast<const int*>(key_mask);
  float* c_ = static_cast<float*>(ctx);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(causal ? launch_forward<true>(q_, k_, v_, m_, c_, B, nh, T, scale, s)
                      : launch_forward<false>(q_, k_, v_, m_, c_, B, nh, T, scale, s));
}

// q, k, v, dctx, dq, dk, dv: (B, nh, T, 64) float32, contiguous, 16-byte
// aligned; key_mask (B, T) int32; stats: above 128 tokens (3, B * nh * T)
// float32 scratch (each row's m, z and D, written by the dQ kernel and read
// by the dK/dV kernel), unused (may be null) at T <= 128.  One launch at T <=
// 128, two above; returns the CUDA error (0 on success).
extern "C" int masked_attention_backward_f32(const void* q, const void* k, const void* v,
                                             const void* dctx, const void* key_mask, void* dq,
                                             void* dk, void* dv, void* stats, int B, int nh,
                                             int T, int hd, int causal, float scale,
                                             void* stream) {
  cudaError_t err = check_shape(B, nh, T, hd);
  static const cudaError_t allowed = [] {
    cudaError_t e = allow_smem(attn_bwd_f32<false, true>, BWD_SMEM);
    if (e == cudaSuccess) e = allow_smem(attn_bwd_f32<false, false>, BWD_SMEM);
    if (e == cudaSuccess) e = allow_smem(attn_bwd_f32<true, true>, BWD_SMEM);
    if (e == cudaSuccess) e = allow_smem(attn_bwd_f32<true, false>, BWD_SMEM);
    if (e == cudaSuccess) e = allow_smem(attn_bwd_dq_f32<false>, DQ_SMEM);
    if (e == cudaSuccess) e = allow_smem(attn_bwd_dq_f32<true>, DQ_SMEM);
    return e;
  }();
  if (err == cudaSuccess) err = allowed;
  if (err == cudaSuccess && T > WHOLE_T && stats == nullptr) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* g_ = static_cast<const float*>(dctx);
  const int* m_ = static_cast<const int*>(key_mask);
  float* dq_ = static_cast<float*>(dq);
  float* dk_ = static_cast<float*>(dk);
  float* dv_ = static_cast<float*>(dv);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(causal ? launch_backward<true>(q_, k_, v_, g_, m_, dq_, dk_, dv_, st, B, nh, T, scale, s)
                      : launch_backward<false>(q_, k_, v_, g_, m_, dq_, dk_, dv_, st, B, nh, T, scale, s));
}
