// K7-BN's two launches with last-block tails, which the port does not use:
// the statistics (or gradient sums) kernel's last block of each slice, found
// by a done counter, combines the chunks while the rest of the card waits;
// the kept design (csrc/masked_bn.cu) lets every block of the second kernel
// combine its slice's chunks instead.  Kept for chip_variants.py --k7-bn,
// which times both in turns.
//
// Train-mode masked BatchNorm + ReLU of the ProteInfer encoder (K7-BN), its
// forward and backward, for Hopper (sm_90a).
//
// Replaces protnote_tpu/models/layers.py:batchnorm_apply(train=True,
// reduce_axes=(0, 1), mask, count) (line 102) followed by jax.nn.relu, as
// protnote_tpu/models/proteinfer.py:proteinfer_embed (lines 176-203) runs it
// on each block's (B, T, C) activations.  x is bf16 (B, T, C) with row
// b * T + t; the mask of row (b, t) is m = [t < lengths[b]] * em[b] (em the
// example mask, or 1).  With the JAX count rule,
//   n_valid = max(sum m, 1),  n = max(rows * t_ref, 1),
//   rows = sum em (or B),  t_ref = max(lengths * em) (or max(lengths)),
//   mean = sum(m x) / n,
//   var  = (sum(m (x - mean)^2) + (n - n_valid) mean^2) / n,
//   inv  = rsqrt(var + eps) * scale,  shift = bias - mean * inv,
//   y    = relu(bf16(x * inv + shift))            (every row, as JAX does),
// and the running statistics move by `momentum` toward mean and the unbiased
// var * n / max(n - 1, 1).
//
// Backward, with gz = dy where bf16(x * inv + shift) > 0 (exactly where the
// forward's y > 0: the same operations on the same saved inv and shift) and
// 0 elsewhere, over every row: G = sum gz (= dbias), Gx = sum gz (x - mean),
// dscale = Gx rstd,
//   dx = bf16(inv gz + m / n (-inv G - scale rstd^3 Gx (x - mean))),
// the autodiff of the forward (the variance's derivative through the mean is
// zero under the count rule: sum m (x - mean) = (n - n_valid) mean).
//
// Layout.  x, dy are read at any row pitch that is a multiple of 8 channels
// with rows on 16 bytes (the conv kernels' padded pitch, 1,104 and 552 for
// the encoder's 1,100 and 550 channels); y and dx are written at
// row_pitch(C) = C rounded up to 8, their padding channels as zeros.  A
// thread owns 8 channels (one 16-byte load), 8 threads a row's 64-channel
// slice, a 256-thread block 32 rows at a time of one slice (blockIdx.x):
// grid (slices, row chunks).  Padding channels are loaded with their vector
// and never summed.
//
// Two launches a direction:
// * forward: `bn_stats_kernel`, one block a (slice, chunk) over the valid
//   rows (the rows with m != 0, in (b, t) order, split into `chunks` equal
//   runs; x is read once from device memory).  A chunk's moments are taken
//   about a shift, the x of its first valid row (S = sum m x,
//   D = sum m (x - K), Q = sum m (x - K)^2, M2 = Q - D^2 / n_k: the chunk's
//   centred moment), written as partials (S, M2) with its count n_k.  The
//   last block of a slice to finish (a done counter after __threadfence, reset
//   to 0 by that block) combines the chunks in a fixed order,
//     sum m (x - mean)^2 = sum_k [M2_k + n_k (S_k / n_k - mean)^2],
//   a chunk with no valid row adding nothing, and writes the counts, the
//   statistics and the running statistics.  Then `bn_apply_kernel` writes y
//   over every row, its chunks in the reverse of the statistics' order, so
//   that the rows read last are read again from the 50 MB L2.
// * backward: `bn_grad_sums_kernel`, G and Gx over every row in chunks, its
//   last block of a slice adds the chunks in order and writes dscale, dbias
//   and dx's two coefficients; then `bn_dx_kernel`, each sums chunk from its
//   end (the rows the sums read last, still in L2).
// Every sum runs in a fixed order and no float is added atomically: two
// calls give the same bits.  The affine and dx's terms are rounded one
// operation at a time (__fmul_rn/__fadd_rn), as the plain PyTorch version
// computes them.
//
// What bounds it: device memory.  The forward reads the valid rows of x for
// the statistics and every row again for the apply (partly from L2) and
// writes y; the backward reads x and dy twice and writes dx.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;                      // channels a thread: one 16-byte load
constexpr int LANES = 8;                    // threads on a row's slice
constexpr int GROUP = VEC * LANES;          // channels of a slice
constexpr int THREADS = 256;
constexpr int ROW_LANES = THREADS / LANES;  // rows a block walks at once
constexpr int SPLIT = THREADS / GROUP;      // threads of a column in a tail
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUPS = 64;              // done counters a direction: C <= 4,096
constexpr int MAX_B = 1024;                 // sequences the statistics' table holds
constexpr int TAIL = 8;                     // chunks a tail thread adds: chunks <= 32

__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// bf16(x * inv + shift), rounded one operation at a time
__device__ __forceinline__ float affine_bf16(float x, float inv, float shift) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(__fmul_rn(x, inv), shift)));
}

// The ReLU's gate, relu(bf16(x * inv + shift)) > 0: bf16(v) > 0 exactly
// when v > 2^-134, half bf16's least subnormal (a tie rounds to the even
// 0).  The kernels are built without flush-to-zero, so v keeps its
// subnormals as the forward's rounding sees them.
__device__ __forceinline__ bool relu_gate(float x, float inv, float shift) {
  return __fadd_rn(__fmul_rn(x, inv), shift) > 0x1p-134f;
}

// Loads row `c0 .. c0 + 7` of a (C,) vector, 0 past C.
__device__ __forceinline__ void load_cols(const float* v, int c0, int C, float (&out)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = c0 + i < C ? v[c0 + i] : 0.f;
}

// This block's last-to-finish test: true in every thread of the slice's
// last block, after its partials and everyone's are visible (the threads
// that wrote them, the first `writers`, fence first).
__device__ __forceinline__ bool last_of_slice(unsigned* done, int chunks, int writers) {
  __shared__ bool s_last;
  if (static_cast<int>(threadIdx.x) < writers) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == static_cast<unsigned>(chunks - 1);
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// Sums red[0..SPLIT)[c] in order for each column c of the slice.
__device__ __forceinline__ float split_sum(const float (*red)[GROUP], int c) {
  float v = red[0][c];
#pragma unroll
  for (int q = 1; q < SPLIT; ++q) v += red[q][c];
  return v;
}

// ---------------------------------------------------------------- forward

// The table of valid rows in shared memory: len[b] the rows of sequence b
// that count (0 where em drops it), start[b] their prefix sum (start[B] the
// total), w[b] the weight m of its valid rows, raw[b] lengths[b] itself.
__device__ int valid_table(const int* lengths, const float* em, int B, int T, int* len,
                           int* start, float* w, int* raw) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float e = em != nullptr ? em[b] : 1.f;
    const int l = lengths[b];
    w[b] = e;
    raw[b] = l;
    len[b] = e != 0.f ? min(max(l, 0), T) : 0;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int run = 0;
    for (int base = 0; base < B; base += 32) {
      int v = base + lane < B ? len[base + lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (base + lane < B) start[base + lane + 1] = run + v;
      run += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) start[0] = 0;
  }
  __syncthreads();
  return start[B];
}

// (b, t) of valid row j < start[B]: start[b] <= j < start[b + 1].
__device__ __forceinline__ void locate(const int* start, int B, int j, int& b, int& t) {
  int lo = 0, hi = B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= j) lo = mid; else hi = mid;
  }
  b = lo;
  t = j - start[lo];
}

// v summed over the warp's 4 row lanes (lanes 8 apart), the same bits in
// each of them.
__device__ __forceinline__ float rows_of_warp(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// A row lane's walk over the valid rows [j, j1) of a statistics chunk,
// ROW_LANES apart: the next U rows' addresses and weights (null past j1).
template <int U>
__device__ __forceinline__ void next_rows(const __nv_bfloat16* x, int pitch, int c0, int T,
                                          int B, const int* len, const float* w, int j1, int& j,
                                          int& b, int& t, const __nv_bfloat16* (&p)[U],
                                          float (&wt)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    p[u] = nullptr;
    wt[u] = 0.f;
    if (j < j1) {
      p[u] = x + (static_cast<size_t>(b) * T + t) * pitch + c0;
      wt[u] = w[b];
      j += ROW_LANES;
      t += ROW_LANES;
      while (b < B && t >= len[b]) t -= len[b++];
    }
  }
}

// Block (slice, chunk): the chunk's partials (S, M2) into part (chunks, 2,
// C) and its count into chunk_n (slices, chunks); the slice's last block
// combines them.  A thread keeps the next U rows' loads in flight while it
// adds the current U.
__global__ void __launch_bounds__(THREADS)
bn_stats_kernel(const __nv_bfloat16* __restrict__ x, int pitch, const int* __restrict__ lengths,
                const float* __restrict__ em, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ run_mean,
                const float* __restrict__ run_var, float momentum, float keep, float eps,
                float* __restrict__ part, float* __restrict__ chunk_n, float* __restrict__ counts,
                float* __restrict__ stats, float* __restrict__ new_mean,
                float* __restrict__ new_var, unsigned* __restrict__ done, int B, int T, int C) {
  __shared__ int s_len[MAX_B], s_start[MAX_B + 1], s_raw[MAX_B];
  __shared__ float s_w[MAX_B];
  __shared__ float s_red[3][WARPS][GROUP];
  __shared__ float s_n[WARPS];
  const int chunks = gridDim.y, k = blockIdx.y, g = blockIdx.x;
  const int tid = threadIdx.x, rl = tid / LANES, lv = tid % LANES, warp = tid / 32;
  const int c0 = g * GROUP + lv * VEC;
  const int total = valid_table(lengths, em, B, T, s_len, s_start, s_w, s_raw);
  const int per = (total + chunks - 1) / chunks;
  const int j0 = min(k * per, total), j1 = min(j0 + per, total);
  float S[VEC], D[VEC], Q[VEC], n = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) S[i] = D[i] = Q[i] = 0.f;
  if (j0 < j1 && c0 < C) {
    int b, t;
    locate(s_start, B, j0, b, t);
    float K[VEC];
    unpack8(load8(x + (static_cast<size_t>(b) * T + t) * pitch + c0), K);
    int j = j0 + rl;
    if (j < j1) locate(s_start, B, j, b, t);
    constexpr int U = 4;
    const __nv_bfloat16* p[U];
    float wt[U];
    uint4 v[U];
    next_rows<U>(x, pitch, c0, T, B, s_len, s_w, j1, j, b, t, p, wt);
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = p[u] != nullptr ? load8(p[u]) : make_uint4(0, 0, 0, 0);
    while (p[0] != nullptr) {
      const __nv_bfloat16* pn[U];
      float wn[U];
      uint4 vn[U];
      next_rows<U>(x, pitch, c0, T, B, s_len, s_w, j1, j, b, t, pn, wn);
#pragma unroll
      for (int u = 0; u < U; ++u)
        vn[u] = pn[u] != nullptr ? load8(pn[u]) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (p[u] == nullptr) continue;
        float f[VEC];
        unpack8(v[u], f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = f[i] - K[i], wd = wt[u] * d;
          S[i] = fmaf(wt[u], f[i], S[i]);
          D[i] += wd;
          Q[i] = fmaf(wd, d, Q[i]);
        }
        n += wt[u];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = pn[u];
        wt[u] = wn[u];
        v[u] = vn[u];
      }
    }
  }
  // the row lanes' sums: the warp's 4 by shuffles, then the 8 warps in order
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    S[i] = rows_of_warp(S[i]);
    D[i] = rows_of_warp(D[i]);
    Q[i] = rows_of_warp(Q[i]);
  }
  n = rows_of_warp(n);
  if (tid % 32 < LANES) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s_red[0][warp][lv * VEC + i] = S[i];
      s_red[1][warp][lv * VEC + i] = D[i];
      s_red[2][warp][lv * VEC + i] = Q[i];
    }
    if (lv == 0) s_n[warp] = n;
  }
  __syncthreads();
  if (tid < GROUP) {
    const int c = g * GROUP + tid;
    float Sk = s_red[0][0][tid], Dk = s_red[1][0][tid], Qk = s_red[2][0][tid], nk = s_n[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      Sk += s_red[0][w][tid];
      Dk += s_red[1][w][tid];
      Qk += s_red[2][w][tid];
      nk += s_n[w];
    }
    if (c < C) {
      part[static_cast<size_t>(k) * 2 * C + c] = Sk;
      part[(static_cast<size_t>(k) * 2 + 1) * C + c] =
          nk > 0.f ? fmaxf(Qk - Dk * (Dk / nk), 0.f) : 0.f;
    }
    if (tid == 0) chunk_n[g * chunks + k] = nk;
  }
  if (!last_of_slice(done + g, chunks, GROUP)) return;

  // ---- the slice's tail: every chunk's partials loaded at once, added in
  // a fixed order (chunk q, q + SPLIT, ... in a thread, then the threads)
  const int q = tid / GROUP, cc = tid % GROUP, c = g * GROUP + cc;
  const bool col = c < C;
  float sk[TAIL], mk[TAIL], nk[TAIL];
#pragma unroll
  for (int i = 0; i < TAIL; ++i) {
    const int kk = q + i * SPLIT;
    sk[i] = mk[i] = nk[i] = 0.f;
    if (col && kk < chunks) {
      nk[i] = __ldcg(chunk_n + g * chunks + kk);
      sk[i] = __ldcg(part + static_cast<size_t>(kk) * 2 * C + c);
      mk[i] = __ldcg(part + (static_cast<size_t>(kk) * 2 + 1) * C + c);
    }
  }
  if (tid < 32) {  // the counts
    float rows = 0.f, t_ref = 0.f, valid = 0.f;
    for (int b = tid; b < B; b += 32) {
      const float e = s_w[b];
      rows += e;
      t_ref = fmaxf(t_ref, __fmul_rn(static_cast<float>(s_raw[b]), e));
      valid += __fmul_rn(static_cast<float>(min(max(s_raw[b], 0), T)), e);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      rows += __shfl_xor_sync(0xffffffffu, rows, o);
      valid += __shfl_xor_sync(0xffffffffu, valid, o);
      t_ref = fmaxf(t_ref, __shfl_xor_sync(0xffffffffu, t_ref, o));
    }
    if (tid == 0) {
      s_n[0] = fmaxf(__fmul_rn(rows, t_ref), 1.f);
      s_n[1] = fmaxf(valid, 1.f);
    }
  }
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < TAIL; ++i) a += sk[i];
  s_red[0][q][cc] = a;
  __syncthreads();
  const float n_all = s_n[0], nv = s_n[1];
  const float mu = __fdiv_rn(split_sum(s_red[0], cc), n_all);
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < TAIL; ++i) {
    if (nk[i] > 0.f) {
      const float dm = sk[i] / nk[i] - mu;
      v += mk[i] + nk[i] * dm * dm;
    }
  }
  s_red[1][q][cc] = v;
  __syncthreads();
  if (q == 0 && col) {
    const float var = __fdiv_rn(
        __fadd_rn(split_sum(s_red[1], cc), __fmul_rn(__fsub_rn(n_all, nv), __fmul_rn(mu, mu))),
        n_all);
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    const float inv = __fmul_rn(rstd, scale[c]);
    stats[c] = mu;
    stats[C + c] = var;
    stats[2 * C + c] = rstd;
    stats[3 * C + c] = inv;
    stats[4 * C + c] = __fsub_rn(bias[c], __fmul_rn(mu, inv));
    const float unbiased = __fmul_rn(var, __fdiv_rn(n_all, fmaxf(__fsub_rn(n_all, 1.f), 1.f)));
    new_mean[c] = __fadd_rn(__fmul_rn(keep, run_mean[c]), __fmul_rn(momentum, mu));
    new_var[c] = __fadd_rn(__fmul_rn(keep, run_var[c]), __fmul_rn(momentum, unbiased));
  }
  if (g == 0 && tid == 0) {
    counts[0] = n_all;
    counts[1] = nv;
  }
  if (tid == 0) done[g] = 0;
}

// y = relu(bf16(x * inv + shift)) over every row, 0 in the padding channels;
// block (slice, j) writes chunk chunks - 1 - j.
__global__ void __launch_bounds__(THREADS)
bn_apply_kernel(const __nv_bfloat16* __restrict__ x, int x_pitch, const float* __restrict__ stats,
                __nv_bfloat16* __restrict__ y, int y_pitch, int R, int C, int rows_per_chunk) {
  const int tid = threadIdx.x, rl = tid / LANES, lv = tid % LANES;
  const int c0 = blockIdx.x * GROUP + lv * VEC;
  if (c0 >= y_pitch) return;
  float inv[VEC], shift[VEC];
  load_cols(stats + 3 * C, c0, C, inv);
  load_cols(stats + 4 * C, c0, C, shift);
  const int chunk = gridDim.y - 1 - blockIdx.y;
  const int r0 = chunk * rows_per_chunk, r1 = min(R, r0 + rows_per_chunk);
  constexpr int U = 8;
  for (int r = r0 + rl; r < r1; r += U * ROW_LANES) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u * ROW_LANES < r1)
        v[u] = load8(x + static_cast<size_t>(r + u * ROW_LANES) * x_pitch + c0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * ROW_LANES >= r1) continue;
      float f[VEC];
      unpack8(v[u], f);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        f[i] = c0 + i < C ? fmaxf(affine_bf16(f[i], inv[i], shift[i]), 0.f) : 0.f;
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(r + u * ROW_LANES) * y_pitch + c0) =
          pack8(f);
    }
  }
}

// --------------------------------------------------------------- backward

// x's and dy's vectors of `row` when it is before r1.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* x, int x_pitch,
                                          const __nv_bfloat16* dy, int dy_pitch, int c0, int row,
                                          int r1, uint4& vx, uint4& vg) {
  if (row < r1) {
    vx = load8(x + static_cast<size_t>(row) * x_pitch + c0);
    vg = load8(dy + static_cast<size_t>(row) * dy_pitch + c0);
  }
}

// Block (slice, chunk): G and Gx of the chunk's rows into part (chunks, 2,
// C); the slice's last block adds the chunks in a fixed order and writes
// dscale, dbias and coef (2, C) = k2 = -inv G / n, k3 = -scale rstd^3 Gx /
// n.  A thread keeps the next U rows' loads in flight while it adds the
// current U.
__global__ void __launch_bounds__(THREADS)
bn_grad_sums_kernel(const __nv_bfloat16* __restrict__ x, int x_pitch,
                    const __nv_bfloat16* __restrict__ dy, int dy_pitch,
                    const float* __restrict__ scale, const float* __restrict__ stats,
                    const float* __restrict__ counts, float* __restrict__ part,
                    float* __restrict__ dscale, float* __restrict__ dbias,
                    float* __restrict__ coef, unsigned* __restrict__ done, int R, int C,
                    int rows_per_chunk) {
  __shared__ float s_red[2][WARPS][GROUP];
  const int chunks = gridDim.y, k = blockIdx.y, g = blockIdx.x;
  const int tid = threadIdx.x, rl = tid / LANES, lv = tid % LANES, warp = tid / 32;
  const int c0 = g * GROUP + lv * VEC;
  float G[VEC], Gx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) G[i] = Gx[i] = 0.f;
  if (c0 < C) {
    float mean[VEC], inv[VEC], shift[VEC];
    load_cols(stats, c0, C, mean);
    load_cols(stats + 3 * C, c0, C, inv);
    load_cols(stats + 4 * C, c0, C, shift);
    const int r0 = k * rows_per_chunk, r1 = min(R, r0 + rows_per_chunk);
    constexpr int U = 4;
    uint4 vx[U], vg[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_rows(x, x_pitch, dy, dy_pitch, c0, r0 + rl + u * ROW_LANES, r1, vx[u], vg[u]);
    for (int r = r0 + rl; r < r1; r += U * ROW_LANES) {
      uint4 nx[U], ng[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_rows(x, x_pitch, dy, dy_pitch, c0, r + (U + u) * ROW_LANES, r1, nx[u], ng[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * ROW_LANES >= r1) continue;
        float f[VEC], d[VEC];
        unpack8(vx[u], f);
        unpack8(vg[u], d);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float gz = relu_gate(f[i], inv[i], shift[i]) ? d[i] : 0.f;
          G[i] += gz;
          Gx[i] = fmaf(gz, f[i] - mean[i], Gx[i]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        vx[u] = nx[u];
        vg[u] = ng[u];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    G[i] = rows_of_warp(G[i]);
    Gx[i] = rows_of_warp(Gx[i]);
  }
  if (tid % 32 < LANES) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s_red[0][warp][lv * VEC + i] = G[i];
      s_red[1][warp][lv * VEC + i] = Gx[i];
    }
  }
  __syncthreads();
  if (tid < 2 * GROUP) {
    const int q = tid / GROUP, cc = tid % GROUP, c = g * GROUP + cc;
    float a = s_red[q][0][cc];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) a += s_red[q][w][cc];
    if (c < C) part[(static_cast<size_t>(k) * 2 + q) * C + c] = a;
  }
  if (!last_of_slice(done + g, chunks, 2 * GROUP)) return;

  const int q = tid / GROUP, cc = tid % GROUP, c = g * GROUP + cc;
  float ga[TAIL], gxa[TAIL];
#pragma unroll
  for (int i = 0; i < TAIL; ++i) {
    const int kk = q + i * SPLIT;
    ga[i] = gxa[i] = 0.f;
    if (c < C && kk < chunks) {
      ga[i] = __ldcg(part + static_cast<size_t>(kk) * 2 * C + c);
      gxa[i] = __ldcg(part + (static_cast<size_t>(kk) * 2 + 1) * C + c);
    }
  }
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int i = 0; i < TAIL; ++i) {
    a += ga[i];
    b += gxa[i];
  }
  s_red[0][q][cc] = a;
  s_red[1][q][cc] = b;
  __syncthreads();
  if (q == 0 && c < C) {
    const float n = counts[0];
    const float Gs = split_sum(s_red[0], cc), Gxs = split_sum(s_red[1], cc);
    const float rstd = stats[2 * C + c], inv = stats[3 * C + c];
    dbias[c] = Gs;
    dscale[c] = __fmul_rn(Gxs, rstd);
    coef[c] = -__fdiv_rn(__fmul_rn(inv, Gs), n);
    coef[C + c] = -__fdiv_rn(
        __fmul_rn(__fmul_rn(scale[c], __fmul_rn(__fmul_rn(rstd, rstd), rstd)), Gxs), n);
  }
  if (tid == 0) done[g] = 0;
}

// dx = bf16(inv gz + m (k2 + k3 (x - mean))) over every row, 0 in the
// padding channels.  The sums kernel's chunks of sum_rows rows ran side by
// side, each from its first row to its last, so the rows each read last are
// in L2: block (slice, j) takes the (j / sum_chunks)-th run of
// rows_per_block rows from the end of sums chunk j % sum_chunks, the ends of
// every chunk first.  Three blocks an SM (the registers of 8 channels'
// five constants, and 2 rows' loads in flight).
__global__ void __launch_bounds__(THREADS, 3)
bn_dx_kernel(const __nv_bfloat16* __restrict__ x, int x_pitch,
             const __nv_bfloat16* __restrict__ dy, int dy_pitch, const int* __restrict__ lengths,
             const float* __restrict__ em, const float* __restrict__ stats,
             const float* __restrict__ coef, __nv_bfloat16* __restrict__ dx, int dx_pitch, int R,
             int T, int C, int sum_rows, int rows_per_block) {
  const int tid = threadIdx.x, rl = tid / LANES, lv = tid % LANES;
  const int c0 = blockIdx.x * GROUP + lv * VEC;
  const int sum_chunks = (R + sum_rows - 1) / sum_rows;
  const int k = blockIdx.y % sum_chunks, run = blockIdx.y / sum_chunks;
  const int r1 = min(R, (k + 1) * sum_rows) - run * rows_per_block;
  const int r0 = max(k * sum_rows, r1 - rows_per_block);
  if (c0 >= dx_pitch || r1 <= r0) return;
  float mean[VEC], inv[VEC], shift[VEC], k2[VEC], k3[VEC];
  load_cols(stats, c0, C, mean);
  load_cols(stats + 3 * C, c0, C, inv);
  load_cols(stats + 4 * C, c0, C, shift);
  load_cols(coef, c0, C, k2);
  load_cols(coef + C, c0, C, k3);
  constexpr int U = 2;
  for (int r = r0 + rl; r < r1; r += U * ROW_LANES) {
    uint4 vx[U], vg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * ROW_LANES < r1) {
        const size_t row = static_cast<size_t>(r + u * ROW_LANES);
        vx[u] = load8(x + row * x_pitch + c0);
        vg[u] = load8(dy + row * dy_pitch + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = r + u * ROW_LANES;
      if (row >= r1) continue;
      const int b = row / T, t = row - b * T;
      const float m = t < lengths[b] ? (em != nullptr ? em[b] : 1.f) : 0.f;
      float f[VEC], d[VEC];
      unpack8(vx[u], f);
      unpack8(vg[u], d);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float gz = relu_gate(f[i], inv[i], shift[i]) ? d[i] : 0.f;
        const float kx = __fmul_rn(m, __fadd_rn(k2[i], __fmul_rn(k3[i], __fsub_rn(f[i], mean[i]))));
        f[i] = c0 + i < C ? __fadd_rn(__fmul_rn(inv[i], gz), kx) : 0.f;
      }
      *reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * dx_pitch + c0) = pack8(f);
    }
  }
}

int groups_of(int C) { return (C + GROUP - 1) / GROUP; }

// What both directions take: a pitch of 8 channels at least C wide, rows on
// 16 bytes, an output at row_pitch(C).
bool layout_ok(const void* p, int pitch, int C) {
  return pitch >= C && pitch % VEC == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int out_pitch(int C) { return (C + VEC - 1) / VEC * VEC; }

}  // namespace

// Forward: y (B, T) rows at row_pitch(C), bf16; stats (5, C) f32 = mean, var,
// rstd, inv, shift; counts (2,) = n, n_valid; new_mean, new_var (C,) the
// running statistics; part (stat_chunks, 2, C) and chunk_n (ceil(C / 64),
// stat_chunks) f32 scratch; done the forward's MAX_GROUPS counters, zero between calls.
// x (B, T) rows at x_pitch.  em may be null.  Two launches.
extern "C" int masked_bn_relu_forward(const void* x, int x_pitch, const void* lengths,
                                      const void* em, const void* scale, const void* bias,
                                      const void* run_mean, const void* run_var, float momentum,
                                      float keep, float eps, void* part, void* chunk_n,
                                      void* counts, void* stats, void* new_mean, void* new_var,
                                      void* done, void* y, int B, int T, int C, int stat_chunks,
                                      int apply_rows, void* stream) {
  const long long R = static_cast<long long>(B) * T;
  if (B <= 0 || B > MAX_B || T <= 0 || C <= 0 || groups_of(C) > MAX_GROUPS || R >= (1LL << 31) ||
      stat_chunks <= 0 || stat_chunks > SPLIT * TAIL || apply_rows <= 0 ||
      !layout_ok(x, x_pitch, C) ||
      !layout_ok(y, out_pitch(C), C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* x_ = static_cast<const __nv_bfloat16*>(x);
  const int rows = static_cast<int>(R);
  bn_stats_kernel<<<dim3(groups_of(C), stat_chunks), THREADS, 0, s>>>(
      x_, x_pitch, static_cast<const int*>(lengths), static_cast<const float*>(em),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(run_mean), static_cast<const float*>(run_var), momentum, keep,
      eps, static_cast<float*>(part), static_cast<float*>(chunk_n), static_cast<float*>(counts),
      static_cast<float*>(stats), static_cast<float*>(new_mean), static_cast<float*>(new_var),
      static_cast<unsigned*>(done), B, T, C);
  bn_apply_kernel<<<dim3(groups_of(C), (rows + apply_rows - 1) / apply_rows), THREADS, 0, s>>>(
      x_, x_pitch, static_cast<const float*>(stats), static_cast<__nv_bfloat16*>(y), out_pitch(C),
      rows, C, apply_rows);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dx (B, T) rows at row_pitch(C), bf16, dscale and dbias (C,) f32,
// from x and dy (rows at their pitches) and the forward's stats and counts;
// part (sum_chunks, 2, C) and coef (2, C) f32 scratch, sum_chunks = ceil(R /
// sum_rows); done the backward's MAX_GROUPS counters.  Two launches.
extern "C" int masked_bn_relu_backward(const void* x, int x_pitch, const void* dy, int dy_pitch,
                                       const void* lengths, const void* em, const void* scale,
                                       const void* stats, const void* counts, void* part,
                                       void* coef, void* dscale, void* dbias, void* done,
                                       void* dx, int B, int T, int C, int sum_rows,
                                       int apply_rows, void* stream) {
  const long long R = static_cast<long long>(B) * T;
  if (B <= 0 || T <= 0 || C <= 0 || groups_of(C) > MAX_GROUPS || R >= (1LL << 31) ||
      sum_rows <= 0 || (R + sum_rows - 1) / sum_rows > SPLIT * TAIL || apply_rows <= 0 ||
      !layout_ok(x, x_pitch, C) ||
      !layout_ok(dy, dy_pitch, C) || !layout_ok(dx, out_pitch(C), C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* x_ = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* dy_ = static_cast<const __nv_bfloat16*>(dy);
  const float* stats_ = static_cast<const float*>(stats);
  float* coef_ = static_cast<float*>(coef);
  const int rows = static_cast<int>(R);
  bn_grad_sums_kernel<<<dim3(groups_of(C), (rows + sum_rows - 1) / sum_rows), THREADS, 0, s>>>(
      x_, x_pitch, dy_, dy_pitch, static_cast<const float*>(scale), stats_,
      static_cast<const float*>(counts), static_cast<float*>(part), static_cast<float*>(dscale),
      static_cast<float*>(dbias), coef_, static_cast<unsigned*>(done), rows, C, sum_rows);
  const int runs = (sum_rows + apply_rows - 1) / apply_rows;  // a sums chunk's dx blocks
  bn_dx_kernel<<<dim3(groups_of(C), (rows + sum_rows - 1) / sum_rows * runs), THREADS, 0, s>>>(
      x_, x_pitch, dy_, dy_pitch, static_cast<const int*>(lengths), static_cast<const float*>(em),
      stats_, coef_, static_cast<__nv_bfloat16*>(dx), out_pitch(C), rows, T, C, sum_rows,
      apply_rows);
  return static_cast<int>(cudaGetLastError());
}
