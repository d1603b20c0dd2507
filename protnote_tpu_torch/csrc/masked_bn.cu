// Train-mode masked BatchNorm + ReLU of the ProteInfer encoder (K7-BN), its
// forward and backward, for Hopper (sm_90a), in bf16 and (the _f32 entry
// points, the encoder training in float32) in float32.
//
// Replaces protnote_tpu/models/layers.py:batchnorm_apply(train=True,
// reduce_axes=(0, 1), mask, count) (line 102) followed by jax.nn.relu, as
// protnote_tpu/models/proteinfer.py:proteinfer_embed (lines 176-203) runs it
// on each block's (B, T, C) activations.  x is bf16 or float32 (B, T, C) with row
// b * T + t; the mask of row (b, t) is m = [t < lengths[b]] * em[b] (em the
// example mask, or 1).  With the JAX count rule,
//   n_valid = max(sum m, 1),  n = max(rows * t_ref, 1),
//   rows = sum em (or B),  t_ref = max(lengths * em) (or max(lengths)),
//   mean = sum(m x) / n,
//   var  = (sum(m (x - mean)^2) + (n - n_valid) mean^2) / n,
//   inv  = rsqrt(var + eps) * scale,  shift = bias - mean * inv,
//   y    = relu(E(x * inv + shift))               (every row, as JAX does;
//          E the element type: bf16 rounds, float32 keeps the value),
// and the running statistics move by `momentum` toward mean and the unbiased
// var * n / max(n - 1, 1).
//
// Backward, with gz = dy where E(x * inv + shift) > 0 (exactly where the
// forward's y > 0: the same operations on the same saved inv and shift) and
// 0 elsewhere, over every row: G = sum gz (= dbias), Gx = sum gz (x - mean),
// dscale = Gx rstd,
//   dx = E(inv gz + m / n (-inv G - scale rstd^3 Gx (x - mean))),
// the autodiff of the forward (the variance's derivative through the mean is
// zero under the count rule: sum m (x - mean) = (n - n_valid) mean).
//
// Layout.  x, dy are read at any row pitch that is a multiple of 8 channels
// with rows on 16 bytes (the conv kernels' padded pitch, 1,104 and 552 for
// the encoder's 1,100 and 550 channels); y and dx are written at
// row_pitch(C) = C rounded up to 8, their padding channels as zeros.  A
// thread owns 8 channels (one 16-byte load in bf16, two in float32), 8
// threads a row's 64-channel
// slice, a 256-thread block 32 rows at a time of one slice (blockIdx.x):
// grid (slices, row chunks).  Padding channels are loaded with their vector
// and never summed.
//
// Two launches a direction, no tail, no counter:
// * forward: `bn_stats_kernel`, one block a (slice, chunk) over the valid
//   rows (the rows with m != 0, in (b, t) order, split into `chunks` equal
//   runs; x is read once from device memory).  A chunk's moments are taken
//   about a shift, the x of its first valid row (S = sum m x,
//   D = sum m (x - K), Q = sum m (x - K)^2, M2 = Q - D^2 / n_k: the chunk's
//   centred moment), written as partials (S, M2) with its count n_k; block
//   (0, 0) writes the counts.  Then `bn_apply_kernel` writes y over every
//   row, its chunks in the reverse of the statistics' order, so that the
//   rows read last may be read again from the 50 MB L2: each block first
//   combines its slice's partials in a fixed order,
//     sum m (x - mean)^2 = sum_k [M2_k + n_k (S_k / n_k - mean)^2],
//   a chunk with no valid row adding nothing, with its first rows' loads in
//   flight (one block a slice writes the statistics and the running
//   statistics).  The combine is repeated in every block (a few KB from L2
//   each) where a last-block tail would hold the whole card for its
//   latency.
// * backward: `bn_grad_sums_kernel`, G and Gx over every row in chunks;
//   then `bn_dx_kernel`, whose blocks each add their slice's chunks in a
//   fixed order into dx's two coefficients (one writes dscale and dbias)
//   and take each sums chunk from its end (the rows the sums read last).
// Every sum runs in a fixed order and no float is added atomically: two
// calls give the same bits.  The affine is rounded one operation at a time
// (__fmul_rn/__fadd_rn), as the plain PyTorch version computes it, so that
// y and the backward's ReLU gate are the plain version's; dx's terms are
// fused (in bf16 its rounding is held to the plain autograd's within 2^-6;
// in float32 nothing is rounded to bf16 anywhere: the gate is v > 0 and dx
// is stored as computed).
//
// What bounds it: device memory.  The forward reads the valid rows of x for
// the statistics and every row again for the apply (partly from L2) and
// writes y; the backward reads x and dy twice and writes dx.  The float32
// forms move twice the bytes of the bf16 ones on the same grids.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

std::atomic<int> kernels_launched{0};  // this library's kernel launches, for the checks

constexpr int VEC = 8;                      // channels a thread: one 16-byte load
constexpr int LANES = 8;                    // threads on a row's slice
constexpr int GROUP = VEC * LANES;          // channels of a slice
constexpr int THREADS = 256;
constexpr int ROW_LANES = THREADS / LANES;  // rows a block walks at once
constexpr int SPLIT = THREADS / GROUP;      // threads of a column in a combine
constexpr int WARPS = THREADS / 32;
constexpr int MAX_B = 1024;                 // sequences the statistics' table holds
constexpr int TAIL = 8;                     // chunks a combining thread adds: chunks <= 32

// A thread's 8 channels of a row as loaded: one 16-byte word of bf16, two
// of float32.
template <typename E>
struct Row8;
template <>
struct Row8<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Row8<float> {
  float4 lo, hi;
};

__device__ __forceinline__ Row8<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ Row8<float> load8(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldg(q), __ldg(q + 1)};
}

template <typename E>
__device__ __forceinline__ Row8<E> zero8();
template <>
__device__ __forceinline__ Row8<__nv_bfloat16> zero8<__nv_bfloat16>() {
  return {make_uint4(0, 0, 0, 0)};
}
template <>
__device__ __forceinline__ Row8<float> zero8<float>() {
  return {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
}

__device__ __forceinline__ void unpack8(const Row8<__nv_bfloat16>& r, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack8(const Row8<float>& r, float (&f)[VEC]) {
  f[0] = r.lo.x, f[1] = r.lo.y, f[2] = r.lo.z, f[3] = r.lo.w;
  f[4] = r.hi.x, f[5] = r.hi.y, f[6] = r.hi.z, f[7] = r.hi.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&f)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// E(x * inv + shift), rounded one operation at a time (bf16: then to bf16;
// float32: as it is)
template <typename E>
__device__ __forceinline__ float affine(float x, float inv, float shift);
template <>
__device__ __forceinline__ float affine<__nv_bfloat16>(float x, float inv, float shift) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(__fmul_rn(x, inv), shift)));
}
template <>
__device__ __forceinline__ float affine<float>(float x, float inv, float shift) {
  return __fadd_rn(__fmul_rn(x, inv), shift);
}

// The ReLU's gate, relu(E(x * inv + shift)) > 0.  bf16: bf16(v) > 0 exactly
// when v > 2^-134, half bf16's least subnormal (a tie rounds to the even
// 0).  float32: v > 0.  The kernels are built without flush-to-zero, so v
// keeps its subnormals as the forward's rounding sees them.
template <typename E>
__device__ __forceinline__ bool relu_gate(float x, float inv, float shift) {
  return __fadd_rn(__fmul_rn(x, inv), shift) > (sizeof(E) == 2 ? 0x1p-134f : 0.f);
}

// dx's blocks an SM: bf16 three (8 channels' five constants and 2 rows'
// loads in flight), float32 two (its rows' loads take twice the registers).
template <typename E>
struct DxBlocks {
  static constexpr int value = sizeof(E) == 2 ? 3 : 2;
};

// Loads row `c0 .. c0 + 7` of a (C,) vector, 0 past C.
__device__ __forceinline__ void load_cols(const float* v, int c0, int C, float (&out)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = c0 + i < C ? v[c0 + i] : 0.f;
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
template <int U, typename E>
__device__ __forceinline__ void next_rows(const E* x, int pitch, int c0, int T, int B,
                                          const int* len, const float* w, int j1, int& j,
                                          int& b, int& t, const E* (&p)[U], float (&wt)[U]) {
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
// C) and its count into chunk_n (slices, chunks); block (0, 0) also writes
// counts (2,) = n, n_valid.  A thread keeps the next U rows' loads in
// flight while it adds the current U.
template <typename E>
__global__ void __launch_bounds__(THREADS)
bn_stats_kernel(const E* __restrict__ x, int pitch, const int* __restrict__ lengths,
                const float* __restrict__ em, float* __restrict__ part,
                float* __restrict__ chunk_n, float* __restrict__ counts, int B, int T, int C) {
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
    const E* p[U];
    float wt[U];
    Row8<E> v[U];
    next_rows<U>(x, pitch, c0, T, B, s_len, s_w, j1, j, b, t, p, wt);
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = p[u] != nullptr ? load8(p[u]) : zero8<E>();
    while (p[0] != nullptr) {
      const E* pn[U];
      float wn[U];
      Row8<E> vn[U];
      next_rows<U>(x, pitch, c0, T, B, s_len, s_w, j1, j, b, t, pn, wn);
#pragma unroll
      for (int u = 0; u < U; ++u) vn[u] = pn[u] != nullptr ? load8(pn[u]) : zero8<E>();
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
  if (g == 0 && k == 0 && tid < 32) {  // the counts
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
      counts[0] = fmaxf(__fmul_rn(rows, t_ref), 1.f);
      counts[1] = fmaxf(valid, 1.f);
    }
  }
}

// The statistics of the block's slice from the statistics kernel's
// partials, the chunks added in a fixed order (chunk q, q + SPLIT, ... in a
// thread, then the threads): each thread's 8 channels' inv and shift; the
// block `writer` also writes stats (5, C) and the running statistics.
__device__ __forceinline__ void slice_statistics(
    const float* __restrict__ part, const float* __restrict__ chunk_n,
    const float* __restrict__ counts, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ run_mean,
    const float* __restrict__ run_var, float momentum, float keep, float eps,
    float* __restrict__ stats, float* __restrict__ new_mean, float* __restrict__ new_var,
    int chunks, int C, bool writer, float (&inv)[VEC], float (&shift)[VEC]) {
  __shared__ float s_red[2][SPLIT][GROUP];
  __shared__ float s_inv[GROUP], s_shift[GROUP];
  const int tid = threadIdx.x, g = blockIdx.x;
  const int q = tid / GROUP, cc = tid % GROUP, c = g * GROUP + cc;
  const bool col = c < C;
  float sk[TAIL], mk[TAIL], nk[TAIL];
#pragma unroll
  for (int i = 0; i < TAIL; ++i) {
    const int kk = q + i * SPLIT;
    sk[i] = mk[i] = nk[i] = 0.f;
    if (col && kk < chunks) {
      nk[i] = chunk_n[g * chunks + kk];
      sk[i] = part[static_cast<size_t>(kk) * 2 * C + c];
      mk[i] = part[(static_cast<size_t>(kk) * 2 + 1) * C + c];
    }
  }
  const float n_all = counts[0], nv = counts[1];
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < TAIL; ++i) a += sk[i];
  s_red[0][q][cc] = a;
  __syncthreads();
  const float mu = __fdiv_rn(split_sum(s_red[0], cc), n_all);
  float vs = 0.f;
#pragma unroll
  for (int i = 0; i < TAIL; ++i) {
    if (nk[i] > 0.f) {
      const float dm = sk[i] / nk[i] - mu;
      vs += mk[i] + nk[i] * dm * dm;
    }
  }
  s_red[1][q][cc] = vs;
  __syncthreads();
  if (q == 0) {
    float iv = 0.f, sh = 0.f;
    if (col) {
      const float var = __fdiv_rn(
          __fadd_rn(split_sum(s_red[1], cc), __fmul_rn(__fsub_rn(n_all, nv), __fmul_rn(mu, mu))),
          n_all);
      const float rstd = rsqrtf(__fadd_rn(var, eps));
      iv = __fmul_rn(rstd, scale[c]);
      sh = __fsub_rn(bias[c], __fmul_rn(mu, iv));
      if (writer) {
        stats[c] = mu;
        stats[C + c] = var;
        stats[2 * C + c] = rstd;
        stats[3 * C + c] = iv;
        stats[4 * C + c] = sh;
        const float unbiased =
            __fmul_rn(var, __fdiv_rn(n_all, fmaxf(__fsub_rn(n_all, 1.f), 1.f)));
        new_mean[c] = __fadd_rn(__fmul_rn(keep, run_mean[c]), __fmul_rn(momentum, mu));
        new_var[c] = __fadd_rn(__fmul_rn(keep, run_var[c]), __fmul_rn(momentum, unbiased));
      }
    }
    s_inv[cc] = iv;
    s_shift[cc] = sh;
  }
  __syncthreads();
  const int lv = tid % LANES;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    inv[i] = s_inv[lv * VEC + i];
    shift[i] = s_shift[lv * VEC + i];
  }
}

// y = relu(E(x * inv + shift)) over every row, 0 in the padding channels;
// block (slice, j) writes chunk chunks - 1 - j, and first combines its
// slice's statistics (slice_statistics; block (slice, 0) writes them) with
// its first rows' loads in flight.
template <typename E>
__global__ void __launch_bounds__(THREADS)
bn_apply_kernel(const E* __restrict__ x, int x_pitch,
                const float* __restrict__ part, const float* __restrict__ chunk_n,
                const float* __restrict__ counts, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ run_mean,
                const float* __restrict__ run_var, float momentum, float keep, float eps,
                float* __restrict__ stats, float* __restrict__ new_mean,
                float* __restrict__ new_var, E* __restrict__ y, int y_pitch, int R,
                int C, int stat_chunks, int rows_per_chunk) {
  const int tid = threadIdx.x, rl = tid / LANES, lv = tid % LANES;
  const int c0 = blockIdx.x * GROUP + lv * VEC;
  const bool active = c0 < y_pitch;
  const int chunk = gridDim.y - 1 - blockIdx.y;
  const int r0 = chunk * rows_per_chunk, r1 = min(R, r0 + rows_per_chunk);
  constexpr int U = 8;
  Row8<E> v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int row = r0 + rl + u * ROW_LANES;
    if (active && row < r1) v[u] = load8(x + static_cast<size_t>(row) * x_pitch + c0);
  }
  float inv[VEC], shift[VEC];
  slice_statistics(part, chunk_n, counts, scale, bias, run_mean, run_var, momentum, keep, eps,
                   stats, new_mean, new_var, stat_chunks, C, blockIdx.y == 0, inv, shift);
  if (!active) return;
  const bool full = c0 + VEC <= C;
  for (int r = r0 + rl;;) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * ROW_LANES >= r1) continue;
      float f[VEC];
      unpack8(v[u], f);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        f[i] = full || c0 + i < C ? fmaxf(affine<E>(f[i], inv[i], shift[i]), 0.f) : 0.f;
      store8(y + static_cast<size_t>(r + u * ROW_LANES) * y_pitch + c0, f);
    }
    r += U * ROW_LANES;
    if (r >= r1) break;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u * ROW_LANES < r1)
        v[u] = load8(x + static_cast<size_t>(r + u * ROW_LANES) * x_pitch + c0);
  }
}

// --------------------------------------------------------------- backward

// x's and dy's vectors of `row` when it is before r1.
template <typename E>
__device__ __forceinline__ void load_rows(const E* x, int x_pitch, const E* dy, int dy_pitch,
                                          int c0, int row, int r1, Row8<E>& vx, Row8<E>& vg) {
  if (row < r1) {
    vx = load8(x + static_cast<size_t>(row) * x_pitch + c0);
    vg = load8(dy + static_cast<size_t>(row) * dy_pitch + c0);
  }
}

// Block (slice, chunk): G and Gx of the chunk's rows into part (chunks, 2,
// C).  A thread keeps the next U rows' loads in flight while it adds the
// current U.
template <typename E>
__global__ void __launch_bounds__(THREADS)
bn_grad_sums_kernel(const E* __restrict__ x, int x_pitch, const E* __restrict__ dy, int dy_pitch,
                    const float* __restrict__ stats, float* __restrict__ part, int R, int C,
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
    Row8<E> vx[U], vg[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_rows(x, x_pitch, dy, dy_pitch, c0, r0 + rl + u * ROW_LANES, r1, vx[u], vg[u]);
    for (int r = r0 + rl; r < r1; r += U * ROW_LANES) {
      Row8<E> nx[U], ng[U];
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
          const float gz = relu_gate<E>(f[i], inv[i], shift[i]) ? d[i] : 0.f;
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
}

// dx's two coefficients of each thread's 8 channels from the sums
// kernel's partials, the chunks added in a fixed order (as
// slice_statistics): k3 = -scale rstd^3 Gx / n and k2 - k3 mean, with
// k2 = -inv G / n; the block `writer` also writes dscale = Gx rstd and
// dbias = G.
__device__ __forceinline__ void slice_coefficients(
    const float* __restrict__ part, const float* __restrict__ counts,
    const float* __restrict__ scale, const float* __restrict__ stats,
    float* __restrict__ dscale, float* __restrict__ dbias, int chunks, int C, bool writer,
    float (&k2)[VEC], float (&k3)[VEC]) {
  __shared__ float s_red[2][SPLIT][GROUP];
  __shared__ float s_k2[GROUP], s_k3[GROUP];
  const int tid = threadIdx.x, g = blockIdx.x;
  const int q = tid / GROUP, cc = tid % GROUP, c = g * GROUP + cc;
  float ga[TAIL], gxa[TAIL];
#pragma unroll
  for (int i = 0; i < TAIL; ++i) {
    const int kk = q + i * SPLIT;
    ga[i] = gxa[i] = 0.f;
    if (c < C && kk < chunks) {
      ga[i] = part[static_cast<size_t>(kk) * 2 * C + c];
      gxa[i] = part[(static_cast<size_t>(kk) * 2 + 1) * C + c];
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
  if (q == 0) {
    float c2 = 0.f, c3 = 0.f;
    if (c < C) {
      const float n = counts[0];
      const float Gs = split_sum(s_red[0], cc), Gxs = split_sum(s_red[1], cc);
      const float rstd = stats[2 * C + c], inv = stats[3 * C + c];
      if (writer) {
        dbias[c] = Gs;
        dscale[c] = __fmul_rn(Gxs, rstd);
      }
      c3 = -__fdiv_rn(__fmul_rn(__fmul_rn(scale[c], __fmul_rn(__fmul_rn(rstd, rstd), rstd)), Gxs),
                      n);
      c2 = -__fdiv_rn(__fmul_rn(inv, Gs), n) - c3 * stats[c];
    }
    s_k2[cc] = c2;
    s_k3[cc] = c3;
  }
  __syncthreads();
  const int lv = tid % LANES;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    k2[i] = s_k2[lv * VEC + i];
    k3[i] = s_k3[lv * VEC + i];
  }
}

// dx = E(inv gz + m (k3 x + (k2 - k3 mean))) over every row (two FMAs
// and a product an element), 0 in the padding channels.  The sums kernel's chunks of sum_rows rows ran side by
// side, each from its first row to its last, so the rows each read last are
// in L2: block (slice, j) takes the (j / sum_chunks)-th run of
// rows_per_block rows from the end of sums chunk j % sum_chunks, the ends of
// every chunk first.  A block first combines its slice's coefficients
// (slice_coefficients; block (slice, 0) writes dscale and dbias).  Blocks
// an SM: DxBlocks.
template <typename E>
__global__ void __launch_bounds__(THREADS, DxBlocks<E>::value)
bn_dx_kernel(const E* __restrict__ x, int x_pitch, const E* __restrict__ dy, int dy_pitch,
             const int* __restrict__ lengths,
             const float* __restrict__ em, const float* __restrict__ scale,
             const float* __restrict__ stats, const float* __restrict__ counts,
             const float* __restrict__ part, float* __restrict__ dscale,
             float* __restrict__ dbias, E* __restrict__ dx, int dx_pitch, int R,
             int T, int C, int sum_rows, int rows_per_block) {
  const int tid = threadIdx.x, rl = tid / LANES, lv = tid % LANES;
  const int c0 = blockIdx.x * GROUP + lv * VEC;
  const int sum_chunks = (R + sum_rows - 1) / sum_rows;
  const int k = blockIdx.y % sum_chunks, run = blockIdx.y / sum_chunks;
  const int r1 = min(R, (k + 1) * sum_rows) - run * rows_per_block;
  const int r0 = max(k * sum_rows, r1 - rows_per_block);
  if (r1 <= r0) return;  // the whole block
  const bool active = c0 < dx_pitch;
  constexpr int U = 2;
  Row8<E> vx[U], vg[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (active) load_rows(x, x_pitch, dy, dy_pitch, c0, r0 + rl + u * ROW_LANES, r1, vx[u], vg[u]);
  float k2[VEC], k3[VEC];
  slice_coefficients(part, counts, scale, stats, dscale, dbias, sum_chunks, C, blockIdx.y == 0,
                     k2, k3);
  if (!active) return;
  float inv[VEC], shift[VEC];
  load_cols(stats + 3 * C, c0, C, inv);
  load_cols(stats + 4 * C, c0, C, shift);
  const bool full = c0 + VEC <= C;
  int b = (r0 + rl) / T, t = r0 + rl - b * T;  // the row's sequence and position
  for (int r = r0 + rl;;) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = r + u * ROW_LANES;
      if (row < r1) {
        const float m = t < lengths[b] ? (em != nullptr ? em[b] : 1.f) : 0.f;
        float f[VEC], d[VEC];
        unpack8(vx[u], f);
        unpack8(vg[u], d);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float gz = relu_gate<E>(f[i], inv[i], shift[i]) ? d[i] : 0.f;
          f[i] = full || c0 + i < C ? fmaf(inv[i], gz, m * fmaf(k3[i], f[i], k2[i])) : 0.f;
        }
        store8(dx + static_cast<size_t>(row) * dx_pitch + c0, f);
      }
      for (t += ROW_LANES; t >= T; t -= T) ++b;
    }
    r += U * ROW_LANES;
    if (r >= r1) break;
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_rows(x, x_pitch, dy, dy_pitch, c0, r + u * ROW_LANES, r1, vx[u], vg[u]);
  }
}

int groups_of(int C) { return (C + GROUP - 1) / GROUP; }

// What both directions take: a pitch of 8 channels at least C wide, rows on
// 16 bytes, an output at row_pitch(C).
bool layout_ok(const void* p, int pitch, int C) {
  return pitch >= C && pitch % VEC == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int out_pitch(int C) { return (C + VEC - 1) / VEC * VEC; }

// Forward: y (B, T) rows at row_pitch(C) in the element type E; stats (5,
// C) f32 = mean, var, rstd, inv, shift; counts (2,) = n, n_valid; new_mean,
// new_var (C,) the running statistics; part (stat_chunks, 2, C) and chunk_n
// (ceil(C / 64), stat_chunks) f32 scratch.  x (B, T) rows at x_pitch.  em
// may be null.
template <typename E>
int forward(const void* x, int x_pitch, const void* lengths, const void* em, const void* scale,
            const void* bias, const void* run_mean, const void* run_var, float momentum,
            float keep, float eps, void* part, void* chunk_n, void* counts, void* stats,
            void* new_mean, void* new_var, void* y, int B, int T, int C, int stat_chunks,
            int apply_rows, void* stream) {
  const long long R = static_cast<long long>(B) * T;
  if (B <= 0 || B > MAX_B || T <= 0 || C <= 0 || R >= (1LL << 31) || stat_chunks <= 0 ||
      stat_chunks > SPLIT * TAIL || apply_rows <= 0 || !layout_ok(x, x_pitch, C) ||
      !layout_ok(y, out_pitch(C), C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const E* x_ = static_cast<const E*>(x);
  const int rows = static_cast<int>(R);
  float* part_ = static_cast<float*>(part);
  float* chunk_n_ = static_cast<float*>(chunk_n);
  float* counts_ = static_cast<float*>(counts);
  bn_stats_kernel<E><<<dim3(groups_of(C), stat_chunks), THREADS, 0, s>>>(
      x_, x_pitch, static_cast<const int*>(lengths), static_cast<const float*>(em), part_,
      chunk_n_, counts_, B, T, C);
  bn_apply_kernel<E><<<dim3(groups_of(C), (rows + apply_rows - 1) / apply_rows), THREADS, 0, s>>>(
      x_, x_pitch, part_, chunk_n_, counts_, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(run_mean),
      static_cast<const float*>(run_var), momentum, keep, eps, static_cast<float*>(stats),
      static_cast<float*>(new_mean), static_cast<float*>(new_var), static_cast<E*>(y),
      out_pitch(C), rows, C, stat_chunks, apply_rows);
  kernels_launched += 2;
  return static_cast<int>(cudaGetLastError());
}

// Backward: dx (B, T) rows at row_pitch(C) in E, dscale and dbias (C,) f32,
// from x and dy (rows at their pitches) and the forward's stats and counts;
// part (ceil(R / sum_rows), 2, C) f32 scratch.
template <typename E>
int backward(const void* x, int x_pitch, const void* dy, int dy_pitch, const void* lengths,
             const void* em, const void* scale, const void* stats, const void* counts,
             void* part, void* dscale, void* dbias, void* dx, int B, int T, int C, int sum_rows,
             int apply_rows, void* stream) {
  const long long R = static_cast<long long>(B) * T;
  if (B <= 0 || T <= 0 || C <= 0 || R >= (1LL << 31) || sum_rows <= 0 ||
      (R + sum_rows - 1) / sum_rows > SPLIT * TAIL || apply_rows <= 0 ||
      !layout_ok(x, x_pitch, C) || !layout_ok(dy, dy_pitch, C) ||
      !layout_ok(dx, out_pitch(C), C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const E* x_ = static_cast<const E*>(x);
  const E* dy_ = static_cast<const E*>(dy);
  const float* stats_ = static_cast<const float*>(stats);
  float* part_ = static_cast<float*>(part);
  const int rows = static_cast<int>(R);
  bn_grad_sums_kernel<E><<<dim3(groups_of(C), (rows + sum_rows - 1) / sum_rows), THREADS, 0, s>>>(
      x_, x_pitch, dy_, dy_pitch, stats_, part_, rows, C, sum_rows);
  const int runs = (sum_rows + apply_rows - 1) / apply_rows;  // a sums chunk's dx blocks
  bn_dx_kernel<E><<<dim3(groups_of(C), (rows + sum_rows - 1) / sum_rows * runs), THREADS, 0, s>>>(
      x_, x_pitch, dy_, dy_pitch, static_cast<const int*>(lengths), static_cast<const float*>(em),
      static_cast<const float*>(scale), stats_, static_cast<const float*>(counts), part_,
      static_cast<float*>(dscale), static_cast<float*>(dbias), static_cast<E*>(dx),
      out_pitch(C), rows, T, C, sum_rows, apply_rows);
  kernels_launched += 2;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entry points: bf16 and float32 (B, T, C) activations, the arguments
// of forward and backward above.
extern "C" int masked_bn_relu_forward(const void* x, int x_pitch, const void* lengths,
                                      const void* em, const void* scale, const void* bias,
                                      const void* run_mean, const void* run_var, float momentum,
                                      float keep, float eps, void* part, void* chunk_n,
                                      void* counts, void* stats, void* new_mean, void* new_var,
                                      void* y, int B, int T, int C, int stat_chunks,
                                      int apply_rows, void* stream) {
  return forward<__nv_bfloat16>(x, x_pitch, lengths, em, scale, bias, run_mean, run_var,
                                momentum, keep, eps, part, chunk_n, counts, stats, new_mean,
                                new_var, y, B, T, C, stat_chunks, apply_rows, stream);
}

extern "C" int masked_bn_relu_forward_f32(const void* x, int x_pitch, const void* lengths,
                                          const void* em, const void* scale, const void* bias,
                                          const void* run_mean, const void* run_var,
                                          float momentum, float keep, float eps, void* part,
                                          void* chunk_n, void* counts, void* stats,
                                          void* new_mean, void* new_var, void* y, int B, int T,
                                          int C, int stat_chunks, int apply_rows, void* stream) {
  return forward<float>(x, x_pitch, lengths, em, scale, bias, run_mean, run_var, momentum, keep,
                        eps, part, chunk_n, counts, stats, new_mean, new_var, y, B, T, C,
                        stat_chunks, apply_rows, stream);
}

extern "C" int masked_bn_relu_backward(const void* x, int x_pitch, const void* dy, int dy_pitch,
                                       const void* lengths, const void* em, const void* scale,
                                       const void* stats, const void* counts, void* part,
                                       void* dscale, void* dbias, void* dx, int B, int T, int C,
                                       int sum_rows, int apply_rows, void* stream) {
  return backward<__nv_bfloat16>(x, x_pitch, dy, dy_pitch, lengths, em, scale, stats, counts,
                                 part, dscale, dbias, dx, B, T, C, sum_rows, apply_rows, stream);
}

extern "C" int masked_bn_relu_backward_f32(const void* x, int x_pitch, const void* dy,
                                           int dy_pitch, const void* lengths, const void* em,
                                           const void* scale, const void* stats,
                                           const void* counts, void* part, void* dscale,
                                           void* dbias, void* dx, int B, int T, int C,
                                           int sum_rows, int apply_rows, void* stream) {
  return backward<float>(x, x_pitch, dy, dy_pitch, lengths, em, scale, stats, counts, part,
                         dscale, dbias, dx, B, T, C, sum_rows, apply_rows, stream);
}

// The kernels the entry points have launched since the library was
// loaded: two a call.
extern "C" int masked_bn_kernels_launched() { return kernels_launched.load(); }
