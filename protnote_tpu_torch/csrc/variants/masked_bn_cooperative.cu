// K7-BN as one cooperative launch a direction, which the port does not use:
// a sum phase that keeps the rows it reads in shared memory, a grid barrier,
// every block combining its slice's partials, then the output phase.  It
// measured slower than the kept two launches (csrc/masked_bn.cu): two
// blocks an SM hide less latency than the kept passes' grids.  Kept for
// chip_variants.py --k7-bn, which times both in turns.
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
// One cooperative launch a direction, two blocks an SM, every block
// resident: a sum phase, a grid barrier, an output phase.
// * forward (`bn_forward_kernel`): block (slice, chunk) sums an equal run
//   of the valid rows (the rows with m != 0, in (b, t) order; a table of the
//   lengths in shared memory), the run's moments about its first row
//   (S = sum m x, D = sum m (x - K), Q = sum m (x - K)^2, M2 = Q - D^2 / n_k:
//   the run's centred moment), keeping the rows it loads in shared memory
//   (96 KB, 768 rows of a slice); partials (S, M2, n_k) to device memory.
//   After the barrier every block adds its slice's runs in a fixed order,
//     sum m (x - mean)^2 = sum_k [M2_k + n_k (S_k / n_k - mean)^2],
//   a run with no valid row adding nothing (the chunk-0 blocks write the
//   statistics, running statistics and counts), then writes y for its run's
//   valid rows from shared memory and for an equal run of the other rows
//   (padding, dropped sequences) from device memory.
// * backward (`bn_backward_kernel`): block (slice, chunk) sums G and Gx over
//   its chunk of every row, keeping the first 384 rows' x and dy in shared
//   memory; after the barrier it adds its slice's chunks in a fixed order
//   and writes dx for its chunk, the kept rows from shared memory, the rest
//   (read last, so partly in L2) again from device memory.
// Every sum runs in a fixed order and no float is added atomically: two
// calls give the same bits.  The affine and dx's terms are rounded one
// operation at a time (__fmul_rn/__fadd_rn), as the plain PyTorch version
// computes them.
//
// What bounds it: device memory.  The forward reads the valid rows of x
// once and the others once and writes y: the bytes of its bound.  The
// backward reads x and dy once, and again for the rows past its shared
// memory (at 32 x 512: 67% of the 1,100-channel chunks, 32% of the 550),
// and writes dx.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;                      // channels a thread: one 16-byte load
constexpr int LANES = 8;                    // threads on a row's slice
constexpr int GROUP = VEC * LANES;          // channels of a slice
constexpr int THREADS = 256;
constexpr int ROW_LANES = THREADS / LANES;  // rows a block walks at once
constexpr int SPLIT = THREADS / GROUP;      // threads of a column in the combine
constexpr int WARPS = THREADS / 32;
constexpr int MAX_B = 256;                  // sequences of the forward's table
constexpr int TAIL = 8;                     // chunks a combining thread adds: chunks <= 32
constexpr int STAGE_BYTES = 96 * 1024;      // a block's kept rows
constexpr int FWD_KEPT = STAGE_BYTES / (THREADS * 16);      // x rows a row lane keeps: 24
constexpr int BWD_KEPT = STAGE_BYTES / (THREADS * 2 * 16);  // x and dy rows: 12

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

// y's 8 channels from x's: relu(bf16(x * inv + shift)), 0 past C.
__device__ __forceinline__ uint4 bn_relu8(const uint4& v, const float (&inv)[VEC],
                                          const float (&shift)[VEC], int c0, int C) {
  float f[VEC];
  unpack8(v, f);
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    f[i] = c0 + i < C ? fmaxf(affine_bf16(f[i], inv[i], shift[i]), 0.f) : 0.f;
  return pack8(f);
}

// Loads row `c0 .. c0 + 7` of a (C,) vector, 0 past C.
__device__ __forceinline__ void load_cols(const float* v, int c0, int C, float (&out)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = c0 + i < C ? v[c0 + i] : 0.f;
}

// v summed over the warp's 4 row lanes (lanes 8 apart), the same bits in
// each of them.
__device__ __forceinline__ float rows_of_warp(float v) {
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums red[0..SPLIT)[c] in order for each column c of the slice.
__device__ __forceinline__ float split_sum(const float (*red)[GROUP], int c) {
  float v = red[0][c];
#pragma unroll
  for (int q = 1; q < SPLIT; ++q) v += red[q][c];
  return v;
}

// Every block of the grid waits here until all have arrived, the writes
// each made before it (the first `writers` threads' partials) visible to
// all.  Block (0, 0) adds 2^31 - (blocks - 1) to the counter, every other
// block 1: the counter's top bit flips when the last arrives, and each
// block waits for the flip from the value its own add returned (the scheme
// of cooperative groups' grid sync; the counter is never reset).  The launch
// is cooperative, so every block is resident.
__device__ __forceinline__ void grid_barrier(unsigned* bar, int writers) {
  if (static_cast<int>(threadIdx.x) < writers) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned blocks = gridDim.x * gridDim.y;
    const unsigned add = blockIdx.x == 0 && blockIdx.y == 0 ? 0x80000000u - (blocks - 1) : 1u;
    const unsigned old = atomicAdd(bar, add);
    volatile unsigned* now = bar;
    while (((old ^ *now) & 0x80000000u) == 0) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------- forward

// The tables of the rows in shared memory: len[b] the rows of sequence b
// that count (0 where em drops it), vstart[b] their prefix sum (vstart[B]
// the total), istart[b] that of the others' (T - len[b] a sequence), w[b]
// the weight m of its valid rows, raw[b] lengths[b] itself.
struct Table {
  int *len, *vstart, *istart, *raw;
  float* w;
};

__host__ __device__ constexpr int table_bytes(int B) {
  return ((5 * B + 2) * 4 + 15) / 16 * 16;
}

__device__ Table row_tables(unsigned char* smem, const int* lengths, const float* em, int B,
                            int T) {
  Table tb;
  tb.len = reinterpret_cast<int*>(smem);
  tb.vstart = tb.len + B;
  tb.istart = tb.vstart + B + 1;
  tb.raw = tb.istart + B + 1;
  tb.w = reinterpret_cast<float*>(tb.raw + B);
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float e = em != nullptr ? em[b] : 1.f;
    const int l = lengths[b];
    tb.w[b] = e;
    tb.raw[b] = l;
    tb.len[b] = e != 0.f ? min(max(l, 0), T) : 0;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // both prefix sums, 32 sequences a step
    const int lane = threadIdx.x;
    int vrun = 0, irun = 0;
    for (int base = 0; base < B; base += 32) {
      int v = base + lane < B ? tb.len[base + lane] : 0;
      int iv = base + lane < B ? T - v : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        const int iu = __shfl_up_sync(0xffffffffu, iv, o);
        if (lane >= o) {
          v += u;
          iv += iu;
        }
      }
      if (base + lane < B) {
        tb.vstart[base + lane + 1] = vrun + v;
        tb.istart[base + lane + 1] = irun + iv;
      }
      vrun += __shfl_sync(0xffffffffu, v, 31);
      irun += __shfl_sync(0xffffffffu, iv, 31);
    }
    if (lane == 0) tb.vstart[0] = tb.istart[0] = 0;
  }
  __syncthreads();
  return tb;
}

// (b, t) of row j < start[B] of a run list: start[b] <= j < start[b + 1].
__device__ __forceinline__ void locate(const int* start, int B, int j, int& b, int& t) {
  int lo = 0, hi = B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= j) lo = mid; else hi = mid;
  }
  b = lo;
  t = j - start[lo];
}

// A row lane's walk over rows [j, j1) of a run list, ROW_LANES apart: the
// next U rows (null past j1).  Sequence b's run has start[b + 1] - start[b]
// rows from position 0 (VALID: its valid rows) or len[b] (the others).
template <int U, bool VALID>
__device__ __forceinline__ void next_rows(const __nv_bfloat16* x, int pitch, int c0, int T, int B,
                                          const Table& tb, int j1, int& j, int& b, int& t,
                                          const __nv_bfloat16* (&p)[U], float (&wt)[U]) {
  const int* start = VALID ? tb.vstart : tb.istart;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    p[u] = nullptr;
    wt[u] = 0.f;
    if (j < j1) {
      const int t_row = VALID ? t : tb.len[b] + t;
      p[u] = x + (static_cast<size_t>(b) * T + t_row) * pitch + c0;
      wt[u] = tb.w[b];
      j += ROW_LANES;
      t += ROW_LANES;
      while (b < B && t >= start[b + 1] - start[b]) {
        t -= start[b + 1] - start[b];
        ++b;
      }
    }
  }
}

// Block (slice, chunk).  The statistics' partials: part (chunks, 2, C) = S,
// M2 and chunk_n (slices, chunks); bar the grid barrier's counter.
__global__ void __launch_bounds__(THREADS, 2)
bn_forward_kernel(const __nv_bfloat16* __restrict__ x, int pitch, const int* __restrict__ lengths,
                  const float* __restrict__ em, const float* __restrict__ scale,
                  const float* __restrict__ bias, const float* __restrict__ run_mean,
                  const float* __restrict__ run_var, float momentum, float keep, float eps,
                  float* __restrict__ part, float* __restrict__ chunk_n,
                  float* __restrict__ counts, float* __restrict__ stats,
                  float* __restrict__ new_mean, float* __restrict__ new_var,
                  unsigned* __restrict__ bar, __nv_bfloat16* __restrict__ y, int y_pitch, int B,
                  int T, int C) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ float s_red[3][WARPS][GROUP];
  __shared__ float s_n[WARPS];
  __shared__ float s_inv[GROUP], s_shift[GROUP];
  const int chunks = gridDim.y, k = blockIdx.y, g = blockIdx.x;
  const int tid = threadIdx.x, rl = tid / LANES, lv = tid % LANES, warp = tid / 32;
  const int c0 = g * GROUP + lv * VEC;
  const Table tb = row_tables(s_dyn, lengths, em, B, T);
  uint4* kept = reinterpret_cast<uint4*>(s_dyn + table_bytes(B));
  const int total = tb.vstart[B];
  const int per = (total + chunks - 1) / chunks;
  const int j0 = min(k * per, total), j1 = min(j0 + per, total);

  // ---- the statistics of the run's valid rows, each row kept
  float S[VEC], D[VEC], Q[VEC], n = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) S[i] = D[i] = Q[i] = 0.f;
  if (j0 < j1 && c0 < C) {
    int b, t;
    locate(tb.vstart, B, j0, b, t);
    float K[VEC];
    unpack8(load8(x + (static_cast<size_t>(b) * T + t) * pitch + c0), K);
    int j = j0 + rl, row = 0;
    if (j < j1) locate(tb.vstart, B, j, b, t);
    constexpr int U = 4;
    const __nv_bfloat16* p[U];
    float wt[U];
    uint4 v[U];
    next_rows<U, true>(x, pitch, c0, T, B, tb, j1, j, b, t, p, wt);
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = p[u] != nullptr ? load8(p[u]) : make_uint4(0, 0, 0, 0);
    while (p[0] != nullptr) {
      const __nv_bfloat16* pn[U];
      float wn[U];
      uint4 vn[U];
      next_rows<U, true>(x, pitch, c0, T, B, tb, j1, j, b, t, pn, wn);
#pragma unroll
      for (int u = 0; u < U; ++u)
        vn[u] = pn[u] != nullptr ? load8(pn[u]) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < U; ++u, ++row) {
        if (p[u] == nullptr) continue;
        if (row < FWD_KEPT) kept[(row * ROW_LANES + rl) * LANES + lv] = v[u];
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
  grid_barrier(bar, GROUP);

  // ---- every block: its slice's runs loaded at once and added in a fixed
  // order (run q, q + SPLIT, ... in a thread, then the threads)
  {
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
        const float e = tb.w[b];
        rows += e;
        t_ref = fmaxf(t_ref, __fmul_rn(static_cast<float>(tb.raw[b]), e));
        valid += __fmul_rn(static_cast<float>(min(max(tb.raw[b], 0), T)), e);
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
      float inv = 0.f, shift = 0.f;
      if (col) {
        const float var = __fdiv_rn(
            __fadd_rn(split_sum(s_red[1], cc), __fmul_rn(__fsub_rn(n_all, nv), __fmul_rn(mu, mu))),
            n_all);
        const float rstd = rsqrtf(__fadd_rn(var, eps));
        inv = __fmul_rn(rstd, scale[c]);
        shift = __fsub_rn(bias[c], __fmul_rn(mu, inv));
        if (k == 0) {
          stats[c] = mu;
          stats[C + c] = var;
          stats[2 * C + c] = rstd;
          stats[3 * C + c] = inv;
          stats[4 * C + c] = shift;
          const float unbiased =
              __fmul_rn(var, __fdiv_rn(n_all, fmaxf(__fsub_rn(n_all, 1.f), 1.f)));
          new_mean[c] = __fadd_rn(__fmul_rn(keep, run_mean[c]), __fmul_rn(momentum, mu));
          new_var[c] = __fadd_rn(__fmul_rn(keep, run_var[c]), __fmul_rn(momentum, unbiased));
        }
      }
      s_inv[cc] = inv;
      s_shift[cc] = shift;
    }
    if (g == 0 && k == 0 && tid == 0) {
      counts[0] = n_all;
      counts[1] = nv;
    }
    __syncthreads();
  }

  // ---- y: the run's valid rows from shared memory (past it, again from
  // device memory), then an equal run of the other rows
  if (c0 >= y_pitch) return;
  float inv[VEC], shift[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    inv[i] = s_inv[lv * VEC + i];
    shift[i] = s_shift[lv * VEC + i];
  }
  constexpr int U = 4;
  if (j0 < j1) {
    int j = j0 + rl, b = 0, t = 0, row = 0;
    if (j < j1) locate(tb.vstart, B, j, b, t);
    while (j < j1) {
      const __nv_bfloat16* p[U];
      float wt[U];
      next_rows<U, true>(x, pitch, c0, T, B, tb, j1, j, b, t, p, wt);
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (p[u] != nullptr)
          v[u] = row + u < FWD_KEPT ? kept[((row + u) * ROW_LANES + rl) * LANES + lv]
                                    : load8(p[u]);
#pragma unroll
      for (int u = 0; u < U; ++u, ++row)
        if (p[u] != nullptr)
          *reinterpret_cast<uint4*>(y + (p[u] - x) / pitch * y_pitch + c0) =
              bn_relu8(v[u], inv, shift, c0, C);
    }
  }
  const int others = tb.istart[B];
  const int iper = (others + chunks - 1) / chunks;
  const int i0 = min(k * iper, others), i1 = min(i0 + iper, others);
  int j = i0 + rl, b = 0, t = 0;
  if (j < i1) locate(tb.istart, B, j, b, t);
  while (j < i1) {
    const __nv_bfloat16* p[U];
    float wt[U];
    next_rows<U, false>(x, pitch, c0, T, B, tb, i1, j, b, t, p, wt);
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (p[u] != nullptr) v[u] = load8(p[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (p[u] != nullptr)
        *reinterpret_cast<uint4*>(y + (p[u] - x) / pitch * y_pitch + c0) =
            bn_relu8(v[u], inv, shift, c0, C);
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

// Block (slice, chunk) of rows_per_chunk rows: G and Gx into part (chunks,
// 2, C); bar the grid barrier's counter.
__global__ void __launch_bounds__(THREADS, 2)
bn_backward_kernel(const __nv_bfloat16* __restrict__ x, int x_pitch,
                   const __nv_bfloat16* __restrict__ dy, int dy_pitch,
                   const int* __restrict__ lengths, const float* __restrict__ em,
                   const float* __restrict__ scale, const float* __restrict__ stats,
                   const float* __restrict__ counts, float* __restrict__ part,
                   float* __restrict__ dscale, float* __restrict__ dbias,
                   unsigned* __restrict__ bar, __nv_bfloat16* __restrict__ dx, int dx_pitch,
                   int R, int T, int C, int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ float s_red[2][WARPS][GROUP];
  __shared__ float s_k2[GROUP], s_k3[GROUP];
  const int chunks = gridDim.y, k = blockIdx.y, g = blockIdx.x;
  const int tid = threadIdx.x, rl = tid / LANES, lv = tid % LANES, warp = tid / 32;
  const int c0 = g * GROUP + lv * VEC;
  uint4* kept = reinterpret_cast<uint4*>(s_dyn);
  const int r0 = k * rows_per_chunk, r1 = min(R, r0 + rows_per_chunk);
  float mean[VEC], inv[VEC], shift[VEC];
  load_cols(stats, c0, C, mean);
  load_cols(stats + 3 * C, c0, C, inv);
  load_cols(stats + 4 * C, c0, C, shift);

  // ---- G and Gx over the chunk, the first rows kept
  float G[VEC], Gx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) G[i] = Gx[i] = 0.f;
  if (c0 < C) {
    constexpr int U = 4;
    uint4 vx[U], vg[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_rows(x, x_pitch, dy, dy_pitch, c0, r0 + rl + u * ROW_LANES, r1, vx[u], vg[u]);
    int row = 0;
    for (int r = r0 + rl; r < r1; r += U * ROW_LANES) {
      uint4 nx[U], ng[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_rows(x, x_pitch, dy, dy_pitch, c0, r + (U + u) * ROW_LANES, r1, nx[u], ng[u]);
#pragma unroll
      for (int u = 0; u < U; ++u, ++row) {
        if (r + u * ROW_LANES >= r1) continue;
        if (row < BWD_KEPT) {
          kept[((row * ROW_LANES + rl) * LANES + lv) * 2] = vx[u];
          kept[((row * ROW_LANES + rl) * LANES + lv) * 2 + 1] = vg[u];
        }
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
  grid_barrier(bar, 2 * GROUP);

  // ---- every block: its slice's chunks added in a fixed order, dx's two
  // coefficients k2 = -inv G / n, k3 = -scale rstd^3 Gx / n
  {
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
    if (q == 0) {
      float k2 = 0.f, k3 = 0.f;
      if (c < C) {
        const float n = counts[0];
        const float Gs = split_sum(s_red[0], cc), Gxs = split_sum(s_red[1], cc);
        const float rstd = stats[2 * C + c], inv_c = stats[3 * C + c];
        if (k == 0) {
          dbias[c] = Gs;
          dscale[c] = __fmul_rn(Gxs, rstd);
        }
        k2 = -__fdiv_rn(__fmul_rn(inv_c, Gs), n);
        k3 = -__fdiv_rn(
            __fmul_rn(__fmul_rn(scale[c], __fmul_rn(__fmul_rn(rstd, rstd), rstd)), Gxs), n);
      }
      s_k2[cc] = k2;
      s_k3[cc] = k3;
    }
    __syncthreads();
  }

  // ---- dx = bf16(inv gz + m (k2 + k3 (x - mean))) over the chunk, 0 in the
  // padding channels: the kept rows from shared memory, the rest (read
  // last in the sums, partly still in L2) again from device memory
  if (c0 >= dx_pitch) return;
  float k2[VEC], k3[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    k2[i] = s_k2[lv * VEC + i];
    k3[i] = s_k3[lv * VEC + i];
  }
  constexpr int U = 2;
  int row = 0;
  for (int r = r0 + rl; r < r1; r += U * ROW_LANES) {
    uint4 vx[U], vg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * ROW_LANES;
      if (rr >= r1) continue;
      if (row + u < BWD_KEPT) {
        vx[u] = kept[(((row + u) * ROW_LANES + rl) * LANES + lv) * 2];
        vg[u] = kept[(((row + u) * ROW_LANES + rl) * LANES + lv) * 2 + 1];
      } else {
        load_rows(x, x_pitch, dy, dy_pitch, c0, rr, r1, vx[u], vg[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u, ++row) {
      const int rr = r + u * ROW_LANES;
      if (rr >= r1) continue;
      const int b = rr / T, t = rr - b * T;
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
      *reinterpret_cast<uint4*>(dx + static_cast<size_t>(rr) * dx_pitch + c0) = pack8(f);
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

// A cooperative launch of `kernel` on a (slices, chunks) grid with `smem`
// bytes of dynamic shared memory, refused when the grid does not fit the
// card at once.
// The kernel's attribute and the card's capacity are looked up again only
// when the shared memory changes.
template <typename... Args>
int cooperative(void (*kernel)(Args...), int slices, int chunks, int smem, cudaStream_t s,
                void** args) {
  static int known_smem = -1, capacity = 0;
  if (smem != known_smem) {
    int per_sm = 0, device = 0, sms = 0;
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
            cudaSuccess ||
        (err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess)
      return static_cast<int>(err);
    known_smem = smem;
    capacity = per_sm * sms;
  }
  if (slices * chunks > capacity) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                      dim3(slices, chunks), dim3(THREADS), args,
                                                      smem, s));
}

}  // namespace

// Forward: y (B, T) rows at row_pitch(C), bf16; stats (5, C) f32 = mean, var,
// rstd, inv, shift; counts (2,) = n, n_valid; new_mean, new_var (C,) the
// running statistics; part (chunks, 2, C) and chunk_n (ceil(C / 64),
// chunks) f32 scratch; bar the grid barrier's counter (0 when first used).  x (B, T) rows
// at x_pitch.  em may be null.  One cooperative launch of ceil(C / 64) x
// chunks blocks.
extern "C" int masked_bn_relu_forward(const void* x, int x_pitch, const void* lengths,
                                      const void* em, const void* scale, const void* bias,
                                      const void* run_mean, const void* run_var, float momentum,
                                      float keep, float eps, void* part, void* chunk_n,
                                      void* counts, void* stats, void* new_mean, void* new_var,
                                      void* bar, void* y, int B, int T, int C, int chunks,
                                      void* stream) {
  const long long R = static_cast<long long>(B) * T;
  if (B <= 0 || B > MAX_B || T <= 0 || C <= 0 || R >= (1LL << 31) || chunks <= 0 ||
      chunks > SPLIT * TAIL || !layout_ok(x, x_pitch, C) || !layout_ok(y, out_pitch(C), C))
    return static_cast<int>(cudaErrorInvalidValue);
  int y_pitch = out_pitch(C);
  void* args[] = {&x, &x_pitch, &lengths, &em, &scale, &bias, &run_mean, &run_var, &momentum,
                  &keep, &eps, &part, &chunk_n, &counts, &stats, &new_mean, &new_var, &bar, &y,
                  &y_pitch, &B, &T, &C};
  return cooperative(bn_forward_kernel, groups_of(C), chunks, table_bytes(B) + STAGE_BYTES,
                     reinterpret_cast<cudaStream_t>(stream), args);
}

// Backward: dx (B, T) rows at row_pitch(C), bf16, dscale and dbias (C,) f32,
// from x and dy (rows at their pitches) and the forward's stats and counts;
// part (ceil(R / rows_per_chunk), 2, C) f32 scratch; bar the grid
// barrier's counter.  One cooperative launch.
extern "C" int masked_bn_relu_backward(const void* x, int x_pitch, const void* dy, int dy_pitch,
                                       const void* lengths, const void* em, const void* scale,
                                       const void* stats, const void* counts, void* part,
                                       void* dscale, void* dbias, void* bar, void* dx, int B,
                                       int T, int C, int rows_per_chunk, void* stream) {
  const long long R = static_cast<long long>(B) * T;
  if (B <= 0 || T <= 0 || C <= 0 || R >= (1LL << 31) || rows_per_chunk <= 0 ||
      (R + rows_per_chunk - 1) / rows_per_chunk > SPLIT * TAIL || !layout_ok(x, x_pitch, C) ||
      !layout_ok(dy, dy_pitch, C) || !layout_ok(dx, out_pitch(C), C))
    return static_cast<int>(cudaErrorInvalidValue);
  int rows = static_cast<int>(R), dx_pitch = out_pitch(C);
  void* args[] = {&x, &x_pitch, &dy, &dy_pitch, &lengths, &em, &scale, &stats, &counts, &part,
                  &dscale, &dbias, &bar, &dx, &dx_pitch, &rows, &T, &C, &rows_per_chunk};
  return cooperative(bn_backward_kernel, groups_of(C), (rows + rows_per_chunk - 1) / rows_per_chunk,
                     STAGE_BYTES, reinterpret_cast<cudaStream_t>(stream), args);
}
