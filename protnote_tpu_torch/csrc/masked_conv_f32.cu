// K7's forward in float32 for Hopper (sm_90a): the ProteInfer encoder's
// masked dilated conv at full float32 precision (its pool is
// csrc/masked_pool.cu's masked_mean_pool_f32).
//
// Replaces the TPU op chain protnote_tpu/models/proteinfer.py:_masked_conv
// (line 127) as proteinfer_embed (line 147) chains it when the encoder
// computes in float32 (no compute_dtype: the standalone ProteInfer
// evaluation, protnote_tpu/cli/test_proteinfer.py, and MIXED_PRECISION
// False), where XLA runs the conv at Precision.HIGHEST: `x * mask`, a "same"
// dilated conv summed in float32, `+ bias`, `* mask`, eval-mode BatchNorm +
// ReLU in front of the block convs, the residual add.
//
// masked_conv_forward_f32 is an implicit GEMM on the FP32 FMA pipe, not the
// tensor cores: wgmma takes no full-float32 input, and TF32 keeps about
// three decimal digits where JAX asks for all of them.  Rows are the (b, t)
// positions, K is taps x C_in, N is C_out.  A block owns a 128-position x
// 128-channel output tile of one sequence (a tile of the host plan,
// ops/masked_conv.py:conv_tile_plan at this kernel's tile) and walks its K
// steps: a step is 16 input channels of one tap whose shifted rows meet [0,
// length).  Each step stages the A tile (the rows t + dilation * (j - half),
// with the eval BN + ReLU prologue applied as they are loaded, then zeroed
// outside [0, length) and past C_in) and the B tile (16 rows of the re-laid
// weights, (taps, k_pad, n_pad) zero-padded) in shared memory, two buffers
// deep: the next step's global loads are in registers while this step's
// products run.  Each of the 256 threads keeps an 8 x 8 register tile of
// outputs (rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and 64 + 4 tx
// + j) and reads 4 float4s of shared memory for 64 FMAs.  Every output is
// summed in one fixed order (taps, then channels), so a call gives the same
// bits every time.  The epilogue adds the bias, applies the output mask
// ((y + bias) * mask, as the plain version) and adds the residual.  The
// first `fill_blocks` blocks write the rows of the row tiles the plan skips
// (past each sequence's length): zeros, or the residual.  Inputs are read
// at their row pitch (a multiple of 8 channels, 16-byte aligned), the
// output written at its own.
//
// What bounds it: operations.  32 sequences at bucket 512 of the default
// encoder need 478 GFLOP for these lengths: 7.1 ms at the H100 SXM's 67
// TFLOP/s of float32 FMA.  Whole 128-row tiles, whole taps and K rounded up
// to 16 channels add work (the 550-channel convs' last column tile is 422
// columns short of its 128 x 5).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // positions of an output tile
constexpr int BN = 128;           // output channels of an output tile
constexpr int BK = 16;            // input channels of a K step (one tap)
constexpr int THREADS = 256;      // 16 x 16 threads, an 8 x 8 register tile each
constexpr int A_STRIDE = BM + 4;  // a K row of the staged A tile: 2-way store conflicts, not 4

struct Args {
  const float* x;
  const float* wt;
  const float* bias;
  const float* bn_inv;
  const float* bn_shift;
  const float* residual;
  const int* lengths;
  const int* plan;
  float* y;
  int B, T, cin, cout, x_pitch, y_pitch, res_pitch, k_pad, n_pad, taps, dilation, tiles;
  int fill_blocks;
};

__device__ __forceinline__ int valid_length(const int* lengths, int b, int T) {
  return min(max(lengths[b], 0), T);
}

// Channels k..k+3 of row t of sequence b as the conv reads them: the
// prologue relu(x * inv + shift) (two roundings, as the plain version's
// float32 ops), then 0 outside [0, L) and past C_in.
__device__ __forceinline__ float4 load_a(const Args& a, int b, int t, int L, int k) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (t >= 0 && t < L && k < a.cin) {
    const float* p = a.x + (static_cast<size_t>(b) * a.T + t) * a.x_pitch + k;
    if (k + 4 <= a.cin) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < a.cin) v[e] = __ldg(p + e);
    }
    if (a.bn_inv != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < a.cin)
          v[e] = fmaxf(__fadd_rn(__fmul_rn(v[e], __ldg(a.bn_inv + k + e)),
                                 __ldg(a.bn_shift + k + e)), 0.f);
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Rows of the row tiles the plan skips (t >= the sequence's length rounded
// up to BM): 0, or the residual.  Block `blk` of `nblk` walks float4 slots
// (b, t, 4c) with a stride.
__device__ void fill_rows(const Args& a, int blk, int nblk) {
  const int cq = (a.cout + 3) / 4;
  const int total = a.B * a.T * cq;
  for (int idx = blk * THREADS + threadIdx.x; idx < total; idx += nblk * THREADS) {
    const int c = (idx % cq) * 4;
    const int r = idx / cq;
    const int t = r % a.T, b = r / a.T;
    const int L = valid_length(a.lengths, b, a.T);
    if (t < (L + BM - 1) / BM * BM) continue;
    float* yr = a.y + static_cast<size_t>(r) * a.y_pitch;
    const float* rr = a.residual == nullptr ? nullptr
                                            : a.residual + static_cast<size_t>(r) * a.res_pitch;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < a.cout) yr[c + e] = rr == nullptr ? 0.f : rr[c + e];
  }
}

__global__ void __launch_bounds__(THREADS, 2) conv_f32_kernel(const Args a) {
  __shared__ __align__(16) float As[2][BK][A_STRIDE];
  __shared__ __align__(16) float Bs[2][BK][BN];
  if (static_cast<int>(blockIdx.x) < a.fill_blocks) {
    fill_rows(a, blockIdx.x, a.fill_blocks);
    return;
  }
  const int tid = threadIdx.x;
  const int mtiles = (a.T + BM - 1) / BM, ntiles = (a.cout + BN - 1) / BN;
  const int code = a.plan[blockIdx.x - a.fill_blocks];
  const int nt = code % ntiles, mt = (code / ntiles) % mtiles, b = code / ntiles / mtiles;
  const int t0 = mt * BM, n0 = nt * BN;
  const int L = valid_length(a.lengths, b, a.T);
  const int half = (a.taps - 1) / 2;
  // the taps whose shifted rows [t0 + s, t0 + s + BM) meet [0, L): a run
  // (the shift grows with j), never empty for a tile of the plan (t0 < L)
  int jlo = a.taps, jhi = -1;
  for (int j = 0; j < a.taps; ++j) {
    const int s = a.dilation * (j - half);
    if (t0 + s < L && t0 + BM + s > 0) {
      jlo = min(jlo, j);
      jhi = j;
    }
  }
  const int kchunks = a.k_pad / BK;
  const int steps = (jhi - jlo + 1) * kchunks;

  // staging: A float4 f = tid + THREADS q is row f / 4, channels 4 (f % 4)
  // (four threads a row's 64 bytes); B float4 f is K row f / 32, columns
  // 4 (f % 32)
  float4 ra[2], rb[2];
  auto load = [&](int step) {
    const int j = jlo + step / kchunks, k0 = (step % kchunks) * BK;
    const int s = a.dilation * (j - half);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = tid + THREADS * q;
      ra[q] = load_a(a, b, t0 + (f >> 2) + s, L, k0 + 4 * (f & 3));
      rb[q] = __ldg(reinterpret_cast<const float4*>(
          a.wt + (static_cast<size_t>(j) * a.k_pad + k0 + (f >> 5)) * a.n_pad + n0 +
          4 * (f & 31)));
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = tid + THREADS * q;
      const int row = f >> 2, k = 4 * (f & 3);
      As[buf][k][row] = ra[q].x;
      As[buf][k + 1][row] = ra[q].y;
      As[buf][k + 2][row] = ra[q].z;
      As[buf][k + 3][row] = ra[q].w;
      *reinterpret_cast<float4*>(&Bs[buf][f >> 5][4 * (f & 31)]) = rb[q];
    }
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int cur = st & 1;
    if (st + 1 < steps) load(st + 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read in step st - 1, which every thread has
    // left (the barrier below it)
    if (st + 1 < steps) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (t >= a.T) continue;
    const float keep = t < L ? 1.f : 0.f;
    const size_t row = static_cast<size_t>(b) * a.T + t;
    float* yr = a.y + row * a.y_pitch;
    const float* rr = a.residual == nullptr ? nullptr : a.residual + row * a.res_pitch;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (c >= a.cout) continue;
      float v = __fmul_rn(__fadd_rn(acc[i][j], __ldg(a.bias + c)), keep);
      if (rr != nullptr) v = __fadd_rn(__ldg(rr + c), v);
      yr[c] = v;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// y (B, T) rows at y_pitch, float32, from x (B, T) rows at x_pitch (a
// multiple of 4 channels, x on 16 bytes), the re-laid weights wt (taps,
// k_pad, n_pad) (k_pad a multiple of 16, n_pad of 128; on 16 bytes), bias
// (cout,), the optional prologue's bn_inv and bn_shift (cin,) (both or
// neither) and residual (B, T) rows at res_pitch, the plan's `tiles` tile
// codes ((b * mtiles + row tile) * ntiles + column tile, tiles of 128 x
// 128) and `fill_blocks` blocks for the rows the plan skips.  Returns a
// CUDA error (0 on success).
extern "C" int masked_conv_forward_f32(const void* x, const void* wt, const void* bias,
                                       const void* bn_inv, const void* bn_shift,
                                       const void* residual, const void* lengths,
                                       const void* plan, void* y, int B, int T, int cin,
                                       int cout, int x_pitch, int y_pitch, int res_pitch,
                                       int k_pad, int n_pad, int taps, int dilation, int tiles,
                                       int fill_blocks, void* stream) {
  if (B <= 0 || T <= 0 || cin <= 0 || cout <= 0 || x_pitch < cin || x_pitch % 4 != 0 ||
      y_pitch < cout || k_pad < cin || k_pad % BK != 0 || n_pad < cout || n_pad % BN != 0 ||
      taps <= 0 || dilation <= 0 || tiles < 0 || fill_blocks < 0 ||
      (bn_inv == nullptr) != (bn_shift == nullptr) || (residual != nullptr && res_pitch < cout) ||
      !aligned16(x) || !aligned16(wt) ||
      static_cast<long long>(B) * T * ((cout + 3) / 4) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const float*>(x);
  a.wt = static_cast<const float*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.bn_inv = static_cast<const float*>(bn_inv);
  a.bn_shift = static_cast<const float*>(bn_shift);
  a.residual = static_cast<const float*>(residual);
  a.lengths = static_cast<const int*>(lengths);
  a.plan = static_cast<const int*>(plan);
  a.y = static_cast<float*>(y);
  a.B = B, a.T = T, a.cin = cin, a.cout = cout, a.x_pitch = x_pitch, a.y_pitch = y_pitch;
  a.res_pitch = res_pitch, a.k_pad = k_pad, a.n_pad = n_pad, a.taps = taps;
  a.dilation = dilation, a.tiles = tiles, a.fill_blocks = fill_blocks;
  const int grid = tiles + fill_blocks;
  if (grid == 0) return 0;
  conv_f32_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
