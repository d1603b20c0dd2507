// K7's float32 convs in their first design, which the port no longer uses:
// the forward and its dX (conv_f32_kernel) and dW (conv_dw_f32_kernel) on
// the FP32 FMA pipe, 128 x 128 tiles with an 8 x 8 register tile a thread,
// the weights re-laid as float32 (taps, K rounded up to 16, N rounded up to
// 128) with N contiguous.  Kept as it was for chip_variants.py --k7-f32,
// which times it against the kept kernels (csrc/masked_conv_f32.cu: the
// bf16x3 split on wgmma) in turns; its entry points take the layout and the
// plans of that first design (chip_variants.py builds them itself).
//
// K7 in float32 for Hopper (sm_90a): the ProteInfer encoder's masked
// dilated conv at full float32 precision, forward, dX and dW (its pool is
// csrc/masked_pool.cu's masked_mean_pool_f32, its train-mode BatchNorm
// csrc/masked_bn.cu's _f32 entry points).
//
// Replaces the TPU op chain protnote_tpu/models/proteinfer.py:_masked_conv
// (line 127) as proteinfer_embed (line 147) chains it when the encoder
// computes in float32 (no compute_dtype: the standalone ProteInfer
// evaluation, protnote_tpu/cli/test_proteinfer.py, and MIXED_PRECISION
// False), where XLA runs the conv at Precision.HIGHEST: `x * mask`, a "same"
// dilated conv summed in float32, `+ bias`, `* mask`, eval-mode BatchNorm +
// ReLU in front of the block convs, the residual add; and, when the encoder
// trains in float32 (TRAIN_SEQUENCE_ENCODER with MIXED_PRECISION False), the
// conv's vjp: with G = mask * dy,
//   dX = mask * sum_j sum_n G[t - d (j - half), n] W[j, c, n],
//   dW[j] = sum_{b, t} (mask x)[t + d (j - half)]^T G[t],  dbias = sum G.
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
// masked_conv_dx_f32 is the same kernel: with the taps reversed (j' = taps
// - 1 - j), t - d (j - half) = t + d (j' - half), so dX is the forward conv
// of G with the weights W'[j'] = W[j]^T re-laid (taps, C_out rounded up to
// 16, C_in rounded up to 128) (ops/masked_conv.py:conv_weight_layout_f32
// with dx), no bias, no prologue: the input mask is the A tile's zeroing,
// the output mask the epilogue's.  It writes dX at the padded pitch the
// BatchNorm's float32 backward reads.
//
// masked_conv_dw_f32 is a second FMA-pipe kernel, conv_dw_f32_kernel: dW[j]
// is a GEMM with M = C_in, N = C_out and K = the positions (b, t) whose
// output row t and input row t + s (s = d (j - half)) are both valid.  A
// block owns a 128 x 128 tile of one tap and one split of its K steps (an
// item of ops/masked_conv.py:dw_step_plan at this kernel's tile and 16
// positions a step, one sequence a step); each step stages 16 positions of
// x (rows t + s) and of dy (rows t) in shared memory, the positions past the
// step's valid count zeroed, two buffers deep, and each thread keeps an 8 x
// 8 register tile as the forward does.  With one split the block writes dW;
// with more each writes float32 partials that dw_reduce_f32_kernel adds in
// split order.  dbias: per-sequence column sums (four interleaved
// accumulators a column, added in a fixed order), then the sequences added
// in order.  Every sum runs in one fixed order: two calls give the same
// bits.
//
// What bounds them: operations.  32 sequences at bucket 512 of the default
// encoder need 478 GFLOP for these lengths in the forward (7.1 ms at the
// H100 SXM's 67 TFLOP/s of float32 FMA) and about as much for dX (all but
// conv1) and for dW.  Whole 128-row tiles, whole taps and K rounded up to
// 16 channels add work to the forward and dX (the 550-channel convs' last
// column tile is 422 columns short of its 128 x 5); dW's steps follow the
// valid positions, its tiles are whole.

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
      float v = a.bias == nullptr ? acc[i][j] : __fadd_rn(acc[i][j], __ldg(a.bias + c));
      v = __fmul_rn(v, keep);
      if (rr != nullptr) v = __fadd_rn(__ldg(rr + c), v);
      yr[c] = v;
    }
  }
}

// ------------------------------------------------------------------ dW

constexpr int DW_BM = 128;  // input channels of a dW tile
constexpr int DW_BN = 128;  // output channels of a dW tile
constexpr int DW_BK = 16;   // positions of a dW K step (ops/masked_conv.py F32_DW_STEP)
constexpr int SUM_COLS = 128;  // columns of a dbias block

struct DwArgs {
  const float* x;
  const float* dy;
  const int* items;    // ((j * splits + sp) * mtiles + mt) * ntiles + nt
  const int* offsets;  // (taps * splits + 1): steps of (j, sp) are [offsets[j * splits + sp], next)
  const int* steps;    // two words a step: b, then t0 | rows << 16 (rows valid from t0)
  float* partial;      // (splits, taps, cin, cout), splits > 1
  float* dw;           // (taps, cin, cout)
  int T, cin, cout, x_pitch, dy_pitch, taps, dilation, mtiles, ntiles, splits;
};

// Channels c..c+3 of row t of sequence b of a (B, T) float32 tensor at
// `pitch` (a multiple of 4, on 16 bytes): 0 past C.
__device__ __forceinline__ float4 load4(const float* base, int pitch, int T, int b, int t, int c,
                                        int C) {
  const float* p = base + (static_cast<size_t>(b) * T + t) * pitch + c;
  if (c + 4 <= C) return __ldg(reinterpret_cast<const float4*>(p));
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < C) v[e] = __ldg(p + e);
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Block = item: dW[j][m0.., n0..] (or split sp's partial) over its steps.
__global__ void __launch_bounds__(THREADS, 2) conv_dw_f32_kernel(const DwArgs a) {
  __shared__ __align__(16) float As[2][DW_BK][DW_BM];  // As[p][c] = x[t0 + p + s, m0 + c]
  __shared__ __align__(16) float Bs[2][DW_BK][DW_BN];  // Bs[p][n] = dy[t0 + p, n0 + n]
  const int tid = threadIdx.x;
  const int code = a.items[blockIdx.x];
  const int u = code / a.ntiles, v = u / a.mtiles;
  const int n0 = (code - u * a.ntiles) * DW_BN, m0 = (u - v * a.mtiles) * DW_BM;
  const int j = v / a.splits, sp = v - j * a.splits;
  const int k0 = a.offsets[v], steps = a.offsets[v + 1] - k0;
  const int s = a.dilation * (j - (a.taps - 1) / 2);

  // staging: float4 f = tid + THREADS q is position f / 32, channels 4 (f % 32)
  float4 ra[2], rb[2];
  auto load = [&](int step) {
    const int b = a.steps[2 * (k0 + step)];
    const int w = a.steps[2 * (k0 + step) + 1];
    const int t0 = w & 0xffff, rows = w >> 16;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = tid + THREADS * q;
      const int p = f >> 5, c = 4 * (f & 31);
      const bool in = p < rows;
      ra[q] = in ? load4(a.x, a.x_pitch, a.T, b, t0 + p + s, m0 + c, a.cin)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      rb[q] = in ? load4(a.dy, a.dy_pitch, a.T, b, t0 + p, n0 + c, a.cout)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = tid + THREADS * q;
      *reinterpret_cast<float4*>(&As[buf][f >> 5][4 * (f & 31)]) = ra[q];
      *reinterpret_cast<float4*>(&Bs[buf][f >> 5][4 * (f & 31)]) = rb[q];
    }
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;

  if (steps > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int cur = st & 1;
    if (st + 1 < steps) load(st + 1);
#pragma unroll
    for (int kk = 0; kk < DW_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    if (st + 1 < steps) store(cur ^ 1);
    __syncthreads();
  }

  float* out = a.splits == 1
                   ? a.dw + static_cast<size_t>(j) * a.cin * a.cout
                   : a.partial + (static_cast<size_t>(sp) * a.taps + j) * a.cin * a.cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (c >= a.cin) continue;
    float* row = out + static_cast<size_t>(c) * a.cout;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = n0 + (jj < 4 ? 4 * tx + jj : 64 + 4 * tx + jj - 4);
      if (n < a.cout) row[n] = acc[i][jj];
    }
  }
}

// dW = the splits' partials added in split order.
__global__ void dw_reduce_f32_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                     long long total, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = partial[i];
    for (int sp = 1; sp < splits; ++sp) acc += partial[sp * total + i];
    dw[i] = acc;
  }
}

// Block (column group, b): column n's sum over sequence b's valid rows of
// dy at `pitch`, four accumulators taking rows t = 0, 1, 2, 3 mod 4, added
// (a0 + a1) + (a2 + a3).
__global__ void __launch_bounds__(SUM_COLS)
seq_col_sums_f32_kernel(const float* __restrict__ dy, const int* __restrict__ lengths,
                        float* __restrict__ part, int T, int C, int pitch) {
  const int b = blockIdx.y, n = blockIdx.x * SUM_COLS + threadIdx.x;
  if (n >= C) return;
  const int L = valid_length(lengths, b, T);
  const float* p = dy + static_cast<size_t>(b) * T * pitch + n;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int t = 0;
  for (; t + 4 <= L; t += 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += __ldg(p + static_cast<size_t>(t + e) * pitch);
  }
  for (int e = 0; t + e < L; ++e) acc[e] += __ldg(p + static_cast<size_t>(t + e) * pitch);
  part[static_cast<size_t>(b) * C + n] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// dbias = the sequences' column sums added in sequence order.
__global__ void dbias_f32_kernel(const float* __restrict__ part, float* __restrict__ db, int B,
                                 int C) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= C) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[static_cast<size_t>(b) * C + n];
  db[n] = acc;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }


// One launch of conv_f32_kernel: `tiles` blocks of the plan after
// `fill_blocks` blocks for the rows it skips.
int conv_launch(const Args& a, void* stream) {
  if (a.B <= 0 || a.T <= 0 || a.cin <= 0 || a.cout <= 0 || a.x_pitch < a.cin ||
      a.x_pitch % 4 != 0 || a.y_pitch < a.cout || a.k_pad < a.cin || a.k_pad % BK != 0 ||
      a.n_pad < a.cout || a.n_pad % BN != 0 || a.taps <= 0 || a.dilation <= 0 || a.tiles < 0 ||
      a.fill_blocks < 0 || (a.bn_inv == nullptr) != (a.bn_shift == nullptr) ||
      (a.residual != nullptr && a.res_pitch < a.cout) || !aligned16(a.x) || !aligned16(a.wt) ||
      static_cast<long long>(a.B) * a.T * ((a.cout + 3) / 4) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = a.tiles + a.fill_blocks;
  if (grid == 0) return 0;
  conv_f32_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

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
  if (bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  return conv_launch(a, stream);
}

// dX (B, T) rows at dx_pitch, float32, from dy (B, T) rows at dy_pitch (a
// multiple of 4 channels, dy on 16 bytes), the dX weights wt (taps, k_pad,
// n_pad): W[taps - 1 - j]^T zero-padded, k_pad (C_out) a multiple of 16,
// n_pad (C_in) of 128, the plan's `tiles` tile codes over C_in columns and
// `fill_blocks` blocks for the rows it skips.  Returns a CUDA error.
extern "C" int masked_conv_dx_f32(const void* dy, const void* wt, const void* lengths,
                                  const void* plan, void* dx, int B, int T, int cin, int cout,
                                  int dy_pitch, int dx_pitch, int k_pad, int n_pad, int taps,
                                  int dilation, int tiles, int fill_blocks, void* stream) {
  Args a{};
  a.x = static_cast<const float*>(dy);
  a.wt = static_cast<const float*>(wt);
  a.lengths = static_cast<const int*>(lengths);
  a.plan = static_cast<const int*>(plan);
  a.y = static_cast<float*>(dx);
  a.B = B, a.T = T, a.cin = cout, a.cout = cin, a.x_pitch = dy_pitch, a.y_pitch = dx_pitch;
  a.k_pad = k_pad, a.n_pad = n_pad, a.taps = taps, a.dilation = dilation, a.tiles = tiles;
  a.fill_blocks = fill_blocks;
  return conv_launch(a, stream);
}

// dW (taps, cin, cout) and dbias (cout,) float32 from the conv input x (B,
// T) rows at x_pitch and dy (B, T) rows at dy_pitch (both multiples of 4
// channels, on 16 bytes), the plan of ops/masked_conv.py:dw_step_plan at
// 128 x 128 tiles and 16 positions a step (its n_items item codes, then
// taps * splits + 1 offsets, then the steps), one block an item; partial is
// (splits, taps, cin, cout) float32 scratch (unused with one split) and
// bias_part (B, cout).  Returns a CUDA error.
extern "C" int masked_conv_dw_f32(const void* x, const void* dy, const void* lengths,
                                  const void* plan, void* partial, void* bias_part, void* dw,
                                  void* db, int B, int T, int cin, int cout, int x_pitch,
                                  int dy_pitch, int taps, int dilation, int splits, int n_items,
                                  void* stream) {
  const int mtiles = (cin + DW_BM - 1) / DW_BM, ntiles = (cout + DW_BN - 1) / DW_BN;
  if (B <= 0 || B > 65535 || T <= 0 || T > 0xffff || cin <= 0 || cout <= 0 || taps <= 0 ||
      dilation <= 0 || splits <= 0 || x_pitch < cin || x_pitch % 4 != 0 || dy_pitch < cout ||
      dy_pitch % 4 != 0 || n_items != taps * splits * mtiles * ntiles || plan == nullptr ||
      (splits > 1 && partial == nullptr) || !aligned16(x) || !aligned16(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  DwArgs a{};
  a.x = static_cast<const float*>(x);
  a.dy = static_cast<const float*>(dy);
  a.items = static_cast<const int*>(plan);
  a.offsets = a.items + n_items;
  a.steps = a.offsets + taps * splits + 1;
  a.partial = static_cast<float*>(partial);
  a.dw = static_cast<float*>(dw);
  a.T = T, a.cin = cin, a.cout = cout, a.x_pitch = x_pitch, a.dy_pitch = dy_pitch;
  a.taps = taps, a.dilation = dilation, a.mtiles = mtiles, a.ntiles = ntiles;
  a.splits = splits;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  conv_dw_f32_kernel<<<n_items, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const long long total = static_cast<long long>(taps) * cin * cout;
    const long long blocks = (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096;
    dw_reduce_f32_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const float*>(partial), a.dw, total, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  seq_col_sums_f32_kernel<<<dim3((cout + SUM_COLS - 1) / SUM_COLS, B), SUM_COLS, 0, s>>>(
      a.dy, static_cast<const int*>(lengths), static_cast<float*>(bias_part), T, cout, dy_pitch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dbias_f32_kernel<<<(cout + 255) / 256, 256, 0, s>>>(static_cast<const float*>(bias_part),
                                                      static_cast<float*>(db), B, cout);
  return static_cast<int>(cudaGetLastError());
}
