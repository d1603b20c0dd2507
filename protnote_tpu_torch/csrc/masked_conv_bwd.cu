// K7's backward for Hopper (sm_90a): the gradients of the masked dilated
// conv y = mask * (bf16(conv(mask * x, W)) + b), given dy (bf16).
//
// Replaces the autodiff of protnote_tpu/models/proteinfer.py:_masked_conv
// (line 127).  With G = mask * dy (the output mask, applied as G is read):
//   masked_conv_dx: dX = mask * bf16(sum_j sum_n G[t - d (j - half), n] W[j, c, n]),
//     the transposed dilated conv on the forward's mainloop (masked_conv.cuh)
//     with the taps' shifts negated and W read with C_in as its N dimension;
//   masked_conv_dw: dW[j] = bf16(sum_{b, t} (mask x)[t + d (j - half)]^T G[t]),
//     one GEMM a tap over the B * T positions (K), C_in x C_out tiles, both
//     operands read K-major through ldmatrix.trans.  The positions are split
//     by sequence into `splits` float32 partial sums, added by a second
//     kernel in split order (the same bits every call); dbias = bf16(sum G)
//     from per-sequence column sums added in sequence order.
// Each gradient is rounded to bf16 once, after its float32 sum, as JAX's
// transposed convs with float32 accumulation would; conv1 needs no dX (its
// input is the one-hot).
//
// What bounds it: operations.  dX and dW each repeat the forward's products
// (dX all but conv1's), about 2 TFLOP for a 32-sequence batch at bucket 512,
// ~2 ms at 989 TFLOP/s.  Rows a block tile never reaches (past a sequence's
// length, or a tap's shift beyond it) are skipped.

#include <algorithm>

#include "masked_conv.cuh"

using namespace k7;

namespace {

__global__ void __launch_bounds__(THREADS)
conv_dw_kernel(const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ G,
               const int* __restrict__ lengths, float* __restrict__ partial, int B, int T,
               int cin, int cout, int taps, int dilation, int splits) {
  __shared__ __align__(16) __nv_bfloat16 As[2][TILE_KN];  // [BK positions][BM input channels]
  __shared__ __align__(16) __nv_bfloat16 Bs[2][TILE_KN];  // [BK positions][BN output channels]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int j = blockIdx.z % taps, split = blockIdx.z / taps;
  const int s = dilation * (j - (taps - 1) / 2);
  const int b_end = static_cast<int>(static_cast<long long>(B) * (split + 1) / splits);
  const int t_lo = max(0, -s);
  // positions t of sequence b with a nonzero G row (t < L) and a nonzero
  // input row (0 <= t + s < L): [t_lo, t_hi(b))
  auto t_hi = [&](int b) {
    const int L = valid_length(lengths, b, T);
    return min(L, L - s);
  };
  // the cursor of the next tile to load: sequence cb, first position ct
  int cb = static_cast<int>(static_cast<long long>(B) * split / splits), ct = t_lo;
  auto settle = [&]() {
    while (cb < b_end && ct >= t_hi(cb)) {
      ++cb;
      ct = t_lo;
    }
  };

  uint32_t ra[LOADS], rb[LOADS];
  auto load = [&]() {
    const int th = t_hi(cb);
    const __nv_bfloat16* Xb = X + static_cast<size_t>(cb) * T * cin;
    const __nv_bfloat16* Gb = G + static_cast<size_t>(cb) * T * cout;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int w = tid + i * THREADS;
      const int t = ct + (w >> 6);
      const int col = 2 * (w & 63);
      const bool ok = t < th;
      ra[i] = ok ? load_pair(Xb + static_cast<size_t>(t + s) * cin, m0 + col, cin) : 0u;
      rb[i] = ok ? load_pair(Gb + static_cast<size_t>(t) * cout, n0 + col, cout) : 0u;
    }
    ct += BK;
    settle();
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int w = tid + i * THREADS;
      store_smem(As[buf], (w >> 6) * LD_KN + 2 * (w & 63), ra[i]);
      store_smem(Bs[buf], (w >> 6) * LD_KN + 2 * (w & 63), rb[i]);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  settle();
  bool have = cb < b_end;
  if (have) {
    load();
    store(0);
  }
  __syncthreads();
  int cur = 0;
  while (have) {
    const bool next = cb < b_end;
    if (next) load();
    mma_step<true, false>(acc, As[cur], Bs[cur], warp_m, warp_n, lane);
    if (next) store(cur ^ 1);
    __syncthreads();
    cur ^= 1;
    have = next;
  }

  float* P = partial + (static_cast<size_t>(split) * taps + j) * cin * cout;
  const int g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = m0 + warp_m * 32 + mi * 16 + g + h * 8;
      if (c >= cin) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = n0 + warp_n * 64 + ni * 8 + 2 * qd;
        if (n < cout) P[static_cast<size_t>(c) * cout + n] = acc[mi][ni][2 * h];
        if (n + 1 < cout) P[static_cast<size_t>(c) * cout + n + 1] = acc[mi][ni][2 * h + 1];
      }
    }
  }
}

// dW = bf16(sum of the splits' partials, in split order).
__global__ void dw_reduce_kernel(const float* __restrict__ partial, __nv_bfloat16* __restrict__ dw,
                                 long long total, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = partial[i];
    for (int sp = 1; sp < splits; ++sp) acc += partial[sp * total + i];
    dw[i] = __float2bfloat16_rn(acc);
  }
}

// dbias = bf16(sum over sequences, in order, of their column sums).
__global__ void dbias_tail_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ db,
                                  int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[static_cast<size_t>(b) * C + c];
  db[c] = __float2bfloat16_rn(acc);
}

}  // namespace

// dX (B*T, cin) bf16 from dy (B*T, cout) and W (taps, cin, cout).
extern "C" int masked_conv_dx(const void* dy, const void* w, const void* lengths, void* dx,
                              int B, int T, int cin, int cout, int taps, int dilation,
                              void* stream) {
  if (B <= 0 || T <= 0 || cin <= 0 || cout <= 0 || taps <= 0 || dilation <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((cin + BN - 1) / BN, conv_rows_grid_y(B, T));
  conv_rows_kernel<true><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(w), nullptr,
      nullptr, nullptr, nullptr, static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(dx), T, cout, cin, taps, dilation);
  return static_cast<int>(cudaGetLastError());
}

// dW (taps, cin, cout) and dbias (cout,) bf16 from the conv input x
// (B*T, cin) and dy (B*T, cout); partial is (splits, taps, cin, cout) and
// bias_part (B, cout) float32 scratch.
extern "C" int masked_conv_dw(const void* x, const void* dy, const void* lengths, void* partial,
                              void* bias_part, void* dw, void* db, int B, int T, int cin,
                              int cout, int taps, int dilation, int splits, void* stream) {
  if (B <= 0 || T <= 0 || cin <= 0 || cout <= 0 || taps <= 0 || dilation <= 0 || splits <= 0 ||
      splits > B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* dy_ = static_cast<const __nv_bfloat16*>(dy);
  const int* len = static_cast<const int*>(lengths);
  conv_dw_kernel<<<dim3((cout + BN - 1) / BN, (cin + BM - 1) / BM, taps * splits), THREADS, 0,
                   s>>>(static_cast<const __nv_bfloat16*>(x), dy_, len,
                        static_cast<float*>(partial), B, T, cin, cout, taps, dilation, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(taps) * cin * cout;
  const long long blocks = std::min<long long>((total + 255) / 256, 4096);
  dw_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(dw), total, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seq_col_sums_kernel<false><<<dim3((cout + SUM_COLS - 1) / SUM_COLS, B), SUM_WARPS * 32, 0, s>>>(
      dy_, len, static_cast<float*>(bias_part), T, cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dbias_tail_kernel<<<(cout + 255) / 256, 256, 0, s>>>(static_cast<const float*>(bias_part),
                                                      static_cast<__nv_bfloat16*>(db), B, cout);
  return static_cast<int>(cudaGetLastError());
}
