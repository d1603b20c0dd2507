// K7's backward for Hopper (sm_90a): the gradients of the masked dilated
// conv y = mask * (bf16(conv(mask * x, W)) + b), given dy (bf16).
//
// Replaces the autodiff of protnote_tpu/models/proteinfer.py:_masked_conv
// (line 127).  With G = mask * dy (the output mask, applied as G is read):
//   masked_conv_dx: dX = mask * bf16(sum_j sum_n G[t - d (j - half), n] W[j, c, n]),
//     the transposed dilated conv on the forward's TMA + wgmma mainloop
//     (masked_conv.cuh) with the taps' shifts negated, W re-laid as (taps,
//     C_in rounded up to 184, C_out rounded up to 64) (W[j] itself,
//     zero-padded: C_in is its N, C_out its K) and dy read at a pitch that
//     is a multiple of 8;
//   masked_conv_dw: dW[j] = bf16(sum_{b, t} (mask x)[t + d (j - half)]^T G[t]),
//     one GEMM a tap over the B * T positions (K), C_in x C_out tiles, both
//     operands read K-major through ldmatrix.trans on mma.sync.  The
//     positions are split by sequence into `splits` float32 partial sums,
//     added by a second kernel in split order (the same bits every call);
//     dbias = bf16(sum G) from per-sequence column sums added in sequence
//     order.  x and dy are read at their row pitches.
// Each gradient is rounded to bf16 once, after its float32 sum, as JAX's
// transposed convs with float32 accumulation would; conv1 needs no dX (its
// input is the one-hot).
//
// What bounds them: operations.  dX and dW each repeat the forward's
// products (dX all but conv1's), about 0.47 TFLOP for a 32-sequence batch at
// bucket 512 and these lengths, ~0.47 ms at 989 TFLOP/s.  dX's 10 calls take
// about 1.4 ms in the kernel on an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 18), ~2.0 with the wrapper's copy of dy to the padded pitch and the
// weights' re-layout (cuDNN's backward data ~3.4): the forward's limits
// (whole tiles and taps, a third more products than needed; K steps fed
// from L2), and twice the forward's column tiles at half the depth (N is
// C_in).  dW (~6.4 ms, cuDNN's
// backward filter ~4.4) is bound by its mma.sync mainloop: 4-byte
// register-staged loads and a block barrier every 32-deep step.  Rows a tile
// never reaches (past a sequence's length, or a tap's shift beyond it) are
// skipped.

#include <algorithm>

#include "masked_conv.cuh"

using namespace k7;

namespace {

// dW's mma.sync GEMM: 128 x 128 block tiles with a depth of 32, eight warps
// of 32 x 64; each step loads its next tiles into registers (4-byte bf16
// pairs) and stores them into the other of two shared-memory buffers.
constexpr int DW_BM = 128, DW_BN = 128, DW_BK = 32;
constexpr int DW_THREADS = 256;       // eight warps: 4 along M x 2 along N
constexpr int MT = 2, NT = 8;         // a warp's m16 and n8 tiles (32 x 64)
constexpr int LD_KN = DW_BN + 8;      // a [32][128] tile's row pitch (bank-conflict free)
constexpr int TILE_KN = DW_BK * LD_KN;
constexpr int LOADS = DW_BM * DW_BK / 2 / DW_THREADS;  // bf16 pairs a thread loads a tile: 8

__device__ __forceinline__ void ldsm_x4_trans_p(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_smem(__nv_bfloat16* tile, int idx, uint32_t v) {
  *reinterpret_cast<uint32_t*>(tile + idx) = v;
}

// One DW_BK-deep step of the block tile: acc += A^T B from shared memory,
// A [DW_BK][LD_KN] (K rows, M contiguous) and B [DW_BK][LD_KN] (K rows, N
// contiguous), both through ldmatrix.trans.
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs, int warp_m, int warp_n,
                                         int lane) {
  const int q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < DW_BK; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int m0 = warp_m * 32 + mi * 16;
      ldsm_x4_trans_p(a[mi], As + (kk + r + (q >> 1) * 8) * LD_KN + m0 + (q & 1) * 8);
    }
#pragma unroll
    for (int nj = 0; nj < NT; nj += 2) {
      const int n0 = warp_n * 64 + nj * 8;
      uint32_t b[4];
      ldsm_x4_trans_p(b, Bs + (kk + r + (q & 1) * 8) * LD_KN + n0 + (q >> 1) * 8);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_bf16(acc[mi][nj], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

__global__ void __launch_bounds__(DW_THREADS)
conv_dw_kernel(const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ G,
               const int* __restrict__ lengths, float* __restrict__ partial, int B, int T,
               int cin, int cout, int x_pitch, int g_pitch, int taps, int dilation, int splits) {
  __shared__ __align__(16) __nv_bfloat16 As[2][TILE_KN];  // [BK positions][BM input channels]
  __shared__ __align__(16) __nv_bfloat16 Bs[2][TILE_KN];  // [BK positions][BN output channels]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int n0 = blockIdx.x * DW_BN, m0 = blockIdx.y * DW_BM;
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

  const bool x_even = (x_pitch & 1) == 0, g_even = (g_pitch & 1) == 0;
  uint32_t ra[LOADS], rb[LOADS];
  auto load = [&]() {
    const int th = t_hi(cb);
    const __nv_bfloat16* Xb = X + static_cast<size_t>(cb) * T * x_pitch;
    const __nv_bfloat16* Gb = G + static_cast<size_t>(cb) * T * g_pitch;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int w = tid + i * DW_THREADS;
      const int t = ct + (w >> 6);
      const int col = 2 * (w & 63);
      const bool ok = t < th;
      ra[i] = ok ? load_pair(Xb + static_cast<size_t>(t + s) * x_pitch, m0 + col, cin, x_even)
                 : 0u;
      rb[i] = ok ? load_pair(Gb + static_cast<size_t>(t) * g_pitch, n0 + col, cout, g_even) : 0u;
    }
    ct += DW_BK;
    settle();
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int w = tid + i * DW_THREADS;
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
    mma_step(acc, As[cur], Bs[cur], warp_m, warp_n, lane);
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

// dX (B, T) rows at dx_pitch, bf16, from dy (B, T) rows at dy_pitch (a
// multiple of 8), the re-laid weights w (taps, n_pad, k_pad) and the plan's
// `tiles` tile codes; `grid` persistent blocks.
extern "C" int masked_conv_dx(const void* dy, const void* w, const void* lengths, const void* plan,
                              void* dx, int B, int T, int cin, int cout, int dy_pitch,
                              int dx_pitch, int k_pad, int n_pad, int taps, int dilation,
                              int tiles, int grid, void* stream) {
  ConvArgs a{};
  a.lengths = static_cast<const int*>(lengths);
  a.plan = static_cast<const int*>(plan);
  a.y = static_cast<__nv_bfloat16*>(dx);
  a.B = B, a.T = T, a.K = cout, a.N = cin, a.k_pad = k_pad, a.n_pad = n_pad, a.taps = taps;
  a.dilation = dilation, a.y_pitch = dx_pitch, a.res_pitch = 0, a.tiles = tiles;
  return conv_launch(DX, dy, dy_pitch, w, a, grid, stream);
}

// dW (taps, cin, cout) and dbias (cout,) bf16 from the conv input x (B, T)
// rows at x_pitch and dy (B, T) rows at dy_pitch; partial is (splits, taps,
// cin, cout) and bias_part (B, cout) float32 scratch.
extern "C" int masked_conv_dw(const void* x, const void* dy, const void* lengths, void* partial,
                              void* bias_part, void* dw, void* db, int B, int T, int cin,
                              int cout, int x_pitch, int dy_pitch, int taps, int dilation,
                              int splits, void* stream) {
  if (B <= 0 || T <= 0 || cin <= 0 || cout <= 0 || taps <= 0 || dilation <= 0 || splits <= 0 ||
      splits > B || x_pitch < cin || dy_pitch < cout)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* dy_ = static_cast<const __nv_bfloat16*>(dy);
  const int* len = static_cast<const int*>(lengths);
  conv_dw_kernel<<<dim3((cout + DW_BN - 1) / DW_BN, (cin + DW_BM - 1) / DW_BM, taps * splits),
                   DW_THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x), dy_, len,
                                       static_cast<float*>(partial), B, T, cin, cout, x_pitch,
                                       dy_pitch, taps, dilation, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(taps) * cin * cout;
  const long long blocks = std::min<long long>((total + 255) / 256, 4096);
  dw_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(dw), total, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seq_col_sums_kernel<false><<<dim3((cout + SUM_COLS - 1) / SUM_COLS, B), SUM_WARPS * 32, 0, s>>>(
      dy_, len, static_cast<float*>(bias_part), T, cout, dy_pitch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dbias_tail_kernel<<<(cout + 255) / 256, 256, 0, s>>>(static_cast<const float*>(bias_part),
                                                      static_cast<__nv_bfloat16*>(db), B, cout);
  return static_cast<int>(cudaGetLastError());
}
