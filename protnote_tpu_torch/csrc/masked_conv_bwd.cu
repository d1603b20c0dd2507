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
//     one GEMM a tap over the valid positions (K) on TMA + wgmma (below),
//     and dbias = bf16(sum G).  x and dy are read at pitches that are
//     multiples of 8.
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
// C_in).
//
// dW on TMA + wgmma (conv_dw_kernel), the pattern of K4-bwd's dW
// (pair_train_bwd.cu): dW[j] is a GEMM with M = C_in, N = C_out and K = the
// positions (b, t) whose output row t and input row t + s (s = d (j - half))
// are both valid.  A tile is 128 input channels x 192 output channels (550
// -> 3 x 192, 1100 -> 6 x 192; C_in 1100 -> 9 x 128, 550 -> 5 x 128, conv1's
// 20 one of 128); a K step is 64 positions of one sequence.
// * Persistent and warp-specialised: one producer thread keeps a 5-stage
//   ring of TMA boxes full (full/empty mbarriers), two consumer warpgroups
//   each own 64 input channels of the tile.  A stage is two 64 x 64 boxes of
//   x (rows t0 + s .. of sequence b, through the pitched 3-D map (C, T, B):
//   rows outside [0, T) and channels past C_in arrive as zeros, and a box
//   never crosses a sequence) and three of dy (rows t0 ..).
// * A = (mask x)^T is formed in registers: ldmatrix.trans from the
//   warpgroup's x box gives the A fragment (channels x positions), then a
//   select, not a multiply, zeroes the positions past the step's valid
//   count (t >= L, or t + s outside [0, L)), so stale or padded values
//   cannot become NaN; B is the dy box read MN-major through the transpose
//   bit.  One masked operand is enough: K is the positions.  A warpgroup
//   whose 64 channels all lie past C_in issues no products.
// * The work list is a host-built plan (ops/masked_conv.py:dw_step_plan,
//   built once per lengths tensor from the lengths the forward read back):
//   each tap's K steps in (sequence, position) order, cut into `splits`
//   ranges of nearly equal length, and the items (tap, split, row tile,
//   column tile), the most steps first.  With one split the epilogue rounds
//   dW to bf16; with more, each writes float32 partials that
//   dw_reduce_kernel adds in split order.  Either way every sum runs in one
//   fixed order: two calls give the same bits.
// dbias = bf16(sum G) from per-sequence column sums added in sequence order.
// What bounds dW now (chip_variants.py --k7 on an H100 80GB HBM3 at 700 W):
// the bytes its stages bring into shared memory, as K4-bwd's dW.  A dilated
// conv takes ~0.32-0.34 ms at dilations 1 and 9 (~275-286 TFLOP/s on the
// products these lengths need; cuDNN's backward filter 0.58-0.78); without
// the x boxes' loads 27% less, without the dy boxes' 23% less, while
// forming A, the position mask and the step reads cost nothing measurable.
// 243 items fill 1.84 waves of 132 blocks.

#include <algorithm>

#include "masked_conv.cuh"

using namespace k7;

namespace {

constexpr int DW_BM = 128;             // input channels of a tile: two warpgroups of 64
constexpr int DW_BN = 192;             // output channels of a tile: three 64-column boxes
constexpr int DW_BK = 64;              // positions of a K step
constexpr int DW_BOX = 64 * DW_BK * 2;  // one 64 x 64 bf16 box, 8 KB
constexpr int DW_X_BYTES = 2 * DW_BOX;
constexpr int DW_STAGE = DW_X_BYTES + (DW_BN / 64) * DW_BOX;  // 40 KB
constexpr int DW_STAGES = 5;
constexpr int DW_BAR_OFF = DW_STAGES * DW_STAGE;
constexpr int DW_SMEM = 1024 + DW_BAR_OFF + 2 * DW_STAGES * 8;  // + alignment slack
static_assert(DW_STAGE % 1024 == 0, "swizzle atoms");
static_assert(DW_SMEM <= SMEM_LIMIT, "shared memory");

struct DwArgs {
  const int* items;    // ((j * splits + sp) * mtiles + mt) * ntiles + nt, the most steps first
  const int* offsets;  // (taps * splits + 1): steps of (j, sp) are [offsets[j * splits + sp], next)
  const int* steps;    // two words a step: b, then t0 | rows << 16 (rows valid from t0)
  float* partial;      // (splits, taps, cin, cout), splits > 1
  __nv_bfloat16* dw;   // (taps, cin, cout)
  int taps, dilation, cin, cout, mtiles, ntiles, splits, n_items;
};

struct DwItem {
  int j, sp, m0, n0, k0, k1, s;
};

__device__ __forceinline__ DwItem dw_item(const DwArgs& a, int it) {
  const int code = a.items[it];
  DwItem w;
  const int u = code / a.ntiles;
  w.n0 = (code - u * a.ntiles) * DW_BN;
  const int v = u / a.mtiles;
  w.m0 = (u - v * a.mtiles) * DW_BM;
  w.j = v / a.splits;
  w.sp = v - w.j * a.splits;
  w.k0 = a.offsets[v];
  w.k1 = a.offsets[v + 1];
  w.s = a.dilation * (w.j - (a.taps - 1) / 2);
  return w;
}

__global__ void __launch_bounds__(THREADS, 1)
conv_dw_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dy,
               const DwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar0 = base + DW_BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (DW_STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
        const DwItem w = dw_item(a, it);
        for (int k = w.k0; k < w.k1; ++k) {
          const int b = a.steps[2 * k];
          const int t0 = a.steps[2 * k + 1] & 0xffff;
          mbar_wait(empty_bar(s), phase ^ 1u);
          const uint32_t st = base + s * DW_STAGE;
          mbar_expect_tx(full_bar(s), DW_STAGE);
          tma_load_3d(st, &tm_x, w.m0, t0 + w.s, b, full_bar(s));
          tma_load_3d(st + DW_BOX, &tm_x, w.m0 + 64, t0 + w.s, b, full_bar(s));
#pragma unroll
          for (int i = 0; i < DW_BN / 64; ++i)
            tma_load_3d(st + DW_X_BYTES + i * DW_BOX, &tm_dy, w.n0 + 64 * i, t0, b, full_bar(s));
          if (++s == DW_STAGES) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: A formed in registers, wgmma on the ring, the epilogue ---
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row (and row + 8): an input channel
  const int q = lane & 3;   // fragment column pair: positions 2q, 2q + 1 (+ 8)
  // ldmatrix.trans of the warpgroup's x box: for k-step kk, lane 8i + r
  // points at position row 16 kk + 8 (i >> 1) + r, 16-byte chunk 2 warp +
  // (i & 1) (channels 16 warp + 8 (i & 1) ..), whose place TMA's 128-byte
  // swizzle moved to chunk ^ r; matrices i = 0..3 are the A fragment's
  // a0..a3 (channels g, g + 8 x positions 2q, 2q + 8 of the k-step)
  const int li = lane >> 3;
  const int lr = lane & 7;
  const uint32_t ld_off = (8 * (li >> 1) + lr) * 128 + (((2 * warp + (li & 1)) ^ lr) << 4);
  float acc[DW_BN / 2];
  uint32_t fa[2][4][4];
  int s = 0;
  uint32_t phase = 0;
  // One stage: wait for its boxes, form (mask x)^T in fa[P] (positions at or
  // past the step's `rows` set to 0), issue its four products against the
  // dy boxes, then retire the previous stage's and free its slot.
  auto stage = [&](auto parity, bool first, bool live, int k, int& prev) {
    constexpr int P = decltype(parity)::value;
    mbar_wait(full_bar(s), phase);
    const uint32_t st = base + s * DW_STAGE;
    if (live) {
      const int rows = a.steps[2 * k + 1] >> 16;
      const uint32_t box = st + wg * DW_BOX;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t c[4];
        ldsm_x4_trans(c, box + kk * 16 * 128 + ld_off);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 16 * kk + 8 * (i >> 1) + 2 * q;  // the pair's first position
          const uint32_t keep = p + 1 < rows ? 0xffffffffu : p < rows ? 0x0000ffffu : 0u;
          fa[P][kk][i] = c[i] & keep;
        }
      }
      const uint64_t db = smem_desc_mn(st + DW_X_BYTES, DW_BOX);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 positions: 2048 bytes
        MmaRsT<DW_BN>::rs(acc, fa[P][kk], db + 128 * kk, !first || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_acc(acc);
      // the wgmma reads its register operands while in flight: the set that
      // fed the previous stage stays live (unreused) until here
      fence_regs(fa[1 - P]);
    }
    if (prev >= 0 && lane == 0) mbar_arrive(empty_bar(prev));
    prev = s;
    if (++s == DW_STAGES) {
      s = 0;
      phase ^= 1u;
    }
  };

  const bool even = (a.cout & 1) == 0;
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    const DwItem w = dw_item(a, it);
    const bool live = w.m0 + 64 * wg < a.cin;  // the warpgroup has a channel below C_in
    int prev = -1;
    for (int k = w.k0; k < w.k1; ++k) {
      if ((k - w.k0) & 1)
        stage(std::integral_constant<int, 1>(), k == w.k0, live, k, prev);
      else
        stage(std::integral_constant<int, 0>(), k == w.k0, live, k, prev);
    }
    if (live) {
      wgmma_wait<0>();
      fence_acc(acc);
      fence_regs(fa[0]);
      fence_regs(fa[1]);
    }
    if (prev >= 0 && lane == 0) mbar_arrive(empty_bar(prev));
    if (!live) continue;
    if (w.k1 == w.k0) {  // no valid position: zeros
#pragma unroll
      for (int i = 0; i < DW_BN / 2; ++i) acc[i] = 0.f;
    }
    // ---- epilogue: acc[4jn + 0/1] is channel c, columns 8 jn + 2q + 0/1;
    // acc[4jn + 2/3] channel c + 8 --------------------------------------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = w.m0 + wg * 64 + warp * 16 + g + 8 * h;
      if (c >= a.cin) continue;
      if (a.splits == 1) {
        __nv_bfloat16* row = a.dw + (static_cast<size_t>(w.j) * a.cin + c) * a.cout;
#pragma unroll
        for (int jn = 0; jn < DW_BN / 8; ++jn) {
          const int n = w.n0 + 8 * jn + 2 * q;
          if (n < a.cout)
            store_pair(row, n, a.cout, pack_bf16x2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]),
                       even);
        }
      } else {
        float* row =
            a.partial + ((static_cast<size_t>(w.sp) * a.taps + w.j) * a.cin + c) * a.cout;
#pragma unroll
        for (int jn = 0; jn < DW_BN / 8; ++jn) {
          const int n = w.n0 + 8 * jn + 2 * q;
          if (even && n + 1 < a.cout) {
            *reinterpret_cast<float2*>(row + n) =
                make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
          } else {
            if (n < a.cout) row[n] = acc[4 * jn + 2 * h];
            if (n + 1 < a.cout) row[n + 1] = acc[4 * jn + 2 * h + 1];
          }
        }
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
// rows at x_pitch and dy (B, T) rows at dy_pitch (both multiples of 8, the
// tensors 16-byte aligned), the plan of ops/masked_conv.py:dw_step_plan (its
// n_items item codes, then taps * splits + 1 offsets, then the steps), on
// `grid` persistent blocks; partial is (splits, taps, cin, cout) float32
// scratch (unused with one split) and bias_part (B, cout).
extern "C" int masked_conv_dw(const void* x, const void* dy, const void* lengths, const void* plan,
                              void* partial, void* bias_part, void* dw, void* db, int B, int T,
                              int cin, int cout, int x_pitch, int dy_pitch, int taps, int dilation,
                              int splits, int n_items, int grid, void* stream) {
  const int mtiles = (cin + DW_BM - 1) / DW_BM, ntiles = (cout + DW_BN - 1) / DW_BN;
  if (B <= 0 || T <= 0 || T > 0xffff || cin <= 0 || cout <= 0 || taps <= 0 || dilation <= 0 ||
      splits <= 0 || grid <= 0 || x_pitch < cin || x_pitch % 8 != 0 || dy_pitch < cout ||
      dy_pitch % 8 != 0 || n_items != taps * splits * mtiles * ntiles || plan == nullptr ||
      (splits > 1 && partial == nullptr) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_dy;
  memset(&tm_x, 0, sizeof(tm_x));
  memset(&tm_dy, 0, sizeof(tm_dy));
  if (!make_map_pitched(&tm_x, x, B, T, cin, x_pitch, DW_BK, 64, true) ||
      !make_map_pitched(&tm_dy, dy, B, T, cout, dy_pitch, DW_BK, 64, true))
    return static_cast<int>(cudaErrorInvalidValue);
  DwArgs a{};
  a.items = static_cast<const int*>(plan);
  a.offsets = a.items + n_items;
  a.steps = a.offsets + taps * splits + 1;
  a.partial = static_cast<float*>(partial);
  a.dw = static_cast<__nv_bfloat16*>(dw);
  a.taps = taps, a.dilation = dilation, a.cin = cin, a.cout = cout;
  a.mtiles = mtiles, a.ntiles = ntiles, a.splits = splits, a.n_items = n_items;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(conv_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_dw_kernel<<<std::min(grid, n_items), THREADS, DW_SMEM, s>>>(tm_x, tm_dy, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const long long total = static_cast<long long>(taps) * cin * cout;
    const long long blocks = std::min<long long>((total + 255) / 256, 4096);
    dw_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const float*>(partial), a.dw, total, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const __nv_bfloat16* dy_ = static_cast<const __nv_bfloat16*>(dy);
  const int* len = static_cast<const int*>(lengths);
  seq_col_sums_kernel<false><<<dim3((cout + SUM_COLS - 1) / SUM_COLS, B), SUM_WARPS * 32, 0, s>>>(
      dy_, len, static_cast<float*>(bias_part), T, cout, dy_pitch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dbias_tail_kernel<<<(cout + 255) / 256, 256, 0, s>>>(static_cast<const float*>(bias_part),
                                                      static_cast<__nv_bfloat16*>(db), B, cout);
  return static_cast<int>(cudaGetLastError());
}
