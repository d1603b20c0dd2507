// K7's conv mainloop on TMA + wgmma, shared by the masked dilated conv's
// forward (masked_conv.cu) and its input gradient (masked_conv_bwd.cu), and
// the per-sequence column sums of dbias (and of the pool's first design,
// variants/masked_pool_v1.cu; the pool is masked_pool.cu).
//
// Activations are channel-last bf16 (B, T, C) whose rows lie `pitch`
// elements apart (pitch >= C; the chain rounds it up to a multiple of 8, so
// that a row starts on 16 bytes and TMA can read it).  Position t of
// sequence b is valid when t < min(lengths[b], T); an invalid position reads
// as zero (the `x * mask` in front of every masked conv), and the "same"
// padding outside [0, T) is zero too.
//
// The conv is an implicit GEMM: rows are the positions (b, t), N the output
// channels, and K runs over (tap j, 64-channel chunk), A's rows read at
// t + step * (j - half) (step = dilation, or -dilation for dX).  A tile is
// BM = 128 positions of one sequence x BN = 184 columns (552 = 3 x 184 and
// 1104 = 6 x 184: the encoder's widths rounded up to 8 have no ragged tile).
//
// * Persistent and warp-specialised, as K1 and K4: one block an SM walks the
//   tiles of a host-built plan (ops/masked_conv.py:conv_tile_plan: the tiles
//   whose first row is valid, the most taps first) with stride gridDim.x.  One
//   producer thread keeps a ring of STAGES stages full by TMA, tracked by
//   full/empty mbarriers, with no block-wide barrier in the mainloop; two
//   consumer warpgroups issue wgmma m64n184k16 on their 64 rows of the tile.
// * A stage is one 128-byte-swizzled box of the activations (64 channels x
//   128 rows of sequence b, through a 3-D map (C, T, B): channels past C and
//   rows outside [0, T) arrive as zeros, and no box reaches into another
//   sequence) and the re-laid weights' tile (184 rows of 64 channels,
//   K-major, zero-padded: ops/masked_conv.py:conv_weight_layout).
// * A is formed in registers: ldmatrix reads the thread's fragment from the
//   swizzled box; the forward's optional prologue applies eval-mode BN and
//   ReLU, relu(bf16(x * inv + shift)); rows whose shifted position lies
//   outside [0, length) are set to 0 (relu(shift) is not 0, nor is a
//   train-mode BN output or dy past the length); then the register-A wgmma.
//   Two fragment sets: one stage's are formed while the last stage's
//   products still read the other.
// * Skips: a tile's taps whose shifted rows all lie outside the valid range,
//   and row tiles that start at or past the length (not in the plan: after
//   its tiles each block writes such rows, zeros or the residual).
// * The epilogue stores from the accumulators at the output's pitch,
//   clipped at N and T: the forward's bf16(acc), + bias rounded again, the
//   output mask, + residual rounded a third time; dX's mask * bf16(acc).

#pragma once

#include <limits.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace k7 {

constexpr int BM = 128;  // positions of a tile: two consumer warpgroups of 64
constexpr int BN = 184;  // columns of a tile
constexpr int BK = 64;   // channels of a K step: one 128-byte row of bf16
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int A_BYTES = BM * BK * 2;  // the activation box
constexpr int B_BYTES = BN * BK * 2;  // the weight tile
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int STAGES = 5;
constexpr int BAR_OFF = STAGES * STAGE;         // then the full and empty mbarriers
constexpr int BN_OFF = BAR_OFF + 2 * STAGES * 8;  // then the prologue's inv[k_pad], shift[k_pad]
static_assert(A_BYTES % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms");
constexpr int SUM_WARPS = 8;   // warps of a column-sum block, each on its own rows
constexpr int SUM_COLS = 64;   // columns of a column-sum block: a lane's pair

enum Mode { FWD = 0, FWD_BN = 1, DX = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

// The bf16 pair at columns (c, c + 1) of a row of width C, zero past C.  c
// is even; `even` says the row starts on 4 bytes (an even pitch), and then
// a whole pair is one 4-byte load.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row, int c, int C, bool even) {
  if (even && c + 1 < C) return __ldg(reinterpret_cast<const unsigned int*>(row + c));
  const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
  const uint32_t lo = c < C ? __ldg(h + c) : 0u;
  const uint32_t hi = c + 1 < C ? __ldg(h + c + 1) : 0u;
  return lo | (hi << 16);
}

// Stores the pair at columns (c, c + 1) of a row of width C, up to C (c and
// `even` as load_pair's).
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int C, uint32_t v,
                                           bool even) {
  if (even && c + 1 < C) {
    *reinterpret_cast<uint32_t*>(row + c) = v;
    return;
  }
  unsigned short* h = reinterpret_cast<unsigned short*>(row);
  if (c < C) h[c] = static_cast<unsigned short>(v & 0xffffu);
  if (c + 1 < C) h[c + 1] = static_cast<unsigned short>(v >> 16);
}

// four 8 x 8 bf16 matrices from shared memory: lane 8i + r gives the address
// of row r of matrix i, and the thread (lane 4g + q) receives columns 2q,
// 2q + 1 of row g of each (i = 0..3 into r[0..3])
__device__ __forceinline__ void ldsm_frag(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ int valid_length(const int* lengths, int b, int T) {
  return min(max(lengths[b], 0), T);
}

struct ConvArgs {
  const __nv_bfloat16* bias;      // (N,), the forward
  const float* bn_inv;            // (K,): the prologue's inv and shift (FWD_BN)
  const float* bn_shift;
  const __nv_bfloat16* residual;  // (B, T) rows at res_pitch, or null (the forward)
  const int* lengths;             // (B,)
  const int* plan;                // tile codes (b * mtiles + row tile) * ntiles + column tile
  __nv_bfloat16* y;               // (B, T) rows at y_pitch
  int B, T, K, N, k_pad, n_pad, taps, dilation, y_pitch, res_pitch, tiles, mtiles, ntiles;
};

struct ConvTile {
  int b, t0, n0, L, jlo, jhi;  // taps jlo..jhi read a valid row (none: jhi < jlo)
};

// Tile `code` of the plan and its taps: those whose shifted rows meet
// [0, L) for the tile's rows (ops/masked_conv.py:conv_tile_plan counts them).
template <bool DXM>
__device__ __forceinline__ ConvTile conv_tile(const ConvArgs& a, int code) {
  ConvTile tl;
  const int u = code / a.ntiles;
  tl.n0 = (code - u * a.ntiles) * BN;
  tl.b = u / a.mtiles;
  tl.t0 = (u - tl.b * a.mtiles) * BM;
  tl.L = valid_length(a.lengths, tl.b, a.T);
  const int half = (a.taps - 1) / 2;
  const int step = DXM ? -a.dilation : a.dilation;
  tl.jlo = a.taps;
  tl.jhi = -1;
  if (tl.t0 < tl.L) {
    for (int j = 0; j < a.taps; ++j) {
      const int s = step * (j - half);
      if (tl.t0 + s < tl.L && tl.t0 + BM + s > 0) {
        tl.jlo = min(tl.jlo, j);
        tl.jhi = max(tl.jhi, j);
      }
    }
  }
  return tl;
}

// The conv over output rows: MODE FWD (x, W^T), FWD_BN (with the eval-mode
// BN + ReLU prologue) or DX (dy, W; the shifts negated).  tm_x maps the
// input (K, T, B) at its pitch, box (64, 128, 1); tm_w the re-laid weights
// (taps * n_pad, k_pad), box (184, 64).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
conv_tma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                const ConvArgs a) {
  constexpr bool DXM = MODE == DX;
  constexpr bool PRO = MODE == FWD_BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (STAGES + s); };
  const int chunks = a.k_pad / BK;
  const int half = (a.taps - 1) / 2;
  const int step = DXM ? -a.dilation : a.dilation;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the prologue's inv[k_pad] and shift[k_pad], 0 past K (a padding channel
  // reads relu(bf16(0 * 0 + 0)) = 0)
  float* s_bn = reinterpret_cast<float*>(smem + BN_OFF);
  if (PRO)
    for (int i = threadIdx.x; i < a.k_pad; i += THREADS) {
      s_bn[i] = i < a.K ? a.bn_inv[i] : 0.f;
      s_bn[a.k_pad + i] = i < a.K ? a.bn_shift[i] : 0.f;
    }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const ConvTile tl = conv_tile<DXM>(a, a.plan[t]);
        for (int j = tl.jlo; j <= tl.jhi; ++j) {
          const int src = tl.t0 + step * (j - half);
          for (int c = 0; c < chunks; ++c) {
            mbar_wait(empty_bar(s), phase ^ 1u);
            const uint32_t st = base + s * STAGE;
            mbar_expect_tx(full_bar(s), STAGE);
            tma_load_3d(st, &tm_x, c * BK, src, tl.b, full_bar(s));
            tma_load(st + A_BYTES, &tm_w, c * BK, j * a.n_pad + tl.n0, full_bar(s));
            if (++s == STAGES) {
              s = 0;
              phase ^= 1u;
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: wgmma on the ring, then the epilogue --------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int q = lane & 3;   // fragment column pair
  const int row = wg * 64 + warp * 16 + g;  // the thread's first row of the tile
  // the row whose 16 bytes this lane addresses for ldmatrix, and its chunk
  // offset: matrices (rows 0-7 | 8-15) x (channels 0-7 | 8-15) of a k-step
  const int lrow = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhi = lane >> 4;
  float acc[BN / 2];
  uint32_t fa[2][4][4];
  int s = 0;
  uint32_t phase = 0;
  // One stage: wait for its boxes, form A into fa[P] (prologue, row mask),
  // issue its four products, then retire the previous stage's and free its
  // slot.  `shift` is the tap's row offset, c0 the chunk's first channel.
  auto stage = [&](auto parity, bool first, int t0, int L, int shift, int c0, int& prev) {
    constexpr int P = decltype(parity)::value;
    mbar_wait(full_bar(s), phase);
    const uint32_t st = base + s * STAGE;
    const uint64_t db = smem_desc(st + A_BYTES);
    const int src = t0 + row + shift;
    const bool v0 = src >= 0 && src < L;
    const bool v1 = src + 8 >= 0 && src + 8 < L;
    const uint32_t abox = st + lrow * 128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_frag(fa[P][kk], abox + (((2 * kk + lhi) ^ (lane & 7)) << 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t v = fa[P][kk][i];
        if (PRO) {  // relu(bf16(x * inv + shift)) of channels ch, ch + 1
          const int ch = c0 + kk * 16 + (i >> 1) * 8 + 2 * q;
          const float2 f = unpack(v);
          const float2 iv = *reinterpret_cast<const float2*>(s_bn + ch);
          const float2 sh = *reinterpret_cast<const float2*>(s_bn + a.k_pad + ch);
          __nv_bfloat162 h = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(f.x, iv.x), sh.x),
                                                   __fadd_rn(__fmul_rn(f.y, iv.y), sh.y));
          h = __hmax2(h, __float2bfloat162_rn(0.f));  // ReLU of the bf16 values: exact
          v = *reinterpret_cast<uint32_t*>(&h);
        }
        fa[P][kk][i] = ((i & 1) ? v1 : v0) ? v : 0u;
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<BN>::rs(acc, fa[P][kk], db + 2 * kk, !first || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    fence_acc(acc);
    fence_regs(fa[1 - P]);
    if (prev >= 0 && lane == 0) mbar_arrive(empty_bar(prev));
    prev = s;
    if (++s == STAGES) {
      s = 0;
      phase ^= 1u;
    }
  };

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const ConvTile tl = conv_tile<DXM>(a, a.plan[t]);
    const int steps = (tl.jhi - tl.jlo + 1) * chunks;  // >= chunks: the centre tap reads row t
    int prev = -1, j = tl.jlo, c = 0;
    auto next = [&]() {
      if (++c == chunks) {
        c = 0;
        ++j;
      }
    };
    int it = 0;
    for (; it + 1 < steps; it += 2) {
      stage(std::integral_constant<int, 0>(), it == 0, tl.t0, tl.L, step * (j - half), c * BK,
            prev);
      next();
      stage(std::integral_constant<int, 1>(), false, tl.t0, tl.L, step * (j - half), c * BK,
            prev);
      next();
    }
    if (it < steps)
      stage(std::integral_constant<int, 0>(), it == 0, tl.t0, tl.L, step * (j - half), c * BK,
            prev);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(fa[0]);
    fence_regs(fa[1]);
    if (lane == 0) mbar_arrive(empty_bar(prev));

    // ---- epilogue: acc[4jn + 0/1] is row `row`, columns 8 jn + 2q + 0/1;
    // acc[4jn + 2/3] row + 8.  A row's bias and residual pairs are loaded
    // before its stores: y aliases neither, but the compiler cannot know,
    // and loads between the stores would wait for each other --------------
    const bool y_even = (a.y_pitch & 1) == 0, r_even = (a.res_pitch & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = tl.t0 + row + 8 * h;
      if (tt >= a.T) continue;
      const size_t pos = static_cast<size_t>(tl.b) * a.T + tt;
      __nv_bfloat16* yrow = a.y + pos * a.y_pitch;
      const __nv_bfloat16* rrow = a.residual != nullptr ? a.residual + pos * a.res_pitch : nullptr;
      const bool live = tt < tl.L;
      uint32_t bias_v[BN / 8], res_v[BN / 8];
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const int n = tl.n0 + 8 * jn + 2 * q;
        bias_v[jn] = !DXM && n < a.N ? load_pair(a.bias, n, a.N, true) : 0u;
        res_v[jn] = !DXM && rrow != nullptr && n < a.N ? load_pair(rrow, n, a.N, r_even) : 0u;
      }
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const int n = tl.n0 + 8 * jn + 2 * q;
        if (n >= a.N) continue;
        float v0 = bf16_round(acc[4 * jn + 2 * h]), v1 = bf16_round(acc[4 * jn + 2 * h + 1]);
        if (!DXM) {
          const float2 bb = unpack(bias_v[jn]);
          v0 = bf16_round(v0 + bb.x);
          v1 = bf16_round(v1 + bb.y);
        }
        if (!live) v0 = v1 = 0.f;
        if (!DXM && rrow != nullptr) {
          const float2 rr = unpack(res_v[jn]);
          v0 = rr.x + v0;
          v1 = rr.y + v1;
        }
        store_pair(yrow, n, a.N, pack_bf16x2(v0, v1), y_even);
      }
    }
  }

  // ---- rows of the row tiles that start at or past the length: zeros, or
  // the residual (residual + 0 is the residual), a warp a row, eight pairs
  // a lane loaded before they are stored ---------------------------------------
  constexpr int TAIL = 8;
  const int cw = threadIdx.x / 32;  // 0 .. 4 * CONSUMERS - 1
  const long long warps = static_cast<long long>(gridDim.x) * 4 * CONSUMERS;
  const long long rows = static_cast<long long>(a.B) * a.T;
  const bool y_even = (a.y_pitch & 1) == 0, r_even = (a.res_pitch & 1) == 0;
  for (long long r = static_cast<long long>(blockIdx.x) * 4 * CONSUMERS + cw; r < rows;
       r += warps) {
    const int b = static_cast<int>(r / a.T);
    const int tt = static_cast<int>(r - static_cast<long long>(b) * a.T);
    const int L = valid_length(a.lengths, b, a.T);
    if (tt < min((L + BM - 1) / BM * BM, a.T)) continue;
    __nv_bfloat16* yrow = a.y + r * a.y_pitch;
    const __nv_bfloat16* rrow =
        !DXM && a.residual != nullptr ? a.residual + r * a.res_pitch : nullptr;
    for (int n0 = 2 * lane; n0 < a.N; n0 += 64 * TAIL) {
      uint32_t v[TAIL];
#pragma unroll
      for (int u = 0; u < TAIL; ++u) {
        const int n = n0 + 64 * u;
        v[u] = rrow != nullptr && n < a.N ? load_pair(rrow, n, a.N, r_even) : 0u;
      }
#pragma unroll
      for (int u = 0; u < TAIL; ++u) store_pair(yrow, n0 + 64 * u, a.N, v[u], y_even);
    }
  }
}

// Checks a launch's shapes and pointers, encodes its two tensor maps and
// launches; cudaErrorInvalidValue for what the kernel does not take: an
// input pitch that is not a multiple of 8 or below K, an input or weight
// pointer off 16 bytes, paddings other than K rounded up to 64 and N to 184.
inline int conv_launch(int mode, const void* x, int x_pitch, const void* w, ConvArgs a, int grid,
                       void* stream) {
  if (a.B <= 0 || a.T <= 0 || a.K <= 0 || a.N <= 0 || a.taps <= 0 || a.dilation <= 0 ||
      x_pitch < a.K || x_pitch % 8 != 0 || a.y_pitch < a.N ||
      (a.residual != nullptr && a.res_pitch < a.N) ||
      a.k_pad != (a.K + BK - 1) / BK * BK || a.n_pad != (a.N + BN - 1) / BN * BN ||
      a.tiles < 0 || (a.tiles > 0 && a.plan == nullptr) || grid <= 0 ||
      (mode == FWD_BN && (a.bn_inv == nullptr || a.bn_shift == nullptr)) ||
      (mode != DX && a.bias == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      static_cast<long long>(a.taps) * a.n_pad > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = 1024 + BN_OFF + (mode == FWD_BN ? 8 * a.k_pad : 0);
  if (bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  a.mtiles = (a.T + BM - 1) / BM;
  a.ntiles = a.n_pad / BN;
  CUtensorMap tm_x, tm_w;
  memset(&tm_x, 0, sizeof(tm_x));
  memset(&tm_w, 0, sizeof(tm_w));
  if (!make_map_pitched(&tm_x, x, a.B, a.T, a.K, x_pitch, BM, BK, true) ||
      !make_map(&tm_w, w, MapType::BF16, static_cast<uint64_t>(a.taps) * a.n_pad, a.k_pad, BN, BK,
                true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto kernel = mode == FWD ? conv_tma_kernel<FWD>
                : mode == FWD_BN ? conv_tma_kernel<FWD_BN> : conv_tma_kernel<DX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, bytes, s>>>(tm_x, tm_w, a);
  return static_cast<int>(cudaGetLastError());
}

// Column sums over the valid rows of each sequence, in a fixed order: block
// (column group, b) sums rows t < min(lengths[b], T) of sequence b (rows
// `pitch` elements apart), each warp every SUM_WARPS-th row, then the warps
// in order.  POOL writes sum / max(lengths[b], 1) (the masked mean pool,
// float32 (B, C)), else the sums themselves (a partial row b of a (B, C)
// buffer).
template <bool POOL>
__global__ void __launch_bounds__(SUM_WARPS * 32)
seq_col_sums_kernel(const __nv_bfloat16* __restrict__ X, const int* __restrict__ lengths,
                    float* __restrict__ out, int T, int C, int pitch) {
  __shared__ float s0[SUM_WARPS][32], s1[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int c = blockIdx.x * SUM_COLS + 2 * lane;
  const int L = valid_length(lengths, b, T);
  const __nv_bfloat16* Xb = X + static_cast<size_t>(b) * T * pitch;
  const bool even = (pitch & 1) == 0;
  float a0 = 0.f, a1 = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int t = warp; t < L; t += SUM_WARPS) {
      const float2 f = unpack(load_pair(Xb + static_cast<size_t>(t) * pitch, c, C, even));
      a0 += f.x;
      a1 += f.y;
    }
  }
  s0[warp][lane] = a0;
  s1[warp][lane] = a1;
  __syncthreads();
  if (warp != 0 || c >= C) return;
  a0 = s0[0][lane];
  a1 = s1[0][lane];
#pragma unroll
  for (int w = 1; w < SUM_WARPS; ++w) {
    a0 += s0[w][lane];
    a1 += s1[w][lane];
  }
  if (POOL) {
    const float d = fmaxf(static_cast<float>(lengths[b]), 1.f);
    a0 = __fdiv_rn(a0, d);
    a1 = __fdiv_rn(a1, d);
  }
  float* o = out + static_cast<size_t>(b) * C;
  o[c] = a0;
  if (c + 1 < C) o[c + 1] = a1;
}

}  // namespace k7
