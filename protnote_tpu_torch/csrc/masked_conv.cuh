// K7's implicit-GEMM mainloop and column sums, shared by the masked dilated
// conv's forward (masked_conv.cu) and backward (masked_conv_bwd.cu).
//
// Activations are channel-last bf16 rows, (B * T, C) with row b * T + t, and
// a conv kernel is the JAX layout (taps, C_in, C_out).  Position t of
// sequence b is valid when t < min(lengths[b], T); an invalid position reads
// as zero (the `x * mask` in front of every masked conv) and the "same"
// padding outside [0, T) is zero too.
//
// The GEMM is mma.sync m16n8k16 (bf16 in, f32 accumulate) on 128 x 128
// block tiles with a depth of 32, eight warps of 32 x 64.  Each step of the
// K loop loads its next tiles from device memory into registers (4-byte bf16
// pairs, so any even channel count is aligned, and odd counts load each
// value alone), runs the current tiles from shared memory, then stores the
// registers into the other of two shared-memory buffers.  ldmatrix (.trans
// where a tile is stored with its K dimension as rows) forms the fragments;
// rows are padded by 8 bf16 (16 bytes), which keeps the eight row addresses
// of each 8 x 8 matrix on distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace k7 {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;          // eight warps: 4 along M x 2 along N
constexpr int MT = 2, NT = 8;         // a warp's m16 and n8 tiles (32 x 64)
constexpr int LD_MK = BK + 8;         // a [128][32] tile's row pitch
constexpr int LD_KN = BN + 8;         // a [32][128] tile's row pitch
constexpr int TILE_MK = BM * LD_MK;   // bf16 elements
constexpr int TILE_KN = BK * LD_KN;
constexpr int LOADS = BM * BK / 2 / THREADS;  // bf16 pairs a thread loads a tile: 8
constexpr int SUM_WARPS = 8;          // warps of a column-sum block, each on its own rows
constexpr int SUM_COLS = 64;          // columns of a column-sum block: a lane's pair

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bf16 pair at columns (c, c + 1) of a row of width C, zero past C.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row, int c, int C) {
  if ((C & 1) == 0) return c < C ? __ldg(reinterpret_cast<const unsigned int*>(row + c)) : 0u;
  const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
  const uint32_t lo = c < C ? __ldg(h + c) : 0u;
  const uint32_t hi = c + 1 < C ? __ldg(h + c + 1) : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Stores the pair at columns (c, c + 1) of a row of width C, up to C.
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int C, uint32_t v) {
  if ((C & 1) == 0) {
    if (c < C) *reinterpret_cast<uint32_t*>(row + c) = v;
    return;
  }
  unsigned short* h = reinterpret_cast<unsigned short*>(row);
  if (c < C) h[c] = static_cast<unsigned short>(v & 0xffffu);
  if (c + 1 < C) h[c + 1] = static_cast<unsigned short>(v >> 16);
}

__device__ __forceinline__ void store_smem(__nv_bfloat16* tile, int idx, uint32_t v) {
  *reinterpret_cast<uint32_t*>(tile + idx) = v;
}

// One BK-deep step of the block tile: acc += A * B from shared memory.
// A is [BM][LD_MK] (M rows, K contiguous) or, with A_KM, [BK][LD_KN] (K
// rows, M contiguous); B is [BK][LD_KN] (K rows, N contiguous) or, with
// B_NK, [BN][LD_MK] (N rows, K contiguous).
template <bool A_KM, bool B_NK>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs, int warp_m, int warp_n,
                                         int lane) {
  const int q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int m0 = warp_m * 32 + mi * 16;
      if (A_KM)
        ldsm_x4_trans(a[mi], As + (kk + r + (q >> 1) * 8) * LD_KN + m0 + (q & 1) * 8);
      else
        ldsm_x4(a[mi], As + (m0 + (lane & 15)) * LD_MK + kk + (lane >> 4) * 8);
    }
#pragma unroll
    for (int nj = 0; nj < NT; nj += 2) {
      const int n0 = warp_n * 64 + nj * 8;
      uint32_t b[4];
      if (B_NK)
        ldsm_x4(b, Bs + (n0 + r + (q >> 1) * 8) * LD_MK + kk + (q & 1) * 8);
      else
        ldsm_x4_trans(b, Bs + (kk + r + (q & 1) * 8) * LD_KN + n0 + (q >> 1) * 8);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_bf16(acc[mi][nj], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ int valid_length(const int* lengths, int b, int T) {
  return min(max(lengths[b], 0), T);
}

// The conv over output rows (the forward, or with DX the input gradient).
// Output row t of sequence b reads input row t + sign * dilation * (j - half)
// under tap j (sign +1 forward, -1 for dX); K runs over (tap, channel chunk).
//   forward: X (B*T, KC) the conv input, W (taps, KC, N); the input prologue
//     relu(bf16(x * bn_inv + bn_shift)) when bn_inv is set (eval-mode BN and
//     ReLU in front of the mask); the epilogue bf16(acc), + bias rounded
//     again, the output mask, + residual rounded a third time.
//   dX: X (B*T, KC) the cotangent of the conv output (KC = C_out), W (taps,
//     N, KC) with N = C_in; the epilogue bf16(acc) and the input mask.
template <bool DX>
__global__ void __launch_bounds__(THREADS)
conv_rows_kernel(const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ W,
                 const __nv_bfloat16* __restrict__ bias, const float* __restrict__ bn_inv,
                 const float* __restrict__ bn_shift, const __nv_bfloat16* __restrict__ residual,
                 const int* __restrict__ lengths, __nv_bfloat16* __restrict__ Y, int T, int KC,
                 int N, int taps, int dilation) {
  __shared__ __align__(16) __nv_bfloat16 As[2][TILE_MK];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][DX ? TILE_MK : TILE_KN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int mtiles = (T + BM - 1) / BM;
  const int b = blockIdx.y / mtiles;
  const int t0 = (blockIdx.y % mtiles) * BM;
  const int n0 = blockIdx.x * BN;
  const int L = valid_length(lengths, b, T);
  const int half = (taps - 1) / 2;
  const int step = DX ? -dilation : dilation;
  // taps that read at least one valid row for a valid output row of the tile
  int jlo = taps, jhi = -1;
  if (t0 < L) {
    for (int j = 0; j < taps; ++j) {
      const int s = step * (j - half);
      if (t0 + s < L && t0 + BM + s > 0) {
        jlo = min(jlo, j);
        jhi = max(jhi, j);
      }
    }
  }
  const int chunks = (KC + BK - 1) / BK;
  const int iters = jhi >= jlo ? (jhi - jlo + 1) * chunks : 0;
  const __nv_bfloat16* Xb = X + static_cast<size_t>(b) * T * KC;

  uint32_t ra[LOADS], rb[LOADS];
  // Every A load of a thread reads the same channel pair of its chunk (rows
  // tid / 16 + 16 i), so the BN prologue's inv and shift are read once a
  // step; every B load the same column pair.  The prologue runs when the
  // registers are stored, after the step's products, so that the loads'
  // latency stays hidden behind them.
  const bool prologue = !DX && bn_inv != nullptr;
  float2 inv = make_float2(0.f, 0.f), shift = inv;
  uint32_t valid = 0u;  // bit i: A row i read a valid position
  bool lo_ok = false, hi_ok = false;
  auto load = [&](int it) {
    const int j = jlo + it / chunks;
    const int c0 = (it % chunks) * BK;
    const int s = step * (j - half);
    const int c = c0 + 2 * (tid & 15);
    lo_ok = c < KC;
    hi_ok = c + 1 < KC;
    if (prologue) {
      inv = shift = make_float2(0.f, 0.f);
      if (lo_ok) inv.x = bn_inv[c], shift.x = bn_shift[c];
      if (hi_ok) inv.y = bn_inv[c + 1], shift.y = bn_shift[c + 1];
    }
    valid = 0u;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int src = t0 + (tid >> 4) + 16 * i + s;
      uint32_t v = 0u;
      if (src >= 0 && src < L) {
        v = load_pair(Xb + static_cast<size_t>(src) * KC, c, KC);
        valid |= 1u << i;
      }
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      if (DX) {  // [BN output channels][BK K channels] from W[j][n0 + row][c0 + ...]
        const int row = n0 + (tid >> 4) + 16 * i;
        rb[i] = row < N ? load_pair(W + (static_cast<size_t>(j) * N + row) * KC, c, KC) : 0u;
      } else {  // [BK K channels][BN output channels] from W[j][c0 + row][n0 + ...]
        const int row = c0 + (tid >> 6) + 4 * i;
        rb[i] = row < KC ? load_pair(W + (static_cast<size_t>(j) * KC + row) * N,
                                     n0 + 2 * (tid & 63), N)
                         : 0u;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int w = tid + i * THREADS;
      uint32_t v = ra[i];
      if (prologue && (valid >> i & 1u)) {  // relu(bf16(x * inv + shift)), then the mask
        const float2 f = unpack(v);
        __nv_bfloat162 h = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(f.x, inv.x), shift.x),
                                                 __fadd_rn(__fmul_rn(f.y, inv.y), shift.y));
        h = __hmax2(h, __float2bfloat162_rn(0.f));  // ReLU of the bf16 values: exact
        v = *reinterpret_cast<uint32_t*>(&h);
        if (!hi_ok) v = lo_ok ? v & 0xffffu : 0u;  // channels past C_in stay 0
      }
      store_smem(As[buf], (w >> 4) * LD_MK + 2 * (w & 15), v);
      if (DX)
        store_smem(Bs[buf], (w >> 4) * LD_MK + 2 * (w & 15), rb[i]);
      else
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
  if (iters > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const int cur = it & 1;
    if (it + 1 < iters) load(it + 1);
    mma_step<false, DX>(acc, As[cur], Bs[cur], warp_m, warp_n, lane);
    if (it + 1 < iters) store(cur ^ 1);
    __syncthreads();
  }

  const int g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + warp_m * 32 + mi * 16 + g + h * 8;
      if (t >= T) continue;
      const size_t row = static_cast<size_t>(b) * T + t;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = n0 + warp_n * 64 + ni * 8 + 2 * qd;
        if (n >= N) continue;
        float v0 = bf16_round(acc[mi][ni][2 * h]), v1 = bf16_round(acc[mi][ni][2 * h + 1]);
        if (!DX) {
          const float2 bb = unpack(load_pair(bias, n, N));
          v0 = bf16_round(v0 + bb.x);
          v1 = bf16_round(v1 + bb.y);
        }
        if (t >= L) v0 = v1 = 0.f;
        if (!DX && residual != nullptr) {
          const float2 rr = unpack(load_pair(residual + row * N, n, N));
          v0 = rr.x + v0;
          v1 = rr.y + v1;
        }
        store_pair(Y + row * N, n, N, pack(v0, v1));
      }
    }
  }
}

// Column sums over the valid rows of each sequence, in a fixed order: block
// (column group, b) sums rows t < min(lengths[b], T) of sequence b, each
// warp every SUM_WARPS-th row, then the warps in order.  POOL writes
// sum / max(lengths[b], 1) (the masked mean pool, float32 (B, C)), else the
// sums themselves (a partial row b of a (B, C) buffer).
template <bool POOL>
__global__ void __launch_bounds__(SUM_WARPS * 32)
seq_col_sums_kernel(const __nv_bfloat16* __restrict__ X, const int* __restrict__ lengths,
                    float* __restrict__ out, int T, int C) {
  __shared__ float s0[SUM_WARPS][32], s1[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int c = blockIdx.x * SUM_COLS + 2 * lane;
  const int L = valid_length(lengths, b, T);
  const __nv_bfloat16* Xb = X + static_cast<size_t>(b) * T * C;
  float a0 = 0.f, a1 = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int t = warp; t < L; t += SUM_WARPS) {
      const float2 f = unpack(load_pair(Xb + static_cast<size_t>(t) * C, c, C));
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

inline unsigned conv_rows_grid_y(int B, int T) {
  return static_cast<unsigned>(B) * static_cast<unsigned>((T + BM - 1) / BM);
}

}  // namespace k7
