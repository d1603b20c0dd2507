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
// The products run on the bf16 tensor cores through the split of
// csrc/pair_scorer_f32.cu (bf16x3.cuh): each float32 operand is the exact
// sum of three bf16 pieces, and the six products x0 w0 + x0 w1 + x1 w0 + x0
// w2 + x1 w1 + x2 w0 keep float32's precision (the three left out lie below
// 2^-24 of |x w|).  Each 64-deep stage's products start from zero in the
// tensor cores' accumulators and are then added into float32 sums rounded
// to nearest: the tensor cores' own adds are not float32's (over K1 f32's
// depth in one accumulator set the error reached 1.9e-5).  Nothing is
// rounded to bf16 that JAX keeps in float32.
//
// masked_conv_forward_f32 (conv_f32_kernel) is K7's bf16 frame
// (csrc/masked_conv.cuh conv_tma_kernel): an implicit GEMM whose rows are
// the positions (b, t), K taps x C_in and N C_out; persistent blocks walk
// the host plan's tiles (ops/masked_conv.py:conv_tile_plan at 128 x 112);
// one producer thread keeps a ring of three TMA stages full, two consumer
// warpgroups own 64 rows each.  A stage is a tap's 64-channel chunk: the
// float32 rows t + d (j - half) of sequence b as two 128-byte-swizzled
// boxes of 32 channels (a 3-D map (C, T, B): rows outside [0, T) and
// channels past C_in arrive as zeros) and W's three bf16 piece tiles (112
// rows of 64 channels, K-major, 128-byte swizzled) from the pieces laid
// once a weight version (ops/masked_conv.py:conv_weight_layout_f32: (3,
// taps, N up to 112, K up to 64)), and with the prologue the chunk's slices
// of its inv and shift.  The consumers read their A-fragment elements from
// the boxes, apply the eval BN + ReLU prologue relu(x * inv + shift) (two
// roundings, as the plain version's float32 ops), zero the rows
// whose shifted position lies outside [0, length), split each value into
// its three pieces and issue six register-A wgmma m64n112k16 a k-step.  The
// 112-column tile covers 550 channels in 560 and 1,100 in 1,120 (a 128-wide
// tile needs 640); two accumulator sets of 56 and the 48 fragment registers
// fit the consumers' 232.  Taps whose shifted rows all lie outside [0,
// length) are skipped, and row tiles that start at or past the length are
// not in the plan: after their tiles the blocks write such rows (zeros, or
// the residual).  The epilogue: (sum + bias) * mask (+ residual), at the
// output's row pitch.  Every output is summed in one fixed order (taps,
// chunks, the tensor cores' order inside a stage): two calls give the same
// bits.
//
// masked_conv_dx_f32 is the same kernel: with the taps reversed (j' = taps
// - 1 - j), t - d (j - half) = t + d (j' - half), so dX is the forward conv
// of G with the weights W'[j'] = W[j]^T (conv_weight_layout_f32 with dx: N
// = C_in, K = C_out), no bias, no prologue: the input mask is A's zeroing,
// the output mask the epilogue's.  It writes dX at the padded pitch the
// BatchNorm's float32 backward reads.
//
// masked_conv_dw_f32 (conv_dw_f32_kernel) takes the bf16 dW frame
// (csrc/masked_conv_bwd.cu conv_dw_kernel): dW[j] is a GEMM with M = C_in,
// N = C_out and K = the positions (b, t) whose output row t and input row t
// + s (s = d (j - half)) are both valid; persistent blocks walk the items of
// ops/masked_conv.py:dw_step_plan at 128 x 128 tiles and 64-position steps
// of one sequence, two stages deep (32-position steps five deep ran 1.4x
// slower: each stage's fixed work runs between one warpgroup's products).
// A stage brings four 64-position x 32-channel float32 boxes of x (rows t0
// + s ..) and dy's three bf16 pieces as 64 x 64 boxes (rows t0 ..): dy is
// read by every tap and C_in tile (81 times at 1,100 channels), so one pass a call (split_rows_kernel) splits it
// into a (3, B, T) bf16 buffer, and the dW kernel reads the pieces MN-major
// (a design that split dy's float32 boxes in shared memory for every item
// instead ran 1.56x slower: chip_variants.py --k7-f32).  A = (mask
// x)^T is formed in registers from the float32 boxes (a select, not a
// multiply, zeroes the positions past the step's valid count) and split;
// six register-A wgmma m64n128k16 a k-step against the pieces (transposed
// B); a warpgroup whose 64 channels lie past C_in issues none.  With one
// split the epilogue writes dW; with more, each item writes float32
// partials that dw_reduce_f32_kernel adds in split order.  dbias:
// per-sequence column sums (four interleaved accumulators a column, added
// in a fixed order), then the sequences added in order.
//
// What bounds them: the products at the split's rate.  32 sequences at
// bucket 512 of the default encoder need 567 GFLOP of float32 products in
// the forward for these lengths: 3.44 ms at 989 / 6 = 165 TFLOP/s (8.46 on
// the 67 TFLOP/s FMA pipe), dX 2.93 and dW 2.95.  The stages' bytes come
// from L2 at about 150 bf16 operations a byte, and on an H100 the loads set
// the pace (chip_variants.py --k7-f32, a dilated conv): without its
// products a kernel takes 0.65x (forward), 0.78x (dX) and 0.86x (dW) of its
// time, and without the split's five cross products the forward and dX run
// at that floor; the split and the prologue run between one warpgroup's
// products and under the other's.

#include "bf16x3.cuh"
#include "hopper.cuh"

#include <limits.h>
#include <string.h>

namespace {

// N = 112 (14 column groups of 8: 550 -> 5 x 112, 1,100 -> 10 x 112),
// register A, B K-major
template <>
struct Mma<112> {
  static __device__ __forceinline__ void rs(float (&d)[56], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
        : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

constexpr int BM = 128;        // positions of a tile: two consumer warpgroups of 64
constexpr int BN = 112;        // output channels of a tile
constexpr int BK = 64;         // input channels of a stage: one 128-byte row of bf16
constexpr int PIECES = 3;      // bf16 pieces of a float32 value
constexpr int CONSUMERS = 2;   // consumer warpgroups; the producer's is the last
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int HALF_BYTES = BM * 32 * 4;  // a 128-row x 32-channel float32 box
constexpr int W_BYTES = BN * BK * 2;     // one piece's 112 x 64 bf16 tile
constexpr int STAGE = 2 * HALF_BYTES + PIECES * W_BYTES;
constexpr int STAGES = 3;
constexpr int VEC_BYTES = 2 * BK * 4;  // a stage's slices of the prologue's inv and shift
constexpr int VEC_OFF = STAGES * STAGE;  // then a ring of STAGES slices, then the mbarriers
constexpr int BAR_OFF = VEC_OFF + STAGES * VEC_BYTES;
constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;  // + alignment slack
static_assert(HALF_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "swizzle atoms");
static_assert(SMEM <= SMEM_LIMIT, "shared memory");

constexpr int SUM_COLS = 128;  // columns of a dbias block

__device__ __forceinline__ int valid_length(const int* lengths, int b, int T) {
  return min(max(lengths[b], 0), T);
}

// 1-D TMA load of the box at element c0; elements past the end arrive as
// zeros and count toward the bytes
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, int c0,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// float element (row r, column c < 32) of a 128-byte-swizzled box of
// 32-float rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * 32 + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// The six register-A products of a 64-deep stage into acc (overwritten),
// the five small cross products of every k-step first, then x0 w0: A pieces
// fa, B piece tiles at descriptors d[p]; `kstep` is a k-step's advance of a
// descriptor (K-major: 32 bytes; MN-major: 16 rows of 128 bytes).
template <class MMA, int NACC>
__device__ __forceinline__ void split_products(float (&acc)[NACC], uint32_t (&fa)[PIECES][4][4],
                                               const uint64_t (&d)[PIECES], uint64_t kstep) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t o = kstep * kk;
    MMA::rs(acc, fa[0][kk], d[1] + o, kk > 0);
    MMA::rs(acc, fa[1][kk], d[0] + o, 1);
    MMA::rs(acc, fa[0][kk], d[2] + o, 1);
    MMA::rs(acc, fa[1][kk], d[1] + o, 1);
    MMA::rs(acc, fa[2][kk], d[0] + o, 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) MMA::rs(acc, fa[0][kk], d[0] + kstep * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int p = 0; p < PIECES; ++p) fence_regs(fa[p]);
}

struct Args {
  const float* bias;      // (N,), or null (dX)
  const float* bn_inv;    // (K,): the prologue's inv and shift, or null
  const float* bn_shift;
  const float* residual;  // (B, T) rows at res_pitch, or null
  const int* lengths;     // (B,)
  const int* plan;        // tile codes (b * mtiles + row tile) * ntiles + column tile
  float* y;               // (B, T) rows at y_pitch
  int B, T, K, N, k_pad, n_pad, taps, dilation, y_pitch, res_pitch, tiles, mtiles, ntiles;
};

struct Tile {
  int b, t0, n0, L, jlo, jhi;  // taps jlo..jhi read a valid row
};

// Tile `code` of the plan and its taps: those whose shifted rows [t0 + s,
// t0 + s + BM) meet [0, L) (a run: the shift grows with j; never empty for
// a tile of the plan, whose first row is valid).
__device__ __forceinline__ Tile conv_tile(const Args& a, int code) {
  Tile tl;
  const int u = code / a.ntiles;
  tl.n0 = (code - u * a.ntiles) * BN;
  tl.b = u / a.mtiles;
  tl.t0 = (u - tl.b * a.mtiles) * BM;
  tl.L = valid_length(a.lengths, tl.b, a.T);
  const int half = (a.taps - 1) / 2;
  tl.jlo = a.taps;
  tl.jhi = -1;
  for (int j = 0; j < a.taps; ++j) {
    const int s = a.dilation * (j - half);
    if (tl.t0 + s < tl.L && tl.t0 + BM + s > 0) {
      tl.jlo = min(tl.jlo, j);
      tl.jhi = j;
    }
  }
  return tl;
}

// The conv over output rows, PRO with the eval-mode BN + ReLU prologue.
// tm_x maps the input (K, T, B) float32 at its pitch, box (32, 128, 1);
// tm_w the pieces (3 * taps * n_pad, k_pad) bf16, box (112, 64); tm_inv and
// tm_shift the prologue's (K,) vectors, box 64 (PRO).
template <bool PRO>
__global__ void __launch_bounds__(THREADS, 1)
conv_f32_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_inv,
                const __grid_constant__ CUtensorMap tm_shift, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (STAGES + s); };
  const int chunks = a.k_pad / BK;
  const int half = (a.taps - 1) / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
      const int piece_rows = a.taps * a.n_pad;
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const Tile tl = conv_tile(a, a.plan[t]);
        for (int j = tl.jlo; j <= tl.jhi; ++j) {
          const int src = tl.t0 + a.dilation * (j - half);
          for (int c = 0; c < chunks; ++c) {
            mbar_wait(empty_bar(s), phase ^ 1u);
            const uint32_t st = base + s * STAGE;
            mbar_expect_tx(full_bar(s), PRO ? STAGE + VEC_BYTES : STAGE);
            if (PRO) {
              const uint32_t sv = base + VEC_OFF + s * VEC_BYTES;
              tma_load_1d(sv, &tm_inv, c * BK, full_bar(s));
              tma_load_1d(sv + BK * 4, &tm_shift, c * BK, full_bar(s));
            }
            tma_load_3d(st, &tm_x, c * BK, src, tl.b, full_bar(s));
            tma_load_3d(st + HALF_BYTES, &tm_x, c * BK + 32, src, tl.b, full_bar(s));
#pragma unroll
            for (int p = 0; p < PIECES; ++p)
              tma_load(st + 2 * HALF_BYTES + p * W_BYTES, &tm_w, c * BK,
                       p * piece_rows + j * a.n_pad + tl.n0, full_bar(s));
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

  // ---- consumers: A formed and split in registers, six products a k-step --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int q = lane & 3;   // fragment column pair
  const int row = wg * 64 + warp * 16 + g;  // the thread's first row of the tile
  float acc[BN / 2];  // a stage's products (the tensor cores' sums)
  float sum[BN / 2];  // the stages' sums, added in float32 rounded to nearest
  uint32_t fa[PIECES][4][4];
  int s = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Tile tl = conv_tile(a, a.plan[t]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
    for (int j = tl.jlo; j <= tl.jhi; ++j) {
      const int src = tl.t0 + row + a.dilation * (j - half);
      const bool v0 = src >= 0 && src < tl.L;
      const bool v1 = src + 8 >= 0 && src + 8 < tl.L;
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(full_bar(s), phase);
        const uint32_t st = base + s * STAGE;
        const unsigned char* sp = smem + s * STAGE;
        const float* sv = reinterpret_cast<const float*>(smem + VEC_OFF + s * VEC_BYTES);
        // the thread's A-fragment elements (rows row, row + 8; columns 2q,
        // 2q + 1 and those + 8 of each 16-wide k-step) from the swizzled
        // halves: the prologue, the row mask, then the split
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* hb = reinterpret_cast<const float*>(sp + (kk >> 1) * HALF_BYTES);
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = (kk & 1) * 16 + 2 * q + 8 * cc;  // within the 32-wide half
            float2 iv = make_float2(0.f, 0.f), sh = make_float2(0.f, 0.f);
            if (PRO) {  // 0 past K (TMA's zeros): relu(0 * 0 + 0) = 0
              iv = *reinterpret_cast<const float2*>(sv + (kk >> 1) * 32 + col);
              sh = *reinterpret_cast<const float2*>(sv + BK + (kk >> 1) * 32 + col);
            }
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              float2 x = *reinterpret_cast<const float2*>(hb + swz(row + 8 * rr, col));
              if (PRO)
                x = make_float2(fmaxf(__fadd_rn(__fmul_rn(x.x, iv.x), sh.x), 0.f),
                                fmaxf(__fadd_rn(__fmul_rn(x.y, iv.y), sh.y), 0.f));
              if (!(rr ? v1 : v0)) x = make_float2(0.f, 0.f);
              const int e = rr + 2 * cc;
              split3(x, fa[0][kk][e], fa[1][kk][e], fa[2][kk][e]);
            }
          }
        }
        const uint64_t d[PIECES] = {smem_desc(st + 2 * HALF_BYTES),
                                    smem_desc(st + 2 * HALF_BYTES + W_BYTES),
                                    smem_desc(st + 2 * HALF_BYTES + 2 * W_BYTES)};
        split_products<Mma<BN>>(acc, fa, d, 2);
        if (lane == 0) mbar_arrive(empty_bar(s));  // the stage is read
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1u;
        }
      }
    }

    // ---- epilogue: sum[4jn + 0/1] is row `row`, columns 8 jn + 2q + 0/1;
    // sum[4jn + 2/3] row + 8.  (sum + bias) * mask, + residual ------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tt = tl.t0 + row + 8 * h;
      if (tt >= a.T) continue;
      const float keep = tt < tl.L ? 1.f : 0.f;
      const size_t pos = static_cast<size_t>(tl.b) * a.T + tt;
      float* yrow = a.y + pos * a.y_pitch;
      const float* rrow = a.residual == nullptr ? nullptr : a.residual + pos * a.res_pitch;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const int n = tl.n0 + 8 * jn + 2 * q;
        if (n >= a.N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sum[4 * jn + 2 * h + e];
          if (a.bias != nullptr && n + e < a.N) x = __fadd_rn(x, __ldg(a.bias + n + e));
          x = __fmul_rn(x, keep);
          if (rrow != nullptr && n + e < a.N) x = __fadd_rn(__ldg(rrow + n + e), x);
          v[e] = x;
        }
        if (n + 1 < a.N)  // pitches are multiples of 4: an 8-byte store
          *reinterpret_cast<float2*>(yrow + n) = make_float2(v[0], v[1]);
        else
          yrow[n] = v[0];
      }
    }
  }

  // ---- rows of the row tiles that start at or past the length: zeros, or
  // the residual (residual + 0 is the residual), a warp a row -------------
  const int cw = threadIdx.x / 32;  // 0 .. 4 * CONSUMERS - 1
  const long long warps = static_cast<long long>(gridDim.x) * 4 * CONSUMERS;
  const long long rows = static_cast<long long>(a.B) * a.T;
  for (long long r = static_cast<long long>(blockIdx.x) * 4 * CONSUMERS + cw; r < rows;
       r += warps) {
    const int b = static_cast<int>(r / a.T);
    const int tt = static_cast<int>(r - static_cast<long long>(b) * a.T);
    const int L = valid_length(a.lengths, b, a.T);
    if (tt < min((L + BM - 1) / BM * BM, a.T)) continue;
    float* yrow = a.y + r * a.y_pitch;
    const float* rrow = a.residual == nullptr ? nullptr : a.residual + r * a.res_pitch;
    for (int n = lane; n < a.N; n += 32) yrow[n] = rrow == nullptr ? 0.f : __ldg(rrow + n);
  }
}

// ------------------------------------------------------------------ dW

constexpr int DW_BM = 128;                     // input channels of a tile: two warpgroups of 64
constexpr int DW_BN = 128;                     // output channels of a tile: two 64-column boxes
constexpr int DW_BK = 64;                      // positions of a K step
constexpr int DW_XHALF = DW_BK * 32 * 4;       // a 64-position x 32-channel float32 box
constexpr int DW_X_BYTES = (DW_BM / 32) * DW_XHALF;
constexpr int DW_BOX = DW_BK * 64 * 2;         // a 64 x 64 bf16 box of a dy piece
constexpr int DW_PIECE = (DW_BN / 64) * DW_BOX;
constexpr int DW_STAGE = DW_X_BYTES + PIECES * DW_PIECE;  // 80 KB
constexpr int DW_STAGES = 2;
constexpr int DW_BAR_OFF = DW_STAGES * DW_STAGE;
constexpr int DW_SMEM = 1024 + DW_BAR_OFF + 2 * DW_STAGES * 8;
static_assert(DW_XHALF % 1024 == 0 && DW_BOX % 1024 == 0, "swizzle atoms");
static_assert(DW_SMEM <= SMEM_LIMIT, "shared memory");

struct DwArgs {
  const int* items;    // ((j * splits + sp) * mtiles + mt) * ntiles + nt, the most steps first
  const int* offsets;  // (taps * splits + 1): steps of (j, sp) are [offsets[j * splits + sp], next)
  const int* steps;    // two words a step: b, then t0 | rows << 16 (rows valid from t0)
  float* partial;      // (splits, taps, cin, cout), splits > 1
  float* dw;           // (taps, cin, cout)
  int B, taps, dilation, cin, cout, mtiles, ntiles, splits, n_items;
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

// tm_x maps x (C_in, T, B) float32 at its pitch, box (32, 64, 1); tm_dy
// dy's pieces (C_out, T, 3B) bf16 (plane p * B + b), box (64, 64, 1).
__global__ void __launch_bounds__(THREADS, 1)
conv_dw_f32_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_dy, const DwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + DW_BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (DW_STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer ---------------------------------------------------------
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
#pragma unroll
          for (int h = 0; h < DW_BM / 32; ++h)
            tma_load_3d(st + h * DW_XHALF, &tm_x, w.m0 + 32 * h, t0 + w.s, b, full_bar(s));
#pragma unroll
          for (int p = 0; p < PIECES; ++p)
#pragma unroll
            for (int i = 0; i < DW_BN / 64; ++i)
              tma_load_3d(st + DW_X_BYTES + p * DW_PIECE + i * DW_BOX, &tm_dy, w.n0 + 64 * i, t0,
                          p * a.B + b, full_bar(s));
          if (++s == DW_STAGES) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: (mask x)^T formed and split in registers ---------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row (and row + 8): an input channel
  const int q = lane & 3;   // fragment column pair: positions 2q, 2q + 1 (+ 8)
  float acc[DW_BN / 2];
  float sum[DW_BN / 2];
  uint32_t fa[PIECES][4][4];
  int s = 0;
  uint32_t phase = 0;
  const bool even = (a.cout & 1) == 0;
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    const DwItem w = dw_item(a, it);
    const bool live = w.m0 + 64 * wg < a.cin;  // the warpgroup has a channel below C_in
#pragma unroll
    for (int i = 0; i < DW_BN / 2; ++i) sum[i] = 0.f;
    for (int k = w.k0; k < w.k1; ++k) {
      mbar_wait(full_bar(s), phase);
      const uint32_t st = base + s * DW_STAGE;
      if (live) {
        const int rows = a.steps[2 * k + 1] >> 16;
        const unsigned char* sp = smem + s * DW_STAGE;
        // A[c][p] = x[p][c]: channel c = 16 warp + g (+ 8) of the
        // warpgroup's 64, positions p, p + 1 a pair
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int cl = warp * 16 + g + 8 * rr;
          const float* hb =
              reinterpret_cast<const float*>(sp + (2 * wg + (cl >> 5)) * DW_XHALF);
          const int c5 = cl & 31;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int p = 16 * kk + 2 * q + 8 * cc;
              const float2 xt = make_float2(p < rows ? hb[swz(p, c5)] : 0.f,
                                            p + 1 < rows ? hb[swz(p + 1, c5)] : 0.f);
              const int e = rr + 2 * cc;
              split3(xt, fa[0][kk][e], fa[1][kk][e], fa[2][kk][e]);
            }
        }
        const uint32_t pb = st + DW_X_BYTES;
        const uint64_t d[PIECES] = {smem_desc_mn(pb, DW_BOX),
                                    smem_desc_mn(pb + DW_PIECE, DW_BOX),
                                    smem_desc_mn(pb + 2 * DW_PIECE, DW_BOX)};
        split_products<MmaRsT<DW_BN>>(acc, fa, d, 128);  // a k-step: 16 rows of 128 bytes
      }
      if (lane == 0) mbar_arrive(empty_bar(s));
      if (live) {
#pragma unroll
        for (int i = 0; i < DW_BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      }
      if (++s == DW_STAGES) {
        s = 0;
        phase ^= 1u;
      }
    }
    if (!live) continue;
    // ---- epilogue: sum[4jn + 0/1] is channel c, columns 8 jn + 2q + 0/1;
    // sum[4jn + 2/3] channel c + 8 (no step: zeros) --------------------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = w.m0 + wg * 64 + warp * 16 + g + 8 * h;
      if (c >= a.cin) continue;
      float* out = a.splits == 1
                       ? a.dw + (static_cast<size_t>(w.j) * a.cin + c) * a.cout
                       : a.partial +
                             ((static_cast<size_t>(w.sp) * a.taps + w.j) * a.cin + c) * a.cout;
#pragma unroll
      for (int jn = 0; jn < DW_BN / 8; ++jn) {
        const int n = w.n0 + 8 * jn + 2 * q;
        if (even && n + 1 < a.cout) {
          *reinterpret_cast<float2*>(out + n) =
              make_float2(sum[4 * jn + 2 * h], sum[4 * jn + 2 * h + 1]);
        } else {
          if (n < a.cout) out[n] = sum[4 * jn + 2 * h];
          if (n + 1 < a.cout) out[n + 1] = sum[4 * jn + 2 * h + 1];
        }
      }
    }
  }
}

// dy (rows at `pitch`) as its three bf16 pieces, (3, rows) at `ppitch` (a
// multiple of 8), channels below C; a thread a pair of channels.
__global__ void split_rows_kernel(const float* __restrict__ dy, int pitch,
                                  __nv_bfloat16* __restrict__ pieces, int ppitch, long long rows,
                                  int C) {
  const int pairs = (C + 1) / 2;
  const long long total = rows * pairs;
  const size_t plane = static_cast<size_t>(rows) * ppitch;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / pairs;
    const int c = 2 * static_cast<int>(i - r * pairs);
    const float* src = dy + r * pitch + c;
    const bool two = c + 1 < C;
    uint32_t p[PIECES];
    split3(make_float2(__ldg(src), two ? __ldg(src + 1) : 0.f), p[0], p[1], p[2]);
    __nv_bfloat16* dst = pieces + r * ppitch + c;
#pragma unroll
    for (int k = 0; k < PIECES; ++k) {
      if (two)
        *reinterpret_cast<uint32_t*>(dst + k * plane) = p[k];
      else
        *reinterpret_cast<unsigned short*>(dst + k * plane) =
            static_cast<unsigned short>(p[k] & 0xffffu);
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

// a (planes, rows, cols) float32 tensor whose rows lie `pitch` elements
// apart (a multiple of 4: TMA's strides are multiples of 16 bytes) as a 3-D
// map with 128-byte-swizzled boxes (1, box_rows, 32): columns past `cols`,
// rows outside [0, rows) and whole boxes of another plane arrive as zeros
bool make_map_f32_pitched(CUtensorMap* map, const void* ptr, uint64_t planes, uint64_t rows,
                          uint64_t cols, uint64_t pitch, uint32_t box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {pitch * 4, rows * pitch * 4};
  const cuuint32_t box[3] = {32, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a float32 vector of n elements as a 1-D map with boxes of BK elements
// (its address on 16 bytes): elements past n arrive as zeros
bool make_map_vec(CUtensorMap* map, const void* ptr, uint64_t n) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[1] = {n};
  const cuuint64_t strides[1] = {n * 4};  // not read at rank 1
  const cuuint32_t box[1] = {BK};
  const cuuint32_t elem[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks a launch's shapes and pointers, encodes its tensor maps and
// launches `grid` persistent blocks; cudaErrorInvalidValue for what the
// kernel does not take: an input pitch that is not a multiple of 4 or below
// K, an output or residual pitch that is odd or below N, an input, weight
// or prologue pointer off 16 bytes, paddings other than K rounded up to 64
// and N to 112.
int conv_launch(const void* x, int x_pitch, const void* w, Args a, int grid, void* stream) {
  if (a.B <= 0 || a.T <= 0 || a.K <= 0 || a.N <= 0 || a.taps <= 0 || a.dilation <= 0 ||
      x_pitch < a.K || x_pitch % 4 != 0 || a.y_pitch < a.N || a.y_pitch % 2 != 0 ||
      (a.residual != nullptr && a.res_pitch < a.N) ||
      a.k_pad != (a.K + BK - 1) / BK * BK || a.n_pad != (a.N + BN - 1) / BN * BN ||
      a.tiles < 0 || (a.tiles > 0 && a.plan == nullptr) || grid <= 0 ||
      (a.bn_inv == nullptr) != (a.bn_shift == nullptr) || !aligned16(x) || !aligned16(w) ||
      !aligned16(a.bn_inv) || !aligned16(a.bn_shift) ||
      static_cast<long long>(PIECES) * a.taps * a.n_pad > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  a.mtiles = (a.T + BM - 1) / BM;
  a.ntiles = a.n_pad / BN;
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward thread may have none yet), which
  // cuTensorMapEncodeTiled needs
  auto kernel = a.bn_inv != nullptr ? conv_f32_kernel<true> : conv_f32_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_x, tm_w, tm_inv, tm_shift;
  memset(&tm_x, 0, sizeof(tm_x));
  memset(&tm_w, 0, sizeof(tm_w));
  memset(&tm_inv, 0, sizeof(tm_inv));
  memset(&tm_shift, 0, sizeof(tm_shift));
  if (!make_map_f32_pitched(&tm_x, x, a.B, a.T, a.K, x_pitch, BM) ||
      !make_map(&tm_w, w, MapType::BF16, static_cast<uint64_t>(PIECES) * a.taps * a.n_pad,
                a.k_pad, BN, BK, true) ||
      (a.bn_inv != nullptr && (!make_map_vec(&tm_inv, a.bn_inv, a.K) ||
                               !make_map_vec(&tm_shift, a.bn_shift, a.K))))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, THREADS, SMEM, reinterpret_cast<cudaStream_t>(stream)>>>(tm_x, tm_w, tm_inv,
                                                                          tm_shift, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (B, T) rows at y_pitch (even), float32, from x (B, T) rows at x_pitch
// (a multiple of 4 channels, x on 16 bytes), W's pieces wt (3, taps, n_pad,
// k_pad) bf16 (ops/masked_conv.py:conv_weight_layout_f32: W[j]^T split,
// k_pad = C_in rounded up to 64, n_pad = C_out rounded up to 112; on 16
// bytes), bias (cout,), the optional prologue's bn_inv and bn_shift (cin,)
// (both or neither, on 16 bytes) and residual (B, T) rows at res_pitch, the plan's
// `tiles` tile codes ((b * mtiles + row tile) * ntiles + column tile, tiles
// of 128 x 112) on `grid` persistent blocks.  Returns a CUDA error (0 on
// success).
extern "C" int masked_conv_forward_f32(const void* x, const void* wt, const void* bias,
                                       const void* bn_inv, const void* bn_shift,
                                       const void* residual, const void* lengths,
                                       const void* plan, void* y, int B, int T, int cin,
                                       int cout, int x_pitch, int y_pitch, int res_pitch,
                                       int k_pad, int n_pad, int taps, int dilation, int tiles,
                                       int grid, void* stream) {
  if (bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.bias = static_cast<const float*>(bias);
  a.bn_inv = static_cast<const float*>(bn_inv);
  a.bn_shift = static_cast<const float*>(bn_shift);
  a.residual = static_cast<const float*>(residual);
  a.lengths = static_cast<const int*>(lengths);
  a.plan = static_cast<const int*>(plan);
  a.y = static_cast<float*>(y);
  a.B = B, a.T = T, a.K = cin, a.N = cout, a.k_pad = k_pad, a.n_pad = n_pad, a.taps = taps;
  a.dilation = dilation, a.y_pitch = y_pitch, a.res_pitch = res_pitch, a.tiles = tiles;
  return conv_launch(x, x_pitch, wt, a, grid, stream);
}

// dX (B, T) rows at dx_pitch (even), float32, from dy (B, T) rows at
// dy_pitch (a multiple of 4 channels, dy on 16 bytes), the dX pieces wt (3,
// taps, n_pad, k_pad) bf16: W[taps - 1 - j] split, n_pad (C_in) a multiple
// of 112, k_pad (C_out) of 64, the plan's `tiles` tile codes over C_in
// columns on `grid` persistent blocks.  Returns a CUDA error.
extern "C" int masked_conv_dx_f32(const void* dy, const void* wt, const void* lengths,
                                  const void* plan, void* dx, int B, int T, int cin, int cout,
                                  int dy_pitch, int dx_pitch, int k_pad, int n_pad, int taps,
                                  int dilation, int tiles, int grid, void* stream) {
  Args a{};
  a.lengths = static_cast<const int*>(lengths);
  a.plan = static_cast<const int*>(plan);
  a.y = static_cast<float*>(dx);
  a.B = B, a.T = T, a.K = cout, a.N = cin, a.k_pad = k_pad, a.n_pad = n_pad, a.taps = taps;
  a.dilation = dilation, a.y_pitch = dx_pitch, a.tiles = tiles;
  return conv_launch(dy, dy_pitch, wt, a, grid, stream);
}

// dW (taps, cin, cout) and dbias (cout,) float32 from the conv input x (B,
// T) rows at x_pitch and dy (B, T) rows at dy_pitch (both multiples of 4
// channels, on 16 bytes), the plan of ops/masked_conv.py:dw_step_plan at
// 128 x 128 tiles and 64 positions a step (its n_items item codes, then
// taps * splits + 1 offsets, then the steps) on `grid` persistent blocks;
// pieces is (3, B, T) bf16 scratch at the pitch cout rounded up to 8 (dy's
// split), partial (splits, taps, cin, cout) float32 scratch (unused with
// one split) and bias_part (B, cout).  Returns a CUDA error.
extern "C" int masked_conv_dw_f32(const void* x, const void* dy, void* pieces,
                                  const void* lengths, const void* plan, void* partial,
                                  void* bias_part, void* dw, void* db, int B, int T, int cin,
                                  int cout, int x_pitch, int dy_pitch, int taps, int dilation,
                                  int splits, int n_items, int grid, void* stream) {
  const int mtiles = (cin + DW_BM - 1) / DW_BM, ntiles = (cout + DW_BN - 1) / DW_BN;
  const int ppitch = (cout + 7) / 8 * 8;
  if (B <= 0 || T <= 0 || T > 0xffff || cin <= 0 || cout <= 0 || taps <= 0 || dilation <= 0 ||
      splits <= 0 || grid <= 0 || x_pitch < cin || x_pitch % 4 != 0 || dy_pitch < cout ||
      n_items != taps * splits * mtiles * ntiles || plan == nullptr || pieces == nullptr ||
      (splits > 1 && partial == nullptr) || !aligned16(x) || !aligned16(pieces) ||
      3LL * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(conv_dw_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_x, tm_dy;
  memset(&tm_x, 0, sizeof(tm_x));
  memset(&tm_dy, 0, sizeof(tm_dy));
  if (!make_map_f32_pitched(&tm_x, x, B, T, cin, x_pitch, DW_BK) ||
      !make_map_pitched(&tm_dy, pieces, 3ULL * B, T, cout, ppitch, DW_BK, 64, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* dy_ = static_cast<const float*>(dy);
  const long long rows = static_cast<long long>(B) * T;
  const long long pairs = rows * ((cout + 1) / 2);
  const long long split_blocks = (pairs + 255) / 256 < 4096 ? (pairs + 255) / 256 : 4096;
  split_rows_kernel<<<static_cast<unsigned>(split_blocks), 256, 0, s>>>(
      dy_, dy_pitch, static_cast<__nv_bfloat16*>(pieces), ppitch, rows, cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  DwArgs a{};
  a.items = static_cast<const int*>(plan);
  a.offsets = a.items + n_items;
  a.steps = a.offsets + taps * splits + 1;
  a.partial = static_cast<float*>(partial);
  a.dw = static_cast<float*>(dw);
  a.B = B, a.taps = taps, a.dilation = dilation, a.cin = cin, a.cout = cout;
  a.mtiles = mtiles, a.ntiles = ntiles, a.splits = splits, a.n_items = n_items;
  conv_dw_f32_kernel<<<grid < n_items ? grid : n_items, THREADS, DW_SMEM, s>>>(tm_x, tm_dy, a);
  err = cudaGetLastError();
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
      dy_, static_cast<const int*>(lengths), static_cast<float*>(bias_part), T, cout, dy_pitch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dbias_f32_kernel<<<(cout + 255) / 256, 256, 0, s>>>(static_cast<const float*>(bias_part),
                                                      static_cast<float*>(db), B, cout);
  return static_cast<int>(cudaGetLastError());
}
