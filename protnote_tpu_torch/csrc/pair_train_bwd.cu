// Training pair-MLP backward for Hopper (sm_90a): the two products of the
// first hidden GEMM's gradient, with x1 and its ReLU gate formed on the fly.
//
// Replaces the backward that JAX derives by autodiff of the TPU op chain
// protnote_tpu/ops/streaming_train.py:pair_logits_dense_decomposed (layer 2's
// GEMM over x1 = relu(a2[b] + c2[l])).  With dz the (B * L, N) bf16 gradient
// of z = x1 @ W (K5's backward), for every sequence b < B, label l < L, input
// column k < K and output column n < N:
//
//   pre[b, l, k] = bf16(f32(a2[b, k]) + f32(c2[l, k]))
//   dx1[b, l, k] = pre > 0 ? bf16(sum_n dz[b * L + l, n] * W[k, n]) : 0
//   da2[b, k]    = bf16(sum_l dx1[b, l, k])           (f32 sums)
//   dc2[l, k]    = bf16(sum_b dx1[b, l, k])
//   dW[k, n]     = bf16(sum_{b, l} x1[b, l, k] * dz[b * L + l, n]),
//                  x1 = bf16(relu(pre))
//
// dx1 is rounded to bf16 before it is summed, as JAX's bf16 dot output is.
// Neither x1, its gate nor dx1 reaches device memory: the plain backward
// forms x1 (6.3 GB at 32 sequences x 32,102 labels x 3072), a bool gate (3.2
// GB) and dx1 (6.3 GB) and runs two cuBLAS products and two reductions.
//
// What bounds it: the tensor cores.  Each product is 2 * B * L * K * N FLOP,
// 19.4 TFLOP at the default width, so the pair takes at least 39.2 ms at the
// 989 TFLOP/s dense bf16 peak; dz (6.3 GB) read once a kernel is 1.9 ms.
// Both kernels are persistent and warp-specialised, on the mainloop of the
// forward (csrc/pair_train.cu): one block an SM, one producer thread keeping
// a ring of TMA-loaded, 128-byte-swizzled stages full (full/empty mbarrier
// pairs), two consumer warpgroups issuing wgmma on their 64 rows of a
// 128-row tile.  dz is read through a 3-D tensor map over (B, L, N), so the
// rows of a tile past L arrive as zeros and never come from the next
// sequence.
//
// pair_train_dx: dX with the gate and both side sums in its epilogue.  A
// tile is 128 labels x 128 input columns of one sequence: A is the dz tile
// (labels x N, K-major), B is W itself ((K, N) row-major is K-major for this
// product, so unlike the forward no transposed copy is made).  A block owns a
// (label tile, column tile) unit and walks all B sequences through it, so
// dc2 = sum_b dx1 is carried in registers and stored once, with no global
// atomics.  The bytes its stages bring into shared memory bound it, not its
// epilogue (chip_variants.py --k4-bwd times it without the W tile's loads
// and without the epilogue; PERF.md); sharing the W tile between the two
// blocks of a cluster by TMA multicast, which halves what each SM pulls
// from L2 but not what lands in its shared memory, made no difference.  The
// 128-column tile keeps the accumulator (64 floats a thread)
// and that running sum (64) in registers without spills: ptxas allocates
// for the 384-thread launch bound, 168 registers a thread, and a
// 256-column tile would need twice both.  The gate's c2 values are read in
// the epilogue (the unit's 32 KB of c2 stays in L1 across its B tiles);
// holding them in registers too made ptxas spill.  da2 = sum_l dx1 is
// each tile's column sum: a reduce-scatter over the 8 lanes that share a
// column pair (28 shuffles), a sum over the warpgroup's 4 warps in shared
// memory, and one f32 atomic a column a warpgroup into a zeroed (B, K)
// scratch (about 49 M adds at the default shape).
//
// pair_train_dw: dW = x1^T dz with x1 formed in the A-operand registers, as
// the forward forms its x1.  A tile is 128 input columns x 256 (or 128)
// output columns; its reduction runs over K-blocks of 64 pair rows of one
// sequence (a block never crosses a sequence: L = 32,102 is not a multiple
// of 64, and rows past L arrive as zeros from both maps).  A stage brings
// two 64-row x 64-column c2 boxes and the dz boxes.  x1^T is c2 as stored,
// transposed: each consumer thread loads its A-fragment elements from its
// warpgroup's c2 box with ldmatrix.trans, adds a2[b] at its two rows, applies
// ReLU and packs to bf16, and issues the register-A wgmma with B (dz, N
// contiguous) read MN-major through the transpose bit; two fragment sets let
// one stage's products run while the next stage's fragments are formed.  An
// earlier form wrote x1 back into the c2 box in shared memory, with a
// proxy fence and a warpgroup barrier a stage, and read both operands
// MN-major from there; it was no faster.  The pair rows may be split into
// `splits`
// even ranges of K-blocks, each writing f32 partial sums, which a second,
// elementwise kernel adds and rounds to bf16: ops/streaming_train.py:
// pair_dw_plan takes the fewest splits that fill one wave.  The 3072 x 3072
// output in 128 x 256 tiles is 288 tiles (2.18 waves on 132 SMs), so one
// split: filling the last wave with more splits or narrower tiles did not
// pay on an H100 (chip_variants.py --k4-bwd, PERF.md).
//
// Offsets: dz holds 3.16e9 elements; it is read only by TMA (64-bit
// strides), and every other index is 64-bit where it can pass 2^31.

#include "hopper.cuh"

#include <limits.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int BM = 128;       // rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;        // reduction depth a stage: one 128-byte row of bf16
constexpr int CONSUMERS = 2;  // consumer warpgroups; the producer's is the last
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int BOX = 64 * BK * 2;  // one 64-row x 64-column bf16 box, 8 KB
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ---------------------------------------------------------------------------
// dX: dx1 = gate * bf16(dz . W^T), reduced to da2 and dc2

constexpr int DX_BN = 128;  // input columns a tile (one a consumer thread of a warpgroup)

struct DxLayout {
  static constexpr int A_BYTES = BM * BK * 2;     // the dz tile: 128 labels x 64
  static constexpr int B_BYTES = DX_BN * BK * 2;  // the W tile: 128 columns x 64
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // da2 partial sums: two buffers (tile parity) x warpgroup x warp x column
  static constexpr int RED_BYTES = 2 * CONSUMERS * 4 * DX_BN * 4;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256 - RED_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int RED_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = RED_OFF + RED_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "swizzle atoms");
  static_assert(STAGES >= 4, "the ring needs four stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

// Unit u is input-column tile u % tiles_k of label tile u / tiles_k (label
// tiles outermost, so the blocks in flight read the same dz rows); a block
// walks its unit's B sequences in order (ops/streaming_train.py:pair_dx_plan).
__global__ void __launch_bounds__(THREADS, 1)
pair_train_dx_kernel(const __grid_constant__ CUtensorMap tm_dz,
                     const __grid_constant__ CUtensorMap tm_w, const __nv_bfloat16* __restrict__ a2,
                     const __nv_bfloat16* __restrict__ c2, float* __restrict__ da2,
                     __nv_bfloat16* __restrict__ dc2, int B, int L, int K, int N, int tiles_k,
                     int units) {
  using Lay = DxLayout;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + Lay::BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (STAGES + s); };
  const int NS = N / BK;

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
      int s = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int l0 = (u / tiles_k) * BM;
        const int k0 = (u % tiles_k) * DX_BN;
        for (int b = 0; b < B; ++b) {
          for (int ns = 0; ns < NS; ++ns) {
            mbar_wait(empty_bar(s), phase ^ 1u);
            const uint32_t st = base + s * Lay::STAGE;
            mbar_expect_tx(full_bar(s), Lay::STAGE);
            tma_load_3d(st, &tm_dz, ns * BK, l0, b, full_bar(s));
            tma_load(st + Lay::A_BYTES, &tm_w, ns * BK, k0, full_bar(s));
            if (++s == STAGES) {
              s = 0;
              phase ^= 1u;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: wgmma on the ring, then the gated epilogue ------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row (and row + 8)
    const int q = lane & 3;   // fragment column pair
    const int row = wg * 64 + warp * 16 + g;  // the thread's first row in the tile
    // acc[4j + 0/1]: row, columns 8j + 2q + 0/1; acc[4j + 2/3]: row + 8
    float acc[DX_BN / 2];
    float dc[DX_BN / 2];  // sum over the sequences so far, acc's layout
    float* red = reinterpret_cast<float*>(smem + Lay::RED_OFF);
    int s = 0;
    uint32_t phase = 0;
    int parity = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int l0 = (u / tiles_k) * BM;
      const int k0 = (u % tiles_k) * DX_BN;
      // c2 at the thread's two rows (row 0 stands in past L, where dx1 is 0)
      const uint32_t* crow[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int l = l0 + row + 8 * rr;
        crow[rr] = reinterpret_cast<const uint32_t*>(c2 + (size_t)(l < L ? l : 0) * K + k0 + 2 * q);
      }
#pragma unroll
      for (int i = 0; i < DX_BN / 2; ++i) dc[i] = 0.f;
      for (int b = 0; b < B; ++b) {
        int prev = -1;
        for (int ns = 0; ns < NS; ++ns) {
          mbar_wait(full_bar(s), phase);
          const uint32_t st = base + s * Lay::STAGE;
          const uint64_t da = smem_desc(st + wg * 64 * BK * 2);
          const uint64_t db = smem_desc(st + Lay::A_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Mma<DX_BN>::ss(acc, da + 2 * kk, db + 2 * kk, ns > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done
          fence_acc(acc);
          if (prev >= 0 && lane == 0) mbar_arrive(empty_bar(prev));
          prev = s;
          if (++s == STAGES) {
            s = 0;
            phase ^= 1u;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty_bar(prev));

        // ---- epilogue: gate, round, sum ------------------------------------
        // dx1 = pre > 0 ? bf16(acc) : 0 (rows past L hold acc 0: their dz
        // arrived as zeros); dc += dx1; cs: the thread's two rows summed
        const __nv_bfloat162* arow =
            reinterpret_cast<const __nv_bfloat162*>(a2 + (size_t)b * K + k0 + 2 * q);
        float cs[DX_BN / 4];  // index 2j + e: column 8j + 2q + e
#pragma unroll
        for (int j = 0; j < DX_BN / 8; ++j) {
          const float2 av = __bfloat1622float2(arow[4 * j]);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float2 cv = unpack_bf16x2(__ldg(crow[rr] + 4 * j));
            const float v0 = av.x + cv.x > 0.f ? round_bf16(acc[4 * j + 2 * rr]) : 0.f;
            const float v1 = av.y + cv.y > 0.f ? round_bf16(acc[4 * j + 2 * rr + 1]) : 0.f;
            dc[4 * j + 2 * rr] += v0;
            dc[4 * j + 2 * rr + 1] += v1;
            s0 += v0;
            s1 += v1;
          }
          cs[2 * j] = s0;
          cs[2 * j + 1] = s1;
        }
        // reduce-scatter over the 8 lanes of one column pair (lane bits 2-4):
        // each step keeps half of the values and adds the partner's copy of
        // them, so lane (g, q) ends with the warp's sums of indices 4g .. 4g+3
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const bool up = lane & 16;
          const float send = up ? cs[i] : cs[i + 16];
          const float keep = up ? cs[i + 16] : cs[i];
          cs[i] = keep + __shfl_xor_sync(FULL, send, 16);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool up = lane & 8;
          const float send = up ? cs[i] : cs[i + 8];
          const float keep = up ? cs[i + 8] : cs[i];
          cs[i] = keep + __shfl_xor_sync(FULL, send, 8);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool up = lane & 4;
          const float send = up ? cs[i] : cs[i + 4];
          const float keep = up ? cs[i + 4] : cs[i];
          cs[i] = keep + __shfl_xor_sync(FULL, send, 4);
        }
        // index 4g + i is column 16g + 8(i >> 1) + 2q + (i & 1); the four
        // warps' sums meet in shared memory (a buffer a tile parity, so the
        // next tile's writes need no second barrier)
        float* mine = red + ((parity * CONSUMERS + wg) * 4 + warp) * DX_BN;
#pragma unroll
        for (int i = 0; i < 4; ++i) mine[16 * g + 8 * (i >> 1) + 2 * q + (i & 1)] = cs[i];
        warpgroup_barrier(1 + wg);
        const float* ours = red + (parity * CONSUMERS + wg) * 4 * DX_BN;
        atomicAdd(da2 + (size_t)b * K + k0 + tid,
                  (ours[tid] + ours[DX_BN + tid]) + (ours[2 * DX_BN + tid] + ours[3 * DX_BN + tid]));
        parity ^= 1;
      }
      // dc2 of the unit, once: rows past L are not written
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int l = l0 + row + 8 * rr;
        if (l < L) {
          uint32_t* dst = reinterpret_cast<uint32_t*>(dc2 + (size_t)l * K + k0 + 2 * q);
#pragma unroll
          for (int j = 0; j < DX_BN / 8; ++j)
            dst[4 * j] = pack_bf16x2(dc[4 * j + 2 * rr], dc[4 * j + 2 * rr + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dW: f32 partial sums of x1^T dz over ranges of K-blocks, then their sum

template <int BN>
struct DwLayout {
  static constexpr int X_BYTES = 2 * BOX;          // two c2 boxes (64 pair rows x 64)
  static constexpr int D_BYTES = (BN / 64) * BOX;  // the dz boxes (64 rows x 64 each)
  static constexpr int STAGE = X_BYTES + D_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "swizzle atoms");
  static_assert(STAGES >= 4, "the ring needs four stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

// the first K-block of split sp (ops/streaming_train.py:PairDwPlan.split_range)
__device__ __forceinline__ int split_begin(int sp, int kblocks, int splits) {
  return (int)(((long long)sp * kblocks) / splits);
}

// Item t is output tile t % tiles of split t / tiles; output tile r is
// column tile r % tiles_n of row tile r / tiles_n.  K-block kb is rows
// (kb % lblocks) * 64 .. + 63 of sequence kb / lblocks.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
pair_train_dw_kernel(const __grid_constant__ CUtensorMap tm_c,
                     const __grid_constant__ CUtensorMap tm_dz,
                     const __nv_bfloat16* __restrict__ a2, float* __restrict__ partial, int K,
                     int N, int tiles_n, int tiles, int lblocks, int kblocks, int splits,
                     int items) {
  using Lay = DwLayout<BN>;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar0 = base + Lay::BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int sp = t / tiles;
        const int r = t - sp * tiles;
        const int m0 = (r / tiles_n) * BM;
        const int n0 = (r % tiles_n) * BN;
        const int kb1 = split_begin(sp + 1, kblocks, splits);
        for (int kb = split_begin(sp, kblocks, splits); kb < kb1; ++kb) {
          const int b = kb / lblocks;
          const int l0 = (kb - b * lblocks) * BK;
          mbar_wait(empty_bar(s), phase ^ 1u);
          const uint32_t st = base + s * Lay::STAGE;
          mbar_expect_tx(full_bar(s), Lay::STAGE);
          tma_load(st, &tm_c, m0, l0, full_bar(s));
          tma_load(st + BOX, &tm_c, m0 + 64, l0, full_bar(s));
#pragma unroll
          for (int i = 0; i < BN / 64; ++i)
            tma_load_3d(st + Lay::X_BYTES + i * BOX, &tm_dz, n0 + 64 * i, l0, b, full_bar(s));
          if (++s == STAGES) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int q = lane & 3;
    const int row = wg * 64 + warp * 16 + g;  // the thread's first row (input column) in the tile
    // ldmatrix.trans of the warpgroup's c2 box: for k-step kk, lane 8j + r
    // points at pair row 16 kk + 8 (j >> 1) + r, 16-byte chunk 2 warp + (j & 1)
    // (input columns 16 warp + 8 (j & 1) ..), whose place TMA's 128-byte
    // swizzle moved to chunk ^ r; matrices j = 0..3 are the A fragment's
    // a0..a3 (rows g, g + 8 x pair columns 2q, 2q + 8 of the k-step)
    const int lj = lane >> 3;
    const int lr = lane & 7;
    const uint32_t ld_off = (8 * (lj >> 1) + lr) * 128 + (((2 * warp + (lj & 1)) ^ lr) << 4);
    float acc[BN / 2];
    uint32_t fa[2][4][4];
    float av0 = 0.f, av1 = 0.f;  // a2[b] at the thread's two rows
    int s = 0;
    uint32_t phase = 0;
    // One stage: wait for its tiles, form x1^T = bf16(relu(a2[b] + c2)) in
    // fa[P] from the c2 box, issue its four products against the dz tile,
    // then retire the previous stage's and free its slot.
    auto stage = [&](auto parity, bool first, int& prev) {
      constexpr int P = decltype(parity)::value;
      mbar_wait(full_bar(s), phase);
      const uint32_t st = base + s * Lay::STAGE;
      const uint32_t box = st + wg * BOX;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t c[4];
        ldsm_x4_trans(c, box + kk * 16 * 128 + ld_off);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = unpack_bf16x2(c[i]);
          const float a = (i & 1) ? av1 : av0;  // a1, a3: row g + 8
          fa[P][kk][i] = pack_bf16x2(fmaxf(a + v.x, 0.f), fmaxf(a + v.y, 0.f));
        }
      }
      const uint64_t db = smem_desc_mn(st + Lay::X_BYTES, BOX);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 pair rows: 2048 bytes
        MmaRsT<BN>::rs(acc, fa[P][kk], db + 128 * kk, !first || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_acc(acc);
      // the wgmma reads its register operands while in flight: the set that
      // fed the previous stage stays live (unreused) until here
      fence_regs(fa[1 - P]);
      if (prev >= 0 && lane == 0) mbar_arrive(empty_bar(prev));
      prev = s;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1u;
      }
    };
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const int sp = t / tiles;
      const int r = t - sp * tiles;
      const int m0 = (r / tiles_n) * BM;
      const int n0 = (r % tiles_n) * BN;
      const int kb0 = split_begin(sp, kblocks, splits);
      const int kb1 = split_begin(sp + 1, kblocks, splits);
      int cur_b = -1;
      int prev = -1;
      for (int kb = kb0; kb < kb1; ++kb) {
        const int b = kb / lblocks;
        if (b != cur_b) {
          const __nv_bfloat16* ab = a2 + (size_t)b * K + m0 + row;
          av0 = __bfloat162float(ab[0]);
          av1 = __bfloat162float(ab[8]);
          cur_b = b;
        }
        if ((kb - kb0) & 1)
          stage(std::integral_constant<int, 1>(), kb == kb0, prev);
        else
          stage(std::integral_constant<int, 0>(), kb == kb0, prev);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      fence_regs(fa[0]);
      fence_regs(fa[1]);
      if (prev >= 0 && lane == 0) mbar_arrive(empty_bar(prev));
      if (kb1 == kb0) {  // an empty split adds zeros
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      }
      // the f32 partial sums of rows m0 + row, + 8 (acc's layout as dX's)
      float* dst = partial + ((size_t)sp * K + m0 + row) * N + n0 + 2 * q;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(dst + (size_t)8 * N + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// dW = bf16(sum over the splits of the partial sums), four elements a step
__global__ void pair_train_dw_reduce_kernel(const float4* __restrict__ partial,
                                            uint2* __restrict__ dw, size_t n4, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 v = __ldg(partial + i);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 w = __ldg(partial + (size_t)sp * n4 + i);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    dw[i] = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BN>
cudaError_t launch_dw(const CUtensorMap& tm_c, const CUtensorMap& tm_dz, const void* a2,
                      float* partial, void* dw, int K, int N, int tiles_n, int tiles, int lblocks,
                      int kblocks, int splits, int items, int grid, cudaStream_t s) {
  constexpr int bytes = DwLayout<BN>::BYTES;
  auto kernel = pair_train_dw_kernel<BN>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, bytes, s>>>(tm_c, tm_dz, static_cast<const __nv_bfloat16*>(a2), partial,
                                      K, N, tiles_n, tiles, lblocks, kblocks, splits, items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)K * N / 4;
  const size_t want = (n4 + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  pair_train_dw_reduce_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(partial),
                                                     static_cast<uint2*>(dw), n4, splits);
  return cudaGetLastError();
}

}  // namespace

// dX of z = relu(a2[b] + c2[l]) @ W: da2 (B, K) float32, which the caller
// zeroes (the kernel adds to it), and dc2 (L, K) bf16 (written whole), from
// dz (B * L, N) bf16 with rows b * L + l, W (K, N), a2 (B, K) and c2 (L, K),
// all bf16, row-major, contiguous and 16-byte aligned.  K is a multiple of
// 128 and N of 64; grid is the number of persistent blocks (at most one an
// SM).  Returns a CUDA error (0 on success): cudaErrorInvalidValue for shapes
// the kernel does not take or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int pair_train_dx(const void* dz, const void* w, const void* a2, const void* c2,
                             void* da2, void* dc2, int B, int L, int K, int N, int grid,
                             void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || K % DX_BN != 0 || N <= 0 || N % BK != 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_k = K / DX_BN;
  const uint64_t units = (uint64_t)((L + BM - 1) / BM) * tiles_k;
  if (units > (uint64_t)INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  const bool ok = make_map_3d(&maps[0], dz, MapType::BF16, B, L, N, BM, BK, true) &&
                  make_map(&maps[1], w, MapType::BF16, K, N, DX_BN, BK, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int g = grid < (int)units ? grid : (int)units;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  constexpr int bytes = DxLayout::BYTES;
  cudaError_t err = allow_smem(pair_train_dx_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  pair_train_dx_kernel<<<g, THREADS, bytes, s>>>(
      maps[0], maps[1], static_cast<const __nv_bfloat16*>(a2),
      static_cast<const __nv_bfloat16*>(c2), static_cast<float*>(da2),
      static_cast<__nv_bfloat16*>(dc2), B, L, K, N, tiles_k, (int)units);
  return (int)cudaGetLastError();
}

// dW (K, N) bf16 of z = relu(a2[b] + c2[l]) @ W, from a2 (B, K), c2 (L, K)
// and dz (B * L, N), all bf16, row-major, contiguous and 16-byte aligned;
// partial is a float32 scratch of splits x K x N.  K is a multiple of 128, N
// of block_n (256 or 128); 1 <= splits <= B * ceil(L / 64).  Returns a CUDA
// error as pair_train_dx.
extern "C" int pair_train_dw(const void* a2, const void* c2, const void* dz, void* partial,
                             void* dw, int B, int L, int K, int N, int block_n, int splits,
                             int grid, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || K % BM != 0 || (block_n != 128 && block_n != 256) ||
      N <= 0 || N % block_n != 0 || grid <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int lblocks = (L + BK - 1) / BK;
  const uint64_t kblocks = (uint64_t)B * lblocks;
  const int tiles_n = N / block_n;
  const uint64_t tiles = (uint64_t)(K / BM) * tiles_n;
  if (kblocks > (uint64_t)INT_MAX || (uint64_t)splits > kblocks ||
      tiles * splits > (uint64_t)INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int items = (int)(tiles * splits);
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  const bool ok = make_map(&maps[0], c2, MapType::BF16, L, K, 64, BK, true) &&
                  make_map_3d(&maps[1], dz, MapType::BF16, B, L, N, 64, BK, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int g = grid < items ? grid : items;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  auto launch = block_n == 256 ? launch_dw<256> : launch_dw<128>;
  return (int)launch(maps[0], maps[1], a2, p, dw, K, N, tiles_n, (int)tiles, lblocks,
                     (int)kblocks, splits, items, g, s);
}

// The dynamic shared memory a launch asks for (bytes): which 0 is the dX
// kernel, 1 the dW kernel with the given column tile; -1 for what neither
// takes.
extern "C" int pair_train_bwd_smem_bytes(int which, int block_n) {
  if (which == 0) return DxLayout::BYTES;
  if (which == 1) return block_n == 256 ? DwLayout<256>::BYTES
                         : block_n == 128 ? DwLayout<128>::BYTES : -1;
  return -1;
}
