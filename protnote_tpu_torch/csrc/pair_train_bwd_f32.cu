// The backward of K4 in float32 for Hopper (sm_90a): the gradients of
// z = relu(a2[b] + c2[l]) @ W over every (sequence, label) pair, at float32's
// precision on the bf16 tensor cores.
//
// Replaces the autodiff backward of the TPU op chain
// protnote_tpu/ops/streaming_train.py:238-240 (the first hidden GEMM of
// pair_logits_dense_decomposed after the broadcast relu(a2 + c2)) at
// compute_dtype float32 (MIXED_PRECISION False, Precision.HIGHEST): with dz
// (B * L, N) float32, rows b * L + l,
//
//   dx1[b, l] = (dz[b, l] @ W^T) where a2[b] + c2[l] > 0, else 0
//   da2[b]    = sum_l dx1[b, l]                  (pair_train_dx_f32)
//   dc2[l]    = sum_b dx1[b, l]
//   dW        = x1^T @ dz, x1 = relu(a2[b] + c2[l])  (pair_train_dw_f32)
//
// all float32; dx1 is not rounded before its sums (JAX rounds it only in
// bf16), and neither x1, its gate nor dx1 is stored.
//
// The products take the split of csrc/pair_scorer_f32.cu: each float32
// operand as three bf16 pieces (bf16x3.cuh), the six products that keep
// float32's precision issued as register-A wgmma, each stage's products in
// accumulators of its own that are then added into float32 sums rounded to
// nearest (the tensor cores' adds are not float32's: over K1's depth in one
// set of accumulators the error reached 1.9e-5 of the largest logit).
//
// pair_train_dx_f32: a unit is (label tile of 128 labels, column tile of 64
// input columns k); a persistent block walks units with the column tiles
// fastest (the blocks in flight read the same dz rows) and, in each, every
// sequence b in order: dz's 128 x 64 float32 box of (b, labels) comes by a
// 3-D TMA load (rows past L as zeros) and is split in registers (A), W's
// pieces (W itself is K-major for dX: row k holds W[k, :]) are TMA-loaded
// as the B tiles.  After a sequence's reduction over N the epilogue gates
// the sums with the forward's own float32 a2 + c2, adds them into dc2's
// per-thread float32 sums (in sequence order; stored once a unit), and sums
// the 128 rows of each column into da2's partial for (label tile, b): two
// rows in the thread, then a butterfly over the warp's 8 row groups, then
// the 8 warps in order through shared memory.  A second kernel adds the
// label tiles' partials in order.  No atomics: the same bits every call.
// 64 columns (m64n64k16) keep the stage, the step and dc2's sums (3 x 32
// floats) with the split's 48 fragment registers within 232 registers.
//
// pair_train_dw_f32 computes dW^T = dz^T @ x1, so that the operand formed
// from the forward (x1) is the one that goes to shared memory: an output
// tile is 128 rows n x 128 columns k, its reduction runs over 64-label
// blocks (label block outermost, every sequence inside it).  A step's
// stage brings dz's 64 x 128 box of (b, label block) and c2's 64 x 128 box
// of the label block by TMA; the consumers form x1 = relu(a2[b] + c2[l]),
// split it and write its three pieces K-major into one of two piece
// buffers (the layout TMA would write, 128-byte swizzled), and read dz^T's
// fragments from the stage (A, split in registers).  One barrier a step: the
// buffer written at step i was last read by step i - 2's products, which
// every warpgroup waited for before step i - 1's barrier.  The plan
// (ops/streaming_train.py:pair_dw_plan, 128-column tiles) runs the whole
// waves' tiles whole (float32 dW out) and cuts the last wave's tiles into
// label-block ranges whose float32 partials a second kernel adds in order.
//
// What bounds them: the products at the split's rate.  At the default
// width (32 sequences x 32,102 labels, K = N = 3072) each is 19.4 TFLOP,
// 117.6 ms at 989 / 6 = 165 TFLOP/s (289 ms on the 67 TFLOP/s FMA pipe).
// The first design keeps to simple schedules: the split and the piece
// writes run between the products, not under them.
//
// pair_train_dw_prod_f32 is the dW kernel with x1's pieces formed from the
// dense scorer's prod block, x1 = P_e[b] * L_e[l] (one float32 product), in
// place of relu(a2[b] + c2[l]): dW_prod = (p * l)^T @ dz, the first Linear's
// prod rows of protnote_tpu/ops/pair_scorer.py:108 pair_logits_dense in
// float32 (6.4 TFLOP at 32 sequences, d 1024: 39.2 ms at the split's rate).

#include "bf16x3.cuh"
#include "hopper.cuh"

#include <limits.h>
#include <string.h>

namespace {

constexpr int BK = 64;          // reduction depth a stage: one 128-byte row of bf16
constexpr int PIECES = 3;       // bf16 pieces of a float32 value
constexpr int CONSUMERS = 2;    // consumer warpgroups; the producer's is the last
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// ---- dX ---------------------------------------------------------------
constexpr int DX_BL = 128;  // labels a tile: one sequence's, 64 a consumer warpgroup
constexpr int DX_BN = 64;   // input columns k a tile

struct DxLayout {
  static constexpr int W_BYTES = DX_BN * BK * 2;   // one piece's 64 x 64 bf16 W tile
  static constexpr int HALF_BYTES = DX_BL * 32 * 4;  // dz's 128 x 32 float32 half box
  static constexpr int STAGE = PIECES * W_BYTES + 2 * HALF_BYTES;
  static constexpr int STAGES = 3;
  static constexpr int RED_OFF = STAGES * STAGE;
  static constexpr int RED_BYTES = 2 * 2 * 4 * DX_BN * 4;  // two slots x 8 warps x 64 floats
  static constexpr int BAR_OFF = RED_OFF + RED_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0, "swizzle atoms");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

// ---- dW ---------------------------------------------------------------
constexpr int DW_BM = 128;    // output rows n (dz's columns): 64 a consumer warpgroup
constexpr int DW_BN = 128;    // output columns k (x1's columns)
constexpr int DW_ROWS = 64;   // pair rows a step: 64 labels of one sequence

struct DwLayout {
  static constexpr int HALF_BYTES = DW_ROWS * 32 * 4;  // a 64 x 32 float32 half box
  static constexpr int DZ_OFF = 0;                     // dz's box: 4 halves over n
  static constexpr int C_OFF = 4 * HALF_BYTES;         // c2's box: 4 halves over k
  static constexpr int STAGE = 8 * HALF_BYTES;
  static constexpr int STAGES = 2;
  static constexpr int PIECE_BYTES = DW_BN * DW_ROWS * 2;  // x1^T's piece: 128 rows k x 64
  static constexpr int PBUF_BYTES = PIECES * PIECE_BYTES;
  static constexpr int PBUF_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = PBUF_OFF + 2 * PBUF_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0 && PIECE_BYTES % 1024 == 0, "swizzle atoms");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

// a barrier of the two consumer warpgroups' 256 threads
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

// element (row r, column c < 32) of a 128-byte-swizzled float32 half box
__device__ __forceinline__ int swz(int r, int c) {
  return r * 32 + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// The six register-A products of a 64-deep stage into acc (overwritten),
// the five small cross products of every k-step first: A pieces fa, B piece
// tiles at descriptors d[p] (K-major, 128-byte swizzled rows of 64 bf16).
template <int N, int NACC>
__device__ __forceinline__ void split_products(float (&acc)[NACC], uint32_t (&fa)[PIECES][4][4],
                                               const uint64_t (&d)[PIECES]) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t o = 2 * kk;
    Mma<N>::rs(acc, fa[0][kk], d[1] + o, kk > 0);
    Mma<N>::rs(acc, fa[1][kk], d[0] + o, 1);
    Mma<N>::rs(acc, fa[0][kk], d[2] + o, 1);
    Mma<N>::rs(acc, fa[1][kk], d[1] + o, 1);
    Mma<N>::rs(acc, fa[2][kk], d[0] + o, 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Mma<N>::rs(acc, fa[0][kk], d[0] + 2 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int p = 0; p < PIECES; ++p) fence_regs(fa[p]);
}

__global__ void __launch_bounds__(THREADS, 1)
pair_train_dx_f32_kernel(const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_dz,
                         const float* __restrict__ a2, const float* __restrict__ c2,
                         float* __restrict__ da2_part, float* __restrict__ dc2, int B, int L,
                         int K, int N, int tiles_k, int units) {
  using Lay = DxLayout;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + Lay::BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (STAGES + s); };
  const int NT = N / BK;

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
    // ---- producer: one thread keeps the ring full ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int l0 = (u / tiles_k) * DX_BL;
        const int k0 = (u % tiles_k) * DX_BN;
        for (int b = 0; b < B; ++b) {
          for (int nt = 0; nt < NT; ++nt) {
            mbar_wait(empty_bar(s), phase ^ 1u);
            const uint32_t st = base + s * Lay::STAGE;
            mbar_expect_tx(full_bar(s), Lay::STAGE);
#pragma unroll
            for (int p = 0; p < PIECES; ++p)
              tma_load(st + p * Lay::W_BYTES, &tm_w, nt * BK, p * K + k0, full_bar(s));
            const uint32_t at = st + PIECES * Lay::W_BYTES;
            tma_load_3d(at, &tm_dz, nt * BK, l0, b, full_bar(s));
            tma_load_3d(at + Lay::HALF_BYTES, &tm_dz, nt * BK + 32, l0, b, full_bar(s));
            if (++s == STAGES) {
              s = 0;
              phase ^= 1u;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers ----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int q = lane & 3;
    const int row = wg * 64 + warp * 16 + g;  // the thread's first label row of the tile
    float* red = reinterpret_cast<float*>(smem + Lay::RED_OFF);
    float acc[DX_BN / 2];
    float sum[DX_BN / 2];
    float dc[DX_BN / 2];  // dc2's sums over the sequences, the layout of sum
    uint32_t fa[PIECES][4][4];
    int s = 0;
    uint32_t phase = 0;
    int slot = 0;  // red's slot: alternates with every sequence, across units too
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int lt = u / tiles_k;
      const int l0 = lt * DX_BL;
      const int k0 = (u % tiles_k) * DX_BN;
      const int la = l0 + row, lb = la + 8;  // the thread's two labels
#pragma unroll
      for (int i = 0; i < DX_BN / 2; ++i) dc[i] = 0.f;
      for (int b = 0; b < B; ++b) {
#pragma unroll
        for (int i = 0; i < DX_BN / 2; ++i) sum[i] = 0.f;
        for (int nt = 0; nt < NT; ++nt) {
          mbar_wait(full_bar(s), phase);
          const uint32_t st = base + s * Lay::STAGE;
          const unsigned char* sp = smem + s * Lay::STAGE + PIECES * Lay::W_BYTES;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* half = reinterpret_cast<const float*>(sp + (kk >> 1) * Lay::HALF_BYTES);
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int col = (kk & 1) * 16 + 2 * q + 8 * cc;
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                const float2 x = *reinterpret_cast<const float2*>(half + swz(row + 8 * rr, col));
                const int e = rr + 2 * cc;
                split3(x, fa[0][kk][e], fa[1][kk][e], fa[2][kk][e]);
              }
            }
          }
          const uint64_t d[PIECES] = {smem_desc(st), smem_desc(st + Lay::W_BYTES),
                                      smem_desc(st + 2 * Lay::W_BYTES)};
          split_products<DX_BN>(acc, fa, d);
          if (lane == 0) mbar_arrive(empty_bar(s));
#pragma unroll
          for (int i = 0; i < DX_BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
          if (++s == STAGES) {
            s = 0;
            phase ^= 1u;
          }
        }
        // ---- sequence b's epilogue: the gate, dc2's sums, da2's partial ----
        // sum[4j + 0/1]: label la, columns k0 + 8j + 2q + 0/1; [4j + 2/3]: lb
        const float* arow = a2 + (size_t)b * K + k0;
        const float* ca = la < L ? c2 + (size_t)la * K + k0 : nullptr;
        const float* cb = lb < L ? c2 + (size_t)lb * K + k0 : nullptr;
        float colsum[DX_BN / 4];
#pragma unroll
        for (int j = 0; j < DX_BN / 8; ++j) {
          const int col = 8 * j + 2 * q;
          const float2 av = *reinterpret_cast<const float2*>(arow + col);
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (ca) {
            const float2 cv = *reinterpret_cast<const float2*>(ca + col);
            v[0] = pair_relu(av.x, cv.x) > 0.f ? sum[4 * j] : 0.f;
            v[1] = pair_relu(av.y, cv.y) > 0.f ? sum[4 * j + 1] : 0.f;
          }
          if (cb) {
            const float2 cv = *reinterpret_cast<const float2*>(cb + col);
            v[2] = pair_relu(av.x, cv.x) > 0.f ? sum[4 * j + 2] : 0.f;
            v[3] = pair_relu(av.y, cv.y) > 0.f ? sum[4 * j + 3] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) dc[4 * j + i] = __fadd_rn(dc[4 * j + i], v[i]);
          colsum[2 * j] = __fadd_rn(v[0], v[2]);
          colsum[2 * j + 1] = __fadd_rn(v[1], v[3]);
        }
        // the warp's 16 rows: a butterfly over the row groups g (lane 4g + q)
#pragma unroll
        for (int i = 0; i < DX_BN / 4; ++i) {
          colsum[i] = __fadd_rn(colsum[i], __shfl_xor_sync(0xffffffffu, colsum[i], 4));
          colsum[i] = __fadd_rn(colsum[i], __shfl_xor_sync(0xffffffffu, colsum[i], 8));
          colsum[i] = __fadd_rn(colsum[i], __shfl_xor_sync(0xffffffffu, colsum[i], 16));
        }
        float* rs = red + slot * (8 * DX_BN);
        if (g == 0) {
#pragma unroll
          for (int j = 0; j < DX_BN / 8; ++j) {
            rs[(wg * 4 + warp) * DX_BN + 8 * j + 2 * q] = colsum[2 * j];
            rs[(wg * 4 + warp) * DX_BN + 8 * j + 2 * q + 1] = colsum[2 * j + 1];
          }
        }
        consumer_barrier();
        if (wg == 0 && tid < DX_BN) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) t = __fadd_rn(t, rs[w * DX_BN + tid]);
          da2_part[((size_t)lt * B + b) * K + k0 + tid] = t;
        }
        slot ^= 1;
      }
      // dc2 of the unit's labels, once
#pragma unroll
      for (int j = 0; j < DX_BN / 8; ++j) {
        const int col = k0 + 8 * j + 2 * q;
        if (la < L)
          *reinterpret_cast<float2*>(dc2 + (size_t)la * K + col) =
              make_float2(dc[4 * j], dc[4 * j + 1]);
        if (lb < L)
          *reinterpret_cast<float2*>(dc2 + (size_t)lb * K + col) =
              make_float2(dc[4 * j + 2], dc[4 * j + 3]);
      }
    }
  }
}

// da2[b, k] = sum over the label tiles of da2_part[t, b, k], in tile order
__global__ void ordered_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int parts, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = 0.f;
  for (int p = 0; p < parts; ++p) t = __fadd_rn(t, part[(size_t)p * n + i]);
  out[i] = t;
}

// PROD: x1 = a2[b] * c2[l] (a2, c2 = P_e, L_e), else relu(a2[b] + c2[l])
template <bool PROD>
__global__ void __launch_bounds__(THREADS, 1)
pair_train_dw_f32_kernel(const __grid_constant__ CUtensorMap tm_dz,
                         const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ a2,
                         float* __restrict__ partial, float* __restrict__ dw, int B, int K,
                         int N, int tiles_n, int full, int tail, int pieces, int lblocks,
                         int items) {
  using Lay = DwLayout;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + Lay::BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (STAGES + s); };

  // item t: (output tile, label blocks [lb0, lb1), partial slot or -1)
  auto item = [&](int t, int& k0, int& n0, int& lb0, int& lb1, int& slot) {
    int tile = t;
    lb0 = 0;
    lb1 = lblocks;
    slot = -1;
    if (t >= full) {
      const int p = (t - full) / tail;
      tile = full + (t - full) % tail;
      if (pieces > 1) {
        lb0 = (int)((long long)p * lblocks / pieces);
        lb1 = (int)((long long)(p + 1) * lblocks / pieces);
        slot = t - full;
      }
    }
    k0 = (tile / tiles_n) * DW_BN;
    n0 = (tile % tiles_n) * DW_BM;
  };

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
        int k0, n0, lb0, lb1, slot;
        item(t, k0, n0, lb0, lb1, slot);
        for (int lb = lb0; lb < lb1; ++lb) {
          for (int b = 0; b < B; ++b) {
            mbar_wait(empty_bar(s), phase ^ 1u);
            const uint32_t st = base + s * Lay::STAGE;
            mbar_expect_tx(full_bar(s), Lay::STAGE);
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              tma_load_3d(st + Lay::DZ_OFF + h * Lay::HALF_BYTES, &tm_dz, n0 + 32 * h,
                          lb * DW_ROWS, b, full_bar(s));
              tma_load(st + Lay::C_OFF + h * Lay::HALF_BYTES, &tm_c, k0 + 32 * h, lb * DW_ROWS,
                       full_bar(s));
            }
            if (++s == STAGES) {
              s = 0;
              phase ^= 1u;
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    const int ct = wg * 128 + tid;  // 0..255: the thread's x1^T row and half
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int q = lane & 3;
    const int row = wg * 64 + warp * 16 + g;  // the thread's first output row n
    const int kr = ct >> 1;                   // the x1^T row (column k) it forms
    const int mh = ct & 1;                    // and which 32 of the 64 labels
    float acc[DW_BN / 2];
    float sum[DW_BN / 2];
    uint32_t fa[PIECES][4][4];
    int s = 0;
    uint32_t phase = 0;
    int step = 0;  // every step of the block: the piece buffer alternates
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      int k0, n0, lb0, lb1, slot;
      item(t, k0, n0, lb0, lb1, slot);
#pragma unroll
      for (int i = 0; i < DW_BN / 2; ++i) sum[i] = 0.f;
      for (int lb = lb0; lb < lb1; ++lb) {
        for (int b = 0; b < B; ++b, ++step) {
          mbar_wait(full_bar(s), phase);
          const unsigned char* sp = smem + s * Lay::STAGE;
          const uint32_t pbuf = base + Lay::PBUF_OFF + (step & 1) * Lay::PBUF_BYTES;
          // B: x1^T's row kr for labels 32 mh .. 32 mh + 31, as three pieces
          {
            const float ak = a2[(size_t)b * K + k0 + kr];
            const float* ch = reinterpret_cast<const float*>(sp + Lay::C_OFF +
                                                             (kr >> 5) * Lay::HALF_BYTES);
            const int cc = kr & 31;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int mc = mh * 4 + c;  // 16-byte chunk of the 128-byte row
              uint32_t w[PIECES][4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int m = mc * 8 + 2 * e;
                const float c0 = ch[swz(m, cc)], c1 = ch[swz(m + 1, cc)];
                const float2 x = PROD ? make_float2(__fmul_rn(ak, c0), __fmul_rn(ak, c1))
                                      : make_float2(pair_relu(ak, c0), pair_relu(ak, c1));
                split3(x, w[0][e], w[1][e], w[2][e]);
              }
              const uint32_t off = kr * 128 + ((mc ^ (kr & 7)) << 4);
#pragma unroll
              for (int p = 0; p < PIECES; ++p)
                st_shared_v4(pbuf + p * Lay::PIECE_BYTES + off, w[p]);
            }
          }
          // A: dz^T's fragments (rows n, columns the step's labels m)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int m = kk * 16 + 2 * q + 8 * cc;
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                const int n = row + 8 * rr;
                const float* half = reinterpret_cast<const float*>(sp + Lay::DZ_OFF +
                                                                   (n >> 5) * Lay::HALF_BYTES);
                const float2 x = make_float2(half[swz(m, n & 31)], half[swz(m + 1, n & 31)]);
                const int e = rr + 2 * cc;
                split3(x, fa[0][kk][e], fa[1][kk][e], fa[2][kk][e]);
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_bar(s));  // the stage is read
          fence_async_smem();  // the pieces, written by threads, for wgmma's reads
          consumer_barrier();
          const uint64_t d[PIECES] = {smem_desc(pbuf), smem_desc(pbuf + Lay::PIECE_BYTES),
                                      smem_desc(pbuf + 2 * Lay::PIECE_BYTES)};
          split_products<DW_BN>(acc, fa, d);
#pragma unroll
          for (int i = 0; i < DW_BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
          if (++s == STAGES) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
      // ---- epilogue: dW[k, n] = sum (row n, column k), or the slot's partial
#pragma unroll
      for (int j = 0; j < DW_BN / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kl = 8 * j + 2 * q + (i & 1);
          const int nl = row + 8 * (i >> 1);
          if (slot < 0)
            dw[(size_t)(k0 + kl) * N + n0 + nl] = sum[4 * j + i];
          else
            partial[((size_t)slot * DW_BN + kl) * DW_BM + nl] = sum[4 * j + i];
        }
      }
    }
  }
}

// dW of the cut tiles: element (kl, nl) of tail tile tt is the sum over the
// pieces p, in order, of slot p * tail + tt
__global__ void dw_pieces_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                 int N, int tiles_n, int full, int tail, int pieces) {
  const int tt = blockIdx.y;
  const int tile = full + tt;
  const int k0 = (tile / tiles_n) * DW_BN, n0 = (tile % tiles_n) * DW_BM;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < DW_BN * DW_BM;
       e += gridDim.x * blockDim.x) {
    float t = 0.f;
    for (int p = 0; p < pieces; ++p)
      t = __fadd_rn(t, partial[(size_t)(p * tail + tt) * DW_BN * DW_BM + e]);
    dw[(size_t)(k0 + e / DW_BM) * N + n0 + e % DW_BM] = t;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// dX in float32: dz (B * L, N), w3 (3K, N) bf16 (the three pieces of W
// (K, N), stacked: row p K + k is piece p of W[k, :]), a2 (B, K), c2 (L, K);
// da2_part (ceil(L / 128), B, K) float32 scratch, da2 (B, K), dc2 (L, K)
// float32 out.  K a multiple of 128, N of 64; grid the persistent blocks.
// Returns a CUDA error (0 on success).
extern "C" int pair_train_dx_f32(const void* dz, const void* w3, const void* a2, const void* c2,
                                 void* da2_part, void* da2, void* dc2, int B, int L, int K, int N,
                                 int grid, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || K % 128 != 0 || N <= 0 || N % BK != 0 || grid <= 0 ||
      dz == nullptr || w3 == nullptr || a2 == nullptr || c2 == nullptr || da2_part == nullptr ||
      da2 == nullptr || dc2 == nullptr)
    return (int)cudaErrorInvalidValue;
  const int tiles_l = (L + DX_BL - 1) / DX_BL;
  const int tiles_k = K / DX_BN;
  if ((long long)tiles_l * tiles_k > INT_MAX) return (int)cudaErrorInvalidValue;
  const int units = tiles_l * tiles_k;
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward thread may have none yet), which
  // cuTensorMapEncodeTiled needs
  constexpr int bytes = DxLayout::BYTES;
  cudaError_t err = allow_smem(pair_train_dx_f32_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  if (!(make_map(&maps[0], w3, MapType::BF16, (uint64_t)PIECES * K, N, DX_BN, BK, true) &&
        make_map_3d(&maps[1], dz, MapType::F32, B, L, N, DX_BL, 32, true)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  pair_train_dx_f32_kernel<<<grid < units ? grid : units, THREADS, bytes, s>>>(
      maps[0], maps[1], static_cast<const float*>(a2), static_cast<const float*>(c2),
      static_cast<float*>(da2_part), static_cast<float*>(dc2), B, L, K, N, tiles_k, units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * K;
  ordered_parts_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(da2_part), static_cast<float*>(da2), tiles_l, n);
  return (int)cudaGetLastError();
}

namespace {

template <bool PROD>
int dw_f32(const void* a2, const void* c2, const void* dz, void* partial, void* dw, int B, int L,
           int K, int N, int full, int pieces, int grid, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || K % DW_BN != 0 || N <= 0 || N % DW_BM != 0 || grid <= 0 ||
      pieces <= 0 || full < 0 || a2 == nullptr || c2 == nullptr || dz == nullptr || dw == nullptr)
    return (int)cudaErrorInvalidValue;
  const int tiles_n = N / DW_BM;
  const long long tiles = (long long)(K / DW_BN) * tiles_n;
  const int lblocks = (L + DW_ROWS - 1) / DW_ROWS;
  if (full > tiles || (pieces > 1 && (partial == nullptr || pieces > lblocks)))
    return (int)cudaErrorInvalidValue;
  const int tail = (int)(tiles - full);
  const long long items = full + (long long)tail * pieces;
  if (items > INT_MAX || (long long)lblocks * B > INT_MAX) return (int)cudaErrorInvalidValue;
  constexpr int bytes = DwLayout::BYTES;
  cudaError_t err = allow_smem(pair_train_dw_f32_kernel<PROD>, bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  if (!(make_map_3d(&maps[0], dz, MapType::F32, B, L, N, DW_ROWS, 32, true) &&
        make_map(&maps[1], c2, MapType::F32, L, K, DW_ROWS, 32, true)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  pair_train_dw_f32_kernel<PROD><<<grid < items ? grid : (int)items, THREADS, bytes, s>>>(
      maps[0], maps[1], static_cast<const float*>(a2), static_cast<float*>(partial),
      static_cast<float*>(dw), B, K, N, tiles_n, full, tail, pieces, lblocks, (int)items);
  err = cudaGetLastError();
  if (err != cudaSuccess || pieces == 1 || tail == 0) return (int)err;
  dw_pieces_kernel<<<dim3(16, tail), 256, 0, s>>>(static_cast<const float*>(partial),
                                                  static_cast<float*>(dw), N, tiles_n, full,
                                                  tail, pieces);
  return (int)cudaGetLastError();
}

}  // namespace

// dW in float32: a2 (B, K), c2 (L, K), dz (B * L, N) float32; dw (K, N)
// float32 out; partial (tail * pieces, 128, 128) float32 scratch when pieces
// > 1.  The plan's (ops/streaming_train.py:pair_dw_plan with 128-column
// tiles) full, pieces and grid; K and N multiples of 128.
extern "C" int pair_train_dw_f32(const void* a2, const void* c2, const void* dz, void* partial,
                                 void* dw, int B, int L, int K, int N, int full, int pieces,
                                 int grid, void* stream) {
  return dw_f32<false>(a2, c2, dz, partial, dw, B, L, K, N, full, pieces, grid, stream);
}

// dW_prod in float32: (P_e * L_e)^T @ dz with P_e (B, K) and L_e (L, K) in
// place of a2 and c2, the rest as pair_train_dw_f32.
extern "C" int pair_train_dw_prod_f32(const void* P_e, const void* L_e, const void* dz,
                                      void* partial, void* dw, int B, int L, int K, int N,
                                      int full, int pieces, int grid, void* stream) {
  return dw_f32<true>(P_e, L_e, dz, partial, dw, B, L, K, N, full, pieces, grid, stream);
}

// The dynamic shared memory a launch asks for (bytes): 0 the dX kernel, 1
// the dW kernel; -1 otherwise.
extern "C" int pair_train_bwd_f32_smem_bytes(int which) {
  return which == 0 ? DxLayout::BYTES : which == 1 ? DwLayout::BYTES : -1;
}
