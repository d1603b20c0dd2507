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
// Every sum runs in a fixed order (no atomics): two calls give the same bits.
//
// What bounds it: the tensor cores.  Each product is 2 * B * L * K * N FLOP,
// 19.4 TFLOP at the default width, so the pair takes at least 39.2 ms at the
// 989 TFLOP/s dense bf16 peak; dz (6.3 GB) read once a kernel is 1.9 ms.
// Both kernels are warp-specialised on the mainloop of the forward
// (csrc/pair_train.cu): one block an SM, one producer thread keeping a ring
// of TMA-loaded, 128-byte-swizzled stages full (full/empty mbarrier pairs),
// two consumer warpgroups issuing wgmma m64n256k16.  dz is read through a
// 3-D tensor map over (B, L, N), so rows of a box past L (or a whole box past
// B) arrive as zeros and never come from the next sequence.  What an SM
// takes into shared memory for each FLOP set the pace of the first design's
// kernels (csrc/variants/pair_train_bwd_v1.cu, chip_variants.py --k4-bwd);
// the tiles below bring less.
//
// pair_train_dx: dX with the gate and both side sums in its epilogue.  A
// block owns one 256-input-column tile and a contiguous range of 64-label
// tiles (ops/streaming_train.py:pair_dx_plan: 12 column tiles x 11 label
// ranges fill 132 SMs at K 3072), and walks the B sequences of each label
// tile two at a time: consumer warpgroup 0 takes sequence 2p, warpgroup 1
// sequence 2p + 1, of the same 64 labels.  A stage is both sequences' dz
// boxes (64 labels x 64, K-major: 2 x 8 KB) and the W box (256 columns x 64:
// (K, N) row-major is K-major for this product, 32 KB), 48 KB for 4.2 MFLOP:
// 11.7 bytes a kFLOP (the first design's 128 x 128 tile: 15.6); three
// stages fit.  The 128-float accumulator leaves no registers for dc2's
// running sum, so the unit's f32 sum (64 x 256, 64 KB) lives in shared
// memory; both warpgroups add to it at once, each to one half of the
// columns and then to the other (named barriers 3 and 4), in the same order
// every call, and the last pair's adds store dc2.  The gate's a2 and c2
// values come from L2 (the stages leave L1 28 KB): read in the epilogue
// they stalled the tensor cores for 12% of the time, so the producer
// warpgroup's three idle warps read them while the products run and leave
// each consumer thread its 128 gate bits in shared memory (two pairs
// ahead).  da2 = sum_l dx1 is each tile's column sum: a reduce-scatter over
// the 8 lanes that share a column pair, a sum over the warpgroup's 4 warps
// in shared memory, added in label-tile order into the block's own f32 row
// of a (ranges, B, K) scratch; a second kernel adds the ranges in order.
// The blocks of one label range walk the same dz rows at once (12 column
// tiles), so dz comes from device memory about once.  Where few label tiles
// leave SMs idle (small L), the plan also splits the sequence pairs into
// groups: each group's dc2 is an f32 partial that the second kernel adds in
// group order.
//
// pair_train_dw: dW = x1^T dz with x1 formed in the A-operand registers, as
// the forward forms its x1.  A tile is 128 input columns x 256 (or 128)
// output columns; its reduction runs over 64-label blocks, label block
// outermost and the B sequences inside it.  A label block's c2 (64 labels x
// 128 columns, two boxes) is loaded once into a small ring of its own, and
// each consumer thread keeps its ldmatrix.trans fragments of its
// warpgroup's box in 16 registers; for each sequence it forms
// x1^T = bf16(relu(a2[b] + c2)) from them and its two a2[b] scalars, with
// no shared-memory read, and issues the register-A wgmma with B (dz, N
// contiguous) read MN-major through the transpose bit (MmaRsT, shared with
// K7's dW).  Only dz streams through the stage ring: 32 KB a 64-row step,
// 7.9 bytes a kFLOP with the c2 box (the first design loaded the c2 boxes
// every step: 11.7).  The 3072 x 3072 output in 128 x 256 tiles is 288
// tiles, 2.18 waves of 132 SMs: ops/streaming_train.py:pair_dw_plan runs
// the whole waves (264 tiles) whole, written as bf16, and cuts each of the
// 24 tiles of the last wave into 5 ranges of label blocks (120 pieces, one
// wave); the pieces' f32 sums are added in range order by a second kernel.
// Pieces are ordered range first, so the blocks in flight read the same dz
// rows, as the blocks of a whole wave do.
//
// pair_train_dw_prod: the same dW kernel for the dense scorer's
// concatenation_prod block (csrc/pair_train.cu:pair_train_prod), dW_prod =
// sum_{b, l} x[b, l]^T dz[b * L + l] with x = bf16(p[b] * l[l]) formed in the
// A registers from the kept fragments of l and the two p[b] scalars, as
// x1^T is formed here (a2 = P_e, c2 = L_e).
//
// Offsets: dz holds 3.16e9 elements; it is read only by TMA (64-bit
// strides), and every other index is 64-bit where it can pass 2^31.

#include "hopper.cuh"

#include <limits.h>
#include <math.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int BK = 64;        // reduction depth a stage: one 128-byte row of bf16
constexpr int CONSUMERS = 2;  // consumer warpgroups; the producer's is the last
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 56;  // setmaxnreg: registers a producer-warpgroup thread keeps
constexpr int CONSUMER_REGS = 224;
constexpr int BOX = 64 * BK * 2;  // one 64-row x 64-column bf16 box, 8 KB
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// named barriers of both consumer warpgroups (256 threads)
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// the first of n things in part i of `parts` (ops/streaming_train.py:_part)
__device__ __forceinline__ int part_begin(int i, int n, int parts) {
  return (int)(((long long)i * n) / parts);
}

// ---------------------------------------------------------------------------
// dX: dx1 = gate * bf16(dz . W^T), reduced to da2 and dc2

constexpr int DX_BL = 64;   // labels a tile: each consumer warpgroup's rows, its own sequence
constexpr int DX_BN = 256;  // input columns a tile
constexpr int DC_PHASE1 = 3;  // named barriers: the two warpgroups' dc2 adds
constexpr int DC_PHASE2 = 4;
constexpr int HELPERS = 96;  // the producer warpgroup's warps 1-3: the gate's bits

struct DxLayout {
  static constexpr int A_BYTES = DX_BL * BK * 2;  // one sequence's dz box: 64 labels x 64
  static constexpr int B_BYTES = DX_BN * BK * 2;  // the W box: 256 columns x 64
  static constexpr int STAGE = 2 * A_BYTES + B_BYTES;
  static constexpr int STAGES = 3;
  static constexpr int DC_BYTES = DX_BL * DX_BN * 4;  // dc2's f32 running sum
  static constexpr int RED_BYTES = CONSUMERS * 4 * DX_BN * 4;  // da2: warpgroup x warp x column
  // the gate's bits: two buffers (pair parity) x warpgroup x thread x 4 words
  static constexpr int GATE_BYTES = 2 * CONSUMERS * 128 * 4 * 4;
  static constexpr int DC_OFF = STAGES * STAGE;
  static constexpr int RED_OFF = DC_OFF + DC_BYTES;
  static constexpr int GATE_OFF = RED_OFF + RED_BYTES;
  static constexpr int BAR_OFF = GATE_OFF + GATE_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + (2 * STAGES + 4) * 8;  // + alignment slack
  static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0, "swizzle atoms");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

// The gate bits of one consumer thread (warpgroup wg, thread tid) for pair
// p: word 2 rr + hh holds, at bit 2 jj + e, pre > 0 at its row + 8 rr and
// column 8 (16 hh + jj) + 2q + e (0 for a sequence past B and for columns
// past K).  Computed by the helper warps in the f32 arithmetic of the
// reference: bf16 a2 + bf16 c2 > 0.
__device__ __forceinline__ uint32_t gate_word(const uint32_t* crow, const uint32_t* arow, int hh) {
  uint32_t w = 0;
#pragma unroll
  for (int jj = 0; jj < DX_BN / 16; ++jj) {
    const int j = (DX_BN / 16) * hh + jj;
    const float2 cv = unpack_bf16x2(__ldg(crow + 4 * j));
    const float2 av = unpack_bf16x2(__ldg(arow + 4 * j));
    w |= (uint32_t)(av.x + cv.x > 0.f) << (2 * jj);
    w |= (uint32_t)(av.y + cv.y > 0.f) << (2 * jj + 1);
  }
  return w;
}

// Block i takes column tile i % tiles_k, label range (i / tiles_k) % ranges
// and sequence-pair group i / (tiles_k * ranges) (ops/streaming_train.py:
// PairDxPlan.block); it walks its label tiles in order and, in each, its
// pairs in order.
__global__ void __launch_bounds__(THREADS, 1)
pair_train_dx_kernel(const __grid_constant__ CUtensorMap tm_dz,
                     const __grid_constant__ CUtensorMap tm_w, const __nv_bfloat16* __restrict__ a2,
                     const __nv_bfloat16* __restrict__ c2, float* __restrict__ da2_part,
                     float* __restrict__ dc2_part, __nv_bfloat16* __restrict__ dc2, int B, int L,
                     int K, int N, int tiles_l, int tiles_k, int ranges, int groups) {
  using Lay = DxLayout;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + Lay::BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (STAGES + s); };
  auto gfull_bar = [&](int gb) { return bar0 + 8u * (2 * STAGES + gb); };
  auto gempty_bar = [&](int gb) { return bar0 + 8u * (2 * STAGES + 2 + gb); };
  uint32_t* gate = reinterpret_cast<uint32_t*>(smem + Lay::GATE_OFF);
  const int NS = N / BK;
  const int kt = blockIdx.x % tiles_k;
  const int r = (blockIdx.x / tiles_k) % ranges;
  const int grp = blockIdx.x / (tiles_k * ranges);
  const int k0 = kt * DX_BN;
  const int lt0 = part_begin(r, tiles_l, ranges), lt1 = part_begin(r + 1, tiles_l, ranges);
  const int pairs = (B + 1) / 2;
  const int p0 = part_begin(grp, pairs, groups), p1 = part_begin(grp + 1, pairs, groups);
  // the last column tile of a K that is an odd multiple of 128 holds 128
  // real columns: W's rows past K arrive as zeros, and their gate bits are 0
  const bool half = K - k0 < DX_BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    for (int gb = 0; gb < 2; ++gb) {
      mbar_init(gfull_bar(gb), HELPERS);
      mbar_init(gempty_bar(gb), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      // ---- producer: one thread keeps the ring full -----------------------
      int s = 0;
      uint32_t phase = 0;
      for (int lt = lt0; lt < lt1; ++lt) {
        for (int p = p0; p < p1; ++p) {
          for (int ns = 0; ns < NS; ++ns) {
            mbar_wait(empty_bar(s), phase ^ 1u);
            const uint32_t st = base + s * Lay::STAGE;
            mbar_expect_tx(full_bar(s), Lay::STAGE);
            // sequence 2p + 1 = B (odd B) is wholly past the map: zeros
            tma_load_3d(st, &tm_dz, ns * BK, lt * DX_BL, 2 * p, full_bar(s));
            tma_load_3d(st + Lay::A_BYTES, &tm_dz, ns * BK, lt * DX_BL, 2 * p + 1, full_bar(s));
            tma_load(st + 2 * Lay::A_BYTES, &tm_w, ns * BK, k0, full_bar(s));
            if (++s == STAGES) {
              s = 0;
              phase ^= 1u;
            }
          }
        }
      }
    } else if (threadIdx.x >= CONSUMERS * 128 + 32) {
      // ---- helpers: the next pairs' gate bits, while the products run -----
      // (its a2 and c2 reads come from L2: in the consumers' epilogue they
      // stalled the tensor cores)
      const int h = threadIdx.x - (CONSUMERS * 128 + 32);
      int gb = 0;
      uint32_t gphase = 0;
      for (int lt = lt0; lt < lt1; ++lt) {
        for (int p = p0; p < p1; ++p) {
          mbar_wait(gempty_bar(gb), gphase ^ 1u);
          uint32_t* words = gate + gb * CONSUMERS * 128 * 4;
          for (int w = h; w < 2 * 128; w += HELPERS) {  // (consumer thread, row)
            const int tid = w >> 1, rr = w & 1;
            const int g = (tid & 31) >> 2, q = tid & 3;
            const int l = lt * DX_BL + (tid >> 5) * 16 + g + 8 * rr;
            const uint32_t* crow =
                reinterpret_cast<const uint32_t*>(c2 + (size_t)(l < L ? l : 0) * K + k0 + 2 * q);
#pragma unroll
            for (int wgi = 0; wgi < CONSUMERS; ++wgi) {
              const int b = 2 * p + wgi;
              const uint32_t* arow =
                  reinterpret_cast<const uint32_t*>(a2 + (size_t)(b < B ? b : 0) * K + k0 + 2 * q);
              uint32_t* out = words + (wgi * 128 + tid) * 4 + 2 * rr;
              out[0] = b < B ? gate_word(crow, arow, 0) : 0u;
              out[1] = b < B && !half ? gate_word(crow, arow, 1) : 0u;
            }
          }
          mbar_arrive(gfull_bar(gb));
          if (++gb == 2) {
            gb = 0;
            gphase ^= 1u;
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
    const int row = warp * 16 + g;  // the thread's first row of the 64 labels
    // acc[4j + 0/1]: row, columns 8j + 2q + 0/1; acc[4j + 2/3]: row + 8
    float acc[DX_BN / 2];
    float2* dcs = reinterpret_cast<float2*>(smem + Lay::DC_OFF);
    float* red = reinterpret_cast<float*>(smem + Lay::RED_OFF);
    int s = 0;
    uint32_t phase = 0;
    int gb = 0;
    uint32_t gphase = 0;
    // dc2's running sum, columns 8j + 2q .. of rows row and row + 8 (rr):
    // float2 slots XOR-swizzled by the row's low bits (g), so a half-warp's
    // accesses hit 32 distinct banks.  Each warpgroup takes half of the
    // columns (16 j) at a time: `write` starts the sum, `out` ends it (dc2 as
    // bf16, or the group's f32 partial) instead of storing it back.
    auto dc_half = [&](auto half_j, bool write, bool out, int l0) {
      constexpr int J0 = decltype(half_j)::value * (DX_BN / 16);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int l = l0 + row + 8 * rr;
#pragma unroll
        for (int j = J0; j < J0 + DX_BN / 16; ++j) {
          float2& slot = dcs[(row + 8 * rr) * (DX_BN / 2) + ((4 * j + q) ^ (g << 2))];
          float2 v = make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
          if (!write) {
            const float2 o = slot;
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          if (!out) {
            slot = v;
          } else if (l < L && !(j >= DX_BN / 16 && half)) {  // the unit's dc2, once
            const size_t at = (size_t)l * K + k0 + 8 * j + 2 * q;
            if (groups == 1)
              *reinterpret_cast<uint32_t*>(dc2 + at) = pack_bf16x2(v.x, v.y);
            else
              *reinterpret_cast<float2*>(dc2_part + (size_t)grp * L * K + at) = v;
          }
          if (j % 8 == 7) asm volatile("" ::: "memory");  // bounds the accesses in flight
        }
      }
    };
    for (int lt = lt0; lt < lt1; ++lt) {
      const int l0 = lt * DX_BL;
      for (int p = p0; p < p1; ++p) {
        const int b = 2 * p + wg;
        int prev = -1;
        for (int ns = 0; ns < NS; ++ns) {
          mbar_wait(full_bar(s), phase);
          const uint32_t st = base + s * Lay::STAGE;
          const uint64_t da = smem_desc(st + wg * Lay::A_BYTES);
          const uint64_t db = smem_desc(st + 2 * Lay::A_BYTES);
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

        // ---- epilogue: gate and round in place -----------------------------
        // dx1 = pre > 0 ? bf16(acc) : 0 (rows past L hold acc 0: their dz
        // arrived as zeros)
        mbar_wait(gfull_bar(gb), gphase);
        const uint4 gw = *reinterpret_cast<const uint4*>(
            gate + ((gb * CONSUMERS + wg) * 128 + tid) * 4);
        const uint32_t bits[4] = {gw.x, gw.y, gw.z, gw.w};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int j = 0; j < DX_BN / 8; ++j) {
            const uint32_t w = bits[2 * rr + j / (DX_BN / 16)];
            const int bit = 2 * (j % (DX_BN / 16));
            float& v0 = acc[4 * j + 2 * rr];
            float& v1 = acc[4 * j + 2 * rr + 1];
            v0 = (w >> bit) & 1u ? round_bf16(v0) : 0.f;
            v1 = (w >> (bit + 1)) & 1u ? round_bf16(v1) : 0.f;
          }
        __syncwarp();
        if (lane == 0) mbar_arrive(gempty_bar(gb));
        if (++gb == 2) {
          gb = 0;
          gphase ^= 1u;
        }
        // ---- dc2: the sum over the sequences, in a fixed order ---------------
        // phase 1: each warpgroup adds its own half of the columns (warpgroup
        // 0 the first 128, 1 the last 128); phase 2: the other half.  So the
        // left half sums s + dx1[2p] + dx1[2p + 1], the right half s +
        // dx1[2p + 1] + dx1[2p], the same order every call; both warpgroups
        // work in both phases.
        const bool first_pair = p == p0;
        const bool last_pair = p == p1 - 1;
        if (lt != lt0 || p != p0) pair_sync(DC_PHASE1);  // the last pair's phase 2 is done
        if (wg == 0)
          dc_half(std::integral_constant<int, 0>(), first_pair, false, l0);
        else
          dc_half(std::integral_constant<int, 1>(), first_pair, false, l0);
        pair_sync(DC_PHASE2);
        if (wg == 0)
          dc_half(std::integral_constant<int, 1>(), false, last_pair, l0);
        else
          dc_half(std::integral_constant<int, 0>(), false, last_pair, l0);
        // ---- da2: the tile's column sums ------------------------------------
        float* mine = red + (wg * 4 + warp) * DX_BN;
        warpgroup_barrier(1 + wg);  // the last pair's sums are read
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // cs[2jj + e]: column 128 hh + 8 jj + 2q + e, the thread's two rows
          float cs[DX_BN / 8];
#pragma unroll
          for (int jj = 0; jj < DX_BN / 16; ++jj) {
            const int j = (DX_BN / 16) * hh + jj;
            cs[2 * jj] = acc[4 * j] + acc[4 * j + 2];
            cs[2 * jj + 1] = acc[4 * j + 1] + acc[4 * j + 3];
          }
          // reduce-scatter over the 8 lanes of one column pair (lane bits
          // 2-4): each step keeps half of the values and adds the partner's
          // copy of them, so lane (g, q) ends with the warp's sums of indices
          // 4g .. 4g+3, columns 128 hh + 16g + 8(i >> 1) + 2q + (i & 1)
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
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mine[128 * hh + 16 * g + 8 * (i >> 1) + 2 * q + (i & 1)] = cs[i];
        }
        warpgroup_barrier(1 + wg);  // the four warps' sums meet
        const float* ours = red + wg * 4 * DX_BN;
        if (b < B) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int col = tid + 128 * hh;
            if (k0 + col < K) {
              const float v = (ours[col] + ours[DX_BN + col]) +
                              (ours[2 * DX_BN + col] + ours[3 * DX_BN + col]);
              float* dst = da2_part + ((size_t)r * B + b) * K + k0 + col;
              *dst = lt == lt0 ? v : *dst + v;  // the block's label tiles in order
            }
          }
        }
      }
    }
  }
}

// out = bf16(sum over the parts of `in`, in part order), n elements a part
__global__ void ordered_sum_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                                   size_t n, int parts) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = __ldg(in + i);
    for (int p = 1; p < parts; ++p) v += __ldg(in + (size_t)p * n + i);
    out[i] = __float2bfloat16_rn(v);
  }
}

cudaError_t launch_ordered_sum(const float* in, void* out, size_t n, int parts, cudaStream_t s) {
  const size_t want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  ordered_sum_kernel<<<blocks, 256, 0, s>>>(in, static_cast<__nv_bfloat16*>(out), n, parts);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dW: x1^T dz, whole tiles as bf16 and pieces of the last wave's tiles as f32
// partial sums, then their sum

template <int BN>
struct DwLayout {
  static constexpr int C_BYTES = 2 * BOX;          // a label block's c2: two 64 x 64 boxes
  static constexpr int C_SLOTS = 2;
  static constexpr int D_BYTES = (BN / 64) * BOX;  // a stage: the dz boxes (64 rows x 64 each)
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256 - C_SLOTS * C_BYTES) / D_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int C_OFF = STAGES * D_BYTES;
  static constexpr int BAR_OFF = C_OFF + C_SLOTS * C_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * (STAGES + C_SLOTS) * 8;  // + alignment slack
  static_assert(D_BYTES % 1024 == 0 && C_BYTES % 1024 == 0, "swizzle atoms");
  static_assert(STAGES >= 4, "the ring needs four stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

// Item t (ops/streaming_train.py:PairDwPlan.item): t < full is output tile t
// whole; else u = t - full is piece u / tail (label blocks part_begin(.., ..,
// pieces)) of tile full + u % tail, written to partial slot u.  Output tile r
// is column tile r % tiles_n of row tile r / tiles_n.
struct DwItem {
  int m0, n0, lb0, lb1, slot;  // slot -1: the whole reduction, stored as bf16
};

__device__ __forceinline__ DwItem dw_item(int t, int tiles_n, int bn, int full, int tail,
                                          int pieces, int lblocks) {
  DwItem it;
  int tile = t;
  it.lb0 = 0;
  it.lb1 = lblocks;
  it.slot = -1;
  if (t >= full) {
    const int u = t - full;
    const int p = u / tail;
    tile = full + (u - p * tail);
    if (pieces > 1) {
      it.lb0 = part_begin(p, lblocks, pieces);
      it.lb1 = part_begin(p + 1, lblocks, pieces);
      it.slot = u;
    }
  }
  it.m0 = (tile / tiles_n) * 128;
  it.n0 = (tile % tiles_n) * bn;
  return it;
}

template <int BN, bool PROD>
__global__ void __launch_bounds__(THREADS, 1)
pair_train_dw_kernel(const __grid_constant__ CUtensorMap tm_c,
                     const __grid_constant__ CUtensorMap tm_dz,
                     const __nv_bfloat16* __restrict__ a2, float* __restrict__ partial,
                     __nv_bfloat16* __restrict__ dw, int B, int K, int N, int tiles_n, int full,
                     int tail, int pieces, int lblocks, int items) {
  using Lay = DwLayout<BN>;
  constexpr int STAGES = Lay::STAGES;
  constexpr int CS = Lay::C_SLOTS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar0 = base + Lay::BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (STAGES + s); };
  auto cfull_bar = [&](int c) { return bar0 + 8u * (2 * STAGES + c); };
  auto cempty_bar = [&](int c) { return bar0 + 8u * (2 * STAGES + CS + c); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMERS * 4);
    }
    for (int c = 0; c < CS; ++c) {
      mbar_init(cfull_bar(c), 1);
      mbar_init(cempty_bar(c), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      int s = 0, c = 0;
      uint32_t phase = 0, cphase = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const DwItem it = dw_item(t, tiles_n, BN, full, tail, pieces, lblocks);
        for (int lb = it.lb0; lb < it.lb1; ++lb) {
          mbar_wait(cempty_bar(c), cphase ^ 1u);
          const uint32_t cst = base + Lay::C_OFF + c * Lay::C_BYTES;
          mbar_expect_tx(cfull_bar(c), Lay::C_BYTES);
          tma_load(cst, &tm_c, it.m0, lb * 64, cfull_bar(c));
          tma_load(cst + BOX, &tm_c, it.m0 + 64, lb * 64, cfull_bar(c));
          if (++c == CS) {
            c = 0;
            cphase ^= 1u;
          }
          for (int b = 0; b < B; ++b) {
            mbar_wait(empty_bar(s), phase ^ 1u);
            const uint32_t st = base + s * Lay::D_BYTES;
            mbar_expect_tx(full_bar(s), Lay::D_BYTES);
#pragma unroll
            for (int i = 0; i < BN / 64; ++i)
              tma_load_3d(st + i * BOX, &tm_dz, it.n0 + 64 * i, lb * 64, b, full_bar(s));
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
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int q = lane & 3;
    const int row = wg * 64 + warp * 16 + g;  // the thread's first row (input column) in the tile
    // ldmatrix.trans of the warpgroup's c2 box: for k-step kk, lane 8j + r
    // points at label row 16 kk + 8 (j >> 1) + r, 16-byte chunk 2 warp + (j & 1)
    // (input columns 16 warp + 8 (j & 1) ..), whose place TMA's 128-byte
    // swizzle moved to chunk ^ r; matrices j = 0..3 are the A fragment's
    // a0..a3 (rows g, g + 8 x label columns 2q, 2q + 8 of the k-step)
    const int lj = lane >> 3;
    const int lr = lane & 7;
    const uint32_t ld_off = (8 * (lj >> 1) + lr) * 128 + (((2 * warp + (lj & 1)) ^ lr) << 4);
    float acc[BN / 2];
    uint32_t cf[4][4];  // the label block's c2 fragments, kept across its B steps
    uint32_t fa[4][4];  // x1^T fragments
    int s = 0, c = 0;
    uint32_t phase = 0, cphase = 0;
    // One step: form x1^T = bf16(relu(a2[b] + c2)) from the kept fragments,
    // wait for the dz boxes, issue the four products and wait for them, then
    // free the stage.  (Leaving a step's products in flight while the next
    // step's fragments were formed gave wrong dW values from a tile's second
    // label block on, on an H100; reading the fragments again by ldmatrix
    // every step, which lets the products overlap, was no faster.)
    auto step = [&](bool first, float av0, float av1) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = unpack_bf16x2(cf[kk][i]);
          const float a = (i & 1) ? av1 : av0;  // a1, a3: row g + 8
          fa[kk][i] = PROD ? pack_bf16x2(a * v.x, a * v.y)
                           : pack_bf16x2(fmaxf(a + v.x, 0.f), fmaxf(a + v.y, 0.f));
        }
      mbar_wait(full_bar(s), phase);
      const uint64_t db = smem_desc_mn(base + s * Lay::D_BYTES, BOX);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 label rows: 2048 bytes
        MmaRsT<BN>::rs(acc, fa[kk], db + 128 * kk, !first || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_regs(fa);
      if (lane == 0) mbar_arrive(empty_bar(s));
      if (++s == STAGES) {
        s = 0;
        phase ^= 1u;
      }
    };
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const DwItem it = dw_item(t, tiles_n, BN, full, tail, pieces, lblocks);
      bool first = true;
      const __nv_bfloat16* arow = a2 + it.m0 + row;
      for (int lb = it.lb0; lb < it.lb1; ++lb) {
        mbar_wait(cfull_bar(c), cphase);
        const uint32_t cbox = base + Lay::C_OFF + c * Lay::C_BYTES + wg * BOX;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldsm_x4_trans(cf[kk], cbox + kk * 16 * 128 + ld_off);
        for (int b = 0; b < B; ++b) {
          step(first, __bfloat162float(arow[(size_t)b * K]),
               __bfloat162float(arow[(size_t)b * K + 8]));
          first = false;
          // the first step has used the fragments: the c2 slot is free
          if (b == 0 && lane == 0) mbar_arrive(cempty_bar(c));
        }
        if (++c == CS) {
          c = 0;
          cphase ^= 1u;
        }
      }
      if (it.slot < 0) {  // rows m0 + row, + 8 of dW (acc's layout as dX's)
        __nv_bfloat16* dst = dw + (size_t)(it.m0 + row) * N + it.n0 + 2 * q;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(dst + (size_t)8 * N + 8 * j) =
              pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      } else {  // the piece's f32 sums, a 128 x BN slot
        float* dst = partial + ((size_t)it.slot * 128 + row) * BN + 2 * q;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(dst + 8 * BN + 8 * j) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

// the pieced tiles of dW: bf16(sum over the pieces, in order), four
// elements a step
__global__ void pair_train_dw_pieces_kernel(const float4* __restrict__ partial,
                                            __nv_bfloat16* __restrict__ dw, int N, int bn,
                                            int tiles_n, int full, int tail, int pieces) {
  const size_t per_tile = (size_t)128 * bn / 4;
  const size_t n4 = (size_t)tail * per_tile;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t tt = i / per_tile;
    const size_t e = i - tt * per_tile;
    float4 v = __ldg(partial + i);
    for (int p = 1; p < pieces; ++p) {
      const float4 w = __ldg(partial + ((size_t)p * tail + tt) * per_tile + e);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int tile = full + (int)tt;
    const int r = (int)(e / (bn / 4));
    const int c4 = (int)(e - (size_t)r * (bn / 4));
    __nv_bfloat16* dst =
        dw + (size_t)((tile / tiles_n) * 128 + r) * N + (tile % tiles_n) * bn + 4 * c4;
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BN, bool PROD>
cudaError_t launch_dw(const CUtensorMap& tm_c, const CUtensorMap& tm_dz, const void* a2,
                      float* partial, void* dw, int B, int K, int N, int tiles_n, int full,
                      int tail, int pieces, int lblocks, int items, int grid, cudaStream_t s) {
  constexpr int bytes = DwLayout<BN>::BYTES;
  pair_train_dw_kernel<BN, PROD><<<grid, THREADS, bytes, s>>>(
      tm_c, tm_dz, static_cast<const __nv_bfloat16*>(a2), partial,
      static_cast<__nv_bfloat16*>(dw), B, K, N, tiles_n, full, tail, pieces, lblocks, items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tail == 0 || pieces == 1) return err;
  const size_t want = ((size_t)tail * 128 * BN / 4 + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  pair_train_dw_pieces_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(partial),
                                                     static_cast<__nv_bfloat16*>(dw), N, BN,
                                                     tiles_n, full, tail, pieces);
  return cudaGetLastError();
}

}  // namespace

// dX of z = relu(a2[b] + c2[l]) @ W: da2 (B, K) and dc2 (L, K) bf16 from dz
// (B * L, N) bf16 with rows b * L + l, W (K, N), a2 (B, K) and c2 (L, K), all
// bf16, row-major, contiguous and 16-byte aligned.  K is a multiple of 128
// and N of 64.  The plan (ops/streaming_train.py:pair_dx_plan) gives
// `ranges` label ranges (1 <= ranges <= ceil(L / 64)) and `groups` sequence-
// pair groups (1 <= groups <= ceil(B / 2)); the grid is ceil(K / 256) x
// ranges x groups blocks.  da2_part is a float32 scratch of ranges x B x K,
// dc2_part one of groups x L x K when groups > 1 (else unused); both are
// written whole.  Returns a CUDA error (0 on success): cudaErrorInvalidValue
// for shapes the kernel does not take or a tensor map cuTensorMapEncodeTiled
// refuses.
extern "C" int pair_train_dx(const void* dz, const void* w, const void* a2, const void* c2,
                             void* da2_part, void* dc2_part, void* da2, void* dc2, int B, int L,
                             int K, int N, int ranges, int groups, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || K % 128 != 0 || N <= 0 || N % BK != 0 || ranges <= 0 ||
      groups <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_l = (L + DX_BL - 1) / DX_BL;
  const int tiles_k = (K + DX_BN - 1) / DX_BN;
  const int pairs = (B + 1) / 2;
  const uint64_t grid = (uint64_t)tiles_k * ranges * groups;
  if (ranges > tiles_l || groups > pairs || grid > (uint64_t)INT_MAX ||
      (groups > 1 && dc2_part == nullptr))
    return (int)cudaErrorInvalidValue;
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward thread may have none yet), which
  // cuTensorMapEncodeTiled needs
  constexpr int bytes = DxLayout::BYTES;
  cudaError_t err = allow_smem(pair_train_dx_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  const bool ok = make_map_3d(&maps[0], dz, MapType::BF16, B, L, N, DX_BL, BK, true) &&
                  make_map(&maps[1], w, MapType::BF16, K, N, DX_BN, BK, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  pair_train_dx_kernel<<<(int)grid, THREADS, bytes, s>>>(
      maps[0], maps[1], static_cast<const __nv_bfloat16*>(a2),
      static_cast<const __nv_bfloat16*>(c2), static_cast<float*>(da2_part),
      static_cast<float*>(dc2_part), static_cast<__nv_bfloat16*>(dc2), B, L, K, N, tiles_l,
      tiles_k, ranges, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_ordered_sum(static_cast<const float*>(da2_part), da2, (size_t)B * K, ranges, s);
  if (err != cudaSuccess || groups == 1) return (int)err;
  return (int)launch_ordered_sum(static_cast<const float*>(dc2_part), dc2, (size_t)L * K, groups,
                                 s);
}

namespace {

template <bool PROD>
int pair_train_dw_form(const void* a2, const void* c2, const void* dz, void* partial, void* dw,
                       int B, int L, int K, int N, int block_n, int full, int pieces, int grid,
                       void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || K % 128 != 0 || (block_n != 128 && block_n != 256) ||
      N <= 0 || N % block_n != 0 || grid <= 0 || pieces <= 0 || full < 0)
    return (int)cudaErrorInvalidValue;
  const int lblocks = (L + 63) / 64;
  const int tiles_n = N / block_n;
  const uint64_t tiles = (uint64_t)(K / 128) * tiles_n;
  if ((uint64_t)full > tiles || pieces > lblocks) return (int)cudaErrorInvalidValue;
  const uint64_t tail = tiles - full;
  const uint64_t items = full + tail * pieces;
  if (items > (uint64_t)INT_MAX || (tail > 0 && pieces > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  // the runtime call first, as in pair_train_dx
  cudaError_t err =
      block_n == 256 ? allow_smem(pair_train_dw_kernel<256, PROD>, DwLayout<256>::BYTES)
                     : allow_smem(pair_train_dw_kernel<128, PROD>, DwLayout<128>::BYTES);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  const bool ok = make_map(&maps[0], c2, MapType::BF16, L, K, 64, BK, true) &&
                  make_map_3d(&maps[1], dz, MapType::BF16, B, L, N, 64, BK, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int g = grid < (int)items ? grid : (int)items;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  auto launch = block_n == 256 ? launch_dw<256, PROD> : launch_dw<128, PROD>;
  return (int)launch(maps[0], maps[1], a2, p, dw, B, K, N, tiles_n, full, (int)tail, pieces,
                     lblocks, (int)items, g, s);
}

}  // namespace

// dW (K, N) bf16 of z = relu(a2[b] + c2[l]) @ W, from a2 (B, K), c2 (L, K)
// and dz (B * L, N), all bf16, row-major, contiguous and 16-byte aligned.  K
// is a multiple of 128, N of block_n (256 or 128).  The plan
// (ops/streaming_train.py:pair_dw_plan) runs output tiles 0 .. full-1 whole
// and cuts each of the other `tail` tiles into `pieces` ranges of label
// blocks (1 <= pieces <= ceil(L / 64)); partial is a float32 scratch of
// tail x pieces x 128 x block_n when tail > 0 and pieces > 1 (else unused).
// grid is the number of persistent blocks.  Returns a CUDA error as
// pair_train_dx.
extern "C" int pair_train_dw(const void* a2, const void* c2, const void* dz, void* partial,
                             void* dw, int B, int L, int K, int N, int block_n, int full,
                             int pieces, int grid, void* stream) {
  return pair_train_dw_form<false>(a2, c2, dz, partial, dw, B, L, K, N, block_n, full, pieces,
                                   grid, stream);
}

// dW_prod (K, N) bf16 of z = bf16(pe[b] * le[l]) @ W: pair_train_dw's
// arguments with a2 = pe (B, K) and c2 = le (L, K).
extern "C" int pair_train_dw_prod(const void* pe, const void* le, const void* dz, void* partial,
                                  void* dw, int B, int L, int K, int N, int block_n, int full,
                                  int pieces, int grid, void* stream) {
  return pair_train_dw_form<true>(pe, le, dz, partial, dw, B, L, K, N, block_n, full, pieces,
                                  grid, stream);
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
