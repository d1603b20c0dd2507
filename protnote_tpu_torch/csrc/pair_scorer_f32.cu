// Folded pair-MLP scorer in float32 for Hopper (sm_90a): one layer of the
// (sequence x label) output MLP per launch, at float32's precision on the
// tensor cores.
//
// Replaces the TPU op chain protnote_tpu/ops/pair_scorer.py:197
// _tiled_scaffold + :242 pair_logits_tiled at compute_dtype float32
// (MIXED_PRECISION False), where every product runs at Precision.HIGHEST:
// the prod einsum (:225-231), the hidden layers (:253-258) and the output
// dot (:233-234).  For a chunk of labels [l0, l0 + nl), padded by the caller
// to nl_pad rows a sequence (a multiple of the 128-row tile), rows r = b *
// nl_pad + l are (sequence, label) pairs, as in csrc/pair_scorer.cu, and
//
//   x1[r]      = relu(a[b] + c[l0 + l])                              (A_PAIR)
//     or, concatenation_prod,
//   x1[r]      = relu((a[b] + c[l0 + l]) + (P_e[b] * L_e[l0 + l]) @ W_prod)
//                                                                    (A_PROD)
//   x_{i+1}[r] = relu(x_i[r] @ W_i + bias_i)                  (A_PAIR or A_X)
//   logit[b, l0 + l] += sum_n x_last[r, n] * w_out[n]               (l < nl)
//
// all in float32, the logits pre-filled with b_out by the caller.  One
// launch computes one GEMM of that chain: its A operand is formed in
// registers from a and c (A_PAIR), from P_e and L_e (A_PROD), or read from
// the previous layer's float32 workspace (A_X); its epilogue stores float32
// activations to a workspace or takes the dot with w_out into the logits.
//
// The split product (bf16x3).  A float32 value x is the exact sum of three
// bf16 values: x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) (each
// remainder is exact in float32, and the last has at most 8 significant
// bits).  With W split alike (once a call, by the caller: three (N, K) bf16
// pieces stacked as one (3N, K) K-major tensor), the six products
//   x0 w0 + x0 w1 + x1 w0 + x0 w2 + x1 w1 + x2 w0
// leave out terms below 2^-24 of |x w| (x1 w2, x2 w1, x2 w2); each product
// of two bf16 values is exact in float32 and the tensor cores sum them in
// float32.  What TPU's Precision.HIGHEST does on the MXU is the same six
// bf16 passes.  3xTF32 on wgmma's tf32 form was the other choice: the same
// rate (495 TFLOP/s / 3 against 989 / 6), 8 bytes of shared memory a W
// element against 6 here, and an A split whose low piece keeps 11 of its 13
// bits; bf16x3 also keeps K1's register-A wgmma (Mma::rs), whose fragment
// layout the bf16 kernel already holds.
//
// What bounds it: the hidden GEMMs at the split's rate.  At the default
// width (H = 3072, two hidden layers) a 32-sequence batch against 64,204
// label rows is 77.5 TFLOP of float32 products: 470 ms at 989 / 6 = 165
// TFLOP/s, 1,157 ms at the 67 TFLOP/s of the float32 FMA pipe.  The design
// is K1's mainloop with a 128 x 128 output tile: a producer thread fills a
// ring of TMA stages (the three W^T piece tiles, 3 x 16 KB, and the A side's
// float32 tile as two 128-byte-wide halves, 2 x 16 KB, 128-byte swizzled;
// 80 KB a stage, so two stages fit beside the store boxes); two consumer
// warpgroups read their A-fragment elements from the float32 tile, form x
// (a + c and ReLU, p * l, or the workspace value), split it in registers into
// three bf16 fragment sets and issue six register-A wgmma m64n128k16 a
// k-step into accumulators of the stage's own, which are then added into
// the tile's float32 sums rounded to nearest: over the whole depth in one
// set of accumulators the error reached 1.9e-5 of the largest logit on an
// H100 (the tensor cores' adds are not float32's rounded adds).  Persistent blocks walk the
// (row tile, column tile) grid with column tiles fastest.  Epilogues run from
// the sums: bias (or a[b] + c[l] for A_PROD) and ReLU, then float32
// 32-column boxes out through TMA stores, or the dot with w_out (four adds a
// row a column tile into the logits).  The float32 workspace is 100 MB a
// chunk of 8,192 rows at H 3072, twice K1's bf16 one: it no longer stays in
// L2, and is written and read once a layer from device memory (200 MB a
// chunk, ~15 ms of the call at 3.35 TB/s).
//
// The same mainloop is K4's float32 forward (pair_train_hidden_f32, at the
// end of the file): the A_PAIR layer over every pair of a training batch,
// its sums stored as they are (EPI_RAW) through a 3-D map over z as (B, L,
// N).  Bound: 19.4 TFLOP at the default width, 117.6 ms at the split's rate.
// And the dense training scorer's concatenation_prod first layer
// (pair_train_prod_f32): the A_PROD layer over every pair, a[b] + c[l] added
// to the raw sums and stored through the same 3-D map (6.4 TFLOP at 32
// sequences, d 1024: 39.2 ms at the split's rate).

#include "bf16x3.cuh"
#include "hopper.cuh"

#include <string.h>

namespace {

constexpr int BM = 128;          // pair rows a tile: two consumer warpgroups of 64
constexpr int BN = 128;          // columns a tile
constexpr int BK = 64;           // reduction depth a stage: one 128-byte row of bf16
constexpr int PIECES = 3;        // bf16 pieces of a float32 value
constexpr int CONSUMERS = 2;     // consumer warpgroups; the producer's is the last
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int EPI_BOX = 64 * 128;  // one 64-row x 32-column float32 box of the output

// where the A operand comes from
enum AMode { A_X = 0, A_PAIR = 1, A_PROD = 2 };
// what the epilogue does with the sums: bias (or a + c) and ReLU stored to a
// workspace, the dot with w_out into the logits, or the sums stored through
// a 3-D map over (B, L, N) with no ReLU: as they are (K4's float32 forward),
// or with a[b] + c[l] added (A_PROD: the dense scorer's prod first layer)
enum Epi { EPI_RELU = 0, EPI_DOT = 1, EPI_RAW = 2 };

// Shared memory of one variant: a ring of STAGES stages, each the three W^T
// piece tiles (BN rows of BK bf16) and the A side's float32 tile as two
// 32-column halves (each row 128 bytes, so TMA's 128-byte swizzle applies);
// for a store epilogue two output boxes a consumer warpgroup; for A_PAIR and
// A_PROD the float32 row slice (a[b] or P_e[b]) of each stage; then the
// mbarriers.  Every tile starts on a 1024-byte swizzle atom.
template <int AMODE, bool STORE>
struct Layout {
  static constexpr int W_BYTES = BN * BK * 2;
  static constexpr int HALF_BYTES = BM * 32 * 4;
  static constexpr int ROW_BYTES = AMODE == A_X ? 0 : BK * 4;
  static constexpr int STAGE = PIECES * W_BYTES + 2 * HALF_BYTES;
  static constexpr int TX = STAGE + ROW_BYTES;  // bytes a stage's loads bring
  static constexpr int EPI_BYTES = STORE ? CONSUMERS * 2 * EPI_BOX : 0;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256 - EPI_BYTES) / (STAGE + ROW_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int EPI_OFF = STAGES * STAGE;
  static constexpr int ROW_OFF = EPI_OFF + EPI_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + STAGES * ROW_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "swizzle atoms");
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v.x), "f"(v.y) : "memory");
}

template <int AMODE, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
pair_mlp_layer_f32_kernel(const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_t,
                          const __grid_constant__ CUtensorMap tm_r,
                          const __grid_constant__ CUtensorMap tm_o,
                          const float* __restrict__ bias, const float* __restrict__ ea,
                          const float* __restrict__ ec, const float* __restrict__ w_out,
                          float* __restrict__ logits, int nl, int nl_pad, int l0, int L, int K,
                          int N, int tiles_n, int tiles) {
  constexpr bool DOT_OUT = EPI == EPI_DOT;
  using Lay = Layout<AMODE, !DOT_OUT>;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + Lay::BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (STAGES + s); };
  const int KT = K / BK;

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
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * BM;
        const int n0 = (t % tiles_n) * BN;
        const int b = m0 / nl_pad;
        // the A side's tile rows: the workspace's rows, or the labels' rows
        // of c / L_e (rows past L arrive as zeros)
        const int trow = AMODE == A_X ? m0 : l0 + (m0 - b * nl_pad);
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty_bar(s), phase ^ 1u);
          const uint32_t st = base + s * Lay::STAGE;
          mbar_expect_tx(full_bar(s), Lay::TX);
#pragma unroll
          for (int p = 0; p < PIECES; ++p)
            tma_load(st + p * Lay::W_BYTES, &tm_w, kt * BK, p * N + n0, full_bar(s));
          const uint32_t at = st + PIECES * Lay::W_BYTES;
          tma_load(at, &tm_t, kt * BK, trow, full_bar(s));
          tma_load(at + Lay::HALF_BYTES, &tm_t, kt * BK + 32, trow, full_bar(s));
          if (AMODE != A_X)
            tma_load(base + Lay::ROW_OFF + s * Lay::ROW_BYTES, &tm_r, kt * BK, b, full_bar(s));
          if (++s == STAGES) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // ---- consumers: split A, six products a k-step, then the epilogue -----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row (and row + 8)
    const int q = lane & 3;   // fragment column pair
    const int row = wg * 64 + warp * 16 + g;  // the thread's first row in the tile
    float acc[BN / 2];  // a stage's products (the tensor cores' sums)
    float sum[BN / 2];  // the stages' sums, added in float32 rounded to nearest
    // the A fragments' bf16 pieces of one stage
    uint32_t fa[PIECES][4][4];
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM;
      const int n0 = (t % tiles_n) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full_bar(s), phase);
        const uint32_t st = base + s * Lay::STAGE;
        // x for the thread's A-fragment elements (rows row, row + 8; columns
        // 2q, 2q + 1 and those + 8 of each 16-wide k-step), read from the
        // swizzled float32 halves, then split into its three pieces
        const unsigned char* sp = smem + s * Lay::STAGE + PIECES * Lay::W_BYTES;
        const float* rowv =
            reinterpret_cast<const float*>(smem + Lay::ROW_OFF + s * Lay::ROW_BYTES);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* half = reinterpret_cast<const float*>(sp + (kk >> 1) * Lay::HALF_BYTES);
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = (kk & 1) * 16 + 2 * q + 8 * cc;  // within the 32-wide half
            float2 rv = make_float2(0.f, 0.f);
            if (AMODE != A_X) rv = *reinterpret_cast<const float2*>(rowv + (kk >> 1) * 32 + col);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int r = row + 8 * rr;
              const int phys = r * 32 + (((col >> 2) ^ (r & 7)) << 2) + (col & 3);
              const float2 tv = *reinterpret_cast<const float2*>(half + phys);
              float2 x;
              if (AMODE == A_X) {
                x = tv;
              } else if (AMODE == A_PAIR) {
                x = make_float2(fmaxf(__fadd_rn(rv.x, tv.x), 0.f),
                                fmaxf(__fadd_rn(rv.y, tv.y), 0.f));
              } else {
                x = make_float2(__fmul_rn(rv.x, tv.x), __fmul_rn(rv.y, tv.y));
              }
              const int e = rr + 2 * cc;
              split3(x, fa[0][kk][e], fa[1][kk][e], fa[2][kk][e]);
            }
          }
        }
        const uint64_t d0 = smem_desc(st);
        const uint64_t d1 = smem_desc(st + Lay::W_BYTES);
        const uint64_t d2 = smem_desc(st + 2 * Lay::W_BYTES);
        // The tensor cores' adds into the accumulators are not float32's
        // rounded adds: over K = 3072 in one set of accumulators the error
        // grew to 1.9e-5 of the largest logit on an H100.  So each stage
        // starts its own sums, the five small cross products first (their
        // adds' error is relative to a sum 2^-8 the size), then x0 w0, and
        // the stage's sums go into `sum` rounded to nearest.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t o = 2 * kk;
          Mma<BN>::rs(acc, fa[0][kk], d1 + o, kk > 0);
          Mma<BN>::rs(acc, fa[1][kk], d0 + o, 1);
          Mma<BN>::rs(acc, fa[0][kk], d2 + o, 1);
          Mma<BN>::rs(acc, fa[1][kk], d1 + o, 1);
          Mma<BN>::rs(acc, fa[2][kk], d0 + o, 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Mma<BN>::rs(acc, fa[0][kk], d0 + 2 * kk, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int p = 0; p < PIECES; ++p) fence_regs(fa[p]);
        if (lane == 0) mbar_arrive(empty_bar(s));  // the stage's tiles are read
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1u;
        }
      }

      // ---- epilogue from the accumulators ---------------------------------
      // sum[4j + 0/1]: row, columns 8j + 2q + 0/1; sum[4j + 2/3]: row + 8
      const int r0 = m0 + row;
      const int b = r0 / nl_pad;
      const int l = r0 - b * nl_pad;  // the tile lies in one sequence: l + 8 too
      if (DOT_OUT) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * q;
          const float2 bv = *reinterpret_cast<const float2*>(bias + col);
          const float2 wv = *reinterpret_cast<const float2*>(w_out + col);
          p0 += fmaxf(__fadd_rn(sum[4 * j], bv.x), 0.f) * wv.x +
                fmaxf(__fadd_rn(sum[4 * j + 1], bv.y), 0.f) * wv.y;
          p1 += fmaxf(__fadd_rn(sum[4 * j + 2], bv.x), 0.f) * wv.x +
                fmaxf(__fadd_rn(sum[4 * j + 3], bv.y), 0.f) * wv.y;
        }
        p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
        p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
        p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
        p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
        if (q == 0) {
          float* out = logits + (size_t)b * L + l0;
          if (l < nl) atomicAdd(out + l, p0);
          if (l + 8 < nl) atomicAdd(out + l + 8, p1);
        }
      } else {
        // the term added before the ReLU: the layer's bias, or for the prod
        // layer a[b] + c[l0 + l] (c rows past L are zero, as the A side's)
        const float* arow = AMODE == A_PROD ? ea + (size_t)b * N : nullptr;
        const float* crow0 =
            AMODE == A_PROD && l0 + l < L ? ec + (size_t)(l0 + l) * N : nullptr;
        const float* crow1 =
            AMODE == A_PROD && l0 + l + 8 < L ? ec + (size_t)(l0 + l + 8) * N : nullptr;
        // 32-column slices of the warpgroup's 64 rows go through two boxes
        // in shared memory (128-byte swizzled, as the output map reads them)
        // and out by TMA; the stores run on under the next tile's products
        const uint32_t ebuf = base + Lay::EPI_OFF + wg * 2 * EPI_BOX;
        const int lr = warp * 16 + g;  // the thread's first row of the warpgroup's 64
#pragma unroll
        for (int part = 0; part < BN / 32; ++part) {
          const uint32_t box = ebuf + (part & 1) * EPI_BOX;
          if (tid == 0) bulk_wait_read<1>();  // the store that last read this box is done
          warpgroup_barrier(1 + wg);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * part + jj;
            const int col = n0 + 8 * j + 2 * q;
            float2 e0, e1;
            if (EPI == EPI_RAW && AMODE != A_PROD) {
              const uint32_t off = (((2 * jj + (q >> 1)) ^ (lr & 7)) << 4) + 8 * (q & 1);
              st_shared_f2(box + lr * 128 + off, make_float2(sum[4 * j], sum[4 * j + 1]));
              st_shared_f2(box + (lr + 8) * 128 + off,
                           make_float2(sum[4 * j + 2], sum[4 * j + 3]));
              continue;
            }
            if (AMODE == A_PROD) {
              const float2 av = *reinterpret_cast<const float2*>(arow + col);
              const float2 c0 =
                  crow0 ? *reinterpret_cast<const float2*>(crow0 + col) : make_float2(0.f, 0.f);
              const float2 c1 =
                  crow1 ? *reinterpret_cast<const float2*>(crow1 + col) : make_float2(0.f, 0.f);
              e0 = make_float2(__fadd_rn(av.x, c0.x), __fadd_rn(av.y, c0.y));
              e1 = make_float2(__fadd_rn(av.x, c1.x), __fadd_rn(av.y, c1.y));
            } else {
              e0 = e1 = *reinterpret_cast<const float2*>(bias + col);
            }
            // bytes 32 jj + 8 q of the 128-byte row: 16-byte chunk 2 jj + q / 2
            const uint32_t off = (((2 * jj + (q >> 1)) ^ (lr & 7)) << 4) + 8 * (q & 1);
            if (EPI == EPI_RAW) {  // the prod layer's z = sums + (a[b] + c[l]), no ReLU
              st_shared_f2(box + lr * 128 + off, make_float2(__fadd_rn(sum[4 * j], e0.x),
                                                             __fadd_rn(sum[4 * j + 1], e0.y)));
              st_shared_f2(box + (lr + 8) * 128 + off,
                           make_float2(__fadd_rn(sum[4 * j + 2], e1.x),
                                       __fadd_rn(sum[4 * j + 3], e1.y)));
              continue;
            }
            st_shared_f2(box + lr * 128 + off,
                         make_float2(fmaxf(__fadd_rn(sum[4 * j], e0.x), 0.f),
                                     fmaxf(__fadd_rn(sum[4 * j + 1], e0.y), 0.f)));
            st_shared_f2(box + (lr + 8) * 128 + off,
                         make_float2(fmaxf(__fadd_rn(sum[4 * j + 2], e1.x), 0.f),
                                     fmaxf(__fadd_rn(sum[4 * j + 3], e1.y), 0.f)));
          }
          fence_async_smem();
          warpgroup_barrier(1 + wg);
          if (tid == 0) {
            if (EPI == EPI_RAW) {
              // rows b * nl_pad + l of the tile are labels l of sequence b;
              // the map clips them at L, and a box wholly past L is left out
              const int lw = m0 - b * nl_pad + wg * 64;
              if (lw < L) tma_store_3d(&tm_o, box, n0 + 32 * part, lw, b);
            } else {
              tma_store(&tm_o, box, n0 + 32 * part, m0 + wg * 64);
            }
            bulk_commit();
          }
        }
      }
    }
    if (!DOT_OUT && tid == 0) bulk_wait_all();  // the last stores leave before the block
  }
}

struct Args {
  CUtensorMap tm_w, tm_t, tm_r, tm_o;
  const float *bias, *ea, *ec, *w_out;
  float* logits;
  int nl, nl_pad, l0, L, K, N, tiles_n, tiles, grid;
};

template <int AMODE, int EPI>
cudaError_t launch(const Args& p, cudaStream_t s) {
  constexpr int bytes = Layout<AMODE, EPI != EPI_DOT>::BYTES;
  auto kernel = pair_mlp_layer_f32_kernel<AMODE, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, THREADS, bytes, s>>>(p.tm_w, p.tm_t, p.tm_r, p.tm_o, p.bias, p.ea, p.ec,
                                        p.w_out, p.logits, p.nl, p.nl_pad, p.l0, p.L, p.K, p.N,
                                        p.tiles_n, p.tiles);
  return cudaGetLastError();
}

constexpr int DOT = 4;  // mode bit: the epilogue takes the dot with w_out

}  // namespace

// One layer of the float32 chain for the label chunk [l0, l0 + nl), padded
// to nl_pad rows a sequence (a multiple of 128): M = B * nl_pad pair rows.
// mode = amode | DOT (4):
//   amode 0 (A_X): A is x_in = tile (M, K) f32, the previous layer's output;
//   amode 1 (A_PAIR): A = relu(a[b] + c[l0 + l]) from row = a (B, K) and
//     tile = c (L, K) f32;
//   amode 2 (A_PROD): A = P_e[b] * L_e[l0 + l] from row = P_e (B, K) and
//     tile = L_e (L, K) f32, and the epilogue adds ea[b] + ec[l0 + l] (the
//     first layer's a (B, N) and c (L, N)) in place of a bias (no DOT);
//   wt3 (3N, K) bf16: the three pieces of W transposed (K-major), stacked;
//   bias (N,) f32; x_out (M, N) f32; w_out (N,) f32; logits (B, L) f32,
//   added into.
// DOT: the epilogue takes the dot with w_out into the logits (the last
// layer); otherwise it stores relu(...) to x_out.  N and K multiples of 128;
// grid the number of persistent blocks (at most one an SM).  Returns a CUDA
// error (0 on success): cudaErrorInvalidValue for shapes or modes the kernel
// does not take or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int pair_mlp_layer_f32(const void* row, const void* tile, const void* wt3,
                                  const void* bias, const void* ea, const void* ec, void* x_out,
                                  const void* w_out, void* logits, int B, int nl, int nl_pad,
                                  int l0, int L, int K, int N, int mode, int grid, void* stream) {
  const int amode = mode & 3;
  const bool dot = mode & DOT;
  if (B <= 0 || nl <= 0 || nl_pad < nl || nl_pad % BM != 0 || K <= 0 || K % (2 * BK) != 0 ||
      N <= 0 || N % BN != 0 || amode > A_PROD || (mode & ~7) != 0 || grid <= 0 ||
      (amode == A_PROD && (dot || ea == nullptr || ec == nullptr)) ||
      (amode != A_PROD && bias == nullptr) || (dot && (w_out == nullptr || logits == nullptr)) ||
      (!dot && x_out == nullptr) || tile == nullptr || (amode != A_X && row == nullptr))
    return (int)cudaErrorInvalidValue;
  Args p;
  memset(&p, 0, sizeof(p));
  const uint64_t M = (uint64_t)B * nl_pad;
  bool ok = make_map(&p.tm_w, wt3, MapType::BF16, (uint64_t)PIECES * N, K, BN, BK, true) &&
            make_map(&p.tm_t, tile, MapType::F32, amode == A_X ? M : (uint64_t)L, K, BM, 32, true);
  if (amode != A_X) ok = ok && make_map(&p.tm_r, row, MapType::F32, B, K, 1, BK, false);
  if (!dot) ok = ok && make_map(&p.tm_o, x_out, MapType::F32, M, N, 64, 32, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  p.bias = static_cast<const float*>(bias);
  p.ea = static_cast<const float*>(ea);
  p.ec = static_cast<const float*>(ec);
  p.w_out = static_cast<const float*>(w_out);
  p.logits = static_cast<float*>(logits);
  p.nl = nl;
  p.nl_pad = nl_pad;
  p.l0 = l0;
  p.L = L;
  p.K = K;
  p.N = N;
  p.tiles_n = N / BN;
  p.tiles = (int)(M / BM) * p.tiles_n;
  p.grid = grid < p.tiles ? grid : p.tiles;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (mode) {
    case A_X: return (int)launch<A_X, EPI_RELU>(p, s);
    case A_PAIR: return (int)launch<A_PAIR, EPI_RELU>(p, s);
    case A_PROD: return (int)launch<A_PROD, EPI_RELU>(p, s);
    case A_X | DOT: return (int)launch<A_X, EPI_DOT>(p, s);
    default: return (int)launch<A_PAIR, EPI_DOT>(p, s);
  }
}

// K4's forward in float32 (the first hidden GEMM of the decomposed training
// scorer, protnote_tpu/ops/streaming_train.py:238-240 at compute_dtype
// float32): z[b * L + l] = relu(a2[b] + c2[l]) @ W for every pair, float32,
// with no bias and no ReLU (the caller adds the bias).  The A_PAIR mainloop
// above on rows padded to nl_pad = ceil(L / 128) * 128 a sequence (c2's rows
// past L arrive as zeros), its sums stored through a 3-D map over z as (B,
// L, N) that clips each sequence's last tile at L, so z has no padding rows
// and no tile writes another sequence's labels.  a2 (B, K), c2 (L, K) and z
// (B * L, N) float32, wt3 (3N, K) bf16 W's pieces as pair_mlp_layer_f32
// takes them; K and N multiples of 128.
extern "C" int pair_train_hidden_f32(const void* a2, const void* c2, const void* wt3, void* z,
                                     int B, int L, int K, int N, int grid, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || K % (2 * BK) != 0 || N <= 0 || N % BN != 0 || grid <= 0 ||
      a2 == nullptr || c2 == nullptr || wt3 == nullptr || z == nullptr)
    return (int)cudaErrorInvalidValue;
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward thread, which reruns this forward under
  // GRADIENT_CHECKPOINTING, may have none yet), which cuTensorMapEncodeTiled
  // needs
  cudaError_t err = cudaFuncSetAttribute(pair_mlp_layer_f32_kernel<A_PAIR, EPI_RAW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<A_PAIR, true>::BYTES);
  if (err != cudaSuccess) return (int)err;
  Args p;
  memset(&p, 0, sizeof(p));
  const int nl_pad = (L + BM - 1) / BM * BM;
  const uint64_t M = (uint64_t)B * nl_pad;
  if (M / BM * (N / BN) > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (!(make_map(&p.tm_w, wt3, MapType::BF16, (uint64_t)PIECES * N, K, BN, BK, true) &&
        make_map(&p.tm_t, c2, MapType::F32, L, K, BM, 32, true) &&
        make_map(&p.tm_r, a2, MapType::F32, B, K, 1, BK, false) &&
        make_map_3d(&p.tm_o, z, MapType::F32, B, L, N, 64, 32, true)))
    return (int)cudaErrorInvalidValue;
  p.nl = L;
  p.nl_pad = nl_pad;
  p.l0 = 0;
  p.L = L;
  p.K = K;
  p.N = N;
  p.tiles_n = N / BN;
  p.tiles = (int)(M / BM) * p.tiles_n;
  p.grid = grid < p.tiles ? grid : p.tiles;
  return (int)launch<A_PAIR, EPI_RAW>(p, reinterpret_cast<cudaStream_t>(stream));
}

// The dense training scorer's concatenation_prod first layer in float32
// (protnote_tpu/ops/pair_scorer.py:108 pair_logits_dense: the prod block of
// :92 joint_embeddings through the first Linear at Precision.HIGHEST):
// z[b * L + l] = (P_e[b] * L_e[l]) @ W_prod + (a[b] + c[l]) for every pair,
// float32, no ReLU.  The A_PROD mainloop on rows padded to nl_pad = ceil(L /
// 128) * 128 a sequence, the sums stored through the 3-D map over z as (B,
// L, N) as pair_train_hidden_f32 stores them.  P_e (B, K), L_e (L, K), a (B,
// N), c (L, N) and z (B * L, N) float32; wt3 (3N, K) bf16 W_prod's pieces;
// K and N multiples of 128.
extern "C" int pair_train_prod_f32(const void* P_e, const void* L_e, const void* wt3,
                                   const void* a, const void* c, void* z, int B, int L, int K,
                                   int N, int grid, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || K % (2 * BK) != 0 || N <= 0 || N % BN != 0 || grid <= 0 ||
      P_e == nullptr || L_e == nullptr || wt3 == nullptr || a == nullptr || c == nullptr ||
      z == nullptr)
    return (int)cudaErrorInvalidValue;
  // a runtime call first, for the context cuTensorMapEncodeTiled needs (as
  // pair_train_hidden_f32)
  cudaError_t err = cudaFuncSetAttribute(pair_mlp_layer_f32_kernel<A_PROD, EPI_RAW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<A_PROD, true>::BYTES);
  if (err != cudaSuccess) return (int)err;
  Args p;
  memset(&p, 0, sizeof(p));
  const int nl_pad = (L + BM - 1) / BM * BM;
  const uint64_t M = (uint64_t)B * nl_pad;
  if (M / BM * (N / BN) > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (!(make_map(&p.tm_w, wt3, MapType::BF16, (uint64_t)PIECES * N, K, BN, BK, true) &&
        make_map(&p.tm_t, L_e, MapType::F32, L, K, BM, 32, true) &&
        make_map(&p.tm_r, P_e, MapType::F32, B, K, 1, BK, false) &&
        make_map_3d(&p.tm_o, z, MapType::F32, B, L, N, 64, 32, true)))
    return (int)cudaErrorInvalidValue;
  p.ea = static_cast<const float*>(a);
  p.ec = static_cast<const float*>(c);
  p.nl = L;
  p.nl_pad = nl_pad;
  p.l0 = 0;
  p.L = L;
  p.K = K;
  p.N = N;
  p.tiles_n = N / BN;
  p.tiles = (int)(M / BM) * p.tiles_n;
  p.grid = grid < p.tiles ? grid : p.tiles;
  return (int)launch<A_PROD, EPI_RAW>(p, reinterpret_cast<cudaStream_t>(stream));
}
