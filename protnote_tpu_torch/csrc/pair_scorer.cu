// Folded pair-MLP scorer for Hopper (sm_90a): one hidden layer of the
// (sequence x label) output MLP per launch.
//
// Replaces the TPU op chain protnote_tpu/ops/pair_scorer.py:197 _tiled_scaffold
// + :242 pair_logits_tiled (and its removed Pallas form pair_logits_pallas).
// For a chunk of labels [l0, l0 + nl), padded by the caller to nl_pad (a
// multiple of the 128-row tile), and all B sequences, rows r = b * nl_pad + l
// are (sequence, label) pairs, and the chain is
//
//   x1[r]      = bf16(relu(a[b] + c[l0 + l]))                 (f32 add)
//   x_{i+1}[r] = bf16(relu(x_i[r] @ W_i + bias_i))            (f32 accumulate)
//   logit[b, l0 + l] += sum_n f32(x_last[r, n]) * f32(w_out[n])   (l < nl only)
//
// with the logits pre-filled with b_out by the caller.  One launch computes
// one GEMM of that chain; a template flag picks where its A operand comes from
// (formed from a and c, or read from a bf16 workspace x_in) and where its
// epilogue goes (a bf16 store of the next activations, or the dot with w_out
// into the logits).  x1 and the last layer's activations never reach device
// memory.
//
// What bounds it: the hidden H x H GEMMs.  At the default width (H = 3072,
// two hidden layers) they cost 2 * 2 * 3072^2 = 37.7 MFLOP per pair, 77.5
// TFLOP for a 32-sequence batch against 64,204 label rows: 78.4 ms at the
// 989 TFLOP/s dense bf16 peak.  The weights (18 MB bf16 a layer) stay in the
// 50 MB L2, so the kernel is bound by the tensor cores.  The design, against
// what held the first (WMMA) version at 17% of that peak:
//
// * wgmma, not mma.sync: two consumer warpgroups each issue
//   wgmma.mma_async m64nBNk16 (BN = 256, or 128 when H is an odd multiple of
//   128) on a 128 x BN output tile, f32 accumulators in registers.
// * TMA, not copies by the compute threads: one producer thread loads each
//   k-step's W^T tile (K-major, the caller transposes W once per call) and
//   A-side tile with cp.async.bulk.tensor into a ring of shared-memory
//   stages, 128-byte swizzled to match the wgmma descriptors; full/empty
//   mbarrier pairs track the ring, so no block-wide barrier sits in the
//   mainloop.  The producer's warpgroup gives its registers to the consumers
//   (setmaxnreg).
// * BK = 64 a stage (four wgmma k-steps), 3-6 stages deep; each consumer
//   keeps one stage's products in flight while it issues the next.
// * The first layer without a second barrier: the caller pads each label
//   chunk to whole row tiles, so a tile's 128 rows are 128 labels of one
//   sequence b.  The producer loads the f32 c rows and the f32 a[b] slice;
//   each consumer thread forms bf16(relu(a + c)) straight into wgmma's
//   A-fragment registers and issues the register-A form of wgmma, with two
//   fragment sets so that one stage's products run while the next stage's
//   fragments are formed.  x1 never reaches shared memory.
// * Persistent: one block an SM walks a static schedule over the launch's
//   (row tile, column tile) grid, column tiles fastest, so the blocks in
//   flight share W's panels and x_in's row panels in L2, and the producer
//   loads the next tile while the consumers run the epilogue.
// * Epilogues from the accumulator registers: bias, ReLU and the bf16
//   rounding in place; the store stages 64-column slices in two 8 KB boxes
//   a warpgroup and TMA-stores them, so they leave under the next tile's
//   products (the first layer's a[b] slices sit outside the ring so that
//   three 64 KB stages and the boxes fit); the dot with w_out sums
//   the thread's columns, then the quad's, and adds one value a row per
//   column tile into the logits (12 adds a logit at H 3072).

#include "hopper.cuh"

#include <string.h>

#include <type_traits>

namespace {

constexpr int BM = 128;          // pair rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;           // reduction depth a stage: one 128-byte row of bf16
constexpr int CONSUMERS = 2;     // consumer warpgroups; the producer's is the last
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

constexpr int EPI_BOX = 64 * 64 * 2;  // one 64 x 64 bf16 box of the output

// Shared memory of one variant: a ring of STAGES stages, each the W^T tile
// (BN rows of BK bf16) and the A side: the bf16 x_in tile (128 rows of BK),
// or for the first layer the f32 c tile as two 32-column halves (each row 128
// bytes, so TMA's 128-byte swizzle applies); for a store epilogue two output
// boxes a consumer warpgroup; for the first layer the f32 a[b] slice of each
// stage; then the mbarriers.  Every tile starts on a 1024-byte swizzle atom.
template <int BN, bool PAIR_A, bool STORE>
struct Layout {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int CH_BYTES = BM * 32 * 4;
  static constexpr int AROW_BYTES = PAIR_A ? BK * 4 : 0;
  static constexpr int STAGE = PAIR_A ? B_BYTES + 2 * CH_BYTES : B_BYTES + A_BYTES;
  static constexpr int TX = STAGE + AROW_BYTES;  // bytes a stage's loads bring
  static constexpr int EPI_BYTES = STORE ? CONSUMERS * 2 * EPI_BOX : 0;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256 - EPI_BYTES) / (STAGE + AROW_BYTES);
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int EPI_OFF = STAGES * STAGE;
  static constexpr int AROW_OFF = EPI_OFF + EPI_BYTES;
  static constexpr int BAR_OFF = AROW_OFF + STAGES * AROW_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "swizzle atoms");
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

template <int BN, bool PAIR_A, bool DOT_OUT>
__global__ void __launch_bounds__(THREADS, 1)
pair_mlp_layer_kernel(const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_c,
                      const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_o,
                      const float* __restrict__ bias, const __nv_bfloat16* __restrict__ w_out,
                      float* __restrict__ logits, int nl, int nl_pad, int l0, int L, int K,
                      int tiles_n, int tiles) {
  using Lay = Layout<BN, PAIR_A, !DOT_OUT>;
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
        const int lrow = l0 + (m0 - b * nl_pad);
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty_bar(s), phase ^ 1u);
          const uint32_t st = base + s * Lay::STAGE;
          mbar_expect_tx(full_bar(s), Lay::TX);
          tma_load(st, &tm_w, kt * BK, n0, full_bar(s));
          if (PAIR_A) {
            tma_load(st + Lay::B_BYTES, &tm_c, kt * BK, lrow, full_bar(s));
            tma_load(st + Lay::B_BYTES + Lay::CH_BYTES, &tm_c, kt * BK + 32, lrow, full_bar(s));
            tma_load(base + Lay::AROW_OFF + s * Lay::AROW_BYTES, &tm_a, kt * BK, b, full_bar(s));
          } else {
            tma_load(st + Lay::B_BYTES, &tm_x, kt * BK, m0, full_bar(s));
          }
          if (++s == STAGES) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // ---- consumers: wgmma on the ring, then the epilogue ------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row (and row + 8)
    const int q = lane & 3;   // fragment column pair
    const int row = wg * 64 + warp * 16 + g;  // the thread's first row in the tile
    float acc[BN / 2];
    // the first layer's A fragments, two sets: one feeds the products in
    // flight while the other is formed for the next stage
    uint32_t fa[2][4][4];
    int s = 0;
    uint32_t phase = 0;
    // One stage: wait for its tiles, (first layer: form A into fa[P]), issue
    // its four products, then retire the previous stage's and free its slot.
    auto stage = [&](auto parity, int kt, int& prev) {
      constexpr int P = decltype(parity)::value;
      mbar_wait(full_bar(s), phase);
      const uint32_t st = base + s * Lay::STAGE;
      const uint64_t db = smem_desc(st);
      if (PAIR_A) {
        // x1 = bf16(relu(a[b] + c)) for the thread's A-fragment elements
        // (rows row, row + 8; columns 2q, 2q + 1 and those + 8 of each
        // 16-wide k-step), read from the swizzled f32 c halves
        const unsigned char* sp = smem + s * Lay::STAGE + Lay::B_BYTES;
        const float* arow = reinterpret_cast<const float*>(smem + Lay::AROW_OFF + s * Lay::AROW_BYTES);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* ch = reinterpret_cast<const float*>(sp + (kk >> 1) * Lay::CH_BYTES);
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = (kk & 1) * 16 + 2 * q + 8 * cc;  // within the 32-wide half
            const float2 av = *reinterpret_cast<const float2*>(arow + (kk >> 1) * 32 + col);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int r = row + 8 * rr;
              const int phys = r * 32 + (((col >> 2) ^ (r & 7)) << 2) + (col & 3);
              const float2 cv = *reinterpret_cast<const float2*>(ch + phys);
              fa[P][kk][rr + 2 * cc] =
                  pack_bf16x2(fmaxf(av.x + cv.x, 0.f), fmaxf(av.y + cv.y, 0.f));
            }
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Mma<BN>::rs(acc, fa[P][kk], db + 2 * kk, kt > 0 || kk > 0);
      } else {
        const uint64_t da = smem_desc(st + Lay::B_BYTES + wg * 64 * BK * 2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Mma<BN>::ss(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_acc(acc);
      // the wgmma reads its register operands while in flight: the set that
      // fed the previous stage stays live (unreused) until here
      if (PAIR_A) fence_regs(fa[1 - P]);
      if (prev >= 0 && lane == 0) mbar_arrive(empty_bar(prev));
      prev = s;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1u;
      }
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM;
      const int n0 = (t % tiles_n) * BN;
      int prev = -1;
      for (int kt = 0; kt < KT; kt += 2) {  // KT is even: K is a multiple of 128
        stage(std::integral_constant<int, 0>(), kt, prev);
        stage(std::integral_constant<int, 1>(), kt + 1, prev);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (PAIR_A) fence_regs(fa[1]);
      if (lane == 0) mbar_arrive(empty_bar(prev));

      // ---- epilogue: bias + ReLU + bf16 round from the accumulators -------
      // acc[4j + 0/1]: row, columns 8j + 2q + 0/1; acc[4j + 2/3]: row + 8
      const int r0 = m0 + row;
      if (DOT_OUT) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * q;
          const float2 bv = *reinterpret_cast<const float2*>(bias + col);
          const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w_out + col));
          p0 += round_bf16(fmaxf(acc[4 * j] + bv.x, 0.f)) * wv.x +
                round_bf16(fmaxf(acc[4 * j + 1] + bv.y, 0.f)) * wv.y;
          p1 += round_bf16(fmaxf(acc[4 * j + 2] + bv.x, 0.f)) * wv.x +
                round_bf16(fmaxf(acc[4 * j + 3] + bv.y, 0.f)) * wv.y;
        }
        p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
        p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
        p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
        p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
        if (q == 0) {
          const int b = r0 / nl_pad;
          const int l = r0 - b * nl_pad;  // the tile lies in one sequence: l + 8 too
          float* out = logits + (size_t)b * L + l0;
          if (l < nl) atomicAdd(out + l, p0);
          if (l + 8 < nl) atomicAdd(out + l + 8, p1);
        }
      } else {
        // 64-column slices of the warpgroup's 64 rows go through two boxes
        // in shared memory (128-byte swizzled, as the output map reads them)
        // and out by TMA; the stores run on under the next tile's products
        const uint32_t ebuf = base + Lay::EPI_OFF + wg * 2 * EPI_BOX;
        const int lr = warp * 16 + g;  // the thread's first row of the warpgroup's 64
#pragma unroll
        for (int part = 0; part < BN / 64; ++part) {
          const uint32_t box = ebuf + (part & 1) * EPI_BOX;
          if (tid == 0) bulk_wait_read<1>();  // the store that last read this box is done
          warpgroup_barrier(1 + wg);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * part + jj;
            const float2 bv = *reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * q);
            const uint32_t off = ((jj ^ (lr & 7)) << 4) + 4 * q;  // rows lr, lr + 8 alike
            st_shared(box + lr * 128 + off,
                      pack_bf16x2(fmaxf(acc[4 * j] + bv.x, 0.f), fmaxf(acc[4 * j + 1] + bv.y, 0.f)));
            st_shared(box + (lr + 8) * 128 + off,
                      pack_bf16x2(fmaxf(acc[4 * j + 2] + bv.x, 0.f),
                                  fmaxf(acc[4 * j + 3] + bv.y, 0.f)));
          }
          fence_async_smem();
          warpgroup_barrier(1 + wg);
          if (tid == 0) {
            tma_store(&tm_o, box, n0 + 64 * part, m0 + wg * 64);
            bulk_commit();
          }
        }
      }
    }
    if (!DOT_OUT && tid == 0) bulk_wait_all();  // the last stores leave before the block
  }
}

struct Args {
  CUtensorMap tm_w, tm_x, tm_c, tm_a, tm_o;
  const float* bias;
  const __nv_bfloat16* w_out;
  float* logits;
  int nl, nl_pad, l0, L, K, tiles_n, tiles, grid;
};

template <int BN, bool PAIR_A, bool DOT_OUT>
cudaError_t launch(const Args& p, cudaStream_t s) {
  constexpr int bytes = Layout<BN, PAIR_A, !DOT_OUT>::BYTES;
  auto kernel = pair_mlp_layer_kernel<BN, PAIR_A, DOT_OUT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, THREADS, bytes, s>>>(p.tm_w, p.tm_x, p.tm_c, p.tm_a, p.tm_o, p.bias, p.w_out,
                                        p.logits, p.nl, p.nl_pad, p.l0, p.L, p.K, p.tiles_n,
                                        p.tiles);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_mode(int mode, const Args& p, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<BN, false, false>(p, s);
    case 1: return launch<BN, true, false>(p, s);
    case 2: return launch<BN, false, true>(p, s);
    default: return launch<BN, true, true>(p, s);
  }
}

}  // namespace

// One hidden layer of the chain for the label chunk [l0, l0 + nl), padded to
// nl_pad rows a sequence (a multiple of 128): M = B * nl_pad pair rows.
//   a (B, K) f32, c (L, K) f32: the first layer's per-side products;
//   x_in (M, K) bf16: the previous layer's activations;
//   wt (N, K) bf16: the layer's W transposed (K-major); bias (N,) f32;
//   x_out (M, N) bf16; w_out (N,) bf16; logits (B, L) f32, added into.
// mode bit 0: A is formed from a and c (first hidden layer); otherwise it is
// read from x_in.  mode bit 1: the epilogue takes the dot with w_out into the
// logits (last hidden layer); otherwise it stores bf16 activations to x_out.
// block_n (256 or 128) is the column tile, grid the number of persistent
// blocks (at most one an SM).  Returns a CUDA error (0 on success):
// cudaErrorInvalidValue for shapes the kernel does not take or a tensor map
// cuTensorMapEncodeTiled refuses.
extern "C" int pair_mlp_layer(const void* a, const void* c, const void* x_in, const void* wt,
                              const void* bias, void* x_out, const void* w_out, void* logits,
                              int B, int nl, int nl_pad, int l0, int L, int K, int N,
                              int block_n, int mode, int grid, void* stream) {
  if (B <= 0 || nl <= 0 || nl_pad < nl || nl_pad % BM != 0 || K <= 0 || K % (2 * BK) != 0 ||
      (block_n != 128 && block_n != 256) || N <= 0 || N % block_n != 0 || mode < 0 || mode > 3 ||
      grid <= 0)
    return (int)cudaErrorInvalidValue;
  const bool pair_a = mode & 1;
  Args p;
  memset(&p, 0, sizeof(p));
  const uint64_t M = (uint64_t)B * nl_pad;
  bool ok = make_map(&p.tm_w, wt, MapType::BF16, N, K, block_n, BK, true);
  if (pair_a) {
    ok = ok && make_map(&p.tm_c, c, MapType::F32, L, K, BM, 32, true) &&
         make_map(&p.tm_a, a, MapType::F32, B, K, 1, BK, false);
  } else {
    ok = ok && make_map(&p.tm_x, x_in, MapType::BF16, M, K, BM, BK, true);
  }
  if (!(mode & 2)) ok = ok && make_map(&p.tm_o, x_out, MapType::BF16, M, N, 64, 64, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  p.bias = static_cast<const float*>(bias);
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.logits = static_cast<float*>(logits);
  p.nl = nl;
  p.nl_pad = nl_pad;
  p.l0 = l0;
  p.L = L;
  p.K = K;
  p.tiles_n = N / block_n;
  p.tiles = (int)(M / BM) * p.tiles_n;
  p.grid = grid < p.tiles ? grid : p.tiles;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(block_n == 256 ? launch_mode<256>(mode, p, s) : launch_mode<128>(mode, p, s));
}

// The dynamic shared memory a launch of the given column tile and mode asks
// for (bytes), or -1 for an argument the kernel does not take.
extern "C" int pair_mlp_layer_smem_bytes(int block_n, int mode) {
  const bool dot = mode & 2;
  if (block_n == 256) {
    if (mode & 1) return dot ? Layout<256, true, false>::BYTES : Layout<256, true, true>::BYTES;
    return dot ? Layout<256, false, false>::BYTES : Layout<256, false, true>::BYTES;
  }
  if (block_n == 128) {
    if (mode & 1) return dot ? Layout<128, true, false>::BYTES : Layout<128, true, true>::BYTES;
    return dot ? Layout<128, false, false>::BYTES : Layout<128, false, true>::BYTES;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// A zero-hidden-layer output MLP (OUTPUT_MLP_NUM_LAYERS 1): the first ReLU
// straight into the logits (protnote_tpu/ops/pair_scorer.py:232-235 with no
// hidden layer):
//
//   logit[b, l0 + l] += sum_n f32(x1[r, n]) * f32(w_out[n]),
//   x1 = bf16(relu(a[b] + c[l0 + l]))        (x null), or
//   x1 = x[b * nl_pad + l]                   (concatenation_prod: the
//        ReLU'd first layer csrc/pair_train.cu:pair_train_prod wrote)
//
// for l < nl, with the logits pre-filled with b_out.  No GEMM is left.
// pair_mlp_head_f32 is the float32 form (compute_dtype float32, MIXED_PRECISION
// False): x1 = relu(a[b] + c[l0 + l]) unrounded, or the float32 x of
// pair_mlp_layer_f32's prod layer, dotted with a float32 w_out.
// From a and c (pair_mlp_head_ac_kernel): a block of 8 warps takes 16
// labels (two a warp) and up to 32 sequences at a time; for each 256-column
// slab it stages the sequences' f32 a slab in shared memory (32 KB), and
// each lane forms its 8 columns of x1 for both labels and every sequence
// from one read of a and its c and w_out values in registers, keeping 64
// running sums; then a butterfly sum a (sequence, label).  Each c row comes
// from device memory once and each a slab from L2 once for 16 labels, where
// a warp a pair read a's whole row per pair (25 GB of L2 reads at 32 x
// 64,204 x 3072).  From x (pair_mlp_head_x_kernel): a warp a pair, its
// lanes 8 columns a step, as x is read once anyway.  What bounds it:
// reading c (789 MB f32 at 64,204 x 3072, 0.24 ms) or x, and the float32
// operations (an add, a max and a multiply-add a pair and column: 0.28 ms
// at 67 TFLOP/s for 32 x 64,204 x 3072); the float32 form reads the same c
// and a w_out of 12 KB instead of 6 KB.

namespace {

constexpr int HEAD_WARPS = 8;
constexpr int HEAD_LPW = 2;    // labels a warp
constexpr int HEAD_B = 32;     // sequences a pass
constexpr int HEAD_SLAB = 256;  // columns a slab: 32 lanes x 8

__device__ __forceinline__ void load8_f32(const float* p, float (&v)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8_bf16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

// F32: x1 is not rounded to bf16 and w_out is float32
template <bool F32>
__device__ __forceinline__ void load8_w(const void* w, size_t n, float (&v)[8]) {
  if (F32) {
    load8_f32(static_cast<const float*>(w) + n, v);
  } else {
    load8_bf16(static_cast<const __nv_bfloat16*>(w) + n, v);
  }
}

template <bool F32>
__global__ void __launch_bounds__(HEAD_WARPS * 32)
pair_mlp_head_ac_kernel(const float* __restrict__ a, const float* __restrict__ c,
                        const void* __restrict__ w_out, float* __restrict__ logits,
                        int B, int nl, int l0, int L, int K) {
  __shared__ __align__(16) float a_s[HEAD_B][HEAD_SLAB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lbase = blockIdx.x * HEAD_WARPS * HEAD_LPW + warp * HEAD_LPW;
  for (int b0 = 0; b0 < B; b0 += HEAD_B) {
    const int nb = min(HEAD_B, B - b0);
    float acc[HEAD_LPW][HEAD_B];
#pragma unroll
    for (int li = 0; li < HEAD_LPW; ++li)
#pragma unroll
      for (int b = 0; b < HEAD_B; ++b) acc[li][b] = 0.f;
    for (int n0 = 0; n0 < K; n0 += HEAD_SLAB) {
      const int width = min(HEAD_SLAB, K - n0);
      __syncthreads();  // the previous slab's reads are done
      for (int i = threadIdx.x; i < nb * (HEAD_SLAB / 4); i += blockDim.x) {
        const int b = i / (HEAD_SLAB / 4);
        const int q4 = i - b * (HEAD_SLAB / 4);
        if (4 * q4 < width)
          *reinterpret_cast<float4*>(&a_s[b][4 * q4]) =
              __ldg(reinterpret_cast<const float4*>(a + (size_t)(b0 + b) * K + n0) + q4);
      }
      __syncthreads();
      const int col = lane * 8;
      if (col >= width) continue;
      float cv[HEAD_LPW][8], wv[8];
      load8_w<F32>(w_out, n0 + col, wv);
#pragma unroll
      for (int li = 0; li < HEAD_LPW; ++li) {
        const int l = lbase + li;
        if (l < nl) {
          load8_f32(c + (size_t)(l0 + l) * K + n0 + col, cv[li]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) cv[li][e] = 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < HEAD_B; ++b) {  // unrolled: acc stays in registers
        if (b >= nb) continue;
        const float4 lo = *reinterpret_cast<const float4*>(&a_s[b][col]);
        const float4 hi = *reinterpret_cast<const float4*>(&a_s[b][col + 4]);
        const float av[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int li = 0; li < HEAD_LPW; ++li) {
          float t = acc[li][b];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float h = fmaxf(av[e] + cv[li][e], 0.f);
            t += (F32 ? h : round_bf16(h)) * wv[e];
          }
          acc[li][b] = t;
        }
      }
    }
#pragma unroll
    for (int li = 0; li < HEAD_LPW; ++li) {
      const int l = lbase + li;
#pragma unroll
      for (int b = 0; b < HEAD_B; ++b) {
        if (b >= nb) continue;
        float sum = acc[li][b];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
        if (lane == 0 && l < nl) logits[(size_t)(b0 + b) * L + l0 + l] += sum;
      }
    }
  }
}

template <bool F32>
__global__ void __launch_bounds__(256)
pair_mlp_head_x_kernel(const void* __restrict__ x, const void* __restrict__ w_out,
                       float* __restrict__ logits, int B, int nl, int nl_pad, int l0, int L,
                       int K) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  const long long pairs = (long long)B * nl;
  for (long long i = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; i < pairs;
       i += warps) {
    const int b = (int)(i / nl);
    const int l = (int)(i - (long long)b * nl);
    float sum = 0.f;
    for (int n = lane * 8; n < K; n += 256) {
      float v[8], w[8];
      load8_w<F32>(x, ((size_t)b * nl_pad + l) * K + n, v);
      load8_w<F32>(w_out, n, w);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[e] * w[e];
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (lane == 0) logits[(size_t)b * L + l0 + l] += sum;
  }
}

template <bool F32>
int head(const void* a, const void* c, const void* x, const void* w_out, void* logits, int B,
         int nl, int nl_pad, int l0, int L, int K, void* stream) {
  if (B <= 0 || nl <= 0 || nl_pad < nl || l0 < 0 || l0 + nl > L || K <= 0 || K % 8 != 0 ||
      (x == nullptr && (a == nullptr || c == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(logits);
  if (x == nullptr) {
    const int per_block = HEAD_WARPS * HEAD_LPW;
    pair_mlp_head_ac_kernel<F32><<<(nl + per_block - 1) / per_block, HEAD_WARPS * 32, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(c), w_out, out, B, nl, l0, L, K);
  } else {
    const long long pairs = (long long)B * nl;
    const int blocks = (int)((pairs + 7) / 8 < 132 * 16 ? (pairs + 7) / 8 : 132 * 16);
    pair_mlp_head_x_kernel<F32><<<blocks, 256, 0, s>>>(x, w_out, out, B, nl, nl_pad, l0, L, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The zero-hidden-layer chain for the label chunk [l0, l0 + nl) of B
// sequences: a (B, K) and c (L, K) f32, or x (B * nl_pad, K) bf16 (then a and
// c unused); w_out (K,) bf16; logits (B, L) f32, added into.  K a multiple of
// 8, all pointers 16-byte aligned.  Returns a CUDA error (0 on success).
extern "C" int pair_mlp_head(const void* a, const void* c, const void* x, const void* w_out,
                             void* logits, int B, int nl, int nl_pad, int l0, int L, int K,
                             void* stream) {
  return head<false>(a, c, x, w_out, logits, B, nl, nl_pad, l0, L, K, stream);
}

// pair_mlp_head in float32: x1 = relu(a + c) not rounded, or x (B * nl_pad,
// K) f32; w_out (K,) f32.
extern "C" int pair_mlp_head_f32(const void* a, const void* c, const void* x, const void* w_out,
                                 void* logits, int B, int nl, int nl_pad, int l0, int L, int K,
                                 void* stream) {
  return head<true>(a, c, x, w_out, logits, B, nl, nl_pad, l0, L, K, stream);
}
