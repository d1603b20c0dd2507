// pair_train_prod in its first design, which the port no longer uses: the
// PROD branch of K4's kernel (pair_train_hidden_kernel<BN, true>): two
// consumer warpgroups share 128 x BN tiles of one sequence, A = bf16(p[b] *
// l[l]) formed in registers, and after the tile's last products the
// epilogue reads a[b] and c's rows straight from global memory, adds them,
// and stores z through shared-memory boxes by TMA; the tensor cores idle
// while it runs.  Kept as it was (the whole file, K4's pair_train_hidden
// too) for chip_variants.py --dense-first, which times it against the kept
// kernels (csrc/pair_train.cu) in turns.  Its entry points take the kept
// ones' arguments.

// Training pair-MLP forward for Hopper (sm_90a): the first hidden GEMM of the
// decomposed training scorer, with its A operand formed on the fly.
//
// Replaces the TPU op chain protnote_tpu/ops/streaming_train.py:
// pair_logits_dense_decomposed (layer 1 decomposed per side, layer 2's
// GEMM).  For every sequence b < B, label l < L and column n
//
//   x1[b, l] = bf16(relu(f32(a2[b]) + f32(c2[l])))            (bf16 inputs)
//   z[b * L + l, n] = bf16(sum_k x1[b, l, k] * W[k, n])         (f32 accumulate)
//
// a2 = bf16(a * inv1) and c2 = bf16(c * inv1 + shift1) carry the analytic
// layer-1 BatchNorm already; their sum is rounded to bf16 once, as the JAX
// path adds two bf16 arrays.  There is no bias (BatchNorm follows) and no
// ReLU: the epilogue stores the raw pre-activation z, whose masked moments
// the BN+ReLU kernels (csrc/bn_relu.cu) then reduce.  x1 never reaches device
// or shared memory.
//
// What bounds it: the tensor cores.  2 * K * N FLOP a pair row: at the
// default width (H = 3072) and 32 sequences against 32,102 labels, 19.4
// TFLOP, 19.6 ms at the 989 TFLOP/s dense bf16 peak; W (18 MB bf16) stays in
// the 50 MB L2 and c2 (197 MB) is read from device memory once.  The design
// is the first layer of the inference scorer (csrc/pair_scorer.cu, mode 1):
//
// * Persistent and warp-specialised: one block an SM; one producer thread
//   (its warpgroup down to 40 registers by setmaxnreg) keeps a ring of
//   TMA-loaded stages full, tracked by full/empty mbarrier pairs, so no
//   block-wide barrier sits in the mainloop; two consumer warpgroups (232
//   registers) each issue wgmma.mma_async m64nBNk16 on their 64 rows of a
//   128 x BN tile (BN = 256, or 128 where N is an odd multiple of 128).
// * A formed in registers: a stage carries the W^T tile (BN rows of BK = 64
//   bf16, K-major: the caller transposes W once a call), one 128-byte-swizzled
//   bf16 c2 box of 128 rows x 64, and the stage's bf16 a2[b] slice; each
//   consumer thread reads its A-fragment elements from the swizzled c2 box,
//   adds a2[b] in f32, applies ReLU, packs to bf16 and issues the register-A
//   wgmma, with two fragment sets so that one stage's products run while the
//   next stage's fragments are formed.  A bf16 c2 box is half the shared-
//   memory bytes of the inference scorer's f32 one, and four 48 KB stages fit
//   beside the epilogue boxes.
// * Tiles never cross a sequence: a row tile is 128 labels of one sequence b
//   (rows past L arrive from TMA as zeros), so a2[b] is one slice.  The static
//   schedule walks label tiles outermost, then sequences, then column tiles
//   (ops/streaming_train.py:pair_train_plan), so the blocks in flight share one
//   786 KB c2 tile (read from device memory once, then from L2) and W.
// * Epilogue from the accumulator registers: the raw f32 sums rounded to
//   bf16, staged in two 64 x 64 boxes a warpgroup (128-byte swizzled) and
//   TMA-stored while the next tile's products run.  The store goes through a
//   3-D tensor map over z viewed as (B, L, N), box (1, 64, 64) at (b, l, n):
//   TMA clips a box at L, so the last label tile of sequence b (102 labels at
//   L = 32,102) never writes into sequence b + 1's rows, which a 2-D store at
//   row b * L + l would do.  z holds 3.16e9 elements at the default shape:
//   every offset is TMA's, in 64-bit strides.
//
// pair_train_prod: the same mainloop for the concatenation_prod block of
// the dense scorer's first layer (protnote_tpu/ops/pair_scorer.py:108
// pair_logits_dense in training, and :217-231, the w1_prod term of
// _tiled_scaffold, in evaluation):
//
//   x[b, l] = bf16(f32(p[b]) * f32(l[l]))                     (bf16 inputs)
//   z[b * Lz + l, n] = bf16((a[b, n] + c[l, n]) + sum_k x[b, l, k] * W[k, n])
//
// with a = P_e @ W1_p and c = L_e @ W1_l (+ b1) the f32 side products, read
// in the epilogue (c's rows past L as 0), and optionally ReLU before the
// rounding (evaluation: K1's first layer).  The product of two bf16 values
// is exact in f32, so x is the JAX chain's bf16 product; the joint (p * l)
// never reaches memory.  z's rows per sequence Lz >= L lets K1 write a
// label chunk into its padded workspace.

#include "hopper.cuh"

#include <limits.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int BM = 128;          // label rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;           // reduction depth a stage: one 128-byte row of bf16
constexpr int CONSUMERS = 2;     // consumer warpgroups; the producer's is the last
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

constexpr int EPI_BOX = 64 * 64 * 2;  // one 64 x 64 bf16 box of z

// Shared memory: a ring of STAGES stages, each the W^T tile (BN rows of BK
// bf16) and the c2 tile (BM rows of BK bf16, one 128-byte swizzled box); two
// output boxes a consumer warpgroup; the bf16 a2[b] slice of each stage; then
// the mbarriers.  Every tile starts on a 1024-byte swizzle atom.
template <int BN>
struct Layout {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int C_BYTES = BM * BK * 2;
  static constexpr int AROW_BYTES = BK * 2;
  static constexpr int STAGE = B_BYTES + C_BYTES;
  static constexpr int TX = STAGE + AROW_BYTES;  // bytes a stage's loads bring
  static constexpr int EPI_BYTES = CONSUMERS * 2 * EPI_BOX;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256 - EPI_BYTES) / (STAGE + AROW_BYTES);
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int EPI_OFF = STAGES * STAGE;
  static constexpr int AROW_OFF = EPI_OFF + EPI_BYTES;
  static constexpr int BAR_OFF = AROW_OFF + STAGES * AROW_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "swizzle atoms");
  static_assert(STAGES >= 4, "the ring needs four stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

// The schedule (ops/streaming_train.py:pair_train_plan mirrors it): tile t is
// column tile t % tiles_n of sequence (t / tiles_n) % B in label tile
// t / (tiles_n * B).
struct Tile {
  int b, l0, n0;
};
template <int BN>
__device__ __forceinline__ Tile tile_at(int t, int tiles_n, int B) {
  const int u = t / tiles_n;
  return {u % B, (u / B) * BM, (t - u * tiles_n) * BN};
}

// PROD: A = bf16(a2[b] * c2[l]) and the epilogue adds a + c (+ ReLU)
template <int BN, bool PROD>
__global__ void __launch_bounds__(THREADS, 1)
pair_train_hidden_kernel(const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_c,
                         const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_z, int B, int K, int tiles_n,
                         int tiles, const float* __restrict__ ea, const float* __restrict__ ec,
                         int L, int N, int relu) {
  using Lay = Layout<BN>;
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
        const Tile tl = tile_at<BN>(t, tiles_n, B);
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty_bar(s), phase ^ 1u);
          const uint32_t st = base + s * Lay::STAGE;
          mbar_expect_tx(full_bar(s), Lay::TX);
          tma_load(st, &tm_w, kt * BK, tl.n0, full_bar(s));
          tma_load(st + Lay::B_BYTES, &tm_c, kt * BK, tl.l0, full_bar(s));
          tma_load(base + Lay::AROW_OFF + s * Lay::AROW_BYTES, &tm_a, kt * BK, tl.b, full_bar(s));
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
    // A fragments, two sets: one feeds the products in flight while the
    // other is formed for the next stage
    uint32_t fa[2][4][4];
    int s = 0;
    uint32_t phase = 0;
    // One stage: wait for its tiles, form A into fa[P], issue its four
    // products, then retire the previous stage's and free its slot.
    auto stage = [&](auto parity, int kt, int& prev) {
      constexpr int P = decltype(parity)::value;
      mbar_wait(full_bar(s), phase);
      const uint32_t st = base + s * Lay::STAGE;
      const uint64_t db = smem_desc(st);
      // x1 = bf16(relu(a2[b] + c2)) for the thread's A-fragment elements:
      // rows row, row + 8; columns 2q, 2q + 1 and those + 8 of each 16-wide
      // k-step, i.e. 16-byte chunk 2 kk + cc of the 128-byte c2 row, whose
      // place in the row TMA's 128-byte swizzle moves to chunk ^ (row & 7)
      const unsigned char* cp = smem + s * Lay::STAGE + Lay::B_BYTES;
      const __nv_bfloat162* arow =
          reinterpret_cast<const __nv_bfloat162*>(smem + Lay::AROW_OFF + s * Lay::AROW_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int chunk = 2 * kk + cc;
          const float2 av = __bfloat1622float2(arow[4 * chunk + q]);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = row + 8 * rr;
            const float2 cv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                cp + r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * q));
            fa[P][kk][rr + 2 * cc] =
                PROD ? pack_bf16x2(av.x * cv.x, av.y * cv.y)
                     : pack_bf16x2(fmaxf(av.x + cv.x, 0.f), fmaxf(av.y + cv.y, 0.f));
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Mma<BN>::rs(acc, fa[P][kk], db + 2 * kk, kt > 0 || kk > 0);
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
    const uint32_t ebuf = base + Lay::EPI_OFF + wg * 2 * EPI_BOX;
    const int lr = warp * 16 + g;  // the thread's first row of the warpgroup's 64
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at<BN>(t, tiles_n, B);
      int prev = -1;
      for (int kt = 0; kt < KT; kt += 2) {  // KT is even: K is a multiple of 128
        stage(std::integral_constant<int, 0>(), kt, prev);
        stage(std::integral_constant<int, 1>(), kt + 1, prev);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      fence_regs(fa[1]);
      if (lane == 0) mbar_arrive(empty_bar(prev));

      if (PROD) {  // z = (a[b] + c[l]) + sum, ReLU'd for evaluation
        const int l1 = tl.l0 + wg * 64 + lr;
        const float* arow = ea + (size_t)tl.b * N + tl.n0 + 2 * q;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 av = *reinterpret_cast<const float2*>(arow + 8 * j);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int l = l1 + 8 * rr;
            const float2 cv = l < L ? *reinterpret_cast<const float2*>(
                                          ec + (size_t)l * N + tl.n0 + 8 * j + 2 * q)
                                    : make_float2(0.f, 0.f);
            float v0 = __fadd_rn(__fadd_rn(av.x, cv.x), acc[4 * j + 2 * rr]);
            float v1 = __fadd_rn(__fadd_rn(av.y, cv.y), acc[4 * j + 2 * rr + 1]);
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            acc[4 * j + 2 * rr] = v0;
            acc[4 * j + 2 * rr + 1] = v1;
          }
        }
      }
      // ---- epilogue: the raw sums rounded to bf16 ---------------------------
      // acc[4j + 0/1]: row, columns 8j + 2q + 0/1; acc[4j + 2/3]: row + 8.
      // 64-column slices of the warpgroup's 64 rows go through two boxes in
      // shared memory (128-byte swizzled, as the output map reads them) and
      // out by TMA at (column, label, sequence); rows past L are clipped
#pragma unroll
      for (int part = 0; part < BN / 64; ++part) {
        const uint32_t box = ebuf + (part & 1) * EPI_BOX;
        if (tid == 0) bulk_wait_read<1>();  // the store that last read this box is done
        warpgroup_barrier(1 + wg);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * part + jj;
          const uint32_t off = ((jj ^ (lr & 7)) << 4) + 4 * q;  // rows lr, lr + 8 alike
          st_shared(box + lr * 128 + off, pack_bf16x2(acc[4 * j], acc[4 * j + 1]));
          st_shared(box + (lr + 8) * 128 + off, pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]));
        }
        fence_async_smem();
        warpgroup_barrier(1 + wg);
        if (tid == 0) {
          tma_store_3d(&tm_z, box, tl.n0 + 64 * part, tl.l0 + wg * 64, tl.b);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait_all();  // the last stores leave before the block
  }
}

struct Epilogue {
  const float* a = nullptr;
  const float* c = nullptr;
  int L = 0, N = 0, relu = 0;
};

template <int BN, bool PROD>
cudaError_t launch(const CUtensorMap (&maps)[4], int B, int K, int tiles_n, int tiles, int grid,
                   const Epilogue& e, cudaStream_t s) {
  constexpr int bytes = Layout<BN>::BYTES;
  auto kernel = pair_train_hidden_kernel<BN, PROD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, bytes, s>>>(maps[0], maps[1], maps[2], maps[3], B, K, tiles_n, tiles,
                                      e.a, e.c, e.L, e.N, e.relu);
  return cudaGetLastError();
}

}  // namespace

// z (B * L, N) bf16 with rows b * L + l: z = relu(a2[b] + c2[l]) @ W for all
// B sequences and L labels.  a2 (B, K) and c2 (L, K) bf16; wt (N, K) bf16,
// W transposed (K-major); all row-major, contiguous and 16-byte aligned.  K
// is a multiple of 128, N a multiple of block_n (256 or 128); grid is the
// number of persistent blocks (at most one an SM).  Returns a CUDA error (0
// on success): cudaErrorInvalidValue for shapes the kernel does not take or
// a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int pair_train_hidden(const void* a2, const void* c2, const void* wt, void* z, int B,
                                 int L, int K, int N, int block_n, int grid, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || K % (2 * BK) != 0 || (block_n != 128 && block_n != 256) ||
      N <= 0 || N % block_n != 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_n = N / block_n;
  const uint64_t tiles = (uint64_t)((L + BM - 1) / BM) * B * tiles_n;
  if (tiles > (uint64_t)INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  const bool ok = make_map(&maps[0], wt, MapType::BF16, N, K, block_n, BK, true) &&
                  make_map(&maps[1], c2, MapType::BF16, L, K, BM, BK, true) &&
                  make_map(&maps[2], a2, MapType::BF16, B, K, 1, BK, false) &&
                  make_map_3d(&maps[3], z, MapType::BF16, B, L, N, 64, 64, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int g = grid < (int)tiles ? grid : (int)tiles;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Epilogue e;
  return (int)(block_n == 256 ? launch<256, false>(maps, B, K, tiles_n, (int)tiles, g, e, s)
                              : launch<128, false>(maps, B, K, tiles_n, (int)tiles, g, e, s));
}

// z (B * Lz, N) bf16 with rows b * Lz + l (l < L written; Lz >= L):
// z = bf16(a[b] + c[l] + bf16(pe[b] * le[l]) @ W), ReLU'd first when relu is
// set.  pe (B, K) and le (L, K) bf16; wt (N, K) bf16, W transposed
// (K-major); a (B, N) and c (L, N) f32; all row-major, contiguous and
// 16-byte aligned.  K a multiple of 128, N of block_n.  Returns a CUDA error
// as pair_train_hidden.
extern "C" int pair_train_prod(const void* pe, const void* le, const void* wt, const void* a,
                               const void* c, void* z, int B, int L, int Lz, int K, int N,
                               int relu, int block_n, int grid, void* stream) {
  if (B <= 0 || L <= 0 || Lz < L || K <= 0 || K % (2 * BK) != 0 ||
      (block_n != 128 && block_n != 256) || N <= 0 || N % block_n != 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_n = N / block_n;
  const uint64_t tiles = (uint64_t)((L + BM - 1) / BM) * B * tiles_n;
  if (tiles > (uint64_t)INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  const bool ok = make_map(&maps[0], wt, MapType::BF16, N, K, block_n, BK, true) &&
                  make_map(&maps[1], le, MapType::BF16, L, K, BM, BK, true) &&
                  make_map(&maps[2], pe, MapType::BF16, B, K, 1, BK, false) &&
                  make_map_3d(&maps[3], z, MapType::BF16, B, Lz, N, 64, 64, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int g = grid < (int)tiles ? grid : (int)tiles;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Epilogue e;
  e.a = static_cast<const float*>(a);
  e.c = static_cast<const float*>(c);
  e.L = L;
  e.N = N;
  e.relu = relu;
  return (int)(block_n == 256 ? launch<256, true>(maps, B, K, tiles_n, (int)tiles, g, e, s)
                              : launch<128, true>(maps, B, K, tiles_n, (int)tiles, g, e, s));
}

// The dynamic shared memory a launch of the given column tile asks for
// (bytes), or -1 for a column tile the kernel does not take.
extern "C" int pair_train_hidden_smem_bytes(int block_n) {
  return block_n == 256 ? Layout<256>::BYTES : block_n == 128 ? Layout<128>::BYTES : -1;
}
