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

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// 2-D TMA load of the box at (column c0, row c1) into shared memory; rows
// past the tensor's end arrive as zeros and count toward the bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 2-D TMA store of a shared-memory box to (column c0, row c1), in the
// thread's bulk group; rows past the tensor's end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.tile.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most N of the thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, made visible to TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier of one warpgroup's 128 threads (ids 1.. ; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart.  A k-step of 16 bf16 (32
// bytes) inside the swizzled row advances the start address by 2 (16-byte
// units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
// fence or wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define F8(d, i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define D64(d) F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
#define D128(d) \
  D64(d), F8(d, 64), F8(d, 72), F8(d, 80), F8(d, 88), F8(d, 96), F8(d, 104), F8(d, 112), F8(d, 120)

// wgmma m64nBNk16, bf16 in, f32 accumulators: ss reads A and B through
// descriptors, rs takes A from registers (four .b32 of two bf16 each, in the
// m16n8k16 A-fragment layout of the thread's warp).  scale_d 0 overwrites.
template <int BN>
struct Mma;

template <>
struct Mma<256> {
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : D128(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : D128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : D64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint), so
// the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiledFn) nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// a row-major (rows, cols) tensor as a 2-D map with box (box_rows, box_cols)
bool make_map(CUtensorMap* map, const void* ptr, bool f32, uint64_t rows, uint64_t cols,
              uint32_t box_rows, uint32_t box_cols, bool swizzle) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  bool ok = make_map(&p.tm_w, wt, false, N, K, block_n, BK, true);
  if (pair_a) {
    ok = ok && make_map(&p.tm_c, c, true, L, K, BM, 32, true) &&
         make_map(&p.tm_a, a, true, B, K, 1, BK, false);
  } else {
    ok = ok && make_map(&p.tm_x, x_in, false, M, K, BM, BK, true);
  }
  if (!(mode & 2)) ok = ok && make_map(&p.tm_o, x_out, false, M, N, 64, 64, true);
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
