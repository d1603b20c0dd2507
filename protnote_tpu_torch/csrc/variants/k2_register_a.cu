// A variant of K2 that the port does not use; chip_variants.py measures it
// against the kept kernel.  K2's layer 1 with its A operand formed in
// registers (static scales, code epilogue, 256-column tiles), as K1 forms
// x1, in place of the code pass (pair_int8_codes) and the smem-A GEMM.  Each
// consumer thread reads its A-fragment elements of the f32 c tile (TMA,
// 128-byte swizzle) and the f32 a[b] slice from the stage and forms
// clip(rint(bf16(relu(a + c)) * inv_s0), -127, 127) straight into the
// m64nNk32 s8 A-fragment registers, then issues the register-A wgmma.  A
// stage is W^T (256 x 128 s8, 32 KB) + c (128 x 128 f32, 64 KB): two stages
// fit beside the output boxes.  The codes equal the kept kernel's.
#include <type_traits>

#include "../pair_scorer_int8.cu"

namespace {

struct LayA {
  static constexpr int BN = 256;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int CH_BYTES = BM * 32 * 4;  // one 32-column f32 box, 128-byte rows
  static constexpr int STAGE = B_BYTES + 4 * CH_BYTES;
  static constexpr int AROW_BYTES = BK * 4;
  static constexpr int EPI_BYTES = CONSUMERS * 2 * EPI_BOX;
  static constexpr int STAGES = (SMEM_LIMIT - 1024 - 256 - EPI_BYTES) / (STAGE + AROW_BYTES);
  static constexpr int EPI_OFF = STAGES * STAGE;
  static constexpr int AROW_OFF = EPI_OFF + EPI_BYTES;
  static constexpr int BAR_OFF = AROW_OFF + STAGES * AROW_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "two stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

__device__ __forceinline__ void rs256(int (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n}\n"
      : I128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fence_regs8(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__global__ void __launch_bounds__(THREADS, 1)
layer1_rega_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_o,
                   const float* __restrict__ s_w, const float* __restrict__ bias, float s_in,
                   float inv_in, float inv_next, int nl_pad, int l0, int K, int tiles_n, int tiles) {
  using Lay = LayA;
  constexpr int BN = Lay::BN;
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
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * BM;
        const int n0 = (t % tiles_n) * BN;
        const int b = m0 / nl_pad;
        const int lrow = l0 + (m0 - b * nl_pad);
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty_bar(s), phase ^ 1u);
          const uint32_t st = base + s * Lay::STAGE;
          mbar_expect_tx(full_bar(s), Lay::STAGE + Lay::AROW_BYTES);
          tma_load(st, &tm_w, kt * BK, n0, full_bar(s));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load(st + Lay::B_BYTES + j * Lay::CH_BYTES, &tm_c, kt * BK + 32 * j, lrow, full_bar(s));
          tma_load(base + Lay::AROW_OFF + s * Lay::AROW_BYTES, &tm_a, kt * BK, b, full_bar(s));
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
    const int row = wg * 64 + warp * 16 + g;
    const int lr = warp * 16 + g;
    const uint32_t ebuf = base + Lay::EPI_OFF + wg * 2 * EPI_BOX;
    int boxes = 0;
    int acc[BN / 2];
    uint32_t fa[2][4][4];
    int s = 0;
    uint32_t phase = 0;
    auto stage = [&](auto parity, int kt, int& prev) {
      constexpr int P = decltype(parity)::value;
      mbar_wait(full_bar(s), phase);
      const uint32_t st = base + s * Lay::STAGE;
      const uint64_t db = smem_desc(st);
      const unsigned char* sp = smem + s * Lay::STAGE + Lay::B_BYTES;
      const float* arow = reinterpret_cast<const float*>(smem + Lay::AROW_OFF + s * Lay::AROW_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* ch = reinterpret_cast<const float*>(sp + kk * Lay::CH_BYTES);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int cg = q + 4 * cc;  // 16-byte chunk: columns 4 cg .. 4 cg + 3 of the k-step
          const float4 av = *reinterpret_cast<const float4*>(arow + kk * 32 + 4 * cg);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = row + 8 * rr;
            const float4 cv = *reinterpret_cast<const float4*>(ch + r * 32 + ((cg ^ (r & 7)) << 2));
            const float v[4] = {round_bf16(fmaxf(__fadd_rn(av.x, cv.x), 0.f)),
                                round_bf16(fmaxf(__fadd_rn(av.y, cv.y), 0.f)),
                                round_bf16(fmaxf(__fadd_rn(av.z, cv.z), 0.f)),
                                round_bf16(fmaxf(__fadd_rn(av.w, cv.w), 0.f))};
            fa[P][kk][rr + 2 * cc] = quantize4<false>(v, inv_in, 0.f, -127.f);
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rs256(acc, fa[P][kk], db + 2 * kk, kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      fence_regs8(fa[1 - P]);
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
      for (int kt = 0; kt < KT; kt += 2) {
        stage(std::integral_constant<int, 0>(), kt, prev);
        stage(std::integral_constant<int, 1>(), kt + 1, prev);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      fence_regs8(fa[1]);
      if (lane == 0) mbar_arrive(empty_bar(prev));

      auto hpair = [&](int j, int hf) {
        const int col = n0 + 8 * j + 2 * q;
        const float2 sw = *reinterpret_cast<const float2*>(s_w + col);
        const float2 bv = *reinterpret_cast<const float2*>(bias + col);
        const float y0 = __int2float_rn(acc[4 * j + 2 * hf]);
        const float y1 = __int2float_rn(acc[4 * j + 2 * hf + 1]);
        return make_float2(
            round_bf16(fmaxf(__fadd_rn(__fmul_rn(y0, __fmul_rn(s_in, sw.x)), bv.x), 0.f)),
            round_bf16(fmaxf(__fadd_rn(__fmul_rn(y1, __fmul_rn(s_in, sw.y)), bv.y), 0.f)));
      };
      constexpr int SLICE = 128;
#pragma unroll
      for (int part = 0; part < BN / SLICE; ++part) {
        const uint32_t box = ebuf + (boxes & 1) * EPI_BOX;
        ++boxes;
        if (tid == 0) bulk_wait_read<1>();
        warpgroup_barrier(1 + wg);
#pragma unroll
        for (int jj = 0; jj < SLICE / 8; ++jj) {
          const int j = (SLICE / 8) * part + jj;
          const float2 h0 = hpair(j, 0), h1 = hpair(j, 1);
          const uint32_t off = ((((jj >> 1) ^ (lr & 7))) << 4) + (jj & 1) * 8 + 2 * q;
          const float c0[4] = {h0.x, h0.y, h1.x, h1.y};
          const uint32_t codes = quantize4<false>(c0, inv_next, 0.f, 0.f);
          st_shared_b16(box + lr * 128 + off, (uint16_t)(codes & 0xffffu));
          st_shared_b16(box + (lr + 8) * 128 + off, (uint16_t)(codes >> 16));
        }
        fence_async_smem();
        warpgroup_barrier(1 + wg);
        if (tid == 0) {
          tma_store(&tm_o, box, n0 + SLICE * part, m0 + wg * 64);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait_all();
  }
}

}  // namespace

// Layer 1 of a static-scale chunk with A formed in registers: codes of the
// next layer into x_out (M, N) int8.  K a multiple of 256, N of 256.
extern "C" int pair_int8_layer1_rega(const void* a, const void* c, const void* wt, const void* s_w,
                                     const void* bias, void* x_out, float s_in, float inv_in,
                                     float inv_next, int B, int nl_pad, int l0, int L, int K,
                                     int N, int grid, void* stream) {
  if (B <= 0 || nl_pad % BM != 0 || K % (2 * BK) != 0 || N % 256 != 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_w, tm_c, tm_a, tm_o;
  const uint64_t M = (uint64_t)B * nl_pad;
  const bool ok = make_map(&tm_w, wt, MapType::S8, N, K, 256, BK, true) &&
                  make_map(&tm_c, c, MapType::F32, L, K, BM, 32, true) &&
                  make_map(&tm_a, a, MapType::F32, B, K, 1, BK, false) &&
                  make_map(&tm_o, x_out, MapType::S8, M, N, 64, 128, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int tiles_n = N / 256;
  const int tiles = (int)(M / BM) * tiles_n;
  constexpr int bytes = LayA::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(layer1_rega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  layer1_rega_kernel<<<grid < tiles ? grid : tiles, THREADS, bytes,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      tm_w, tm_c, tm_a, tm_o, static_cast<const float*>(s_w), static_cast<const float*>(bias), s_in,
      inv_in, inv_next, nl_pad, l0, K, tiles_n, tiles);
  return (int)cudaGetLastError();
}

// the dynamic shared memory a launch asks for (bytes)
extern "C" int pair_int8_layer1_rega_smem_bytes() { return LayA::BYTES; }
