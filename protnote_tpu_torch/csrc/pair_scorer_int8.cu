// int8 folded pair-MLP scorer for Hopper (sm_90a): one hidden layer of the
// (sequence x label) output MLP per launch, on s8 x s8 tensor-core products
// with int32 accumulators.
//
// Replaces the TPU op chain protnote_tpu/ops/pair_scorer.py:375
// pair_logits_tiled_int8 (with quantize_folded :295 and the dynamic scales
// :432-447).  For a chunk of labels [l0, l0 + nl), padded by the caller to
// nl_pad rows a sequence (a multiple of the 128-row tile, so a tile lies in
// one sequence; ops/pair_scorer.py:launch_plan, shared with K1), rows
// r = b * nl_pad + l are (sequence, label) pairs.  Each hidden layer i is
//
//   y     = hq_i @ Wq_i                                 (int32, exact)
//   h     = bf16(relu(y * alpha + bias_i))              (f32 epilogue)
//   alpha = s_i * s_w[col]                              static scales
//         = s_act[row] * s_w[col]                       dynamic scales
//
// on int8 codes hq_i that every launch reads from a chunk workspace:
//   pair_int8_codes (static, layer 1):
//       clip(rint(bf16(relu(a[b] + c[l0 + l])) * inv_s0), -127, 127);
//   pair_int8_layer's code epilogue (static, the next layer's input):
//       clip(rint(h * inv_s_{i+1}), 0, 127);
//   pair_int8_row_scale (dynamic, before every layer): the row's scale
//       s_act = max(max |x[r, 0::stride]| * margin, 1e-12) * float32(1 / 127)
//       over x = bf16(relu(a + c)) (layer 1) or the previous layer's bf16 h,
//       and the row's codes clip(rint(x / s_act), -127, 127), a correctly
//       rounded division an element (div_rn: the row's reciprocal and two
//       FMA corrections; the layer's epilogue stores bf16 h for it).
// inv_s = float32(1 / s) comes from the caller: the JAX chain divides by the
// static scales in its source, but they are compile-time constants there,
// and XLA compiles a division by a constant into a multiply by its float32
// reciprocal; a division by data (s_act) stays a division.  The last layer
// dots its h with w_out and adds the row sums into the logits (pre-filled
// with b_out by the caller) with atomics, as K1 does.  Every product, sum
// and quotient is rounded on its own (__fmul_rn, __fadd_rn, div_rn,
// rintf: no FMA contraction, half to even), so the carried codes equal the
// plain version's (ops/pair_scorer.py, _int8_hidden_reference) bit for bit;
// only the w_out reduction order and its atomics differ.
//
// What bounds it: the hidden H x H GEMMs.  At the full serving width (32
// sequences x 64,204 label rows, H = 3072, two hidden layers) a batch is
// 2 x 2 x 2,054,528 x 3072^2 = 77.6 T int8 operations, 39.2 ms at the
// 1,979 TOPS int8 peak.  The GEMM is K1's mainloop (csrc/pair_scorer.cu) on
// s8: persistent, one block an SM walking (row tile, column tile) with the
// column tiles fastest; one producer thread keeps a ring of TMA stages full
// (full/empty mbarriers, 128-byte swizzle: a 128-byte stage row is 128 int8
// values, four k-steps of 32); two consumer warpgroups issue
// wgmma.mma_async m64nBNk32.s32.s8.s8 on 128 x BN tiles (BN 256, or 128
// when H is an odd multiple of 128) with both operands K-major in shared
// memory; the producer's warpgroup gives its registers to the consumers.
// Epilogues run from the accumulator registers: codes or bf16 leave through
// swizzled shared-memory boxes and TMA stores under the next tile's
// products, the dot with w_out adds one value a row per column tile.  Layer
// 1's A operand is a pass of its own (pair_int8_codes), not formed in
// registers as K1 forms x1: the f32 c tile is 4 bytes for each 1-byte
// operand value, re-read from L2 for every column tile, and only two such
// stages fit.  Formed in registers (the register-A s8 wgmma), layer 1 of a
// chunk of 8,192 rows took 0.49 ms on an H100 80GB HBM3 (700 W) against
// 0.15 for the code pass and this GEMM; a chunk's codes (8,192 rows x 3072
// = 25 MB) stay in the 50 MB L2 for the GEMM.
//
// Indexing: the largest workspace is a chunk of 16,384 x 3072 bf16 (100
// MB) and c has 197 M elements, all below 2^31, so 32-bit element indices
// suffice; pointer offsets are formed in size_t all the same.

#include "hopper.cuh"

#include <string.h>

namespace {

constexpr int BM = 128;          // pair rows a tile: two consumer warpgroups of 64
constexpr int BK = 128;          // reduction depth a stage: one 128-byte row of int8
constexpr int CONSUMERS = 2;     // consumer warpgroups; the producer's is the last
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int EPI_BOX = 64 * 128;  // one 64-row x 128-byte box of the output

// Where the epilogue goes.
enum Epi { E_CODES = 0, E_BF16 = 1, E_DOT = 2 };

// Shared memory of one variant: a ring of STAGES stages, each the W^T tile
// (BN rows of BK int8) and the A tile (128 rows of BK int8 codes); for a
// store epilogue two output boxes a consumer warpgroup; then the mbarriers.
// Every tile starts on a 1024-byte swizzle atom.
template <int BN, bool STORE>
struct Layout {
  static constexpr int B_BYTES = BN * BK;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE = B_BYTES + A_BYTES;
  static constexpr int EPI_BYTES = STORE ? CONSUMERS * 2 * EPI_BOX : 0;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256 - EPI_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int EPI_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = EPI_OFF + EPI_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "swizzle atoms");
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

// wgmma m64nBNk32, s8 x s8 in, s32 accumulators, both operands K-major in
// shared memory (8-bit wgmma takes no transpose).  scale_d 0 overwrites.
template <int BN>
struct Mma8;

template <>
struct Mma8<256> {
  static __device__ __forceinline__ void ss(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : I128(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma8<128> {
  static __device__ __forceinline__ void ss(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : I64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// clip(rint(q), lo, 127) as one byte: q = x / s correctly rounded (DIV,
// through s's rounded reciprocal r: div_rn) or x * s (s a constant's
// reciprocal, r unused)
template <bool DIV>
__device__ __forceinline__ uint32_t quantize(float x, float s, float r, float lo) {
  const float q = fminf(fmaxf(rintf(DIV ? div_rn(x, s, r) : __fmul_rn(x, s)), lo), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// 4 consecutive values -> 4 int8 codes packed little-endian
template <bool DIV>
__device__ __forceinline__ uint32_t quantize4(const float (&v)[4], float s, float r, float lo) {
  return quantize<DIV>(v[0], s, r, lo) | (quantize<DIV>(v[1], s, r, lo) << 8) |
         (quantize<DIV>(v[2], s, r, lo) << 16) | (quantize<DIV>(v[3], s, r, lo) << 24);
}

template <int BN, int EPI, bool DYN>
__global__ void __launch_bounds__(THREADS, 1)
pair_int8_layer_kernel(const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_o,
                       const float* __restrict__ s_w, const float* __restrict__ bias,
                       const float* __restrict__ row_scale,
                       const __nv_bfloat16* __restrict__ w_out, float* __restrict__ logits,
                       float s_in, float inv_next, int nl, int nl_pad, int l0, int L, int K,
                       int tiles_n, int tiles) {
  using Lay = Layout<BN, EPI != E_DOT>;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
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
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty_bar(s), phase ^ 1u);
          const uint32_t st = base + s * Lay::STAGE;
          mbar_expect_tx(full_bar(s), Lay::STAGE);
          tma_load(st, &tm_w, kt * BK, n0, full_bar(s));
          tma_load(st + Lay::B_BYTES, &tm_x, kt * BK, m0, full_bar(s));
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
    const int lr = warp * 16 + g;             // ... of the warpgroup's 64
    const uint32_t ebuf = base + Lay::EPI_OFF + wg * 2 * EPI_BOX;
    int boxes = 0;  // output boxes used so far: they alternate
    int acc[BN / 2];
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM;
      const int n0 = (t % tiles_n) * BN;
      int prev = -1;
      for (int kt = 0; kt < KT; ++kt) {
        // wait for the stage, issue its four products, then retire the
        // previous stage's and free its slot
        mbar_wait(full_bar(s), phase);
        const uint32_t st = base + s * Lay::STAGE;
        const uint64_t db = smem_desc(st);
        const uint64_t da = smem_desc(st + Lay::B_BYTES + wg * 64 * BK);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Mma8<BN>::ss(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
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

      // ---- epilogue: dequantize, bias, ReLU, bf16 from the accumulators ---
      // acc[4j + 0/1]: row, columns 8j + 2q + 0/1; acc[4j + 2/3]: row + 8
      const int r0 = m0 + row;
      const float sr0 = DYN ? row_scale[r0] : s_in;
      const float sr1 = DYN ? row_scale[r0 + 8] : s_in;
      // h of accumulator pair (4j + 2 hf, 4j + 2 hf + 1)
      auto hpair = [&](int j, int hf) {
        const int col = n0 + 8 * j + 2 * q;
        const float2 sw = *reinterpret_cast<const float2*>(s_w + col);
        const float2 bv = *reinterpret_cast<const float2*>(bias + col);
        const float sr = hf ? sr1 : sr0;
        const float y0 = __int2float_rn(acc[4 * j + 2 * hf]);
        const float y1 = __int2float_rn(acc[4 * j + 2 * hf + 1]);
        return make_float2(
            round_bf16(fmaxf(__fadd_rn(__fmul_rn(y0, __fmul_rn(sr, sw.x)), bv.x), 0.f)),
            round_bf16(fmaxf(__fadd_rn(__fmul_rn(y1, __fmul_rn(sr, sw.y)), bv.y), 0.f)));
      };
      if (EPI == E_DOT) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 wv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(w_out + n0 + 8 * j + 2 * q));
          const float2 h0 = hpair(j, 0), h1 = hpair(j, 1);
          p0 += h0.x * wv.x + h0.y * wv.y;  // bf16 x bf16 products are exact in f32
          p1 += h1.x * wv.x + h1.y * wv.y;
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
        // 128-byte-wide column slices of the warpgroup's 64 rows (128 codes
        // or 64 bf16) go through two alternating boxes in shared memory
        // (128-byte swizzled, as the output map reads them) and out by TMA;
        // the stores run on under the next tile's products
        constexpr int SLICE = EPI == E_CODES ? 128 : 64;  // columns a box
#pragma unroll
        for (int part = 0; part < BN / SLICE; ++part) {
          const uint32_t box = ebuf + (boxes & 1) * EPI_BOX;
          ++boxes;
          if (tid == 0) bulk_wait_read<1>();  // the store that last read this box is done
          warpgroup_barrier(1 + wg);
#pragma unroll
          for (int jj = 0; jj < SLICE / 8; ++jj) {
            const int j = (SLICE / 8) * part + jj;
            const float2 h0 = hpair(j, 0), h1 = hpair(j, 1);
            if (EPI == E_CODES) {
              // byte 8 jj + 2q of the row: 16-byte chunk jj / 2, swizzled
              const uint32_t off = ((((jj >> 1) ^ (lr & 7))) << 4) + (jj & 1) * 8 + 2 * q;
              const float c0[4] = {h0.x, h0.y, h1.x, h1.y};
              const uint32_t codes = quantize4<false>(c0, inv_next, 0.f, 0.f);
              st_shared_b16(box + lr * 128 + off, (uint16_t)(codes & 0xffffu));
              st_shared_b16(box + (lr + 8) * 128 + off, (uint16_t)(codes >> 16));
            } else {
              const uint32_t off = ((jj ^ (lr & 7)) << 4) + 4 * q;  // rows lr, lr + 8 alike
              st_shared(box + lr * 128 + off, pack_bf16x2(h0.x, h0.y));
              st_shared(box + (lr + 8) * 128 + off, pack_bf16x2(h1.x, h1.y));
            }
          }
          fence_async_smem();
          warpgroup_barrier(1 + wg);
          if (tid == 0) {
            tma_store(&tm_o, box, n0 + SLICE * part, m0 + wg * 64);
            bulk_commit();
          }
        }
      }
    }
    if (EPI != E_DOT && tid == 0) bulk_wait_all();  // the last stores leave before the block
  }
}

// One warp a pair row of the chunk: its int8 codes, and with DYN its scale.
// x = bf16(relu(a[b] + c[l0 + l])) when FIRST (rows l >= nl, padding, take
// c = 0), else the row of the bf16 workspace x_in.
template <bool FIRST, bool DYN>
__global__ void __launch_bounds__(256)
pair_int8_quantize_kernel(const float* __restrict__ a, const float* __restrict__ c,
                          const __nv_bfloat16* __restrict__ x_in, float* __restrict__ row_scale,
                          int8_t* __restrict__ codes, int nl, int nl_pad, int l0, int M, int K,
                          int stride, float margin, float inv) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= M) return;
  const int b = r / nl_pad;
  const int l = r - b * nl_pad;
  const float* ar = a + (size_t)b * K;
  const float* cr = FIRST && l < nl ? c + (size_t)(l0 + l) * K : nullptr;
  const __nv_bfloat16* xr = x_in + (size_t)r * K;
  auto x_at = [&](int j) {
    if (FIRST) return round_bf16(fmaxf(__fadd_rn(ar[j], cr ? cr[j] : 0.f), 0.f));
    return __bfloat162float(xr[j]);
  };
  float s = inv;
  if (DYN) {
    float m = 0.f;
    for (int j = lane * stride; j < K; j += 32 * stride) m = fmaxf(m, fabsf(x_at(j)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    s = __fmul_rn(fmaxf(__fmul_rn(m, margin), 1e-12f), __frcp_rn(127.f));
    if (lane == 0) row_scale[r] = s;
  }
  const float rs = DYN ? __frcp_rn(s) : 0.f;
  int8_t* out = codes + (size_t)r * K;
  for (int j = 4 * lane; j < K; j += 128) {
    float v[4];
    if (FIRST) {
      const float4 av = *reinterpret_cast<const float4*>(ar + j);
      const float4 cv = cr ? *reinterpret_cast<const float4*>(cr + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = round_bf16(fmaxf(__fadd_rn(av.x, cv.x), 0.f));
      v[1] = round_bf16(fmaxf(__fadd_rn(av.y, cv.y), 0.f));
      v[2] = round_bf16(fmaxf(__fadd_rn(av.z, cv.z), 0.f));
      v[3] = round_bf16(fmaxf(__fadd_rn(av.w, cv.w), 0.f));
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(xr + j);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      v[0] = lo.x;
      v[1] = lo.y;
      v[2] = hi.x;
      v[3] = hi.y;
    }
    *reinterpret_cast<uint32_t*>(out + j) = quantize4<DYN>(v, s, rs, -127.f);
  }
}

struct Args {
  CUtensorMap tm_w, tm_x, tm_o;
  const float *s_w, *bias, *row_scale;
  const __nv_bfloat16* w_out;
  float* logits;
  float s_in, inv_next;
  int nl, nl_pad, l0, L, K, tiles_n, tiles, grid;
};

template <int BN, int EPI, bool DYN>
cudaError_t launch(const Args& p, cudaStream_t s) {
  constexpr int bytes = Layout<BN, EPI != E_DOT>::BYTES;
  auto kernel = pair_int8_layer_kernel<BN, EPI, DYN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, THREADS, bytes, s>>>(p.tm_w, p.tm_x, p.tm_o, p.s_w, p.bias, p.row_scale,
                                        p.w_out, p.logits, p.s_in, p.inv_next, p.nl, p.nl_pad,
                                        p.l0, p.L, p.K, p.tiles_n, p.tiles);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_mode(int mode, const Args& p, cudaStream_t s) {
  switch (mode) {
    case E_CODES: return launch<BN, E_CODES, false>(p, s);
    case E_DOT: return launch<BN, E_DOT, false>(p, s);
    case E_BF16 | 4: return launch<BN, E_BF16, true>(p, s);
    case E_DOT | 4: return launch<BN, E_DOT, true>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FIRST, bool DYN>
int quantize_rows(const void* a, const void* c, const void* x_in, void* row_scale, void* codes,
                  int nl, int nl_pad, int l0, int M, int K, int stride, float margin, float inv,
                  void* stream) {
  const int rows_per_block = 256 / 32;
  pair_int8_quantize_kernel<FIRST, DYN><<<(M + rows_per_block - 1) / rows_per_block, 256, 0,
                                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(c),
      static_cast<const __nv_bfloat16*>(x_in), static_cast<float*>(row_scale),
      static_cast<int8_t*>(codes), nl, nl_pad, l0, M, K, stride, margin, inv);
  return (int)cudaGetLastError();
}

}  // namespace

// One hidden layer of the chain for the label chunk [l0, l0 + nl), padded to
// nl_pad rows a sequence (a multiple of 128): M = B * nl_pad pair rows.
//   x_in (M, K) int8: the layer's input codes;
//   wt (N, K) int8: the layer's Wq transposed (K-major); s_w, bias (N,) f32;
//   row_scale (M,) f32: the dynamic scales (unused with static ones);
//   x_out (M, N): int8 codes (quantized with inv_next = 1 / s_{i+1}) or bf16
//   activations; w_out (N,) bf16; logits (B, L) f32, added into.
// mode = epilogue | (dynamic << 2): epilogue 0 stores the next layer's codes
// (static), 1 its bf16 activations (dynamic), 2 takes the dot with w_out into
// the logits (the last layer); dynamic: alpha is row_scale[row] * s_w[col],
// else s_in * s_w[col].  block_n (256 or 128) is the column tile, grid the
// number of persistent blocks (at most one an SM).  Returns a CUDA error (0
// on success): cudaErrorInvalidValue for shapes the kernel does not take or a
// tensor map cuTensorMapEncodeTiled refuses.
extern "C" int pair_int8_layer(const void* x_in, const void* wt, const void* s_w,
                               const void* bias, const void* row_scale, void* x_out,
                               const void* w_out, void* logits, float s_in, float inv_next, int B,
                               int nl, int nl_pad, int l0, int L, int K, int N, int block_n,
                               int mode, int grid, void* stream) {
  const int epi = mode & 3;
  if (B <= 0 || nl <= 0 || nl_pad < nl || nl_pad % BM != 0 || K <= 0 || K % BK != 0 ||
      (block_n != 128 && block_n != 256) || N <= 0 || N % block_n != 0 || epi > E_DOT ||
      mode > 7 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  Args p;
  memset(&p, 0, sizeof(p));
  const uint64_t M = (uint64_t)B * nl_pad;
  bool ok = make_map(&p.tm_w, wt, MapType::S8, N, K, block_n, BK, true) &&
            make_map(&p.tm_x, x_in, MapType::S8, M, K, BM, BK, true);
  if (epi == E_CODES) ok = ok && make_map(&p.tm_o, x_out, MapType::S8, M, N, 64, 128, true);
  if (epi == E_BF16) ok = ok && make_map(&p.tm_o, x_out, MapType::BF16, M, N, 64, 64, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  p.s_w = static_cast<const float*>(s_w);
  p.bias = static_cast<const float*>(bias);
  p.row_scale = static_cast<const float*>(row_scale);
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.logits = static_cast<float*>(logits);
  p.s_in = s_in;
  p.inv_next = inv_next;
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

// Layer 1's codes with the static scale, rows r = b * nl_pad + l of the
// chunk: clip(rint(bf16(relu(a[b] + c[l0 + l])) * inv_s0), -127, 127) into
// codes (M, K) int8 (rows l >= nl take c = 0).  a (B, K), c (L, K) f32.
extern "C" int pair_int8_codes(const void* a, const void* c, void* codes, int nl, int nl_pad,
                               int l0, int M, int K, float inv_s0, void* stream) {
  if (M <= 0 || nl <= 0 || nl_pad < nl || K <= 0 || K % 128 != 0)
    return (int)cudaErrorInvalidValue;
  return quantize_rows<true, false>(a, c, nullptr, nullptr, codes, nl, nl_pad, l0, M, K, 1, 1.f,
                                    inv_s0, stream);
}

// Per pair row r of the chunk: row_scale[r] = max(max_j |x[r, j]| * margin,
// 1e-12) * float32(1 / 127) over j = 0, stride, 2 * stride, ... < K, and the
// row's codes clip(rint(x[r, :] / row_scale[r]), -127, 127) into codes (M, K)
// int8, where x is bf16(relu(a[b] + c[l0 + l])) when first, else the bf16 rows
// of x_in.
extern "C" int pair_int8_row_scale(const void* a, const void* c, const void* x_in,
                                   void* row_scale, void* codes, int nl, int nl_pad, int l0,
                                   int M, int K, int stride, float margin, int first,
                                   void* stream) {
  if (M <= 0 || nl <= 0 || nl_pad < nl || K <= 0 || K % 128 != 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  return first ? quantize_rows<true, true>(a, c, x_in, row_scale, codes, nl, nl_pad, l0, M, K,
                                           stride, margin, 0.f, stream)
               : quantize_rows<false, true>(a, c, x_in, row_scale, codes, nl, nl_pad, l0, M, K,
                                            stride, margin, 0.f, stream);
}

// The dynamic shared memory a launch of the given column tile and epilogue
// asks for (bytes), or -1 for an argument the kernel does not take.
extern "C" int pair_int8_layer_smem_bytes(int block_n, int epi) {
  const bool store = epi != E_DOT;
  if (block_n == 256) return store ? Layout<256, true>::BYTES : Layout<256, false>::BYTES;
  if (block_n == 128) return store ? Layout<128, true>::BYTES : Layout<128, false>::BYTES;
  return -1;
}
