// int8 folded pair-MLP scorer for Hopper (sm_90a): one hidden layer of the
// (sequence x label) output MLP per launch, on s8 x s8 tensor-core products
// with int32 accumulators.
//
// Replaces the TPU op chain protnote_tpu/ops/pair_scorer.py:375
// pair_logits_tiled_int8 (with quantize_folded :295, layer 1's static codes
// :407-409 and the dynamic scales and codes :441-450).  For a chunk of labels [l0, l0 + nl), padded by the caller to
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
//       rounded division an element (div_bf16: the row's reciprocal and one
//       FMA correction, exact for a bf16 x; the layer's epilogue stores bf16
//       h for it).
// The code passes are kernels of their own, below the GEMM ("the code
// passes").
// inv_s = float32(1 / s) comes from the caller: the JAX chain divides by the
// static scales in its source, but they are compile-time constants there,
// and XLA compiles a division by a constant into a multiply by its float32
// reciprocal; a division by data (s_act) stays a division.  The last layer
// dots its h with w_out and adds the row sums into the logits (pre-filled
// with b_out by the caller) with atomics, as K1 does.  Every product, sum
// and quotient is rounded on its own (__fmul_rn, __fadd_rn, the quotient
// correctly rounded, half to even: no FMA contraction), so the carried codes equal the
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
// 0.15 for the first design's code pass and this GEMM; a chunk's codes
// (8,192 rows x 3072 = 25 MB) stay in the 50 MB L2 for the GEMM, so the
// code passes store them with the default (write-back) policy.
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

template <int BN, int EPI, bool DYN, bool W32>
__global__ void __launch_bounds__(THREADS, 1)
pair_int8_layer_kernel(const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_o,
                       const float* __restrict__ s_w, const float* __restrict__ bias,
                       const float* __restrict__ row_scale,
                       const void* __restrict__ w_out, float* __restrict__ logits,
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
          // w_out in bf16, or in float32 (W32: compute_dtype float32, where
          // JAX dots bf16 h, widened, with the float32 w_out)
          const int col = n0 + 8 * j + 2 * q;
          const float2 wv =
              W32 ? *reinterpret_cast<const float2*>(static_cast<const float*>(w_out) + col)
                  : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                        static_cast<const __nv_bfloat16*>(w_out) + col));
          const float2 h0 = hpair(j, 0), h1 = hpair(j, 1);
          p0 += h0.x * wv.x + h0.y * wv.y;
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

// ---- the code passes -------------------------------------------------------
// Layer 1's static codes (pair_int8_codes) and the dynamic row scales and
// codes (pair_int8_row_scale) that pair_int8_layer reads.  What bounds them
// is the bytes: a chunk's 25 MB of codes out (8,192 rows x 3072) against
// 3.1 MB of c (layer 1) or 50 MB of bf16 h (the later layers) in; and,
// nearly as close, the arithmetic of each code.  The first design (one warp
// a pair row, csrc/variants/k2_codes_v1.cu) read a row of a and of c for
// every pair row, ~200 MB from L2 a chunk, read a later layer's rows twice,
// and spent rintf, the int cast and the bf16 round of each element on the
// card's slower conversion pipe.  Here:
// - a code is rounded by a float add: q clipped to +-127, plus 1.5 * 2^23,
//   lands where the float spacing is 1, so the sum is rounded half to even
//   and its low byte is rint(q) as an int8 (code_byte); byte permutes (and,
//   for quotients >= 0, multiply-adds) pack four;
// - layer 1's codes come from work items of (sequence tile x label group x
//   64-column slice) (ops/pair_scorer.py:code_plan): the slice of a for the
//   tile's sequences in shared memory, each thread's c slice of its label in
//   registers, so a leaves L2 once a label group and c once a sequence tile;
//   16 codes a thread, a 16-byte store;
// - layer 1's dynamic scales come first, every chunk's in one launch of a
//   kernel of their own: a row's maximum over the columns 0::stride of
//   bf16(relu(a + c)) is bf16(max(0, max(a + c))) (relu and the bf16
//   rounding are monotone); persistent blocks keep a's sampled columns
//   (compacted by the caller) in shared memory and walk the labels, c's
//   samples read in place (each of its sectors once);
// - a later layer's row is read once: one warp a row, a row of up to 3072
//   bf16 (twelve 16-byte vectors a lane) held in registers; at stride 8 the
//   sampled columns are each vector's first element; the maximum of |x| is
//   an integer maximum of the bf16 bits; then the codes, 8 a lane a store.
//   A wider row is read twice (once for its maximum).
// Every step rounds as the plain version does (__fadd_rn, the bf16 round,
// the division correctly rounded, half to even, the clip), so the codes and
// scales are its bits.

constexpr float ROUND_MAGIC = 12582912.f;  // 1.5 * 2^23
constexpr int CODE_THREADS = 256;
constexpr int SCALE_ROWS = 64;      // pair rows a block of the layer-1 scale kernel, at most
constexpr int SCALE_ROUND = 384;    // sampled columns staged a round
constexpr int SCALE_PITCH4 = SCALE_ROUND / 4 + 1;  // a staged row of samples, float4s (padded)
constexpr int ROW_VECS = 12;        // 16-byte vectors of a later layer's row a lane holds
constexpr int ROW_STAGE = 8;        // row scales a thread of the codes kernel stages, at most

// clip(rint(q), -127, 127) in the low byte of the returned word
__device__ __forceinline__ uint32_t code_byte(float q) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(q, -127.f), 127.f), ROUND_MAGIC));
}

// the low bytes of four words, little-endian
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t w0, uint32_t w1, uint32_t w2,
                                                   uint32_t w3) {
  return __byte_perm(__byte_perm(w0, w1, 0x0040), __byte_perm(w2, w3, 0x0040), 0x5410);
}

// x / s correctly rounded for a bf16 x (8 significant bits), given r =
// float32(1 / s): q = x r and one correction, q + fma(-q, s, x) r (div_rn
// takes two).  Before its last rounding the corrected value is within 2^-22
// of an ulp of x / s, so it can round elsewhere only where x / s lies that
// close to a float midpoint; at the midpoints beside every half-integer up
// to 127.5 (where a code could change) it is the correctly rounded quotient
// for every bf16 significand and every s that puts x / s near them
// (tests/test_torch_int8_code_plan.py checks them all in exact arithmetic),
// so the codes are those of the true division.
__device__ __forceinline__ float div_bf16(float x, float s, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, s, x), r, q);
}

// the codes of four values: x * s (s a constant's reciprocal) or x / s
// (DIV: div_bf16 through s's rounded reciprocal r; x bf16)
template <bool DIV>
__device__ __forceinline__ uint32_t codes4(float x0, float x1, float x2, float x3, float s,
                                           float r) {
  auto q = [&](float x) { return DIV ? div_bf16(x, s, r) : __fmul_rn(x, s); };
  return pack_low_bytes(code_byte(q(x0)), code_byte(q(x1)), code_byte(q(x2)), code_byte(q(x3)));
}

// the codes of four values q >= 0 (or NaN): only the upper clip can bind,
// and each word's second byte is 0, so two multiply-adds pack a pair and one
// byte permute the four
__device__ __forceinline__ uint32_t codes4_pos(float q0, float q1, float q2, float q3) {
  auto word = [](float q) { return __float_as_uint(__fadd_rn(fminf(q, 127.f), ROUND_MAGIC)); };
  return __byte_perm(word(q1) * 256u + word(q0), word(q3) * 256u + word(q2), 0x5410);
}

// bf16(relu(a + c)) of two columns, as floats: POS rounds and takes the
// ReLU in one convert (the same value: rounding keeps the sign)
template <bool POS>
__device__ __forceinline__ float2 relu_bf16x2(float a0, float c0, float a1, float c1) {
  uint32_t w;
  if (POS) {
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(__fadd_rn(a1, c1)), "f"(__fadd_rn(a0, c0)));
  } else {
    w = pack_bf16x2(fmaxf(__fadd_rn(a0, c0), 0.f), fmaxf(__fadd_rn(a1, c1), 0.f));
  }
  return make_float2(__uint_as_float(w * 65536u), __uint_as_float(w & 0xffff0000u));
}

// labels a block of the layer-1 scale kernel (ops/pair_scorer.py:scale_labels)
__host__ __device__ __forceinline__ int scale_labels(int seq_tile) {
  return seq_tile < SCALE_ROWS ? SCALE_ROWS / seq_tile : 1;
}

// its dynamic shared memory: a's samples of the tile, c's of the labels
__host__ __device__ __forceinline__ int scale_smem_bytes(int seq_tile) {
  return 16 * SCALE_PITCH4 * (seq_tile + scale_labels(seq_tile));
}

// a row's dynamic scale from the maximum m of |x| over its sampled columns
__device__ __forceinline__ float row_scale_of(float m, float margin) {
  return __fmul_rn(fmaxf(__fmul_rn(m, margin), 1e-12f), __frcp_rn(127.f));
}

// asynchronous copies to shared memory: 4 or 16 bytes, zeros where !valid;
// a block's copies are all in flight before it waits for them
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tiling of layer 1's codes kernel (ops/pair_scorer.py:code_plan):
// block i is the work item (sequence tile t, label group g, slice s) with
// i = (t * label_groups + g) * slices + s; its thread (u, li, sg) = (tid %
// units, tid / units % labels, tid / (units * labels)) codes the columns
// [16 (s units + u), + 16) of label g labels + li for the tile's sequences
// sg, sg + seq_groups, ...
struct CodePlan {
  int units, labels, seq_groups, seq_tile, label_groups, seq_tiles, slices;
};

// Layer 1's codes of a chunk's rows r = b * nl_pad + l: clip(rint(x * inv),
// -127, 127) (static) or clip(rint(x / row_scale[r]), -127, 127) (DYN), x =
// bf16(relu(a[b] + c[l0 + l])) and c = 0 for the padding rows l >= nl.  POS:
// every quotient is >= 0 (x >= 0, and inv or the row's scale > 0 and
// finite), so the lower clip cannot bind (the dynamic scales always are).
template <bool DYN, bool POS>
__global__ void __launch_bounds__(CODE_THREADS)
pair_int8_first_codes_kernel(const float* __restrict__ a, const float* __restrict__ c,
                             const float* __restrict__ row_scale, int8_t* __restrict__ codes,
                             const CodePlan p, int B, int nl, int nl_pad, int l0, int K,
                             float inv) {
  // a_s [b][k][u]: unit u's k-th float4 of the tile's sequence b; DYN: then
  // the scale and its reciprocal of the block's rows, [b][label]
  extern __shared__ float4 a_s[];
  const int slice = blockIdx.x % p.slices;
  const int item = blockIdx.x / p.slices;
  const int b0 = item / p.label_groups * p.seq_tile;
  const int bt = min(p.seq_tile, B - b0);
  const int k0 = slice * 16 * p.units;
  const int u = threadIdx.x % p.units;
  const int li = threadIdx.x / p.units % p.labels;
  const int sg = threadIdx.x / (p.units * p.labels);
  const int l = item % p.label_groups * p.labels + li;
  const int col = k0 + 16 * u;
  float4 cv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    cv[k] = l < nl ? __ldg(reinterpret_cast<const float4*>(c + (size_t)(l0 + l) * K + col) + k)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  const int w4 = 4 * p.units;  // float4s of a slice row
  for (int f = threadIdx.x; f < bt * w4; f += CODE_THREADS) {
    const int b = f / w4, j = f - b * w4;
    a_s[(4 * b + (j & 3)) * p.units + (j >> 2)] =
        __ldg(reinterpret_cast<const float4*>(a + (size_t)(b0 + b) * K + k0) + j);
  }
  float* s_s = reinterpret_cast<float*>(a_s + p.seq_tile * w4);
  float* r_s = s_s + p.seq_tile * p.labels;
  if (DYN) {
    // the rows' scales, all loads in flight at once (seq_tile * labels <=
    // ROW_STAGE * CODE_THREADS), then their reciprocals
    const int lg = item % p.label_groups * p.labels;
    float sv[ROW_STAGE];
#pragma unroll
    for (int k = 0; k < ROW_STAGE; ++k) {
      const int f = threadIdx.x + k * CODE_THREADS;
      const int b = f / p.labels;
      sv[k] = b < bt ? row_scale[(size_t)(b0 + b) * nl_pad + lg + f % p.labels] : 1.f;
    }
#pragma unroll
    for (int k = 0; k < ROW_STAGE; ++k) {
      const int f = threadIdx.x + k * CODE_THREADS;
      if (f < bt * p.labels) {
        s_s[f] = sv[k];
        r_s[f] = __frcp_rn(sv[k]);
      }
    }
  }
  __syncthreads();
  for (int b = sg; b < bt; b += p.seq_groups) {
    const size_t r = (size_t)(b0 + b) * nl_pad + l;
    const float s = DYN ? s_s[b * p.labels + li] : inv;
    const float rs = DYN ? r_s[b * p.labels + li] : 0.f;
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 av = a_s[(4 * b + k) * p.units + u];
      const float2 x01 = relu_bf16x2<POS>(av.x, cv[k].x, av.y, cv[k].y);
      const float2 x23 = relu_bf16x2<POS>(av.z, cv[k].z, av.w, cv[k].w);
      if (POS) {
        auto q = [&](float x) { return DYN ? div_bf16(x, s, rs) : __fmul_rn(x, s); };
        w[k] = codes4_pos(q(x01.x), q(x01.y), q(x23.x), q(x23.y));
      } else {
        w[k] = codes4<DYN>(x01.x, x01.y, x23.x, x23.y, s, rs);
      }
    }
    *reinterpret_cast<uint4*>(codes + r * K + col) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Layer 1's dynamic scales of every chunk of a call, one launch: for the
// labels [label0, label0 + n_labels) in chunks of `chunk` labels (the last
// ragged), each padded to whole 128-row tiles, the padded label lam (chunk k
// = lam / chunk, l = lam - k chunk) of sequence b has its row at B k chunk +
// b nl_pad_k + l of `scales`, and its scale from bf16(max(0, max_i (a[b, i]
// + c[label0 + lam, i]))) over i = 0, stride, ... < K (c = 0 for lam >=
// n_labels).  A work item is a sequence tile (code_plan's) x
// scale_labels(seq_tile) padded labels: at most SCALE_ROWS rows, each split
// over `parts` threads that walk its sampled columns four at a time, in
// rounds of SCALE_ROUND columns staged in shared memory (a's from a_sub =
// a[:, ::stride], contiguous; c's read in place, each sector once), then
// combined in a fixed order.  The blocks are persistent: a's samples of the
// tile stay staged across a block's items, which is what a launch a chunk
// could not do (128 blocks a chunk each staging the same 48 KB from L2).
__global__ void __launch_bounds__(256)
pair_int8_first_scale_kernel(const float* __restrict__ a_sub, const float* __restrict__ c,
                             float* __restrict__ scales, int B, int label0, int n_labels,
                             int chunk, int lam_end, int K, int stride, float margin,
                             int seq_tile) {
  extern __shared__ float4 samples[];
  __shared__ float part_max[256];
  const int lgs = scale_labels(seq_tile);
  const int groups = (lam_end + lgs - 1) / lgs;
  const int items = (B + seq_tile - 1) / seq_tile * groups;
  const int rows = seq_tile * lgs;
  const int parts = 256 / rows;
  const int ns = K / stride;
  const bool one_round = ns <= SCALE_ROUND;
  // [sequence][SCALE_PITCH4], then [label][SCALE_PITCH4]: a row's staging
  // stores are contiguous, and the lanes' reads (consecutive sequences or
  // labels, one float4) fall on distinct banks
  float4* a_s = samples;
  float4* c_s = samples + SCALE_PITCH4 * seq_tile;
  const int t = threadIdx.x;
  const int rho = t % rows, q = t / rows;
  const int b = rho % seq_tile, li = rho / seq_tile;
  int staged = -1;  // the sequence tile whose samples a_s holds (one round)
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item / groups;
    const int b0 = tile * seq_tile;
    const int bt = min(seq_tile, B - b0);
    const int lg = item % groups * lgs;
    const int lam = lg + li;
    const bool mine = q < parts && b < bt && lam < lam_end;
    float m = 0.f;
    for (int r0 = 0; r0 < ns; r0 += SCALE_ROUND) {
      const int n4 = min(SCALE_ROUND, ns - r0) / 4;
      // (constant divisors: the index arithmetic is a multiply and a shift)
      for (int f = t; f < lgs * SCALE_ROUND; f += 256) {
        const int lf = f / SCALE_ROUND, i = f % SCALE_ROUND;
        const bool valid = lg + lf < n_labels;
        if (i < 4 * n4)
          cp_async4(smem_u32(reinterpret_cast<float*>(c_s + lf * SCALE_PITCH4) + i),
                    c + (valid ? (size_t)(label0 + lg + lf) * K + (size_t)(r0 + i) * stride : 0),
                    valid);
      }
      if (!one_round || tile != staged) {
        for (int f = t; f < bt * (SCALE_ROUND / 4); f += 256) {
          const int bf = f / (SCALE_ROUND / 4), i4 = f % (SCALE_ROUND / 4);
          if (i4 < n4)
            cp_async16(smem_u32(a_s + bf * SCALE_PITCH4 + i4),
                       reinterpret_cast<const float4*>(a_sub + (size_t)(b0 + bf) * ns + r0) + i4);
        }
        staged = tile;
      }
      cp_async_wait_all();
      __syncthreads();
      if (mine) {
        for (int i4 = q; i4 < n4; i4 += parts) {
          const float4 av = a_s[b * SCALE_PITCH4 + i4];
          const float4 cv = c_s[li * SCALE_PITCH4 + i4];
          m = fmaxf(m, fmaxf(fmaxf(__fadd_rn(av.x, cv.x), __fadd_rn(av.y, cv.y)),
                             fmaxf(__fadd_rn(av.z, cv.z), __fadd_rn(av.w, cv.w))));
        }
      }
      __syncthreads();
    }
    part_max[t] = m;
    __syncthreads();
    if (t < rows && mine) {
      for (int p = 1; p < parts; ++p) m = fmaxf(m, part_max[p * rows + t]);
      const int k = lam / chunk, l = lam - k * chunk;
      const int nl_pad = min(chunk, lam_end - k * chunk);
      scales[(size_t)B * k * chunk + (size_t)(b0 + b) * nl_pad + l] =
          row_scale_of(round_bf16(m), margin);
    }
  }
}

// A later layer's dynamic scales and codes: one warp a row r of the bf16
// workspace x_in, row_scale[r] from max |x[r, 0::STRIDE]| and the codes
// clip(rint(x / row_scale[r]), -127, 127).
template <int STRIDE>
__global__ void __launch_bounds__(256)
pair_int8_later_kernel(const __nv_bfloat16* __restrict__ x_in, float* __restrict__ row_scale,
                       int8_t* __restrict__ codes, int M, int K, float margin) {
  constexpr int PIECE = 32 * ROW_VECS;
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x_in + (size_t)r * K);
  uint2* out = reinterpret_cast<uint2*>(codes + (size_t)r * K);
  const int nv = K / 8;
  uint4 v[ROW_VECS];
  auto load = [&](int p0) {
#pragma unroll
    for (int k = 0; k < ROW_VECS; ++k) {
      const int i = p0 + lane + 32 * k;
      v[k] = i < nv ? __ldg(xr + i) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // |x| as bf16 bits, sign cleared: their integer order is the values'
  uint32_t mb = 0;
  for (int p0 = 0; p0 < nv; p0 += PIECE) {
    load(p0);
#pragma unroll
    for (int k = 0; k < ROW_VECS; ++k) {
      if (STRIDE == 8) {
        mb = max(mb, v[k].x & 0x7fffu);  // column 8 i: the vector's first element
      } else {
        const uint32_t w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) mb = max(mb, max(w[e] & 0x7fffu, (w[e] >> 16) & 0x7fffu));
      }
    }
  }
  mb = __reduce_max_sync(0xffffffffu, mb);
  const float s = row_scale_of(__uint_as_float(mb << 16), margin);
  if (lane == 0) row_scale[r] = s;
  const float rs = __frcp_rn(s);
  auto lo = [](uint32_t w) { return __uint_as_float(w << 16); };
  auto hi = [](uint32_t w) { return __uint_as_float(w & 0xffff0000u); };
  for (int p0 = 0; p0 < nv; p0 += PIECE) {
    if (nv > PIECE) load(p0);  // a row wider than the registers: its second read
#pragma unroll
    for (int k = 0; k < ROW_VECS; ++k) {
      const int i = p0 + lane + 32 * k;
      if (i < nv)
        out[i] = make_uint2(codes4<true>(lo(v[k].x), hi(v[k].x), lo(v[k].y), hi(v[k].y), s, rs),
                            codes4<true>(lo(v[k].z), hi(v[k].z), lo(v[k].w), hi(v[k].w), s, rs));
    }
  }
}

struct Args {
  CUtensorMap tm_w, tm_x, tm_o;
  const float *s_w, *bias, *row_scale;
  const void* w_out;
  float* logits;
  float s_in, inv_next;
  int nl, nl_pad, l0, L, K, tiles_n, tiles, grid;
};

template <int BN, int EPI, bool DYN, bool W32 = false>
cudaError_t launch(const Args& p, cudaStream_t s) {
  constexpr int bytes = Layout<BN, EPI != E_DOT>::BYTES;
  auto kernel = pair_int8_layer_kernel<BN, EPI, DYN, W32>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, THREADS, bytes, s>>>(p.tm_w, p.tm_x, p.tm_o, p.s_w, p.bias, p.row_scale,
                                        p.w_out, p.logits, p.s_in, p.inv_next, p.nl, p.nl_pad,
                                        p.l0, p.L, p.K, p.tiles_n, p.tiles);
  return cudaGetLastError();
}

constexpr int W32_OUT = 8;  // mode bit: w_out is float32

template <int BN>
cudaError_t launch_mode(int mode, const Args& p, cudaStream_t s) {
  switch (mode) {
    case E_CODES: return launch<BN, E_CODES, false>(p, s);
    case E_DOT: return launch<BN, E_DOT, false>(p, s);
    case E_BF16 | 4: return launch<BN, E_BF16, true>(p, s);
    case E_DOT | 4: return launch<BN, E_DOT, true>(p, s);
    case E_DOT | W32_OUT: return launch<BN, E_DOT, false, true>(p, s);
    case E_DOT | 4 | W32_OUT: return launch<BN, E_DOT, true, true>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// The code plan of a chunk from code_plan's four choices; false for a plan
// the kernel does not take.
bool make_code_plan(CodePlan* p, int B, int nl_pad, int K, int units, int labels, int seq_groups,
                    int seq_tile) {
  if (units <= 0 || labels <= 0 || seq_groups <= 0 || seq_tile <= 0 ||
      units * labels * seq_groups != CODE_THREADS || nl_pad % labels != 0 ||
      K % (16 * units) != 0 || seq_tile * 64 * units > 40 * 1024 ||
      seq_tile * labels > ROW_STAGE * CODE_THREADS)
    return false;
  p->units = units;
  p->labels = labels;
  p->seq_groups = seq_groups;
  p->seq_tile = seq_tile;
  p->label_groups = nl_pad / labels;
  p->seq_tiles = (B + seq_tile - 1) / seq_tile;
  p->slices = K / (16 * units);
  return (int64_t)p->seq_tiles * p->label_groups * p->slices < (1ll << 31);
}

template <bool DYN, bool POS>
int first_codes(const void* a, const void* c, const void* row_scale, void* codes,
                const CodePlan& p, int B, int nl, int nl_pad, int l0, int K, float inv,
                cudaStream_t s) {
  const int smem = p.seq_tile * 64 * p.units + (DYN ? 8 * p.seq_tile * p.labels : 0);
  pair_int8_first_codes_kernel<DYN, POS>
      <<<p.seq_tiles * p.label_groups * p.slices, CODE_THREADS, smem, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(c),
          static_cast<const float*>(row_scale), static_cast<int8_t*>(codes), p, B, nl, nl_pad,
          l0, K, inv);
  return (int)cudaGetLastError();
}

}  // namespace

// One hidden layer of the chain for the label chunk [l0, l0 + nl), padded to
// nl_pad rows a sequence (a multiple of 128): M = B * nl_pad pair rows.
//   x_in (M, K) int8: the layer's input codes;
//   wt (N, K) int8: the layer's Wq transposed (K-major); s_w, bias (N,) f32;
//   row_scale (M,) f32: the dynamic scales (unused with static ones);
//   x_out (M, N): int8 codes (quantized with inv_next = 1 / s_{i+1}) or bf16
//   activations; w_out (N,) bf16, or f32 with mode bit 8; logits (B, L)
//   f32, added into.
// mode = epilogue | (dynamic << 2) | (f32 w_out << 3): epilogue 0 stores the next layer's codes
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
      mode > 15 || ((mode & W32_OUT) && epi != E_DOT) || grid <= 0)
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
  p.w_out = w_out;
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
// chunk (b < B, l < nl_pad): clip(rint(bf16(relu(a[b] + c[l0 + l])) *
// inv_s0), -127, 127) into codes (B * nl_pad, K) int8 (rows l >= nl take c =
// 0).  a (B, K), c (L, K) f32.  units, labels, seq_groups, seq_tile: the
// tiling (ops/pair_scorer.py:code_plan).  Returns a CUDA error (0 on
// success), cudaErrorInvalidValue for what the kernel does not take.
extern "C" int pair_int8_codes(const void* a, const void* c, void* codes, int B, int nl,
                               int nl_pad, int l0, int K, float inv_s0, int units, int labels,
                               int seq_groups, int seq_tile, void* stream) {
  CodePlan p;
  if (B <= 0 || nl <= 0 || nl_pad < nl || K <= 0 || K % 128 != 0 ||
      !make_code_plan(&p, B, nl_pad, K, units, labels, seq_groups, seq_tile))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (inv_s0 > 0.f && inv_s0 <= 3.4e38f)  // every quotient >= 0: the lower clip is moot
    return first_codes<false, true>(a, c, nullptr, codes, p, B, nl, nl_pad, l0, K, inv_s0, s);
  return first_codes<false, false>(a, c, nullptr, codes, p, B, nl, nl_pad, l0, K, inv_s0, s);
}

// Per pair row r = b * nl_pad + l of the chunk: row_scale[r] = max(max_j
// |x[r, j]| * margin, 1e-12) * float32(1 / 127) over j = 0, stride, ... < K
// (stride 1 or 8), and the row's codes clip(rint(x[r, :] / row_scale[r]),
// -127, 127) into codes (B * nl_pad, K) int8.  first = 0: x is the bf16 rows
// of x_in, one kernel (a, a_sub, c and the other arguments unused).  Layer 1
// (x = bf16(relu(a[b] + c[l0 + l])), rows l >= nl take c = 0): the scales of
// every chunk of the call come from one launch of the scale kernel, which
// first = 2 makes before this chunk's codes (the call's first chunk, l0 its
// first label: labels [l0, l0 + n_labels) in chunks of `chunk`, row_scale
// the call's buffer of their rows, this chunk's first), and first = 1 reads
// (row_scale this chunk's rows of that buffer); then the codes kernel on
// code_plan's tiling (units, labels, seq_groups, seq_tile).  a_sub is
// a[:, ::stride], contiguous.
extern "C" int pair_int8_row_scale(const void* a, const void* a_sub, const void* c,
                                   const void* x_in, void* row_scale, void* codes, int B, int nl,
                                   int nl_pad, int l0, int K, int stride, float margin,
                                   int first, int units, int labels, int seq_groups,
                                   int seq_tile, int n_labels, int chunk, void* stream) {
  if (B <= 0 || nl <= 0 || nl_pad < nl || K <= 0 || K % 128 != 0 ||
      (stride != 1 && stride != 8) || first < 0 || first > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * nl_pad;
  if (!first) {
    const int grid = (M + 7) / 8;  // a warp a row
    if (stride == 8)
      pair_int8_later_kernel<8><<<grid, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x_in), static_cast<float*>(row_scale),
          static_cast<int8_t*>(codes), M, K, margin);
    else
      pair_int8_later_kernel<1><<<grid, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x_in), static_cast<float*>(row_scale),
          static_cast<int8_t*>(codes), M, K, margin);
    return (int)cudaGetLastError();
  }
  CodePlan p;
  if (!make_code_plan(&p, B, nl_pad, K, units, labels, seq_groups, seq_tile))
    return (int)cudaErrorInvalidValue;
  if (first == 2) {
    if (n_labels < nl || chunk < nl_pad || chunk % 128 != 0) return (int)cudaErrorInvalidValue;
    const int n_chunks = (n_labels + chunk - 1) / chunk;
    const int last = n_labels - (n_chunks - 1) * chunk;
    const int lam_end = (n_chunks - 1) * chunk + (last + 127) / 128 * 128;
    const int lgs = scale_labels(seq_tile);
    const int items = (B + seq_tile - 1) / seq_tile * ((lam_end + lgs - 1) / lgs);
    const int smem = scale_smem_bytes(seq_tile);
    cudaError_t err = cudaFuncSetAttribute(pair_int8_first_scale_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_int8_first_scale_kernel,
                                                          256, smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = min(items, sms * max(per_sm, 1));
    pair_int8_first_scale_kernel<<<grid, 256, smem, s>>>(
        static_cast<const float*>(a_sub), static_cast<const float*>(c),
        static_cast<float*>(row_scale), B, l0, n_labels, chunk, lam_end, K, stride, margin,
        seq_tile);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return first_codes<true, true>(a, c, row_scale, codes, p, B, nl, nl_pad, l0, K, 0.f, s);
}

// The dynamic shared memory a launch of the given column tile and epilogue
// asks for (bytes), or -1 for an argument the kernel does not take.
extern "C" int pair_int8_layer_smem_bytes(int block_n, int epi) {
  const bool store = epi != E_DOT;
  if (block_n == 256) return store ? Layout<256, true>::BYTES : Layout<256, false>::BYTES;
  if (block_n == 128) return store ? Layout<128, true>::BYTES : Layout<128, false>::BYTES;
  return -1;
}
