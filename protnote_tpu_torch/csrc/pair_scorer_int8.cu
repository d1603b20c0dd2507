// int8 folded pair-MLP scorer for Hopper (sm_90a): one hidden layer of the
// (sequence x label) output MLP per launch, on s8 x s8 tensor-core products
// with int32 accumulators.
//
// Replaces the TPU op chain protnote_tpu/ops/pair_scorer.py:375
// pair_logits_tiled_int8 (with quantize_folded :295 and the scaffold of
// :197).  For a chunk of labels [l0, l0 + nl) and all B sequences, rows
// r = b * nl + l are (sequence, label) pairs.  Each hidden layer i computes
//
//   y    = hq_i @ Wq_i                                  (int32, exact)
//   h    = bf16(relu(y * alpha + bias_i))               (f32 epilogue)
//   alpha = s_i * s_w[col]                              static scales
//         = s_act[row] * s_w[col]                       dynamic scales
//
// where hq_i, the layer's int8 input codes, come from
//   layer 1:  clip(rint(bf16(relu(a[b] + c[l0 + l])) * inv_s0), -127, 127)
//             (static) or clip(rint(... / s_act[row]), -127, 127) (dynamic),
//             formed in shared memory from the f32 a and c (x1 never
//             reaches device memory in any type, as in K1);
//   static:   the previous layer's carried codes clip(rint(h * inv_s_i), 0,
//             127), written by its epilogue into the chunk workspace (int8);
//   dynamic:  the previous layer's bf16 h, quantized in shared memory with
//             the row's scale clip(rint(h / s_act[row]), -127, 127).
// inv_s = float32(1 / s) comes from the caller: the JAX chain divides by the
// static scales in its source, but they are compile-time constants there,
// and XLA compiles a division by a constant into a multiply by its float32
// reciprocal; a division by data (s_act) stays a division.
// The last layer dots its h with w_out and adds the row sums into the logits
// (pre-filled with b_out by the caller) with atomics, as K1 does.
//
// pair_int8_row_scale computes the dynamic scales, one warp per row:
// s_act = max(max |x[r, 0::stride]| * margin, 1e-12) * float32(1 / 127) over
// x = bf16(relu(a + c)) (layer 1) or the bf16 workspace (later layers).
//
// Every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn, rintf: no FMA contraction, half to even), so the
// carried codes equal the plain version's (ops/pair_scorer.py,
// _int8_hidden_reference) bit for bit; only the w_out reduction order and
// its atomics differ.
//
// What bounds it: the hidden H x H GEMMs.  At the full serving width (32
// sequences x 64,204 label rows, H = 3072, two hidden layers) a batch is
// 2 x 2 x 2,054,528 x 3072^2 = 77.6 T int8 operations, 39.2 ms at the
// 1,979 TOPS int8 peak.  This first design is K1's, with int8 tiles: 128 x
// 128 x 32 block tiles, 8 warps of WMMA s8 16x16x16 products (mma.sync),
// two blocks per SM, a ring of cp.async stages.  Tiles are stored k-sliced
// ([k / 16][row][16 bytes]) so that each 16x16 fragment is one contiguous,
// 256-byte-aligned block and each cp.async chunk lands whole; W comes in
// column-major (N, K), the layout the s8 products take, laid out once per
// call by the wrapper.  wgmma for s8, TMA and a persistent schedule are the
// next steps toward the bound.
//
// Indexing: the largest buffer is a chunk workspace of 16,384 x 3072
// (50 MB as int8, 100 MB as bf16) and c has 197 M elements, all below
// 2^31, so 32-bit element indices suffice; pointer offsets are formed in
// size_t all the same.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;            // pair rows per block
constexpr int BN = 128;            // output columns per block
constexpr int BK = 32;             // reduction depth per k-step (bytes of int8)
constexpr int KS = 16;             // depth of one WMMA s8 product
constexpr int THREADS = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int TILE_BYTES = BM * BK;  // an int8 A or B tile, k-sliced
constexpr int X_LD = BK + 8;       // padded row stride of the bf16 ring tile
constexpr int CF_LD = BK + 4;      // padded row stride of the f32 c ring tile
constexpr int E_LD = 16 + 4;       // per-warp int32 epilogue scratch stride

static_assert(BM == BN, "A and B tiles share TILE_BYTES");

// Where the layer's A operand comes from, and where its epilogue goes.
enum AMode { A_FIRST = 0, A_CODES = 1, A_BF16 = 2 };
enum EMode { E_CODES = 0, E_BF16 = 1, E_DOT = 2 };

// Shared memory of one variant: a ring of STAGES stages, each an A-side
// tile (the f32 c tile of layer 1, the bf16 activations, or the int8 codes)
// and an int8 W tile; the int8 A tile formed per k-step (not for A_CODES);
// the per-row logit sums.
template <int AM>
struct Layout {
  static constexpr int STAGES = AM == A_FIRST ? 3 : 4;
  static constexpr int A_BYTES = AM == A_FIRST ? BM * CF_LD * 4
                                 : AM == A_BF16 ? BM * X_LD * 2 : TILE_BYTES;
  static constexpr int B_OFF = STAGES * A_BYTES;
  static constexpr int TILE_OFF = B_OFF + STAGES * TILE_BYTES;
  static constexpr int SUM_OFF = TILE_OFF + (AM == A_CODES ? 0 : TILE_BYTES);
  static constexpr int BYTES = SUM_OFF + BM * 4;
  static_assert(8 * 16 * E_LD * 4 <= B_OFF, "epilogue scratch must fit in the ring");
  static_assert(2 * (BYTES + 1024) <= 232448, "two blocks must fit an SM");
  static_assert(A_BYTES % 128 == 0 && TILE_OFF % 128 == 0, "tiles stay aligned");
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// clip(rint(q), lo, 127) as one byte, q = x / s (DIV) or x * s (a
// constant's reciprocal)
template <bool DIV>
__device__ __forceinline__ uint32_t quantize(float x, float s, float lo) {
  const float q = fminf(fmaxf(rintf(DIV ? __fdiv_rn(x, s) : __fmul_rn(x, s)), lo), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// 4 consecutive values -> 4 int8 codes packed little-endian
template <bool DIV>
__device__ __forceinline__ uint32_t quantize4(const float* v, float s, float lo) {
  return quantize<DIV>(v[0], s, lo) | (quantize<DIV>(v[1], s, lo) << 8) |
         (quantize<DIV>(v[2], s, lo) << 16) | (quantize<DIV>(v[3], s, lo) << 24);
}

// 16-byte global->shared copy; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <int AM, int EM, bool DYN>
__global__ void __launch_bounds__(THREADS, 2)
pair_int8_layer_kernel(const float* __restrict__ a, const float* __restrict__ c,
                       const void* __restrict__ x_in, const int8_t* __restrict__ wt,
                       const float* __restrict__ s_w, const float* __restrict__ bias,
                       const float* __restrict__ row_scale, void* __restrict__ x_out,
                       const __nv_bfloat16* __restrict__ w_out, float* __restrict__ logits,
                       float s_in, float inv_in, float inv_next, int nl, int l0, int L, int M,
                       int K, int N) {
  using Lay = Layout<AM>;
  constexpr int STAGES = Lay::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* row_sum = reinterpret_cast<float*>(smem_raw + Lay::SUM_OFF);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;       // 64-row slab of the block tile
  const int wn = warp & 3;        // 32-column slab of the block tile
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;

  // Layer 1 and the dynamic later layers form the int8 A tile each k-step:
  // thread (f_row, f_slice) quantizes 16 consecutive values of one row,
  // one k-slice: divided by its row's scale (dynamic) or multiplied by the
  // reciprocal of the static one.
  const int f_row = tid >> 1;
  const int f_slice = tid & 1;
  const bool f_ok = r0 + f_row < M;
  float f_q = 1.f;
  if (AM != A_CODES) f_q = DYN ? (f_ok ? row_scale[r0 + f_row] : 1.f) : inv_in;

  // Layer 1: the ring carries the f32 c rows of the block's pairs (four
  // 16-byte chunks a thread per k-step); the thread keeps its a row's 16
  // values in registers one k-step ahead.
  const float* c_src[4];
  bool c_ok[4];
  const float* a_row = a;
  float4 ra[4];
  if (AM == A_FIRST) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + (tid >> 3) + 32 * j;
      c_ok[j] = r < M;
      c_src[j] = c_ok[j] ? c + (size_t)(l0 + r % nl) * K + (tid & 7) * 4 : c;
    }
    if (f_ok) a_row = a + (size_t)((r0 + f_row) / nl) * K + f_slice * KS;
  }
  auto load_a_regs = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ra[i] = f_ok ? *reinterpret_cast<const float4*>(a_row + kt * BK + 4 * i)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto a_stage = [&](int s) { return smem_raw + s * Lay::A_BYTES; };
  auto b_stage = [&](int s) {
    return reinterpret_cast<int8_t*>(smem_raw + Lay::B_OFF + s * TILE_BYTES);
  };
  // cp.async of one k-step's W tile and A-side tile.
  auto issue_stage = [&](int s, int kt) {
    const int k0 = kt * BK;
    if (AM == A_FIRST) {
      float* dst = reinterpret_cast<float*>(a_stage(s));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async16(dst + ((tid >> 3) + 32 * j) * CF_LD + (tid & 7) * 4, c_src[j] + k0, c_ok[j]);
    } else if (AM == A_BF16) {
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(x_in);
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(a_stage(s));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * THREADS;
        const int row = idx >> 2;
        const int col = (idx & 3) * 8;
        const int r = r0 + row;
        const bool ok = r < M;
        cp_async16(dst + row * X_LD + col, src + (size_t)(ok ? r : 0) * K + k0 + col, ok);
      }
    } else {
      const int8_t* src = static_cast<const int8_t*>(x_in);
      const int r = r0 + f_row;
      cp_async16(a_stage(s) + f_slice * BM * KS + f_row * KS,
                 src + (size_t)(f_ok ? r : 0) * K + k0 + f_slice * KS, f_ok);
    }
    // W tile: column n of the block, one k-slice of 16 bytes a thread
    const int n = tid >> 1;
    cp_async16(b_stage(s) + f_slice * BN * KS + n * KS,
               wt + (size_t)(n0 + n) * K + k0 + f_slice * KS, true);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) issue_stage(s, s);
    cp_async_commit();
  }
  if (AM == A_FIRST) load_a_regs(0);

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed and visible; stage kt-1 and the A tile free
    const int nxt = kt + STAGES - 1;
    if (nxt < KT) issue_stage(nxt % STAGES, nxt);
    cp_async_commit();
    const int8_t* ta;
    if (AM != A_CODES) {
      float v[16];
      if (AM == A_FIRST) {
        // x1 = bf16(relu(a + c)), formed in f32
        const float* cs = reinterpret_cast<const float*>(a_stage(cur)) + f_row * CF_LD +
                          f_slice * KS;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(cs + 4 * i);
          v[4 * i] = round_bf16(fmaxf(__fadd_rn(ra[i].x, cv.x), 0.f));
          v[4 * i + 1] = round_bf16(fmaxf(__fadd_rn(ra[i].y, cv.y), 0.f));
          v[4 * i + 2] = round_bf16(fmaxf(__fadd_rn(ra[i].z, cv.z), 0.f));
          v[4 * i + 3] = round_bf16(fmaxf(__fadd_rn(ra[i].w, cv.w), 0.f));
        }
        if (kt + 1 < KT) load_a_regs(kt + 1);
      } else {
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(a_stage(cur)) +
                                  f_row * X_LD + f_slice * KS;
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = __bfloat162float(xs[e]);
      }
      int8_t* tile = reinterpret_cast<int8_t*>(smem_raw + Lay::TILE_OFF);
      *reinterpret_cast<uint4*>(tile + f_slice * BM * KS + f_row * KS) =
          make_uint4(quantize4<DYN>(v, f_q, -127.f), quantize4<DYN>(v + 4, f_q, -127.f),
                     quantize4<DYN>(v + 8, f_q, -127.f), quantize4<DYN>(v + 12, f_q, -127.f));
      __syncthreads();  // the A tile is complete
      ta = tile;
    } else {
      ta = reinterpret_cast<const int8_t*>(a_stage(cur));
    }
    const int8_t* tb = b_stage(cur);
#pragma unroll
    for (int sl = 0; sl < BK / KS; ++sl) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], reinterpret_cast<const signed char*>(
            ta + sl * BM * KS + (wm * 64 + i * 16) * KS), KS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], reinterpret_cast<const signed char*>(
            tb + sl * BN * KS + (wn * 32 + j * 16) * KS), KS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp done with the ring: reuse it as scratch

  // ---- epilogue: dequantize, bias, ReLU, bf16; then codes, bf16 or w_out --
  int* scratch = reinterpret_cast<int*>(smem_raw) + warp * 16 * E_LD;
  if (EM == E_DOT) {
    for (int i = tid; i < BM; i += THREADS) row_sum[i] = 0.f;
    __syncthreads();
  }
  const int er = lane >> 1;         // fragment row handled by this lane
  const int ec = (lane & 1) * 8;    // first of its 8 fragment columns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = wm * 64 + i * 16 + er;
    const int r = r0 + row;
    const bool ok = r < M;
    const float s_row = DYN ? (ok ? row_scale[r] : 0.f) : s_in;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], E_LD, wmma::mem_row_major);
      __syncwarp();
      const int col = n0 + wn * 32 + j * 16 + ec;
      float h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = __int2float_rn(scratch[er * E_LD + ec + e]);
        const float alpha = __fmul_rn(s_row, s_w[col + e]);
        h[e] = round_bf16(fmaxf(__fadd_rn(__fmul_rn(y, alpha), bias[col + e]), 0.f));
      }
      if (EM == E_DOT) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          part = __fadd_rn(part, __fmul_rn(h[e], __bfloat162float(w_out[col + e])));
      } else if (ok) {
        if (EM == E_CODES) {
          *reinterpret_cast<uint2*>(static_cast<int8_t*>(x_out) + (size_t)r * N + col) =
              make_uint2(quantize4<false>(h, inv_next, 0.f), quantize4<false>(h + 4, inv_next, 0.f));
        } else {
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(x_out) + (size_t)r * N + col) =
              make_uint4(pack_bf16x2(h[0], h[1]), pack_bf16x2(h[2], h[3]),
                         pack_bf16x2(h[4], h[5]), pack_bf16x2(h[6], h[7]));
        }
      }
      __syncwarp();
    }
    if (EM == E_DOT) {
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if ((lane & 1) == 0) atomicAdd(&row_sum[row], part);
    }
  }
  if (EM == E_DOT) {
    __syncthreads();
    for (int i = tid; i < BM; i += THREADS) {
      const int r = r0 + i;
      if (r < M) {
        const int b = r / nl;
        const int l = r - b * nl;
        atomicAdd(&logits[(size_t)b * L + l0 + l], row_sum[i]);
      }
    }
  }
}

// One warp per pair row: the row's dynamic scale.
__global__ void __launch_bounds__(256)
pair_int8_row_scale_kernel(const float* __restrict__ a, const float* __restrict__ c,
                           const __nv_bfloat16* __restrict__ x_in, float* __restrict__ row_scale,
                           int nl, int l0, int M, int K, int stride, float margin, int first) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= M) return;
  float m = 0.f;
  if (first) {
    const float* ar = a + (size_t)(r / nl) * K;
    const float* cr = c + (size_t)(l0 + r % nl) * K;
    for (int j = lane * stride; j < K; j += 32 * stride)
      m = fmaxf(m, round_bf16(fmaxf(__fadd_rn(ar[j], cr[j]), 0.f)));
  } else {
    const __nv_bfloat16* xr = x_in + (size_t)r * K;
    for (int j = lane * stride; j < K; j += 32 * stride)
      m = fmaxf(m, fabsf(__bfloat162float(xr[j])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) row_scale[r] = __fmul_rn(fmaxf(__fmul_rn(m, margin), 1e-12f), __frcp_rn(127.f));
}

template <int AM, int EM, bool DYN>
cudaError_t launch(dim3 grid, cudaStream_t s, const float* a, const float* c, const void* x_in,
                   const int8_t* wt, const float* s_w, const float* bias,
                   const float* row_scale, void* x_out, const __nv_bfloat16* w_out,
                   float* logits, float s_in, float inv_in, float inv_next, int nl, int l0,
                   int L, int M, int K, int N) {
  constexpr int bytes = Layout<AM>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(pair_int8_layer_kernel<AM, EM, DYN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  pair_int8_layer_kernel<AM, EM, DYN><<<grid, THREADS, bytes, s>>>(
      a, c, x_in, wt, s_w, bias, row_scale, x_out, w_out, logits, s_in, inv_in, inv_next, nl,
      l0, L, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// mode = a | (e << 2) | (dynamic << 4): a is where the A operand comes from
// (0: formed from a and c, the first hidden layer; 1: int8 codes in x_in;
// 2: bf16 activations in x_in, quantized with row_scale), e where the
// epilogue goes (0: int8 codes into x_out, quantized with inv_next = 1 /
// s_{i+1}; 1: bf16 into x_out; 2: the dot with w_out into the logits, the
// last layer), and dynamic whether the scales are per row (row_scale) or
// s_in (layer 1 quantizing with inv_in = 1 / s_in).  Static runs
// a in {0, 1} with e in {0, 2}; dynamic a in {0, 2} with e in {1, 2}.
// Returns the CUDA error of the attribute call or the launch (0 on success).
extern "C" int pair_int8_layer(const void* a, const void* c, const void* x_in, const void* wt,
                               const void* s_w, const void* bias, const void* row_scale,
                               void* x_out, const void* w_out, void* logits, float s_in,
                               float inv_in, float inv_next, int nl, int l0, int L, int M,
                               int K, int N, int mode, void* stream) {
  if (M <= 0 || nl <= 0 || K % BK != 0 || N % BN != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a_ = static_cast<const float*>(a);
  const float* c_ = static_cast<const float*>(c);
  const int8_t* wt_ = static_cast<const int8_t*>(wt);
  const float* sw_ = static_cast<const float*>(s_w);
  const float* bias_ = static_cast<const float*>(bias);
  const float* rs_ = static_cast<const float*>(row_scale);
  const __nv_bfloat16* wo_ = static_cast<const __nv_bfloat16*>(w_out);
  float* lg_ = static_cast<float*>(logits);
#define PAIR_INT8_CASE(AM, EM, DYN)                                                        \
  case (AM) | ((EM) << 2) | ((DYN) << 4):                                                  \
    return (int)launch<AM, EM, DYN>(grid, s, a_, c_, x_in, wt_, sw_, bias_, rs_, x_out,   \
                                    wo_, lg_, s_in, inv_in, inv_next, nl, l0, L, M, K, N);
  switch (mode) {
    PAIR_INT8_CASE(A_FIRST, E_CODES, false)
    PAIR_INT8_CASE(A_FIRST, E_DOT, false)
    PAIR_INT8_CASE(A_CODES, E_CODES, false)
    PAIR_INT8_CASE(A_CODES, E_DOT, false)
    PAIR_INT8_CASE(A_FIRST, E_BF16, true)
    PAIR_INT8_CASE(A_FIRST, E_DOT, true)
    PAIR_INT8_CASE(A_BF16, E_BF16, true)
    PAIR_INT8_CASE(A_BF16, E_DOT, true)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAIR_INT8_CASE
}

// Per pair row r of the chunk: row_scale[r] = max(max_j |x[r, j]| * margin,
// 1e-12) * float32(1 / 127) over j = 0, stride, 2 * stride, ... < K, where x is
// bf16(relu(a[b] + c[l0 + l])) when first, else the bf16 rows of x_in.
extern "C" int pair_int8_row_scale(const void* a, const void* c, const void* x_in,
                                   void* row_scale, int nl, int l0, int M, int K, int stride,
                                   float margin, int first, void* stream) {
  if (M <= 0 || nl <= 0 || K <= 0 || stride <= 0) return (int)cudaErrorInvalidValue;
  const int rows_per_block = 256 / 32;
  pair_int8_row_scale_kernel<<<(M + rows_per_block - 1) / rows_per_block, 256, 0,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(c),
      static_cast<const __nv_bfloat16*>(x_in), static_cast<float*>(row_scale), nl, l0, M, K,
      stride, margin, first);
  return (int)cudaGetLastError();
}
