// Folded pair-MLP scorer for Hopper (sm_90a): one hidden layer of the
// (sequence x label) output MLP per launch.
//
// Replaces the TPU op chain protnote_tpu/ops/pair_scorer.py:_tiled_scaffold +
// pair_logits_tiled (and its removed Pallas form pair_logits_pallas).  For a
// chunk of labels [l0, l0 + nl) and all B sequences, rows r = b * nl + l are
// (sequence, label) pairs, and the chain is
//
//   x1[r]      = bf16(relu(a[b] + c[l0 + l]))                 (f32 add)
//   x_{i+1}[r] = bf16(relu(x_i[r] @ W_i + bias_i))            (f32 accumulate)
//   logit[b, l0 + l] += sum_n x_last[r, n] * w_out[n]          (f32)
//
// with the logits pre-filled with b_out by the caller.  One launch computes
// one GEMM of that chain; a template flag picks where its A operand comes from
// (formed on the fly from a and c, or read from a bf16 workspace) and where
// its epilogue goes (a bf16 store of the next activations, or the dot with
// w_out reduced over the block's columns and added to the logits with
// atomics).  x1 and the last layer's activations never reach device memory.
//
// What bounds it: the hidden H x H GEMMs.  At the default width (H = 3072,
// two hidden layers) they cost 2 * 2 * 3072^2 = 37.7 MFLOP per pair, about
// 77.5 TFLOP for a 32-sequence batch against 64,204 label rows, so at least
// 78 ms per batch even at the 989 TFLOP/s dense bf16 peak.  The kernel is
// compute-bound: weights (18 MB bf16 per layer) stay in the 50 MB L2, and
// each 128 x 128 output tile reads its A and W tiles once per k-step.
// This first design is plain: 128 x 128 x 32 block tiles, 8 warps of WMMA
// (mma.sync) bf16 products with f32 accumulators, two blocks per SM, and a
// ring of shared-memory stages filled by cp.async, so several k-steps of
// loads are in flight while the tensor cores work on the current one.  Later
// layers copy their bf16 A tile (x_in) through the ring (4 stages).  The
// first layer cannot copy its A tile, which is computed: the ring carries the
// f32 c rows instead (3 stages, so two blocks still fit an SM), the a row
// waits in registers one k-step ahead, and each k-step forms the bf16 A tile
// in shared memory behind a second barrier.  wgmma, TMA and a persistent
// schedule are the next steps toward the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;           // pair rows per block
constexpr int BN = 128;           // output columns per block
constexpr int BK = 32;            // reduction depth per k-step
constexpr int THREADS = 256;      // 8 warps: 2 (rows) x 4 (columns)
constexpr int A_LD = BK + 8;      // padded shared-memory row strides (bf16)
constexpr int B_LD = BN + 8;
constexpr int CF_LD = BK + 4;     // padded row stride of the f32 c tile
constexpr int E_LD = 16 + 4;      // per-warp f32 epilogue scratch stride

// Shared-memory layout of one variant: a ring of STAGES stages, each an
// A-side tile (the bf16 x_in tile, or for the first layer the f32 c tile)
// and a bf16 W tile; the first layer's bf16 A tile; the per-row logit sums.
template <bool PAIR_A>
struct Layout {
  static constexpr int STAGES = PAIR_A ? 3 : 4;  // two blocks must fit an SM
  static constexpr int A_BYTES = PAIR_A ? BM * CF_LD * 4 : BM * A_LD * 2;
  static constexpr int B_BYTES = BK * B_LD * 2;
  static constexpr int B_OFF = STAGES * A_BYTES;
  static constexpr int TILE_OFF = B_OFF + STAGES * B_BYTES;
  static constexpr int SUM_OFF = TILE_OFF + (PAIR_A ? BM * A_LD * 2 : 0);
  static constexpr int BYTES = SUM_OFF + BM * 4;
  static_assert(8 * 16 * E_LD * 4 <= B_OFF, "epilogue scratch must fit in the ring");
  static_assert(2 * (BYTES + 1024) <= 232448, "two blocks must fit an SM");
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Two blocks per SM: this caps a thread at 128 registers (a few dozen bytes
// spill in some variants), and the chain runs faster than at one (PERF.md).
template <bool PAIR_A, bool DOT_OUT>
__global__ void __launch_bounds__(THREADS, 2)
pair_mlp_layer_kernel(const float* __restrict__ a, const float* __restrict__ c,
                      const __nv_bfloat16* __restrict__ x_in,
                      const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ x_out,
                      const __nv_bfloat16* __restrict__ w_out, float* __restrict__ logits,
                      int nl, int l0, int L, int M, int K, int N) {
  using Lay = Layout<PAIR_A>;
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

  // First layer: the ring carries the f32 c rows of the block's pairs (four
  // 16-byte chunks a thread per k-step); each thread then forms 16
  // consecutive x1 values of one row from them and from its a row, which it
  // keeps in registers one k-step ahead.
  const float* c_src[4];
  bool c_ok[4];
  const int pa_row = tid >> 1;
  const int pa_col = (tid & 1) * 16;
  const float* a_row = a;
  bool a_ok = false;
  float4 ra[4];
  if (PAIR_A) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + (tid >> 3) + 32 * j;
      c_ok[j] = r < M;
      c_src[j] = c_ok[j] ? c + (size_t)(l0 + r % nl) * K + (tid & 7) * 4 : c;
    }
    const int r = r0 + pa_row;
    a_ok = r < M;
    if (a_ok) a_row = a + (size_t)(r / nl) * K + pa_col;
  }
  auto load_a_regs = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ra[i] = a_ok ? *reinterpret_cast<const float4*>(a_row + kt * BK + 4 * i)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto a_stage = [&](int s) { return smem_raw + s * Lay::A_BYTES; };
  auto b_stage = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + Lay::B_OFF + s * Lay::B_BYTES);
  };
  // cp.async of one k-step's W tile and A-side tile.
  auto issue_stage = [&](int s, int kt) {
    const int k0 = kt * BK;
    if (PAIR_A) {
      float* dst = reinterpret_cast<float*>(a_stage(s));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async16(dst + ((tid >> 3) + 32 * j) * CF_LD + (tid & 7) * 4, c_src[j] + k0, c_ok[j]);
    } else {
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(a_stage(s));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * THREADS;
        const int row = idx >> 2;
        const int col = (idx & 3) * 8;
        const int r = r0 + row;
        const bool ok = r < M;
        cp_async16(dst + row * A_LD + col, x_in + (size_t)(ok ? r : 0) * K + k0 + col, ok);
      }
    }
    __nv_bfloat16* dst = b_stage(s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 4;
      const int col = (idx & 15) * 8;
      cp_async16(dst + row * B_LD + col, w + (size_t)(k0 + row) * N + n0 + col, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) issue_stage(s, s);
    cp_async_commit();
  }
  if (PAIR_A) load_a_regs(0);

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed and visible; stage kt-1 and the A tile free
    const int nxt = kt + STAGES - 1;
    if (nxt < KT) issue_stage(nxt % STAGES, nxt);
    cp_async_commit();
    const __nv_bfloat16* ta;
    if (PAIR_A) {
      // x1 = bf16(relu(a + c)), formed in f32, into the block's bf16 A tile
      __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_raw + Lay::TILE_OFF);
      const float* cs = reinterpret_cast<const float*>(a_stage(cur)) + pa_row * CF_LD + pa_col;
      uint32_t p[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 cv = *reinterpret_cast<const float4*>(cs + 4 * i);
        p[2 * i] = pack_bf16x2(fmaxf(ra[i].x + cv.x, 0.f), fmaxf(ra[i].y + cv.y, 0.f));
        p[2 * i + 1] = pack_bf16x2(fmaxf(ra[i].z + cv.z, 0.f), fmaxf(ra[i].w + cv.w, 0.f));
      }
      uint4* dst = reinterpret_cast<uint4*>(tile + pa_row * A_LD + pa_col);
      dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
      dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
      if (kt + 1 < KT) load_a_regs(kt + 1);
      __syncthreads();  // the A tile is complete
      ta = tile;
    } else {
      ta = reinterpret_cast<const __nv_bfloat16*>(a_stage(cur));
    }
    const __nv_bfloat16* tb = b_stage(cur);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], ta + (wm * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], tb + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp done with the ring: reuse it as scratch

  // ---- epilogue: bias + ReLU + bf16 round, then store or dot with w_out --
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 16 * E_LD;
  if (DOT_OUT) {
    for (int i = tid; i < BM; i += THREADS) row_sum[i] = 0.f;
    __syncthreads();
  }
  const int er = lane >> 1;         // fragment row handled by this lane
  const int ec = (lane & 1) * 8;    // first of its 8 fragment columns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = wm * 64 + i * 16 + er;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], E_LD, wmma::mem_row_major);
      __syncwarp();
      const int col = n0 + wn * 32 + j * 16 + ec;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = fmaxf(scratch[er * E_LD + ec + e] + bias[col + e], 0.f);
      if (DOT_OUT) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          part += __bfloat162float(__float2bfloat16_rn(v[e])) * __bfloat162float(w_out[col + e]);
      } else {
        const int r = r0 + row;
        if (r < M) {
          *reinterpret_cast<uint4*>(x_out + (size_t)r * N + col) =
              make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                         pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
        }
      }
      __syncwarp();
    }
    if (DOT_OUT) {
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if ((lane & 1) == 0) atomicAdd(&row_sum[row], part);
    }
  }
  if (DOT_OUT) {
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

template <bool PAIR_A, bool DOT_OUT>
cudaError_t launch(dim3 grid, cudaStream_t s, const float* a, const float* c,
                   const __nv_bfloat16* x_in, const __nv_bfloat16* w, const float* bias,
                   __nv_bfloat16* x_out, const __nv_bfloat16* w_out, float* logits,
                   int nl, int l0, int L, int M, int K, int N) {
  constexpr int bytes = Layout<PAIR_A>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(pair_mlp_layer_kernel<PAIR_A, DOT_OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  pair_mlp_layer_kernel<PAIR_A, DOT_OUT><<<grid, THREADS, bytes, s>>>(
      a, c, x_in, w, bias, x_out, w_out, logits, nl, l0, L, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// mode bit 0: A is formed from a and c (first hidden layer); otherwise it is
// read from x_in.  mode bit 1: the epilogue takes the dot with w_out into the
// logits (last hidden layer); otherwise it stores bf16 activations to x_out.
// Returns the CUDA error of the attribute call or the launch (0 on success).
extern "C" int pair_mlp_layer(const void* a, const void* c, const void* x_in,
                              const void* w, const void* bias, void* x_out,
                              const void* w_out, void* logits, int nl, int l0,
                              int L, int M, int K, int N, int mode,
                              void* stream) {
  if (M <= 0 || nl <= 0 || K % BK != 0 || N % BN != 0 || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a_ = static_cast<const float*>(a);
  const float* c_ = static_cast<const float*>(c);
  const __nv_bfloat16* x_in_ = static_cast<const __nv_bfloat16*>(x_in);
  const __nv_bfloat16* w_ = static_cast<const __nv_bfloat16*>(w);
  const float* bias_ = static_cast<const float*>(bias);
  __nv_bfloat16* x_out_ = static_cast<__nv_bfloat16*>(x_out);
  const __nv_bfloat16* w_out_ = static_cast<const __nv_bfloat16*>(w_out);
  float* logits_ = static_cast<float*>(logits);
  cudaError_t err;
  switch (mode) {
    case 0:
      err = launch<false, false>(grid, s, a_, c_, x_in_, w_, bias_, x_out_, w_out_, logits_, nl, l0, L, M, K, N);
      break;
    case 1:
      err = launch<true, false>(grid, s, a_, c_, x_in_, w_, bias_, x_out_, w_out_, logits_, nl, l0, L, M, K, N);
      break;
    case 2:
      err = launch<false, true>(grid, s, a_, c_, x_in_, w_, bias_, x_out_, w_out_, logits_, nl, l0, L, M, K, N);
      break;
    default:
      err = launch<true, true>(grid, s, a_, c_, x_in_, w_, bias_, x_out_, w_out_, logits_, nl, l0, L, M, K, N);
      break;
  }
  return (int)err;
}
