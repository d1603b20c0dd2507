// Training pair-MLP forward for Hopper (sm_90a): the first hidden GEMM of the
// decomposed training scorer, with its A operand formed on the fly.
//
// Replaces the TPU op chain protnote_tpu/ops/streaming_train.py:
// pair_logits_dense_decomposed (layer 1 decomposed per side, layer 2's
// GEMM).  For a chunk of labels [l0, l0 + nl) and all B sequences, rows
// r = b * nl + l of the chunk are (sequence, label) pairs, and
//
//   x1[r] = bf16(relu(f32(a2[b]) + f32(c2[l0 + l])))         (bf16 inputs)
//   z[b * L + l0 + l] = bf16(x1[r] @ W)                        (f32 accumulate)
//
// a2 = bf16(a * inv1) and c2 = bf16(c * inv1 + shift1) carry the analytic
// layer-1 BatchNorm already; their sum is rounded to bf16 once, as the JAX
// path adds two bf16 arrays.  There is no bias (BatchNorm follows) and no
// ReLU: the epilogue stores the raw pre-activation z, whose masked moments
// the BN+ReLU kernels (csrc/bn_relu.cu) then reduce.  x1 never reaches device
// memory: it is formed in shared memory, one k-step at a time.
//
// What bounds it: the H x H GEMM, 2 * H^2 FLOP per pair row.  At the default
// width (H = 3072) and a 32-sequence batch against 32,102 labels that is
// 19.4 TFLOP, at least 20 ms at the 989 TFLOP/s dense bf16 peak; W (18 MB
// bf16) stays in the 50 MB L2, and a2/c2 (0.2 MB and 197 MB) are read once
// per output-column tile.  This first design is the tile GEMM of the
// inference scorer (csrc/pair_scorer.cu, its first-layer variant): 128 x 128
// x 32 block tiles, 8 warps of WMMA (mma.sync) bf16 products with f32
// accumulators, two blocks per SM, a 4-stage cp.async ring that carries the
// bf16 c2 tile and the W tile, the a2 row in registers one k-step ahead, and
// a second barrier per k-step behind the formed A tile.  wgmma, TMA and a
// persistent schedule are the steps toward the bound.

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
constexpr int STAGES = 4;
constexpr int A_LD = BK + 8;      // padded shared-memory row strides (bf16)
constexpr int B_LD = BN + 8;
constexpr int E_LD = 16 + 4;      // per-warp f32 epilogue scratch stride

// Shared memory: a ring of STAGES stages (the bf16 c2 tile and the bf16 W
// tile of one k-step), then the formed bf16 A tile.
constexpr int A_BYTES = BM * A_LD * 2;
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int B_OFF = STAGES * A_BYTES;
constexpr int TILE_OFF = B_OFF + STAGES * B_BYTES;
constexpr int SMEM_BYTES = TILE_OFF + BM * A_LD * 2;
static_assert(8 * 16 * E_LD * 4 <= B_OFF, "epilogue scratch must fit in the ring");
static_assert(2 * (SMEM_BYTES + 1024) <= 232448, "two blocks must fit an SM");

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(relu(f32(a) + f32(c))) for two packed bf16 pairs.
__device__ __forceinline__ uint32_t relu_sum_bf16x2(uint32_t a, uint32_t c) {
  const __nv_bfloat162 av = *reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162 cv = *reinterpret_cast<__nv_bfloat162*>(&c);
  const float lo = __bfloat162float(av.x) + __bfloat162float(cv.x);
  const float hi = __bfloat162float(av.y) + __bfloat162float(cv.y);
  return pack_bf16x2(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
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

__global__ void __launch_bounds__(THREADS, 2)
pair_train_hidden_kernel(const __nv_bfloat16* __restrict__ a2,
                         const __nv_bfloat16* __restrict__ c2,
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ z,
                         int nl, int l0, int L, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;       // 64-row slab of the block tile
  const int wn = warp & 3;        // 32-column slab of the block tile
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;

  // The ring carries the c2 rows of the block's pairs (two 16-byte chunks a
  // thread per k-step); each thread then forms 16 consecutive x1 values of
  // one row from them and from its a2 row, which it keeps in registers one
  // k-step ahead.
  const __nv_bfloat16* c_src[2];
  bool c_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = tid + j * THREADS;
    const int r = r0 + (idx >> 2);
    c_ok[j] = r < M;
    c_src[j] = c2 + (size_t)(c_ok[j] ? l0 + r % nl : 0) * K + (idx & 3) * 8;
  }
  const int pa_row = tid >> 1;
  const int pa_col = (tid & 1) * 16;
  const bool a_ok = r0 + pa_row < M;
  const __nv_bfloat16* a_row = a2 + (size_t)(a_ok ? (r0 + pa_row) / nl : 0) * K + pa_col;
  uint4 ra[2];
  auto load_a_regs = [&](int kt) {
    const uint4* src = reinterpret_cast<const uint4*>(a_row + kt * BK);
    ra[0] = a_ok ? src[0] : make_uint4(0, 0, 0, 0);
    ra[1] = a_ok ? src[1] : make_uint4(0, 0, 0, 0);
  };
  auto a_stage = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * A_BYTES);
  };
  auto b_stage = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + B_OFF + s * B_BYTES);
  };
  // cp.async of one k-step's c2 tile and W tile.
  auto issue_stage = [&](int s, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* da = a_stage(s);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * THREADS;
      cp_async16(da + (idx >> 2) * A_LD + (idx & 3) * 8, c_src[j] + k0, c_ok[j]);
    }
    __nv_bfloat16* db = b_stage(s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 4;
      const int col = (idx & 15) * 8;
      cp_async16(db + row * B_LD + col, w + (size_t)(k0 + row) * N + n0 + col, true);
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
  load_a_regs(0);

  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_raw + TILE_OFF);
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed and visible; stage kt-1 and the A tile free
    const int nxt = kt + STAGES - 1;
    if (nxt < KT) issue_stage(nxt % STAGES, nxt);
    cp_async_commit();
    // x1 = bf16(relu(a2 + c2)) into the block's bf16 A tile
    const uint4* cs = reinterpret_cast<const uint4*>(a_stage(cur) + pa_row * A_LD + pa_col);
    uint4* dst = reinterpret_cast<uint4*>(tile + pa_row * A_LD + pa_col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 cv = cs[h];
      dst[h] = make_uint4(relu_sum_bf16x2(ra[h].x, cv.x), relu_sum_bf16x2(ra[h].y, cv.y),
                          relu_sum_bf16x2(ra[h].z, cv.z), relu_sum_bf16x2(ra[h].w, cv.w));
    }
    if (kt + 1 < KT) load_a_regs(kt + 1);
    __syncthreads();  // the A tile is complete
    const __nv_bfloat16* tb = b_stage(cur);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], tile + (wm * 64 + i * 16) * A_LD + kk, A_LD);
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

  // ---- epilogue: round to bf16 and store z at its global pair row --------
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 16 * E_LD;
  const int er = lane >> 1;         // fragment row handled by this lane
  const int ec = (lane & 1) * 8;    // first of its 8 fragment columns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + wm * 64 + i * 16 + er;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], E_LD, wmma::mem_row_major);
      __syncwarp();
      if (r < M) {
        const float* v = scratch + er * E_LD + ec;
        const int b = r / nl;
        const size_t row = (size_t)b * L + l0 + (r - b * nl);
        *reinterpret_cast<uint4*>(z + row * N + n0 + wn * 32 + j * 16 + ec) =
            make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                       pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
      }
      __syncwarp();
    }
  }
}

}  // namespace

// One launch: z rows of the labels [l0, l0 + nl) for all B = M / nl
// sequences.  a2 (B, K), c2 (L, K), w (K, N), z (B * L, N), all bf16 and
// row-major.  Returns the CUDA error of the attribute call or the launch
// (0 on success).
extern "C" int pair_train_hidden(const void* a2, const void* c2, const void* w, void* z,
                                 int nl, int l0, int L, int M, int K, int N,
                                 void* stream) {
  if (M <= 0 || nl <= 0 || M % nl != 0 || l0 < 0 || l0 + nl > L || K % BK != 0 ||
      N % BN != 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pair_train_hidden_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  pair_train_hidden_kernel<<<grid, THREADS, SMEM_BYTES, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a2), static_cast<const __nv_bfloat16*>(c2),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(z),
      nl, l0, L, M, K, N);
  return (int)cudaGetLastError();
}
