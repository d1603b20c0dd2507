// Masked softmax attention of the label text tower (K8a) for Hopper (sm_90a).
//
// Replaces the core of protnote_tpu/models/text_transformer.py:_attention
// (lines 182-190), the XLA chain
//
//   scores = einsum(q, k, f32) / sqrt(hd) + bias          (f32)
//   probs  = bf16(softmax(scores))                         (f32 softmax)
//   ctx    = bf16(einsum(probs, v, f32))                   (f32 sums)
//
// with q, k, v (B, nh, T, hd) bf16 and the additive bias -1e9 on keys whose
// key_mask is 0 (bert), or on those and on future keys (gpt, causal).  The
// division by the constant sqrt(hd) is a multiply by its float32
// reciprocal, which is what jitted XLA compiles it into; the caller passes
// that reciprocal as `scale`.
//
// Design: one block per (batch row, head, 64-query tile), four warps of 16
// query rows each.  Every caller truncates label text at 510 tokens, so T is
// at most 512 and a block keeps its 64 whole score rows in shared memory
// (64 x 512 f32 = 128 KB at the longest).  That lets the kernel round
// where JAX rounds: the normalised probabilities are rounded to bf16 before
// P.V, as at text_transformer.py:186 (an online softmax would round
// elsewhere).  Steps:
//   1. S = Q.K^T with WMMA bf16 16x16x16 tiles and f32 accumulators, K
//      streamed in 64-key tiles through a two-slot cp.async ring;
//   2. s = s * scale + bias, each step rounded on its own (no FMA), the
//      bias added to every key: a row whose keys are all masked gets the
//      uniform softmax JAX gives it, not 0/0;
//   3. row max, expf (not __expf), row sum and a true division in f32; the
//      bf16 probabilities overwrite their own f32 scores in place;
//   4. ctx = P.V with V streamed through the same ring, f32 accumulators,
//      rounded to bf16 on the way out.
// Keys past T are left out of the softmax (zero-filled tiles, zero
// probabilities); query rows past T are computed and not stored.
//
// What bounds it: bytes.  It must read q, k and v and write ctx, 4*B*T*H*2
// bytes: at B 128, T 128, H 1024 that is 134 MB, 0.040 ms at 3.35 TB/s; its
// 8.6 GFLOP take 0.009 ms at the bf16 peak.  This first design is simple:
// WMMA (mma.sync) rather than wgmma, a small ring rather than TMA, and K and
// V read once per query tile (twice at T 128).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // query rows per block, and keys per ring tile
constexpr int THREADS = 128;    // four warps, 16 query rows each
constexpr int MAX_T = 512;
constexpr float MASKED = -1e9f;  // the JAX package's additive mask value

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory: the Q tile and a two-slot K/V ring (bf16, rows padded to
// HD + 8), then 64 score rows of s_ld floats (the bf16 probabilities of a
// row overwrite the front of the row; the output tile reuses it at the end).
template <int HD>
struct Tile {
  static constexpr int BYTES = BQ * (HD + 8) * 2;
};

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
masked_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ key_mask,
                        __nv_bfloat16* __restrict__ ctx, int nh, int T, int T_pad, int s_ld,
                        float scale) {
  constexpr int LD = HD + 8;
  constexpr int ROW_CHUNKS = HD / 8;  // 16-byte chunks of one bf16 row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = qs + BQ * LD;
  float* S = reinterpret_cast<float*>(smem + 3 * Tile<HD>::BYTES);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / nh;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * T * HD;
  const int nkt = T_pad / BQ;
  const int* mask_row = key_mask + (size_t)b * T;
  float* srows = S + warp * 16 * s_ld;

  // a 64-row tile of q, k or v starting at row r0; rows past T read as zeros
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int r0) {
    for (int c = tid; c < BQ * ROW_CHUNKS; c += THREADS) {
      const int row = c / ROW_CHUNKS;
      const int col = (c % ROW_CHUNKS) * 8;
      const int r = r0 + row;
      const bool ok = r < T;
      cp_async16(dst + row * LD + col, src + base + (size_t)(ok ? r : 0) * HD + col, ok);
    }
  };
  load_tile(qs, q, q0);
  load_tile(ring, k, 0);
  cp_async_commit();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(o[n], 0.f);

  // ring tiles 0 .. nkt-1 are K, nkt .. 2 nkt-1 are V
  for (int t = 0; t < 2 * nkt; ++t) {
    const int nxt = t + 1;
    if (nxt < 2 * nkt)
      load_tile(ring + (nxt & 1) * BQ * LD, nxt < nkt ? k : v, (nxt < nkt ? nxt : nxt - nkt) * BQ);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t (and the Q tile) landed
    const __nv_bfloat16* tile = ring + (t & 1) * BQ * LD;
    if (t < nkt) {
      // 1. this warp's 16 query rows against 64 keys
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, qs + warp * 16 * LD + kk, LD);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, tile + n * 16 * LD + kk, LD);
          wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(srows + t * BQ + n * 16, acc[n], s_ld, wmma::mem_row_major);
      if (t == nkt - 1) {
        __syncwarp();
        // 2.-3. the softmax of this warp's rows; V tile 0 is in flight
        for (int rr = 0; rr < 16; ++rr) {
          float* srow = srows + rr * s_ld;
          const int i = q0 + warp * 16 + rr;
          float m = -INFINITY;
          for (int j = lane; j < T; j += 32) {
            const bool keep = __ldg(mask_row + j) > 0 && (!CAUSAL || j <= i);
            const float s = __fadd_rn(__fmul_rn(srow[j], scale), keep ? 0.f : MASKED);
            srow[j] = s;
            m = fmaxf(m, s);
          }
          m = warp_max(m);
          float sum = 0.f;
          for (int j = lane; j < T; j += 32) {
            const float e = expf(__fsub_rn(srow[j], m));
            srow[j] = e;
            sum = __fadd_rn(sum, e);
          }
          sum = warp_sum(sum);
          // bf16 probability j lands on bytes [2j, 2j + 2) of the row, which
          // hold f32 scores this loop has read already (j0 = 0: in this step)
          __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(srow);
          for (int j0 = 0; j0 < T_pad; j0 += 32) {
            const int j = j0 + lane;
            const float e = j < T ? srow[j] : 0.f;
            __syncwarp();
            prow[j] = __float2bfloat16_rn(__fdiv_rn(e, sum));
            __syncwarp();
          }
        }
      }
    } else {
      // 4. P (16 rows x 64 keys of this tile) . V tile
      const __nv_bfloat16* prow = reinterpret_cast<const __nv_bfloat16*>(srows) + (t - nkt) * BQ;
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp;
        wmma::load_matrix_sync(fp, prow + kk, 2 * s_ld);
#pragma unroll
        for (int n = 0; n < HD / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
          wmma::load_matrix_sync(fv, tile + kk * LD + n * 16, LD);
          wmma::mma_sync(o[n], fp, fv, o[n]);
        }
      }
    }
    __syncthreads();  // ring slot t & 1 is refilled in the next step
  }

  // the output tile through this warp's own score rows, rounded to bf16
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(srows + n * 16, o[n], s_ld, wmma::mem_row_major);
  __syncwarp();
  for (int c = lane; c < 16 * ROW_CHUNKS; c += 32) {
    const int row = c / ROW_CHUNKS;
    const int col = (c % ROW_CHUNKS) * 8;
    const int i = q0 + warp * 16 + row;
    if (i < T) {
      const float* src = srows + row * s_ld + col;
      *reinterpret_cast<uint4*>(ctx + base + (size_t)i * HD + col) =
          make_uint4(pack_bf16x2(src[0], src[1]), pack_bf16x2(src[2], src[3]),
                     pack_bf16x2(src[4], src[5]), pack_bf16x2(src[6], src[7]));
    }
  }
}

template <int HD, bool CAUSAL>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const int* key_mask, __nv_bfloat16* ctx, int B, int nh, int T, float scale,
                   cudaStream_t s) {
  const int T_pad = (T + BQ - 1) / BQ * BQ;
  const int s_ld = (T_pad > HD ? T_pad : HD) + 4;
  const int bytes = 3 * Tile<HD>::BYTES + BQ * s_ld * 4;
  cudaError_t err = cudaFuncSetAttribute(masked_attention_kernel<HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  masked_attention_kernel<HD, CAUSAL><<<dim3(T_pad / BQ, B * nh), THREADS, bytes, s>>>(
      q, k, v, key_mask, ctx, nh, T, T_pad, s_ld, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                      const int* key_mask, __nv_bfloat16* ctx, int B, int nh, int T,
                      int causal, float scale, cudaStream_t s) {
  return causal ? launch<HD, true>(q, k, v, key_mask, ctx, B, nh, T, scale, s)
                : launch<HD, false>(q, k, v, key_mask, ctx, B, nh, T, scale, s);
}

}  // namespace

// q, k, v, ctx: (B, nh, T, hd) bf16, contiguous, 16-byte aligned; key_mask:
// (B, T) int32, nonzero = a real token.  hd is 64; 1 <= T <= 512.
// scale: float32(1 / sqrt(hd)).  Returns the CUDA error of the attribute
// call or the launch (0 on success).
extern "C" int masked_attention(const void* q, const void* k, const void* v,
                                const void* key_mask, void* ctx, int B, int nh, int T, int hd,
                                int causal, float scale, void* stream) {
  if (B < 1 || nh < 1 || T < 1 || T > MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* q_ = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* k_ = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* v_ = static_cast<const __nv_bfloat16*>(v);
  const int* m_ = static_cast<const int*>(key_mask);
  __nv_bfloat16* c_ = static_cast<__nv_bfloat16*>(ctx);
  // every tower the port loads (E5/XLM-R large and base, BERT, BioGPT) has
  // 64-wide heads
  if (hd != 64) return (int)cudaErrorInvalidValue;
  return (int)launch_hd<64>(q_, k_, v_, m_, c_, B, nh, T, causal, scale, s);
}
