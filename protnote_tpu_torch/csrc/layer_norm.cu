// Residual add + LayerNorm of the label text tower (K8b) for Hopper (sm_90a).
//
// Replaces protnote_tpu/models/text_transformer.py:_layer_norm (line 159)
// with the residual add in front of it (x + a at lines 245 and 255, the
// post-LN layers of bert), and the plain LayerNorm of the embeddings (226),
// of the pre-LN branches (258, 260) and the final LN (271), where there is no
// residual.  Per row of H bf16 values:
//
//   v    = f32(bf16(x + r))          (the add rounded to bf16, as JAX adds)
//   mu   = sum(v) / H
//   var  = sum((v - mu)^2) / H       (two passes, not E[v^2] - mu^2)
//   y    = bf16(((v - mu) * rsqrt(var + eps)) * scale + bias)
//
// every product and sum rounded on its own (no FMA), as the plain PyTorch
// version computes it.
//
// What bounds it: bytes.  One warp per row: each lane loads 16 bytes (8
// bf16) at a time and keeps its H / 32 values in registers, so x and r are
// read once and y written once, 3 * N * H * 2 bytes with a residual: at
// 16,384 rows of 1024 that is 101 MB, 0.030 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // rows per block
constexpr int MAX_CHUNKS = 8;  // 16-byte chunks a lane: H up to 2048

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// CH 16-byte chunks a lane: H = 256 * CH; lane l holds columns
// (c * 32 + l) * 8 .. + 7 of chunk c, so a warp's loads are contiguous
template <int CH, bool RESIDUAL>
__global__ void __launch_bounds__(WARPS * 32)
add_layer_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ r,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y, long long N, float eps) {
  constexpr int H = 256 * CH;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  const size_t off = (size_t)row * H;
  float v[CH][8];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * 32 + lane) * 8;
    unpack8(*reinterpret_cast<const uint4*>(x + off + col), v[c]);
    if (RESIDUAL) {
      float a[8];
      unpack8(*reinterpret_cast<const uint4*>(r + off + col), a);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[c][e] = __bfloat162float(__float2bfloat16_rn(__fadd_rn(v[c][e], a[e])));
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = __fadd_rn(sum, v[c][e]);
  }
  const float mu = __fdiv_rn(warp_sum(sum), (float)H);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = __fsub_rn(v[c][e], mu);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)H), eps));
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * 32 + lane) * 8;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[c][e], mu), rs), scale[col + e]),
                       bias[col + e]);
    *reinterpret_cast<uint4*>(y + off + col) =
        make_uint4(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]),
                   pack_bf16x2(o[4], o[5]), pack_bf16x2(o[6], o[7]));
  }
}

template <int CH>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* r, const float* scale,
                   const float* bias, __nv_bfloat16* y, long long N, float eps, cudaStream_t s) {
  const unsigned blocks = (unsigned)((N + WARPS - 1) / WARPS);
  if (r != nullptr)
    add_layer_norm_kernel<CH, true><<<blocks, WARPS * 32, 0, s>>>(x, r, scale, bias, y, N, eps);
  else
    add_layer_norm_kernel<CH, false><<<blocks, WARPS * 32, 0, s>>>(x, r, scale, bias, y, N, eps);
  return cudaGetLastError();
}

}  // namespace

// x, r (or null), y: (N, H) bf16, contiguous, 16-byte aligned; scale, bias:
// (H,) float32.  H is a multiple of 256, at most 2048.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int add_layer_norm(const void* x, const void* r, const void* scale, const void* bias,
                              void* y, long long N, int H, float eps, void* stream) {
  if (N < 1 || H < 256 || H % 256 != 0 || H / 256 > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* x_ = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* r_ = static_cast<const __nv_bfloat16*>(r);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  __nv_bfloat16* y_ = static_cast<__nv_bfloat16*>(y);
  switch (H / 256) {
    case 1: return (int)launch<1>(x_, r_, sc, bi, y_, N, eps, s);
    case 2: return (int)launch<2>(x_, r_, sc, bi, y_, N, eps, s);
    case 3: return (int)launch<3>(x_, r_, sc, bi, y_, N, eps, s);
    case 4: return (int)launch<4>(x_, r_, sc, bi, y_, N, eps, s);
    case 5: return (int)launch<5>(x_, r_, sc, bi, y_, N, eps, s);
    case 6: return (int)launch<6>(x_, r_, sc, bi, y_, N, eps, s);
    case 7: return (int)launch<7>(x_, r_, sc, bi, y_, N, eps, s);
    default: return (int)launch<8>(x_, r_, sc, bi, y_, N, eps, s);
  }
}
