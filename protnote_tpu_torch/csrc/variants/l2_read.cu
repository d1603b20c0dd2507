// A probe of the rate at which the L2 feeds the SMs, not a kernel of any
// path: every block reads region blockIdx.x % regions of a buffer that fits
// the 50 MB L2 (after the first pass, every read hits), `iters` times, by
// 16-byte loads that skip L1 (ld.global.cg).  chip_variants.py --dense-first
// times it beside pair_train_prod, whose stages come from the L2 at 0.010
// bytes a bf16 operation (0.020 for a ping-pong schedule, which was slower).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(512) l2_read_kernel(const uint4* __restrict__ p, long long n16,
                                                      int regions, int iters,
                                                      uint4* __restrict__ out) {
  const uint4* r = p + (size_t)(blockIdx.x % regions) * n16;
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int it = 0; it < iters; ++it) {
#pragma unroll 8
    for (long long i = threadIdx.x; i < n16; i += blockDim.x) {
      const uint4 v = __ldcg(r + i);
      acc.x ^= v.x;
      acc.y ^= v.y;
      acc.z ^= v.z;
      acc.w ^= v.w;
    }
  }
  if (acc.x == 0x9E3779B9u && acc.y == 0x7F4A7C15u) out[blockIdx.x] = acc;  // keeps the loads
}

}  // namespace

// grid blocks of `threads` (at most 512) threads each read `n16` 16-byte
// words of region b % regions of p, `iters` times.  Returns a CUDA error.
extern "C" int l2_read(const void* p, long long n16, int regions, int iters, int grid,
                       int threads, void* out, void* stream) {
  l2_read_kernel<<<grid, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), n16, regions, iters, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}
