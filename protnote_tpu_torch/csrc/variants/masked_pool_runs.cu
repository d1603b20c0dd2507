// K7's masked mean pool forward in the form of runs, which the port does
// not use: the valid rows of each sequence cut into runs of RUN rows, a
// block a run over every channel (8 channels a thread by 16-byte loads,
// GROUP_ROWS rows, IN_FLIGHT of them loaded at once), the run's float32 sums
// written to a (B, runs, pitch8) scratch, and a second launch adding each
// sequence's runs in order and dividing.  Kept as it was measured for
// chip_variants.py --k7-pool, which times it against the kept pool
// (csrc/masked_pool.cu) in turns; its entry point masked_mean_pool takes the
// scratch (B * ceil(T / RUN) * 8 * ceil(C / 8) float32) before the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RUN = 32;                   // rows of a run: one forward block
constexpr int GROUPS = 4;                 // row groups of a block
constexpr int GROUP_ROWS = RUN / GROUPS;  // rows a thread
constexpr int IN_FLIGHT = 4;              // of them loaded at once (registers: 2 blocks an SM)
constexpr int MIN_BLOCKS = 2;             // forward blocks an SM at 640 threads: <= 51 registers
constexpr int LANE_CHANNELS = 8;          // channels a thread: 16 bytes of bf16
constexpr int MAX_LANES = 160;            // C up to 1,280 channels
constexpr int MAX_THREADS = GROUPS * MAX_LANES;  // 640: up to 102 registers a thread
constexpr int FINISH_THREADS = 256;       // a finish block: 4 channels a thread

__device__ __forceinline__ int valid_length(const int* lengths, int b, int T) {
  return min(max(lengths[b], 0), T);
}

// The 8 bf16 channels at p as four 32-bit words, read A elements (2A bytes)
// at a time: p lies on 2A bytes.
template <int A>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  if constexpr (A == 8) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (A == 4) {
    const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
    const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p + 4));
    return make_uint4(lo.x, lo.y, hi.x, hi.y);
  } else if constexpr (A == 2) {
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
    return make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = __ldg(h + 2 * j) | (uint32_t(__ldg(h + 2 * j + 1)) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The first n < 8 channels at p, zero past them (the last lane of a row
// whose width is not a multiple of 8: nothing past C is read).
__device__ __forceinline__ uint4 load_tail(const __nv_bfloat16* p, int n) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = 2 * j < n ? __ldg(h + 2 * j) : 0u;
    const uint32_t hi = 2 * j + 1 < n ? __ldg(h + 2 * j + 1) : 0u;
    w[j] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void add8(float (&acc)[8], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    acc[2 * j] += f.x;
    acc[2 * j + 1] += f.y;
  }
}

// Block (run, b): the float32 sums of rows [run * RUN, run * RUN + RUN) of
// sequence b that lie below its length, every channel, into
// part[(b * runs + run) * pitch8 + c] (pitch8 = 8 * lanes; the channels in
// [C, pitch8) get 0).  Thread i: row group i / lanes, lane i % lanes.
template <int A>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
pool_runs_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ lengths,
                 float* __restrict__ part, int T, int C, int pitch, int lanes) {
  __shared__ float4 s_acc[GROUPS - 1][MAX_LANES][2];
  const int b = blockIdx.y, run = blockIdx.x, runs = gridDim.x;
  const int L = valid_length(lengths, b, T);
  const int t0 = run * RUN;
  if (t0 >= L) return;  // the whole block: no row of this run is valid
  const int g = threadIdx.x / lanes, lane = threadIdx.x - g * lanes;
  const int c0 = lane * LANE_CHANNELS;
  const int n = min(LANE_CHANNELS, C - c0);  // channels of this lane
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (g < GROUPS) {
    const int r0 = t0 + g * GROUP_ROWS;
    const __nv_bfloat16* p = x + (static_cast<size_t>(b) * T + r0) * pitch + c0;
#pragma unroll
    for (int h = 0; h < GROUP_ROWS; h += IN_FLIGHT) {
      uint4 v[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int r = h + u;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < L) v[u] = n == LANE_CHANNELS ? load8<A>(p + static_cast<size_t>(r) * pitch)
                                                  : load_tail(p + static_cast<size_t>(r) * pitch, n);
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u)
        if (r0 + h + u < L) add8(acc, v[u]);
    }
    if (g > 0) {
      s_acc[g - 1][lane][0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      s_acc[g - 1][lane][1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
  __syncthreads();
  if (g != 0) return;
#pragma unroll
  for (int h = 0; h < GROUPS - 1; ++h) {
    const float4 lo = s_acc[h][lane][0], hi = s_acc[h][lane][1];
    acc[0] += lo.x, acc[1] += lo.y, acc[2] += lo.z, acc[3] += lo.w;
    acc[4] += hi.x, acc[5] += hi.y, acc[6] += hi.z, acc[7] += hi.w;
  }
  float4* o = reinterpret_cast<float4*>(
      part + (static_cast<size_t>(b) * runs + run) * (lanes * LANE_CHANNELS) + c0);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// Block (x, b): channels [4 * (x * FINISH_THREADS + i), + 4) of sequence b:
// the sum of its runs' partial sums in run order, over max(length, 1).
__global__ void __launch_bounds__(FINISH_THREADS)
pool_finish_kernel(const float* __restrict__ part, const int* __restrict__ lengths,
                   float* __restrict__ out, int T, int C, int runs, int pitch8) {
  const int b = blockIdx.y;
  const int c = 4 * (blockIdx.x * FINISH_THREADS + threadIdx.x);
  if (c >= C) return;
  const int L = valid_length(lengths, b, T);
  const int n = (L + RUN - 1) / RUN;  // the runs that hold a valid row
  const float4* p = reinterpret_cast<const float4*>(part + static_cast<size_t>(b) * runs * pitch8 + c);
  const int step = pitch8 / 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int r = 0; r < n; ++r) {
    const float4 v = __ldcg(p + static_cast<size_t>(r) * step);
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  const float d = fmaxf(static_cast<float>(lengths[b]), 1.f);
  const float q[4] = {__fdiv_rn(s.x, d), __fdiv_rn(s.y, d), __fdiv_rn(s.z, d), __fdiv_rn(s.w, d)};
  float* o = out + static_cast<size_t>(b) * C + c;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < C) o[j] = q[j];
}

// The widest load of 8 channels that every row start allows: 8 elements
// (16 bytes) where the base and the pitch are multiples of them, else 4, 2,
// 1.
int load_width(const void* x, int pitch) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  int a = LANE_CHANNELS;
  while (a > 1 && (pitch % a != 0 || base % (2 * a) != 0)) a /= 2;
  return a;
}

}  // namespace

// out (B, C) float32 from x (B, T, C) bf16 rows at `pitch` (>= C; any base
// on 2 bytes) and lengths (B,) int32, through part: B * ceil(T / RUN) *
// 8 * ceil(C / 8) float32 of scratch.  Two launches; returns a CUDA error.
extern "C" int masked_mean_pool(const void* x, const void* lengths, void* part, void* out,
                                int B, int T, int C, int pitch, void* stream) {
  const int lanes = (C + LANE_CHANNELS - 1) / LANE_CHANNELS;
  if (B <= 0 || B > 65535 || T <= 0 || C <= 0 || pitch < C || lanes > MAX_LANES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int runs = (T + RUN - 1) / RUN;
  const int threads = (GROUPS * lanes + 31) / 32 * 32;
  const dim3 grid(runs, B);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const int* len = static_cast<const int*>(lengths);
  float* p = static_cast<float*>(part);
  switch (load_width(x, pitch)) {
    case 8: pool_runs_kernel<8><<<grid, threads, 0, s>>>(xb, len, p, T, C, pitch, lanes); break;
    case 4: pool_runs_kernel<4><<<grid, threads, 0, s>>>(xb, len, p, T, C, pitch, lanes); break;
    case 2: pool_runs_kernel<2><<<grid, threads, 0, s>>>(xb, len, p, T, C, pitch, lanes); break;
    default: pool_runs_kernel<1><<<grid, threads, 0, s>>>(xb, len, p, T, C, pitch, lanes);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 fgrid((C + 4 * FINISH_THREADS - 1) / (4 * FINISH_THREADS), B);
  pool_finish_kernel<<<fgrid, FINISH_THREADS, 0, s>>>(p, len, static_cast<float*>(out), T, C,
                                                      runs, lanes * LANE_CHANNELS);
  return static_cast<int>(cudaGetLastError());
}
