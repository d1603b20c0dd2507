// K7's masked mean pool for Hopper (sm_90a), forward and backward.
//
// Replaces the last three lines of protnote_tpu/models/proteinfer.py:
// proteinfer_embed (lines 208-212):
//
//   feats = feats * mask
//   denom = max(lengths, 1)
//   pooled = sum(feats.astype(f32), axis=1) / denom
//
// and their vjp, bf16(g / denom) on the valid rows and 0 elsewhere (the
// transpose of `* mask`, of the cast to float32 and of the division).
//
// What bounds it: bytes.  The forward reads each valid row once (32
// sequences at bucket 512 of the 1,100-channel encoder: 20.5 MB, 0.0061 ms
// at 3.35 TB/s); the backward writes every row of a (B, T, C) bf16 gradient
// at the padded pitch once (36.2 MB at pitch 1,104: 0.0108 ms).
//
// masked_mean_pool, one launch: block (group, b) sums every valid row of
// sequence b over GROUP_CHANNELS channels.  A thread owns 8 channels (one
// 16-byte load a row where the rows lie a multiple of 8 channels apart and
// start on 16 bytes; narrower loads otherwise); the block's ROW_SLOTS row
// slots take rows slot, slot + ROW_SLOTS, ..., each thread IN_FLIGHT rows
// loaded before their adds, so a block has ROW_SLOTS x IN_FLIGHT rows (64
// KB) in flight and a 512-row sequence takes 2 rounds; then thread c adds
// the slots' sums of channel c in slot order and divides by max(length, 1)
// (__fdiv_rn).  Rows past the length are not read, so the bytes follow the
// valid rows; no scratch, no second launch, no lengths on the host.  The
// first design (csrc/variants/masked_pool_v1.cu) had a quarter of these
// bytes in flight a block (8 warps of 4-byte pairs), so a long sequence's
// block set the end (16 dependent rounds at 512 rows); the runs form
// (csrc/variants/masked_pool_runs.cu: a block a run of 32 rows, then a
// launch adding the runs) paid two launches' latency chains.  The order of
// every sum is fixed by T and the lengths alone: the same input gives the
// same bits on every call and every card.
//
// masked_mean_pool_f32, one launch: the same pool on float32 activations
// (the encoder computing in float32, csrc/masked_conv_f32.cu), a 16-byte
// load now 4 channels: block (group, b), a warp one row's 128 channels (32
// lanes of 4), 32 row slots x IN_FLIGHT rows in flight, then the slots added
// in order and divided (__fdiv_rn).  Bound by bytes: the valid rows read
// once (41 MB for 32 sequences at bucket 512, 0.012 ms).
//
// masked_mean_pool_backward, one launch: block (row chunk, b) writes
// BWD_ROWS rows of sequence b at the padded pitch (a multiple of 8
// channels), a thread 8 channels with one 16-byte store a row:
// bf16_rn(__fdiv_rn(g, max(length, 1))) on rows t < length, that value
// times 0 on the rows past it (the plain version's `* mask` in bf16, a
// signed zero), and 0 in the padding channels.  The thread forms its two
// 16-byte words once and stores one of them a row.
//
// masked_mean_pool_backward_f32, one launch: the same transpose in float32
// (the encoder training in float32, MIXED_PRECISION False), where nothing is
// rounded: __fdiv_rn(g, max(length, 1)) on the valid rows, that value times
// 0 past them, 0 in the padding channels, at the padded pitch the last
// float32 conv's backward (csrc/masked_conv_f32.cu:masked_conv_dx_f32 and
// masked_conv_dw_f32) reads.  A thread 8 channels as two float4 words, each
// formed once and stored a row.  Bound by bytes: every row of the (B, T, C)
// float32 gradient at the padded pitch written once (72.4 MB at pitch
// 1,104 for 32 sequences at bucket 512: 0.0216 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE_CHANNELS = 8;          // channels a thread: 16 bytes of bf16
constexpr int GROUP_CHANNELS = 128;       // channels of a forward block
constexpr int ROW_LANES = GROUP_CHANNELS / LANE_CHANNELS;  // threads a row
constexpr int POOL_THREADS = 1024;        // a forward block: one an SM by registers
constexpr int ROW_SLOTS = POOL_THREADS / ROW_LANES;        // rows at once: 64
constexpr int IN_FLIGHT = 4;              // rows a thread loads before their adds
constexpr int GROUPS = 4;                 // row groups of a backward block
constexpr int MAX_LANES = 160;            // C up to 1,280 channels (the backward's lanes)
constexpr int MAX_THREADS = GROUPS * MAX_LANES;  // 640
constexpr int BWD_ROWS = 32;              // rows of a backward block
constexpr int BWD_GROUP_ROWS = BWD_ROWS / GROUPS;

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

// Block (group, b): out[b, c] for the channels c of group `group`, thread
// i the row slot i / ROW_LANES and the lane i % ROW_LANES (channels
// 128 group + 8 lane, + 8).
template <int A>
__global__ void __launch_bounds__(POOL_THREADS, 1)
pool_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ lengths,
            float* __restrict__ out, int T, int C, int pitch) {
  __shared__ float4 s_acc[ROW_SLOTS][GROUP_CHANNELS / 4];
  const int b = blockIdx.y;
  const int slot = threadIdx.x / ROW_LANES, lane = threadIdx.x % ROW_LANES;
  const int c0 = blockIdx.x * GROUP_CHANNELS + lane * LANE_CHANNELS;
  const int n = min(LANE_CHANNELS, C - c0);  // channels of this lane (<= 0 past C)
  const int L = valid_length(lengths, b, T);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (n > 0) {
    const __nv_bfloat16* p = x + static_cast<size_t>(b) * T * pitch + c0;
    for (int r0 = slot; r0 < L; r0 += ROW_SLOTS * IN_FLIGHT) {
      uint4 v[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int r = r0 + u * ROW_SLOTS;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (r < L) v[u] = n == LANE_CHANNELS ? load8<A>(p + static_cast<size_t>(r) * pitch)
                                             : load_tail(p + static_cast<size_t>(r) * pitch, n);
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u)
        if (r0 + u * ROW_SLOTS < L) add8(acc, v[u]);
    }
  }
  s_acc[slot][2 * lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  s_acc[slot][2 * lane + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  const int c = blockIdx.x * GROUP_CHANNELS + threadIdx.x;
  if (threadIdx.x >= GROUP_CHANNELS || c >= C) return;
  const float* s_flat = reinterpret_cast<const float*>(s_acc);
  float sum = 0.f;
#pragma unroll 8
  for (int r = 0; r < ROW_SLOTS; ++r) sum += s_flat[r * GROUP_CHANNELS + threadIdx.x];
  out[static_cast<size_t>(b) * C + c] = __fdiv_rn(sum, fmaxf(static_cast<float>(lengths[b]), 1.f));
}

constexpr int F32_LANE_CHANNELS = 4;  // channels a thread of the float32 pool: 16 bytes
constexpr int F32_ROW_LANES = GROUP_CHANNELS / F32_LANE_CHANNELS;  // a warp a row
constexpr int F32_ROW_SLOTS = POOL_THREADS / F32_ROW_LANES;        // rows at once: 32

// Block (group, b) of the float32 pool: thread i the row slot i / 32 and the
// lane i % 32 (channels 128 group + 4 lane, + 4); A = 4: one 16-byte load a
// row, A = 1: four 4-byte loads.
template <int A>
__global__ void __launch_bounds__(POOL_THREADS, 1)
pool_f32_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                float* __restrict__ out, int T, int C, int pitch) {
  __shared__ float4 s_acc[F32_ROW_SLOTS][F32_ROW_LANES];
  const int b = blockIdx.y;
  const int slot = threadIdx.x / F32_ROW_LANES, lane = threadIdx.x % F32_ROW_LANES;
  const int c0 = blockIdx.x * GROUP_CHANNELS + lane * F32_LANE_CHANNELS;
  const int n = min(F32_LANE_CHANNELS, C - c0);  // channels of this lane (<= 0 past C)
  const int L = valid_length(lengths, b, T);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) {
    const float* p = x + static_cast<size_t>(b) * T * pitch + c0;
    for (int r0 = slot; r0 < L; r0 += F32_ROW_SLOTS * IN_FLIGHT) {
      float4 v[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int r = r0 + u * F32_ROW_SLOTS;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r >= L) continue;
        const float* q = p + static_cast<size_t>(r) * pitch;
        if (A == 4 && n == F32_LANE_CHANNELS) {
          v[u] = __ldg(reinterpret_cast<const float4*>(q));
        } else {
          v[u].x = __ldg(q);
          if (n > 1) v[u].y = __ldg(q + 1);
          if (n > 2) v[u].z = __ldg(q + 2);
          if (n > 3) v[u].w = __ldg(q + 3);
        }
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        if (r0 + u * F32_ROW_SLOTS >= L) continue;
        acc.x += v[u].x, acc.y += v[u].y, acc.z += v[u].z, acc.w += v[u].w;
      }
    }
  }
  s_acc[slot][lane] = acc;
  __syncthreads();
  const int c = blockIdx.x * GROUP_CHANNELS + threadIdx.x;
  if (threadIdx.x >= GROUP_CHANNELS || c >= C) return;
  const float* s_flat = reinterpret_cast<const float*>(s_acc);
  float sum = 0.f;
#pragma unroll 8
  for (int r = 0; r < F32_ROW_SLOTS; ++r) sum += s_flat[r * GROUP_CHANNELS + threadIdx.x];
  out[static_cast<size_t>(b) * C + c] = __fdiv_rn(sum, fmaxf(static_cast<float>(lengths[b]), 1.f));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// Block (chunk, b): rows [chunk * BWD_ROWS, + BWD_ROWS) of sequence b's
// gradient, every channel of the padded pitch; thread i: row group
// i / lanes (BWD_GROUP_ROWS consecutive rows), lane i % lanes (8 channels).
__global__ void __launch_bounds__(MAX_THREADS)
pool_backward_kernel(const float* __restrict__ g, const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ dx, int T, int C, int pitch, int lanes) {
  const int b = blockIdx.y;
  const int grp = threadIdx.x / lanes, lane = threadIdx.x - grp * lanes;
  if (grp >= GROUPS) return;
  const int c0 = lane * LANE_CHANNELS;
  const int L = valid_length(lengths, b, T);
  const float d = fmaxf(static_cast<float>(lengths[b]), 1.f);
  const float* gb = g + static_cast<size_t>(b) * C;
  __nv_bfloat16 v[8], z[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in = c0 + j < C;
    v[j] = __float2bfloat16_rn(in ? __fdiv_rn(__ldg(gb + c0 + j), d) : 0.f);
    z[j] = __float2bfloat16_rn(in ? __fmul_rn(__bfloat162float(v[j]), 0.f) : 0.f);
  }
  const uint4 val = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                               pack2(v[6], v[7]));
  const uint4 zero = make_uint4(pack2(z[0], z[1]), pack2(z[2], z[3]), pack2(z[4], z[5]),
                                pack2(z[6], z[7]));
  const int r0 = blockIdx.x * BWD_ROWS + grp * BWD_GROUP_ROWS;
  uint4* o = reinterpret_cast<uint4*>(dx + (static_cast<size_t>(b) * T + r0) * pitch + c0);
  const int step = pitch / LANE_CHANNELS;
#pragma unroll
  for (int u = 0; u < BWD_GROUP_ROWS; ++u)
    if (r0 + u < T) o[static_cast<size_t>(u) * step] = r0 + u < L ? val : zero;
}

// Block (chunk, b) of the float32 transpose: the bf16 kernel's rows and
// lanes, a lane's 8 channels stored as two float4 words a row.
__global__ void __launch_bounds__(MAX_THREADS)
pool_backward_f32_kernel(const float* __restrict__ g, const int* __restrict__ lengths,
                         float* __restrict__ dx, int T, int C, int pitch, int lanes) {
  const int b = blockIdx.y;
  const int grp = threadIdx.x / lanes, lane = threadIdx.x - grp * lanes;
  if (grp >= GROUPS) return;
  const int c0 = lane * LANE_CHANNELS;
  const int L = valid_length(lengths, b, T);
  const float d = fmaxf(static_cast<float>(lengths[b]), 1.f);
  const float* gb = g + static_cast<size_t>(b) * C;
  float v[8], z[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in = c0 + j < C;
    v[j] = in ? __fdiv_rn(__ldg(gb + c0 + j), d) : 0.f;
    z[j] = in ? __fmul_rn(v[j], 0.f) : 0.f;
  }
  const float4 val0 = make_float4(v[0], v[1], v[2], v[3]);
  const float4 val1 = make_float4(v[4], v[5], v[6], v[7]);
  const float4 zero0 = make_float4(z[0], z[1], z[2], z[3]);
  const float4 zero1 = make_float4(z[4], z[5], z[6], z[7]);
  const int r0 = blockIdx.x * BWD_ROWS + grp * BWD_GROUP_ROWS;
  float4* o = reinterpret_cast<float4*>(dx + (static_cast<size_t>(b) * T + r0) * pitch + c0);
  const int step = pitch / 4;
#pragma unroll
  for (int u = 0; u < BWD_GROUP_ROWS; ++u) {
    if (r0 + u >= T) continue;
    const bool in = r0 + u < L;
    o[static_cast<size_t>(u) * step] = in ? val0 : zero0;
    o[static_cast<size_t>(u) * step + 1] = in ? val1 : zero1;
  }
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
// on 2 bytes) and lengths (B,) int32.  One launch; returns a CUDA error.
extern "C" int masked_mean_pool(const void* x, const void* lengths, void* out, int B, int T,
                                int C, int pitch, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || C <= 0 || pitch < C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((C + GROUP_CHANNELS - 1) / GROUP_CHANNELS, B);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  switch (load_width(x, pitch)) {
    case 8: pool_kernel<8><<<grid, POOL_THREADS, 0, s>>>(xb, len, o, T, C, pitch); break;
    case 4: pool_kernel<4><<<grid, POOL_THREADS, 0, s>>>(xb, len, o, T, C, pitch); break;
    case 2: pool_kernel<2><<<grid, POOL_THREADS, 0, s>>>(xb, len, o, T, C, pitch); break;
    default: pool_kernel<1><<<grid, POOL_THREADS, 0, s>>>(xb, len, o, T, C, pitch);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (B, C) float32 from x (B, T, C) float32 rows at `pitch` (>= C; any
// base on 4 bytes) and lengths (B,) int32.  One launch; returns a CUDA error.
extern "C" int masked_mean_pool_f32(const void* x, const void* lengths, void* out, int B,
                                    int T, int C, int pitch, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || C <= 0 || pitch < C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((C + GROUP_CHANNELS - 1) / GROUP_CHANNELS, B);
  const auto* xf = static_cast<const float*>(x);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (pitch % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    pool_f32_kernel<4><<<grid, POOL_THREADS, 0, s>>>(xf, len, o, T, C, pitch);
  else
    pool_f32_kernel<1><<<grid, POOL_THREADS, 0, s>>>(xf, len, o, T, C, pitch);
  return static_cast<int>(cudaGetLastError());
}

// dx (B, T, C) bf16 at `pitch` (a multiple of 8 channels, dx on 16 bytes;
// the padding channels are written too) from g (B, C) float32 and lengths
// (B,) int32.  One launch; returns a CUDA error.
extern "C" int masked_mean_pool_backward(const void* g, const void* lengths, void* dx, int B,
                                         int T, int C, int pitch, void* stream) {
  const int lanes = (C + LANE_CHANNELS - 1) / LANE_CHANNELS;
  if (B <= 0 || B > 65535 || T <= 0 || C <= 0 || pitch < C || pitch % LANE_CHANNELS != 0 ||
      lanes > MAX_LANES || reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int threads = (GROUPS * (pitch / LANE_CHANNELS) + 31) / 32 * 32;
  if (threads > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + BWD_ROWS - 1) / BWD_ROWS, B);
  pool_backward_kernel<<<grid, threads, 0, s>>>(static_cast<const float*>(g),
                                                static_cast<const int*>(lengths),
                                                static_cast<__nv_bfloat16*>(dx), T, C, pitch,
                                                pitch / LANE_CHANNELS);
  return static_cast<int>(cudaGetLastError());
}

// dx (B, T, C) float32 at `pitch` (a multiple of 8 channels, dx on 16
// bytes; the padding channels are written too) from g (B, C) float32 and
// lengths (B,) int32.  One launch; returns a CUDA error.
extern "C" int masked_mean_pool_backward_f32(const void* g, const void* lengths, void* dx, int B,
                                             int T, int C, int pitch, void* stream) {
  const int lanes = (C + LANE_CHANNELS - 1) / LANE_CHANNELS;
  if (B <= 0 || B > 65535 || T <= 0 || C <= 0 || pitch < C || pitch % LANE_CHANNELS != 0 ||
      lanes > MAX_LANES || reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (GROUPS * (pitch / LANE_CHANNELS) + 31) / 32 * 32;
  if (threads > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + BWD_ROWS - 1) / BWD_ROWS, B);
  pool_backward_f32_kernel<<<grid, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(lengths), static_cast<float*>(dx), T,
      C, pitch, pitch / LANE_CHANNELS);
  return static_cast<int>(cudaGetLastError());
}
