// pair_side_sums in its first design, which the port no longer uses: two
// kernels each read all of x (side_sum_over_b_kernel: a thread 8 columns of
// one label over every sequence in order; side_sum_over_l_kernel: per row
// chunk of `per` labels and sequence, the warps' column sums added in warp
// order into one partial row), then column_sums_tail_kernel adds the
// chunks in order.  x crosses device memory twice.  Kept as it was for
// chip_variants.py --dense-first, which times it against the kept kernel
// (csrc/pair_dense.cu: both sums in one read of x) in turns.  Its entry
// points take the kept ones' arguments, with `per` any label count (the
// wrapper's chunks of about 1,000 labels, ops/streaming_train.py:_chunks).

#include "bn_columns.cuh"

namespace {

// sl[l] = sum_b x[b, l] * u[b] (u null: ones), b in order; a thread owns 8
// columns of one label at a time.
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
side_sum_over_b_kernel(const T* __restrict__ x, const T* __restrict__ u,
                       float* __restrict__ sl, int B, int L, int K) {
  const int vpr = K / VEC;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= vpr) return;
  for (int l = blockIdx.x; l < L; l += gridDim.x) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int b = 0; b < B; ++b) {
      float xf[VEC], wf[VEC];
      load8(x + (((long long)b * L + l) * vpr + cv) * VEC, xf);
      if (u != nullptr) load8(u + ((size_t)b * vpr + cv) * VEC, wf);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] = __fadd_rn(acc[e], u != nullptr ? __fmul_rn(xf[e], wf[e]) : xf[e]);
    }
    float4* out = reinterpret_cast<float4*>(sl + (size_t)l * K + cv * VEC);
    out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// Per label chunk and sequence b (blockIdx.z): the column sums of
// x[b, l] * v[l] over the chunk's labels, into partial row `chunk` of
// part (chunks, B * K) at column b * K + k.
template <typename T>
__global__ void __launch_bounds__(RED_WARPS * 32)
side_sum_over_l_kernel(const T* __restrict__ x, const T* __restrict__ v,
                       float* __restrict__ part, int B, int L, int K, long long per) {
  __shared__ float s[1][RED_WARPS][COLS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * COLS;
  const int col = c0 + lane * VEC;
  const long long first = (long long)blockIdx.y * per;
  const long long last = min(first + per, (long long)L);
  float acc[1][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[0][e] = 0.f;
#pragma unroll 2
  for (long long l = first + warp; l < last; l += RED_WARPS) {
    float xf[VEC], wf[VEC];
    load8(x + ((long long)b * L + l) * K + col, xf);
    if (v != nullptr) load8(v + l * K + col, wf);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[0][e] = __fadd_rn(acc[0][e], v != nullptr ? __fmul_rn(xf[e], wf[e]) : xf[e]);
  }
  float* const out[1] = {part + (size_t)b * K};
  block_column_sums<1>(s, acc, out, blockIdx.y, c0, B * K);
}

template <typename T>
int side_sums(const void* x, const void* u, const void* v, void* part, void* sb, void* sl, int B,
              int L, int K, int chunks, long long per, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || K % COLS != 0 || chunks <= 0 || chunks > 65535 ||
      B > 65535 || per <= 0 || (long long)chunks * per < L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* x_ = static_cast<const T*>(x);
  const int vpr = K / VEC;
  side_sum_over_b_kernel<T><<<dim3((unsigned)std::min(L, 132 * 16),
                                   (unsigned)((vpr + EW_THREADS - 1) / EW_THREADS)),
                              std::min(EW_THREADS, vpr), 0, s>>>(
      x_, static_cast<const T*>(u), static_cast<float*>(sl), B, L, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  side_sum_over_l_kernel<T><<<dim3(K / COLS, chunks, B), RED_WARPS * 32, 0, s>>>(
      x_, static_cast<const T*>(v), static_cast<float*>(part), B, L, K, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cols = B * K;
  column_sums_tail_kernel<1><<<(cols + 255) / 256, 256, 0, s>>>(
      ChunkSums<1>{{static_cast<const float*>(part)}, {static_cast<float*>(sb)}}, chunks, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// For x (B * L, K) bf16 with rows b * L + l: sb (B, K) = sum_l x[b, l] * v[l]
// and sl (L, K) = sum_b x[b, l] * u[b], f32; u (B, K) and v (L, K) bf16, or
// null for ones.  part is a f32 scratch of chunks x B x K (chunks row chunks
// of `per` labels cover L).  K is a multiple of 256.  Returns a CUDA error.
extern "C" int pair_side_sums(const void* x, const void* u, const void* v, void* part, void* sb,
                              void* sl, int B, int L, int K, int chunks, long long per,
                              void* stream) {
  return side_sums<__nv_bfloat16>(x, u, v, part, sb, sl, B, L, K, chunks, per, stream);
}

// Its float32 form: x, u and v float32.
extern "C" int pair_side_sums_f32(const void* x, const void* u, const void* v, void* part,
                                  void* sb, void* sl, int B, int L, int K, int chunks,
                                  long long per, void* stream) {
  return side_sums<float>(x, u, v, part, sb, sl, B, L, K, chunks, per, stream);
}
