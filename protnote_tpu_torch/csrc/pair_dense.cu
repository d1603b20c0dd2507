// The dense training scorer's first layer over every (sequence, label) pair,
// and the side sums of its backward, for Hopper (sm_90a).
//
// Replaces the first layer of the TPU op chain
// protnote_tpu/ops/pair_scorer.py:108 pair_logits_dense (the joint embedding
// of :92 joint_embeddings through the output MLP's first Linear, :56
// output_mlp_apply) for concatenation and concatenation_diff, and the
// broadcast transposes of its backward.  The joint is never built: with
// a = P_e @ W1_p (B, H) and c = L_e @ W1_l (L, H) the float32 side products
// (the diff block folded into both),
//
//   pair_first_add:  z[b * L + l, n] = bf16(a[b, n] + c[l, n])
//   pair_side_sums:  sb[b, k] = sum_l x[b * L + l, k] * v[l, k]   (f32)
//                    sl[l, k] = sum_b x[b * L + l, k] * u[b, k]   (f32)
//
// where the side sums give the first layer's da = sum_l dz and dc =
// sum_b dz (u = v = 1), and for concatenation_prod the gradients of P_e and
// L_e through the prod block: x = dJ = dz @ W_prod^T, v = L_e, u = P_e.
// Each product of two bf16 values is exact in float32; every sum runs in a
// fixed order (sl over b in order; sb per row chunk over its rows, its
// warps in order, then the chunks in order), so two calls give the same
// bits.
//
// What bounds them: device memory.  pair_first_add walks the pairs label
// by label (the B rows of one label in turn), so each row of c comes from
// device memory once and a (393 KB) stays in L2; it writes z, 6.3 GB at 32 x
// 32,102 x 3072 (with c's 394 MB, 2.0 ms at 3.35 TB/s).  pair_side_sums
// reads x twice (once a sum), 12.6 GB for dz at that shape.  Each thread
// moves 16 bytes (8 bf16) an access, a warp 256 consecutive columns of a
// row.
//
// The float32 forms (pair_first_add_f32: z float32, nothing rounded;
// pair_side_sums_f32: x, u and v float32, each product x * u rounded once
// to float32 as JAX's float32 chain rounds it, MIXED_PRECISION False) are
// the same kernels on float32 elements, 8 columns a thread in two 16-byte
// accesses: twice the bytes of z and x.

#include "bn_columns.cuh"

namespace {

// z = T(a[b] + c[l]): each thread owns 8 columns of one row at a time;
// the grid-stride loop walks the pairs label-major (pair i is sequence
// i % B of label i / B), so the blocks in flight share c's rows.
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
pair_first_add_kernel(const float* __restrict__ a, const float* __restrict__ c,
                      T* __restrict__ z, int B, int L, int H) {
  const int vpr = H / VEC;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= vpr) return;
  const long long rows = (long long)B * L;
  for (long long i = blockIdx.x; i < rows; i += gridDim.x) {
    const int l = (int)(i / B);
    const int b = (int)(i - (long long)l * B);
    const long long r = (long long)b * L + l;
    const float4* ap = reinterpret_cast<const float4*>(a + (size_t)b * H + cv * VEC);
    const float4* cp = reinterpret_cast<const float4*>(c + (size_t)l * H + cv * VEC);
    float f[VEC];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 av = __ldg(ap + h);
      const float4 cw = __ldg(cp + h);
      f[4 * h] = __fadd_rn(av.x, cw.x);
      f[4 * h + 1] = __fadd_rn(av.y, cw.y);
      f[4 * h + 2] = __fadd_rn(av.z, cw.z);
      f[4 * h + 3] = __fadd_rn(av.w, cw.w);
    }
    store8(z + (r * vpr + cv) * VEC, f);
  }
}

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
int first_add(const void* a, const void* c, void* z, int B, int L, int H, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || H % VEC != 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * L;
  const int vpr = H / VEC;
  const dim3 grid((unsigned)std::min(rows, (long long)132 * 64),
                  (unsigned)((vpr + EW_THREADS - 1) / EW_THREADS));
  pair_first_add_kernel<T><<<grid, std::min(EW_THREADS, vpr), 0,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(c), static_cast<T*>(z), B, L, H);
  return (int)cudaGetLastError();
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

// z (B * L, H) bf16 with rows b * L + l: bf16(a[b] + c[l]); a (B, H) and c
// (L, H) f32, all contiguous and 16-byte aligned, H a multiple of 8.
// Returns a CUDA error (0 on success).
extern "C" int pair_first_add(const void* a, const void* c, void* z, int B, int L, int H,
                              void* stream) {
  return first_add<__nv_bfloat16>(a, c, z, B, L, H, stream);
}

// Its float32 form: z (B * L, H) float32, a[b] + c[l] as it is.
extern "C" int pair_first_add_f32(const void* a, const void* c, void* z, int B, int L, int H,
                                  void* stream) {
  return first_add<float>(a, c, z, B, L, H, stream);
}

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
