// K2's code passes in their first design, which the port no longer uses:
// one kernel, one warp a pair row, for layer 1's static codes and for the
// dynamic row scales and codes (from a and c, or from the bf16 carry).  The
// scale's maximum is a loop of scalar loads `stride` columns apart, then the
// row is read again for its codes, 4 codes a lane a store.  Kept as it was
// for chip_variants.py --k2-codes, which times it against the kept kernels
// (csrc/pair_scorer_int8.cu) in turns; its entry points keep their first
// signatures.
#include "../hopper.cuh"

namespace {

// clip(rint(q), lo, 127) as one byte: q = x / s correctly rounded (DIV,
// through s's rounded reciprocal r: div_rn) or x * s (s a constant's
// reciprocal, r unused)
template <bool DIV>
__device__ __forceinline__ uint32_t quantize(float x, float s, float r, float lo) {
  const float q = fminf(fmaxf(rintf(DIV ? div_rn(x, s, r) : __fmul_rn(x, s)), lo), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// 4 consecutive values -> 4 int8 codes packed little-endian
template <bool DIV>
__device__ __forceinline__ uint32_t quantize4(const float (&v)[4], float s, float r, float lo) {
  return quantize<DIV>(v[0], s, r, lo) | (quantize<DIV>(v[1], s, r, lo) << 8) |
         (quantize<DIV>(v[2], s, r, lo) << 16) | (quantize<DIV>(v[3], s, r, lo) << 24);
}

// One warp a pair row of the chunk: its int8 codes, and with DYN its scale.
// x = bf16(relu(a[b] + c[l0 + l])) when FIRST (rows l >= nl, padding, take
// c = 0), else the row of the bf16 workspace x_in.
template <bool FIRST, bool DYN>
__global__ void __launch_bounds__(256)
pair_int8_quantize_kernel(const float* __restrict__ a, const float* __restrict__ c,
                          const __nv_bfloat16* __restrict__ x_in, float* __restrict__ row_scale,
                          int8_t* __restrict__ codes, int nl, int nl_pad, int l0, int M, int K,
                          int stride, float margin, float inv) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= M) return;
  const int b = r / nl_pad;
  const int l = r - b * nl_pad;
  const float* ar = a + (size_t)b * K;
  const float* cr = FIRST && l < nl ? c + (size_t)(l0 + l) * K : nullptr;
  const __nv_bfloat16* xr = x_in + (size_t)r * K;
  auto x_at = [&](int j) {
    if (FIRST) return round_bf16(fmaxf(__fadd_rn(ar[j], cr ? cr[j] : 0.f), 0.f));
    return __bfloat162float(xr[j]);
  };
  float s = inv;
  if (DYN) {
    float m = 0.f;
    for (int j = lane * stride; j < K; j += 32 * stride) m = fmaxf(m, fabsf(x_at(j)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    s = __fmul_rn(fmaxf(__fmul_rn(m, margin), 1e-12f), __frcp_rn(127.f));
    if (lane == 0) row_scale[r] = s;
  }
  const float rs = DYN ? __frcp_rn(s) : 0.f;
  int8_t* out = codes + (size_t)r * K;
  for (int j = 4 * lane; j < K; j += 128) {
    float v[4];
    if (FIRST) {
      const float4 av = *reinterpret_cast<const float4*>(ar + j);
      const float4 cv = cr ? *reinterpret_cast<const float4*>(cr + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = round_bf16(fmaxf(__fadd_rn(av.x, cv.x), 0.f));
      v[1] = round_bf16(fmaxf(__fadd_rn(av.y, cv.y), 0.f));
      v[2] = round_bf16(fmaxf(__fadd_rn(av.z, cv.z), 0.f));
      v[3] = round_bf16(fmaxf(__fadd_rn(av.w, cv.w), 0.f));
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(xr + j);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      v[0] = lo.x;
      v[1] = lo.y;
      v[2] = hi.x;
      v[3] = hi.y;
    }
    *reinterpret_cast<uint32_t*>(out + j) = quantize4<DYN>(v, s, rs, -127.f);
  }
}

template <bool FIRST, bool DYN>
int quantize_rows(const void* a, const void* c, const void* x_in, void* row_scale, void* codes,
                  int nl, int nl_pad, int l0, int M, int K, int stride, float margin, float inv,
                  void* stream) {
  const int rows_per_block = 256 / 32;
  pair_int8_quantize_kernel<FIRST, DYN><<<(M + rows_per_block - 1) / rows_per_block, 256, 0,
                                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(c),
      static_cast<const __nv_bfloat16*>(x_in), static_cast<float*>(row_scale),
      static_cast<int8_t*>(codes), nl, nl_pad, l0, M, K, stride, margin, inv);
  return (int)cudaGetLastError();
}

}  // namespace

// Layer 1's codes with the static scale, rows r = b * nl_pad + l of the
// chunk: clip(rint(bf16(relu(a[b] + c[l0 + l])) * inv_s0), -127, 127) into
// codes (M, K) int8 (rows l >= nl take c = 0).  a (B, K), c (L, K) f32.
extern "C" int pair_int8_codes(const void* a, const void* c, void* codes, int nl, int nl_pad,
                               int l0, int M, int K, float inv_s0, void* stream) {
  if (M <= 0 || nl <= 0 || nl_pad < nl || K <= 0 || K % 128 != 0)
    return (int)cudaErrorInvalidValue;
  return quantize_rows<true, false>(a, c, nullptr, nullptr, codes, nl, nl_pad, l0, M, K, 1, 1.f,
                                    inv_s0, stream);
}

// Per pair row r of the chunk: row_scale[r] = max(max_j |x[r, j]| * margin,
// 1e-12) * float32(1 / 127) over j = 0, stride, 2 * stride, ... < K, and the
// row's codes clip(rint(x[r, :] / row_scale[r]), -127, 127) into codes (M, K)
// int8, where x is bf16(relu(a[b] + c[l0 + l])) when first, else the bf16 rows
// of x_in.
extern "C" int pair_int8_row_scale(const void* a, const void* c, const void* x_in,
                                   void* row_scale, void* codes, int nl, int nl_pad, int l0,
                                   int M, int K, int stride, float margin, int first,
                                   void* stream) {
  if (M <= 0 || nl <= 0 || nl_pad < nl || K <= 0 || K % 128 != 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  return first ? quantize_rows<true, true>(a, c, x_in, row_scale, codes, nl, nl_pad, l0, M, K,
                                           stride, margin, 0.f, stream)
               : quantize_rows<false, true>(a, c, x_in, row_scale, codes, nl, nl_pad, l0, M, K,
                                            stride, margin, 0.f, stream);
}
