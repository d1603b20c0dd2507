// Residual add + LayerNorm of the label text tower (K8b) for Hopper (sm_90a).
//
// Replaces protnote_tpu/models/text_transformer.py:_layer_norm (line 159)
// with the residual add in front of it (x + a at lines 245 and 255, the
// post-LN layers of bert), and the plain LayerNorm of the embeddings (226),
// of the pre-LN branches (258, 260) and the final LN (271), where there is no
// residual.  Per row of H values of the element type E (bf16 or float32):
//
//   v    = f32(E(x + r))             (the add in E, as JAX adds: bf16
//                                     rounds it, float32 is exact f32)
//   mu   = sum(v) / H
//   var  = sum((v - mu)^2) / H       (two passes, not E[v^2] - mu^2)
//   y    = E(((v - mu) * rsqrt(var + eps)) * scale + bias)
//
// every product and sum rounded on its own (no FMA), as the plain PyTorch
// version computes it.  The sums run in this order (the plain version's
// order differs; tests/test_torch_text_transformer.py emulates this one):
// lane l holds columns (c * 32 + l) * 8 + e of chunk c < H / 256, e < 8;
// eight partial sums a lane, p[e] = v[0][e] + v[1][e] + ... over the chunks
// in order, then ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), then a
// butterfly over the lanes (xor 16, 8, 4, 2, 1).
//
// Every kernel is a template on E: the bf16 forms (the entry points without
// a suffix) and the float32 forms (`_f32`, MIXED_PRECISION False) run the
// same code and the same order of sums; a lane's 16-byte chunk of bf16 is
// two 16-byte words of float32 (Row8<E>), so lane l holds the same columns
// in both.  In float32 nothing is rounded but the float32 ops themselves.
//
// What bounds it: bytes.  x and r are read once and y written once, 3 * N * H
// * sizeof(E) bytes with a residual: at 16,384 rows of 1024 that is 101 MB in
// bf16, 0.030 ms at 3.35 TB/s (67 MB, 0.020 ms without); 201 MB, 0.060 ms in
// float32 (0.040 without).  The first design (one warp a row,
// one row a warp) lost ~0.025 ms a call that did not scale with the bytes:
// each lane reloaded its 64 scale and bias values for every row, as scalar
// loads whose 32 lanes touch 1 KB apiece (~512 L1 wavefronts a row, more than
// the row's own bytes), and every row's load, two serial 32-add chains and
// store ran one after another.  This design:
//
// * Persistent: a grid of SMs x resident blocks, each warp walking rows
//   with a stride.
// * The next row's x (and r) are loaded into a second register buffer before
//   the current row's reductions, so each warp keeps a row in flight.
// * scale and bias are loaded once a warp as float4 and kept in registers up
//   to H 1024 in bf16 (64 a lane), up to H 512 in float32 (whose rows take
//   twice the registers); wider rows read them as float4 per row (L1).
// * Eight independent partial sums a lane in place of one serial chain.
// * v is kept in E as loaded (the residual add is rounded to E, so v is
//   exact in it) and widened once a pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;       // warps (rows in flight) a block
constexpr int MAX_CHUNKS = 8;  // chunks of 8 elements a lane: H up to 2048

__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  return pack_bf16x2(__fadd_rn(lo_bf16(a), lo_bf16(b)), __fadd_rn(hi_bf16(a), hi_bf16(b)));
}
__device__ __forceinline__ float comp(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// A lane's 8 elements of a chunk as loaded: one 16-byte word of bf16, two
// of float32.
template <typename E>
struct Row8;
template <>
struct Row8<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Row8<float> {
  float4 lo, hi;
};

__device__ __forceinline__ Row8<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ Row8<float> load8(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldg(q), __ldg(q + 1)};
}
// element e (< 8)
__device__ __forceinline__ float elem(const Row8<__nv_bfloat16>& r, int e) {
  const uint32_t w = e < 2 ? r.u.x : e < 4 ? r.u.y : e < 6 ? r.u.z : r.u.w;
  return (e & 1) ? hi_bf16(w) : lo_bf16(w);
}
__device__ __forceinline__ float elem(const Row8<float>& r, int e) {
  return e < 4 ? comp(r.lo, e) : comp(r.hi, e - 4);
}
// E(a + b), element by element
__device__ __forceinline__ Row8<__nv_bfloat16> add8(const Row8<__nv_bfloat16>& a,
                                                    const Row8<__nv_bfloat16>& b) {
  return {make_uint4(add_bf16x2(a.u.x, b.u.x), add_bf16x2(a.u.y, b.u.y),
                     add_bf16x2(a.u.z, b.u.z), add_bf16x2(a.u.w, b.u.w))};
}
__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ Row8<float> add8(const Row8<float>& a, const Row8<float>& b) {
  return {add4(a.lo, b.lo), add4(a.hi, b.hi)};
}
// 8 outputs, rounded to E
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&o)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]),
                                            pack_bf16x2(o[4], o[5]), pack_bf16x2(o[6], o[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&o)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// the lane's eight partial sums in a fixed tree, then over the warp
__device__ __forceinline__ float row_sum(const float (&p)[8]) {
  float v = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                      __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// scale and bias of the lane's columns: in registers (REGS: up to 4 chunks
// in bf16, 2 in float32, whose rows take twice the registers) or read per
// row
template <int CH, typename E>
struct Affine {
  static constexpr bool REGS = CH <= (sizeof(E) == 2 ? 4 : 2);
  float4 s[REGS ? 2 * CH : 1], b[REGS ? 2 * CH : 1];
  const float4 *sp, *bp;
  __device__ __forceinline__ Affine(const float* scale, const float* bias, int lane)
      : sp(reinterpret_cast<const float4*>(scale) + 2 * lane),
        bp(reinterpret_cast<const float4*>(bias) + 2 * lane) {
    if constexpr (REGS) {
#pragma unroll
      for (int i = 0; i < 2 * CH; ++i) {
        s[i] = __ldg(sp + 64 * (i >> 1) + (i & 1));
        b[i] = __ldg(bp + 64 * (i >> 1) + (i & 1));
      }
    }
  }
  // float4 h (< 2) of chunk c
  __device__ __forceinline__ float4 scale(int c, int h) const {
    if constexpr (REGS) return s[2 * c + h];
    else return __ldg(sp + 64 * c + h);
  }
  __device__ __forceinline__ float4 bias(int c, int h) const {
    if constexpr (REGS) return b[2 * c + h];
    else return __ldg(bp + 64 * c + h);
  }
};

// CH chunks of 8 elements a lane: H = 256 * CH; lane l holds columns
// (c * 32 + l) * 8 .. + 7 of chunk c, so a warp's loads are contiguous
template <typename E, int CH, bool RESIDUAL>
__global__ void __launch_bounds__(WARPS * 32)
add_layer_norm_kernel(const E* __restrict__ x, const E* __restrict__ r,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      E* __restrict__ y, float* __restrict__ stats, long long N, float eps) {
  constexpr int H = 256 * CH;
  constexpr int RC = RESIDUAL ? CH : 1;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * WARPS;
  long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  const Affine<CH, E> aff(scale, bias, lane);

  Row8<E> xc[CH], rc[RC];
  auto load = [&](long long rw, Row8<E> (&xd)[CH], Row8<E> (&rd)[RC]) {
    const size_t off = (size_t)rw * H + lane * 8;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      xd[c] = load8(x + off + c * 256);
      if constexpr (RESIDUAL) rd[c] = load8(r + off + c * 256);
    }
  };
  load(row, xc, rc);
  for (; row < N; row += stride) {
    const long long next = row + stride;
    Row8<E> xn[CH], rn[RC];
    if (next < N) load(next, xn, rn);  // in flight under this row's work

    if constexpr (RESIDUAL) {  // v = E(x + r), in place
#pragma unroll
      for (int c = 0; c < CH; ++c) xc[c] = add8(xc[c], rc[c]);
    }
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      p[e] = elem(xc[0], e);
#pragma unroll
      for (int c = 1; c < CH; ++c) p[e] = __fadd_rn(p[e], elem(xc[c], e));
    }
    const float mu = __fdiv_rn(row_sum(p), (float)H);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d0 = __fsub_rn(elem(xc[0], e), mu);
      p[e] = __fmul_rn(d0, d0);
#pragma unroll
      for (int c = 1; c < CH; ++c) {
        const float d = __fsub_rn(elem(xc[c], e), mu);
        p[e] = __fadd_rn(p[e], __fmul_rn(d, d));
      }
    }
    const float rs = rsqrtf(__fadd_rn(__fdiv_rn(row_sum(p), (float)H), eps));
    if (stats != nullptr && lane == 0) {  // mu and rstd for the backward
      stats[2 * row] = mu;
      stats[2 * row + 1] = rs;
    }
    const size_t off = (size_t)row * H + lane * 8;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float o[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 sv = aff.scale(c, h), bv = aff.bias(c, h);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * h + i;
          o[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(elem(xc[c], e), mu), rs), comp(sv, i)),
                           comp(bv, i));
        }
      }
      store8(y + off + c * 256, o);
    }
    if (next < N) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        xc[c] = xn[c];
        if constexpr (RESIDUAL) rc[c] = rn[c];
      }
    }
  }
}

template <typename E, int CH, bool RESIDUAL>
cudaError_t launch_variant(const E* x, const E* r, const float* scale, const float* bias, E* y,
                           float* stats, long long N, float eps, cudaStream_t s) {
  auto kernel = add_layer_norm_kernel<E, CH, RESIDUAL>;
  static int per_sm = 0;  // resident blocks an SM: one query a variant
  if (per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, 0);
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long blocks = (N + WARPS - 1) / WARPS;
  const long long full = (long long)per_sm * sms;
  kernel<<<(unsigned)(blocks < full ? blocks : full), WARPS * 32, 0, s>>>(x, r, scale, bias, y,
                                                                         stats, N, eps);
  return cudaGetLastError();
}

template <typename E, int CH>
cudaError_t launch(const E* x, const E* r, const float* scale, const float* bias, E* y,
                   float* stats, long long N, float eps, cudaStream_t s) {
  return r != nullptr ? launch_variant<E, CH, true>(x, r, scale, bias, y, stats, N, eps, s)
                      : launch_variant<E, CH, false>(x, r, scale, bias, y, stats, N, eps, s);
}

template <typename E>
int forward(const void* x, const void* r, const void* scale, const void* bias, void* y,
            void* stats, long long N, int H, float eps, void* stream) {
  if (N < 1 || H < 256 || H % 256 != 0 || H / 256 > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const E* x_ = static_cast<const E*>(x);
  const E* r_ = static_cast<const E*>(r);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  E* y_ = static_cast<E*>(y);
  float* st = static_cast<float*>(stats);
  switch (H / 256) {
    case 1: return (int)launch<E, 1>(x_, r_, sc, bi, y_, st, N, eps, s);
    case 2: return (int)launch<E, 2>(x_, r_, sc, bi, y_, st, N, eps, s);
    case 3: return (int)launch<E, 3>(x_, r_, sc, bi, y_, st, N, eps, s);
    case 4: return (int)launch<E, 4>(x_, r_, sc, bi, y_, st, N, eps, s);
    case 5: return (int)launch<E, 5>(x_, r_, sc, bi, y_, st, N, eps, s);
    case 6: return (int)launch<E, 6>(x_, r_, sc, bi, y_, st, N, eps, s);
    case 7: return (int)launch<E, 7>(x_, r_, sc, bi, y_, st, N, eps, s);
    default: return (int)launch<E, 8>(x_, r_, sc, bi, y_, st, N, eps, s);
  }
}

}  // namespace

// x, r (or null), y: (N, H) bf16, contiguous, 16-byte aligned; scale, bias:
// (H,) float32, 16-byte aligned.  H is a multiple of 256, at most 2048.
// stats (or null): (N, 2) float32, each row's mu and rstd, written when a
// gradient will be needed.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int add_layer_norm(const void* x, const void* r, const void* scale, const void* bias,
                              void* y, void* stats, long long N, int H, float eps,
                              void* stream) {
  return forward<__nv_bfloat16>(x, r, scale, bias, y, stats, N, H, eps, stream);
}

// The same with x, r and y float32 (MIXED_PRECISION False).
extern "C" int add_layer_norm_f32(const void* x, const void* r, const void* scale,
                                  const void* bias, void* y, void* stats, long long N, int H,
                                  float eps, void* stream) {
  return forward<float>(x, r, scale, bias, y, stats, N, H, eps, stream);
}

// ---------------------------------------------------------------------------
// Backward (K8b-bwd): what JAX derives by autodiff from _layer_norm(x + r).
// With g the cotangent of y (in E), mu and rstd from the forward's stats:
//
//   v   = f32(E(x + r)),  xh = (v - mu) * rstd,  gh = f32(g) * scale
//   dx  = E((gh - mean(gh) - xh * mean(gh * xh)) * rstd)    (= d r)
//   dscale = sum over rows of f32(g) * xh,   dbias = sum over rows of f32(g)
//
// dx is one tensor: the add's two operands share its cotangent.  A warp
// walks rows as in the forward and keeps the dscale and dbias partial sums
// of its lane's columns in registers; a block sums its warps' partials in
// a fixed order into one row of `partial` (blocks, 2, H), and a second
// launch sums those rows in block order: no float atomics, so a step gives
// the same bits every time.  Bytes bound it: x, r, g read and dx written,
// 4 * N * H * sizeof(E) bytes (134 MB in bf16 at 16,384 rows of 1024: 0.040
// ms at 3.35 TB/s; 268 MB, 0.080 ms in float32), plus the partial rows.

namespace {

template <typename E, int CH, bool RESIDUAL>
__global__ void __launch_bounds__(WARPS * 32)
add_layer_norm_bwd_kernel(const E* __restrict__ x, const E* __restrict__ r,
                          const E* __restrict__ g, const float* __restrict__ scale,
                          const float* __restrict__ stats, E* __restrict__ dx,
                          float* __restrict__ partial, long long N) {
  constexpr int H = 256 * CH;
  __shared__ float red[WARPS * H];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * WARPS;
  float dsc[CH * 8], dbi[CH * 8];
#pragma unroll
  for (int i = 0; i < CH * 8; ++i) dsc[i] = dbi[i] = 0.0f;
  const float4* sp = reinterpret_cast<const float4*>(scale) + 2 * lane;

  for (long long row = (long long)blockIdx.x * WARPS + warp; row < N; row += stride) {
    const size_t off = (size_t)row * H + lane * 8;
    Row8<E> xc[CH], gc[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      xc[c] = load8(x + off + c * 256);
      gc[c] = load8(g + off + c * 256);
      if constexpr (RESIDUAL) xc[c] = add8(xc[c], load8(r + off + c * 256));
    }
    const float mu = stats[2 * row], rs = stats[2 * row + 1];
    float a[8], b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = b[e] = 0.0f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 sv = __ldg(sp + 64 * c + h);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * h + i;
          const float xh = __fmul_rn(__fsub_rn(elem(xc[c], e), mu), rs);
          const float gf = elem(gc[c], e);
          const float gh = __fmul_rn(gf, comp(sv, i));
          a[e] = __fadd_rn(a[e], gh);
          b[e] = __fadd_rn(b[e], __fmul_rn(gh, xh));
          dsc[c * 8 + e] = __fadd_rn(dsc[c * 8 + e], __fmul_rn(gf, xh));
          dbi[c * 8 + e] = __fadd_rn(dbi[c * 8 + e], gf);
        }
      }
    }
    const float ma = __fdiv_rn(row_sum(a), (float)H), mb = __fdiv_rn(row_sum(b), (float)H);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float o[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 sv = __ldg(sp + 64 * c + h);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * h + i;
          const float xh = __fmul_rn(__fsub_rn(elem(xc[c], e), mu), rs);
          const float gh = __fmul_rn(elem(gc[c], e), comp(sv, i));
          o[e] = __fmul_rn(__fsub_rn(__fsub_rn(gh, ma), __fmul_rn(xh, mb)), rs);
        }
      }
      store8(dx + off + c * 256, o);
    }
  }

  // the block's partial sums: warps in order, dscale then dbias
  float* out = partial + (size_t)blockIdx.x * 2 * H;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[warp * H + (c * 32 + lane) * 8 + e] = part == 0 ? dsc[c * 8 + e] : dbi[c * 8 + e];
    __syncthreads();
    for (int col = threadIdx.x; col < H; col += WARPS * 32) {
      float s = red[col];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, red[w * H + col]);
      out[part * H + col] = s;
    }
  }
}

// out[col] = sum over blocks, in block order, of partial[block][col], for
// the 2H columns (dscale, then dbias)
__global__ void add_layer_norm_bwd_reduce(const float* __restrict__ partial, int blocks, int H2,
                                          float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= H2) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s = __fadd_rn(s, partial[(size_t)b * H2 + col]);
  out[col] = s;
}

template <typename E, int CH>
cudaError_t launch_bwd(const E* x, const E* r, const E* g, const float* scale,
                       const float* stats, E* dx, float* partial, float* dscale_dbias, int blocks,
                       long long N, cudaStream_t s) {
  constexpr int H = 256 * CH;
  if (r != nullptr)
    add_layer_norm_bwd_kernel<E, CH, true><<<blocks, WARPS * 32, 0, s>>>(x, r, g, scale, stats,
                                                                       dx, partial, N);
  else
    add_layer_norm_bwd_kernel<E, CH, false><<<blocks, WARPS * 32, 0, s>>>(x, r, g, scale, stats,
                                                                        dx, partial, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  add_layer_norm_bwd_reduce<<<(2 * H + 255) / 256, 256, 0, s>>>(partial, blocks, 2 * H,
                                                               dscale_dbias);
  return cudaGetLastError();
}

template <typename E>
int backward(const void* x, const void* r, const void* g, const void* scale, const void* stats,
             void* dx, void* partial, void* dscale_dbias, int blocks, long long N, int H,
             void* stream) {
  if (N < 1 || blocks < 1 || H < 256 || H % 256 != 0 || H / 256 > MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const E* x_ = static_cast<const E*>(x);
  const E* r_ = static_cast<const E*>(r);
  const E* g_ = static_cast<const E*>(g);
  const float* sc = static_cast<const float*>(scale);
  const float* st = static_cast<const float*>(stats);
  E* dx_ = static_cast<E*>(dx);
  float* pa = static_cast<float*>(partial);
  float* out = static_cast<float*>(dscale_dbias);
  switch (H / 256) {
    case 1: return (int)launch_bwd<E, 1>(x_, r_, g_, sc, st, dx_, pa, out, blocks, N, s);
    case 2: return (int)launch_bwd<E, 2>(x_, r_, g_, sc, st, dx_, pa, out, blocks, N, s);
    case 3: return (int)launch_bwd<E, 3>(x_, r_, g_, sc, st, dx_, pa, out, blocks, N, s);
    case 4: return (int)launch_bwd<E, 4>(x_, r_, g_, sc, st, dx_, pa, out, blocks, N, s);
    case 5: return (int)launch_bwd<E, 5>(x_, r_, g_, sc, st, dx_, pa, out, blocks, N, s);
    case 6: return (int)launch_bwd<E, 6>(x_, r_, g_, sc, st, dx_, pa, out, blocks, N, s);
    case 7: return (int)launch_bwd<E, 7>(x_, r_, g_, sc, st, dx_, pa, out, blocks, N, s);
    default: return (int)launch_bwd<E, 8>(x_, r_, g_, sc, st, dx_, pa, out, blocks, N, s);
  }
}

}  // namespace

// x, r (or null), g, dx: (N, H) bf16, contiguous, 16-byte aligned; scale
// (H,) float32, 16-byte aligned; stats (N, 2) float32 from the forward;
// partial: (blocks, 2, H) float32 scratch; dscale_dbias: (2, H) float32
// out.  `blocks` is the grid of the row kernel (any count >= 1: warps walk
// rows with its stride).  Two launches; returns the CUDA error (0 on
// success).
extern "C" int add_layer_norm_backward(const void* x, const void* r, const void* g,
                                       const void* scale, const void* stats, void* dx,
                                       void* partial, void* dscale_dbias, int blocks,
                                       long long N, int H, void* stream) {
  return backward<__nv_bfloat16>(x, r, g, scale, stats, dx, partial, dscale_dbias, blocks, N, H,
                                 stream);
}

// The same with x, r, g and dx float32 (MIXED_PRECISION False).
extern "C" int add_layer_norm_backward_f32(const void* x, const void* r, const void* g,
                                           const void* scale, const void* stats, void* dx,
                                           void* partial, void* dscale_dbias, int blocks,
                                           long long N, int H, void* stream) {
  return backward<float>(x, r, g, scale, stats, dx, partial, dscale_dbias, blocks, N, H, stream);
}
