// The split of a float32 value into three bf16 pieces that the float32 pair
// kernels (pair_scorer_f32.cu: K1 and K4 in float32; pair_train_bwd_f32.cu:
// K4-bwd in float32) feed to the bf16 tensor cores: x = x0 + x1 + x2
// exactly, each piece the previous remainder rounded to nearest, each
// remainder an exact float32 subtraction.  ops/pair_scorer.py:split_bf16x3
// is the same split on the host (W's pieces), and the CPU tests emulate the
// products with it.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x (two adjacent elements) as three packed bf16 pairs, the first element in
// the low half of each
__device__ __forceinline__ void split3(float2 x, uint32_t& p0, uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 b0 = __floats2bfloat162_rn(x.x, x.y);
  const float2 f0 = __bfloat1622float2(b0);
  const float2 r1 = make_float2(__fsub_rn(x.x, f0.x), __fsub_rn(x.y, f0.y));
  const __nv_bfloat162 b1 = __floats2bfloat162_rn(r1.x, r1.y);
  const float2 f1 = __bfloat1622float2(b1);
  const __nv_bfloat162 b2 = __floats2bfloat162_rn(__fsub_rn(r1.x, f1.x), __fsub_rn(r1.y, f1.y));
  p0 = bits_of(b0);
  p1 = bits_of(b1);
  p2 = bits_of(b2);
}

// The forward's first activation relu(a + c), rounded once: the expression
// K4's float32 forward forms and its backward gates on
__device__ __forceinline__ float pair_relu(float a, float c) {
  return fmaxf(__fadd_rn(a, c), 0.f);
}

}  // namespace
