// K7's forward for Hopper (sm_90a): the ProteInfer encoder's masked dilated
// conv and its masked mean pool.
//
// Replaces the TPU op chain protnote_tpu/models/proteinfer.py:_masked_conv
// (line 127) as proteinfer_embed (line 147) chains it: `x * mask`, a "same"
// dilated conv with float32 accumulation rounded to bf16, `+ bias` in bf16,
// `* mask`, eval-mode BatchNorm + ReLU in front of the block convs, the
// residual add, and the masked mean pool.
//
// masked_conv_forward is an implicit GEMM (masked_conv.cuh): rows are the
// (b, t) positions, K is taps x C_in, N is C_out, and A's rows are read at
// t + dilation * (j - half) with zeros outside [0, length).  Its optional
// prologue applies eval-mode BN (per-channel inv/shift), ReLU and then the
// mask to each loaded input value, in that order (BN is not folded into the
// weights: a padded position must read 0, not relu(shift)); its epilogue
// rounds the accumulator to bf16, adds the bias with a second rounding,
// applies the output mask and optionally adds the residual with a third.
// A block skips the taps whose rows all fall outside the valid range (at
// dilation 81 the taps reach +-324 positions) and the tiles past the
// sequence's length.
//
// What bounds it: operations.  At the default width a 32-sequence batch at
// bucket 512 is 998 GFLOP of bf16 products, about 1.0 ms at 989 TFLOP/s;
// the activations it moves are ~36 MB a conv.  mma.sync reaches a part of
// the card's rate only (wgmma and TMA are later work).
//
// masked_mean_pool: the float32 column sums of each sequence's valid rows in
// a fixed order, divided by max(length, 1) (a row of length 0 gives 0).

#include "masked_conv.cuh"

extern "C" int masked_conv_forward(const void* x, const void* w, const void* bias,
                                   const void* bn_inv, const void* bn_shift,
                                   const void* residual, const void* lengths, void* y, int B,
                                   int T, int cin, int cout, int taps, int dilation,
                                   void* stream) {
  if (B <= 0 || T <= 0 || cin <= 0 || cout <= 0 || taps <= 0 || dilation <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((cout + k7::BN - 1) / k7::BN, k7::conv_rows_grid_y(B, T));
  k7::conv_rows_kernel<false><<<grid, k7::THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const float*>(bn_inv),
      static_cast<const float*>(bn_shift), static_cast<const __nv_bfloat16*>(residual),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(y), T, cin, cout, taps,
      dilation);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int masked_mean_pool(const void* x, const void* lengths, void* out, int B, int T,
                                int C, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((C + k7::SUM_COLS - 1) / k7::SUM_COLS, B);
  k7::seq_col_sums_kernel<true><<<grid, k7::SUM_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(lengths),
      static_cast<float*>(out), T, C);
  return static_cast<int>(cudaGetLastError());
}
