// K7's forward for Hopper (sm_90a): the ProteInfer encoder's masked dilated
// conv (its masked mean pool is csrc/masked_pool.cu).
//
// Replaces the TPU op chain protnote_tpu/models/proteinfer.py:_masked_conv
// (line 127) as proteinfer_embed (line 147) chains it: `x * mask`, a "same"
// dilated conv with float32 accumulation rounded to bf16, `+ bias` in bf16,
// `* mask`, eval-mode BatchNorm + ReLU in front of the block convs, the
// residual add.
//
// masked_conv_forward is an implicit GEMM on TMA + wgmma (masked_conv.cuh):
// rows are the (b, t) positions, K is taps x C_in, N is C_out, and A's rows
// are read at t + dilation * (j - half), formed in registers with zeros
// outside [0, length).  Its optional prologue applies eval-mode BN
// (per-channel inv/shift), ReLU and then the mask to each input value, in
// that order (BN is not folded into the weights: a padded position must read
// 0, not relu(shift)); its epilogue rounds the accumulator to bf16, adds the
// bias with a second rounding, applies the output mask and optionally adds
// the residual with a third.  A tile skips the taps whose rows all fall
// outside the valid range (at dilation 81 the taps reach +-324 positions);
// row tiles past a sequence's length only write zeros or the residual.  The
// input is read at its row pitch (a multiple of 8 channels), the output
// written at its own; the weights come re-laid as (taps, C_out rounded up to
// 184, C_in rounded up to 64), W[j] transposed and zero-padded.
//
// What bounds it: operations.  At the default width a 32-sequence batch at
// bucket 512 is 478 GFLOP of bf16 products for these lengths (998 padded),
// 0.48 ms at 989 TFLOP/s.  The 11 convs take about 1.8 ms on an H100 80GB
// HBM3 at 700 W (chip_smoke.py phase 4; cuDNN's conv1d calls ~3.4 ms):
// - whole 128-row tiles, whole taps and K padded to 64 compute a third more
//   products than these lengths need (conv1 3.8 times its own);
// - a dilated conv's mainloop runs at ~530 TFLOP/s without the prologue
//   and ~370 with it (chip_variants.py --k7): the BN arithmetic on every A
//   element is repeated for each tap and each column tile, and the K steps
//   are fed from L2 (~75 FLOP a byte of stage);
// - the 1 x 1 convs (9 K steps a tile) are bound by tile waves and their
//   epilogues, conv1 by its 20 channels in a 64-deep step.
// Next: apply BN + ReLU once, in the epilogue of the conv that produces
// the input, as a second output.

#include "masked_conv.cuh"

// y (B, T) rows at y_pitch, bf16, from x (B, T) rows at x_pitch (a multiple
// of 8), the re-laid weights wt (taps, n_pad, k_pad), bias (cout,), the
// optional prologue's bn_inv and bn_shift (cin,) float32 (both or neither)
// and residual (B, T) rows at res_pitch, and the plan's `tiles` tile codes;
// `grid` persistent blocks.  Returns a CUDA error (0 on success).
extern "C" int masked_conv_forward(const void* x, const void* wt, const void* bias,
                                   const void* bn_inv, const void* bn_shift, const void* residual,
                                   const void* lengths, const void* plan, void* y, int B, int T,
                                   int cin, int cout, int x_pitch, int y_pitch, int res_pitch,
                                   int k_pad, int n_pad, int taps, int dilation, int tiles,
                                   int grid, void* stream) {
  k7::ConvArgs a{};
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.bn_inv = static_cast<const float*>(bn_inv);
  a.bn_shift = static_cast<const float*>(bn_shift);
  a.residual = static_cast<const __nv_bfloat16*>(residual);
  a.lengths = static_cast<const int*>(lengths);
  a.plan = static_cast<const int*>(plan);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B, a.T = T, a.K = cin, a.N = cout, a.k_pad = k_pad, a.n_pad = n_pad, a.taps = taps;
  a.dilation = dilation, a.y_pitch = y_pitch, a.res_pitch = res_pitch, a.tiles = tiles;
  const bool prologue = bn_inv != nullptr || bn_shift != nullptr;
  return k7::conv_launch(prologue ? k7::FWD_BN : k7::FWD, x, x_pitch, wt, a, grid, stream);
}
