// K7's masked mean pool in its first design, which the port no longer uses:
// one block a (64-column group, sequence), 8 warps each walking every 8th
// valid row of the sequence with a 4-byte bf16 pair a lane, the warps added
// in order, then the division (masked_conv.cuh: seq_col_sums_kernel<true>,
// which dW's dbias still uses as seq_col_sums_kernel<false>).  Kept as it
// was for chip_variants.py --k7-pool, which times it against the kept pool
// (csrc/masked_pool.cu) in turns; its entry point keeps its first
// signature.

#include "../masked_conv.cuh"

// out (B, C) float32 from x (B, T) rows at `pitch`.
extern "C" int masked_mean_pool(const void* x, const void* lengths, void* out, int B, int T,
                                int C, int pitch, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || pitch < C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((C + k7::SUM_COLS - 1) / k7::SUM_COLS, B);
  k7::seq_col_sums_kernel<true><<<grid, k7::SUM_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(lengths),
      static_cast<float*>(out), T, C, pitch);
  return static_cast<int>(cudaGetLastError());
}
