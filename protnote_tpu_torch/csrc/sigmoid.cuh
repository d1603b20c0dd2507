// The probability of a logit, shared by the eval accumulator (K3) and the
// threshold-sweep counter (K9).
//
// XLA lowers jax.nn.sigmoid (lax.logistic) to 1 / (1 + exp(-x)) in float32,
// and the JAX eval accumulator and sweep both compute it so.  Here expf is the
// accurate CUDA exponential and the division is IEEE; XLA's and CUDA's
// exponentials may differ by an ulp, so an element within an ulp of a bin
// edge or of a threshold may land on the other side.
#pragma once

__device__ __forceinline__ float prob_of(float x) {
  return 1.0f / (1.0f + expf(-x));
}
