// K9's update in its first design, which the port no longer uses: a block
// is 256 label columns x ROWS_PER_THREAD rows, and every valid element adds
// one to its (slot, column) word of the histogram with its own atomicAdd in
// L2 (about a million a 32 x 32,102 batch).  Kept as it was, finalize
// included, for chip_variants.py --k9-update, which times it against the
// kept update (csrc/threshold_sweep.cu) in turns and checks that both give
// the same histogram; its entry points keep their first signatures.
//
// Decision-threshold sweep counter (K9) for Hopper (sm_90a): per-label
// tp/fp/fn at each of T candidate thresholds, over every batch of an
// evaluation.
//
// Replaces protnote_tpu/train/trainer.py:_sweep_count_fn (line 1117), which
// runs lax.map over the thresholds of a (B, L) compare-reduce:
//
//   p = sigmoid(logit),  t = label > 0,  valid = mask[b] > 0
//   pred_i = p >= th_i && valid
//   tp[i, c] += pred_i && t,  fp[i, c] += pred_i && !t,
//   fn[i, c] += !pred_i && t && valid
//
// for the columns c < L (label padding past L is dropped), with p computed as
// 1 / (1 + expf(-x)) (sigmoid.cuh), which is what XLA makes of jax.nn.sigmoid.
//
// The XLA form reads the batch once a threshold: 99 passes over 8.2 MB of
// logits and targets at B = 32 and 32,102 labels.  Here nothing is compared
// T times.  The wrapper sorts the thresholds once (a stable argsort).  Sorted
// ascending, {i : p >= th_i} is a prefix of length k = #{th <= p}, so pred_i
// holds iff i < k (in sorted order; a NaN p gives k = 0, as the compare
// does, and equal thresholds give equal counts).  So:
//
// * threshold_sweep_update, one launch a batch: each valid element finds k
//   by a binary search over the sorted thresholds in shared memory (7 steps
//   for 99) and adds one to a per-label histogram over k in [0, T], of its
//   positives or of its negatives.  The state is 2 x (T + 1) x L int32
//   (25.7 MB at T = 99 and L = 32,102), which the 50 MB L2 holds; the adds
//   are atomics whose result is unused (fire-and-forget reductions), exact
//   in any order.  A block is 256 label columns x ROWS_PER_THREAD rows, every
//   load of a thread issued before its first add, as in K3's update.
// * threshold_sweep_finalize, once an evaluation: one thread a label walks
//   k from T down and writes the suffix sums tp[i] = sum_{k > i} pos_k,
//   fp[i] = sum_{k > i} neg_k and fn[i] = P - tp[i] (P = sum_k pos_k) in the
//   JAX (T, L) layout and the thresholds' original order.
//
// What bounds it: bytes.  An update reads the logits and targets once and
// reads and writes one state word a valid element (16 MB at full width,
// 0.005 ms at 3.35 TB/s); finalize reads the 25.7 MB state and writes the
// 38.1 MB of counts (0.019 ms).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sigmoid.cuh"

namespace {

constexpr int SWEEP_THREADS = 256;
constexpr int ROWS_PER_THREAD = 4;
constexpr int MAX_THRESHOLDS = 1024;
constexpr int FINALIZE_THREADS = 256;

// #{i : th[i] <= p} over ascending th[0..T); 0 for a NaN p.
__device__ __forceinline__ int count_at_or_below(const float* th, int T, float p) {
  int lo = 0, n = T;
  while (n > 0) {
    const int half = n >> 1;
    if (th[lo + half] <= p) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
sweep_update_kernel(const float* __restrict__ logits, const float* __restrict__ labels,
                    const float* __restrict__ mask, const float* __restrict__ sorted_th,
                    int B, int Lb, int L, int T, int* hist) {
  __shared__ float s_th[MAX_THRESHOLDS];
  for (int i = threadIdx.x; i < T; i += blockDim.x) s_th[i] = sorted_th[i];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b0 = blockIdx.y * ROWS_PER_THREAD;
  bool ok[ROWS_PER_THREAD];
  float x[ROWS_PER_THREAD], y[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int b = b0 + r;
    ok[r] = c < L && b < B && mask[b] > 0.0f;
    const size_t off = (size_t)b * Lb + c;
    x[r] = ok[r] ? logits[off] : 0.0f;
    y[r] = ok[r] ? labels[off] : 0.0f;
  }
  __syncthreads();  // s_th is loaded
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    if (!ok[r]) continue;
    const int k = count_at_or_below(s_th, T, prob_of(x[r]));
    const int slot = (y[r] > 0.0f ? 0 : T + 1) + k;
    atomicAdd(hist + ((size_t)slot * L + c), 1);
  }
}

__global__ void __launch_bounds__(FINALIZE_THREADS)
sweep_finalize_kernel(const int* __restrict__ hist, const int* __restrict__ order, int L,
                      int T, int* tp, int* fp, int* fn) {
  __shared__ int s_order[MAX_THRESHOLDS];
  for (int i = threadIdx.x; i < T; i += blockDim.x) s_order[i] = order[i];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= L) return;
  const int* pos = hist;
  const int* neg = hist + (size_t)(T + 1) * L;
  int n_pos = 0;
  for (int k = 0; k <= T; ++k) n_pos += pos[(size_t)k * L + c];
  int s_pos = 0, s_neg = 0;
  for (int i = T - 1; i >= 0; --i) {
    s_pos += pos[(size_t)(i + 1) * L + c];
    s_neg += neg[(size_t)(i + 1) * L + c];
    const size_t o = (size_t)s_order[i] * L + c;
    tp[o] = s_pos;
    fp[o] = s_neg;
    fn[o] = n_pos - s_pos;
  }
}

}  // namespace

// One batch into the histogram.  logits/labels (B, Lb) f32, mask (B,) f32,
// sorted_th (T,) f32 ascending, hist 2 * (T + 1) * L int32 (positives, then
// negatives; slot-major: hist[slot * L + c]); columns c >= L are dropped.
// Returns a cudaError_t.
extern "C" int threshold_sweep_update(const void* logits, const void* labels,
                                      const void* mask, const void* sorted_th, int B,
                                      int Lb, int L, int T, void* hist, void* stream) {
  if (B <= 0 || Lb <= 0 || L <= 0 || L > Lb || T <= 0 || T > MAX_THRESHOLDS)
    return (int)cudaErrorInvalidValue;
  const int row_groups = (B + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD;
  if (row_groups > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((L + SWEEP_THREADS - 1) / SWEEP_THREADS, row_groups);
  sweep_update_kernel<<<grid, SWEEP_THREADS, 0, s>>>(
      static_cast<const float*>(logits), static_cast<const float*>(labels),
      static_cast<const float*>(mask), static_cast<const float*>(sorted_th), B, Lb, L, T,
      static_cast<int*>(hist));
  return (int)cudaGetLastError();
}

// The (T, L) int32 tp/fp/fn of the histogram, row order[i] holding sorted
// threshold i's counts (order: the stable argsort of the thresholds).
extern "C" int threshold_sweep_finalize(const void* hist, const void* order, int L, int T,
                                        void* tp, void* fp, void* fn, void* stream) {
  if (L <= 0 || T <= 0 || T > MAX_THRESHOLDS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  sweep_finalize_kernel<<<(L + FINALIZE_THREADS - 1) / FINALIZE_THREADS, FINALIZE_THREADS,
                          0, s>>>(static_cast<const int*>(hist),
                                  static_cast<const int*>(order), L, T,
                                  static_cast<int*>(tp), static_cast<int*>(fp),
                                  static_cast<int*>(fn));
  return (int)cudaGetLastError();
}
