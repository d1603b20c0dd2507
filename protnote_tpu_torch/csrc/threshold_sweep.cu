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
// * threshold_sweep_codes, one launch a batch: each element's slot code,
//   uint16: k in the sorted thresholds (shared memory) plus T + 1 for a
//   negative, 0xffff for a masked row, into a ring of the last batches'
//   codes (ops/threshold_sweep.py: SweepCounter, RING_ROWS rows).  A table
//   of BUCKETS + 2 counts, tab[i] = #{th < i / BUCKETS}, built by each
//   block, gives k's range for p in [i / BUCKETS, (i + 1) / BUCKETS) in one
//   lookup; a binary search finishes it inside that range (no step for the
//   CLI's 99 thresholds: at most one threshold a bucket).
// * threshold_sweep_flush, once the ring is full and before the counts are
//   read: the histogram over k in [0, T] of every label's positives and
//   negatives, 2 x (T + 1) x L int32 (25.7 MB at T = 99 and L = 32,102,
//   which the 50 MB L2 holds), gains the ring's rows.  A block owns
//   COLS = 128 label columns over all the ring's rows and counts them in
//   shared memory first, a byte a (slot, column): word w of a slot's 32
//   words holds columns w, w + 32, w + 64, w + 96, so the 32 lanes of a
//   warp, on 32 consecutive columns, add to 32 banks.  Then the nonzero
//   counts go to the histogram, a warp a slot, one fire-and-forget
//   atomicAdd of 32 consecutive columns an instruction.  The state is
//   touched once a (slot, 8-column sector) for all the ring's rows, not
//   once an element (the first design: ~1 M scattered L2 reductions a
//   batch) nor once a batch: with 256 rows the sectors a flush touches are
//   dense.  The block owns its columns, so the adds meet no other block's;
//   the sums are integers, so any order and any flush point give the same
//   histogram.  A byte counts at most CHUNK_ROWS rows: more are counted and
//   added a chunk at a time.  Where 2 (T + 1) slots of 128 bytes pass
//   SLOT_BYTES, the slots are cut into ranges, blockIdx.y a range, each
//   reading the codes again (T > 383: ops/threshold_sweep.py:flush_plan).
// * threshold_sweep_finalize, once an evaluation: one thread a label walks
//   k from T down and writes the suffix sums tp[i] = sum_{k > i} pos_k,
//   fp[i] = sum_{k > i} neg_k and fn[i] = P - tp[i] (P = sum_k pos_k) in the
//   JAX (T, L) layout and the thresholds' original order.
//
// What bounds it: bytes.  A batch's update is bound by reading the logits
// and targets once and reading and writing one state word a valid element
// (16 MB at full width, 0.0048 ms at 3.35 TB/s; the L2 moves 32-byte
// sectors, so a word alone in its sector moves eight times its bytes
// there); the codes cost 2 bytes an element written and read once more;
// finalize reads the 25.7 MB state and writes the 38.1 MB of counts
// (0.019 ms).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sigmoid.cuh"

namespace {

constexpr int CODE_THREADS = 1024;   // a codes block: 4,096 columns of one row
constexpr int FLUSH_THREADS = 1024;  // 32 warps: 4 column groups x 8 row phases
constexpr int COLS = 128;            // label columns of a flush block
constexpr int ROW_PHASES = FLUSH_THREADS / COLS;
constexpr int LOADS = 4;             // rows a thread loads before it counts them
constexpr uint32_t NO_SLOT = 0xffff; // the code of a masked row's element
constexpr int CHUNK_ROWS = 255;      // rows a byte counts before a flush
constexpr int BUCKETS = 1024;        // probability buckets of the threshold table
constexpr int SLOT_BYTES = 96 * 1024;  // counts of a flush block: 768 slots of 128 bytes
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

// #{i : th[i] < v} over ascending th[0..T).
__device__ __forceinline__ int count_below(const float* th, int T, float v) {
  int lo = 0, n = T;
  while (n > 0) {
    const int half = n >> 1;
    if (th[lo + half] < v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// k = #{th <= p} through the bucket table (tab[BUCKETS + 1] = T): p lies in
// [0, 1] (a sigmoid) or is NaN (k = 0, as every compare is false).
__device__ __forceinline__ int threshold_count(const float* th, const int* tab, float p) {
  if (p != p) return 0;
  const int i = min(static_cast<int>(p * static_cast<float>(BUCKETS)), BUCKETS);
  const int lo = tab[i];
  return lo + count_at_or_below(th + lo, tab[i + 1] - lo, p);
}

// Block (x, b): columns [4 * (1024 x + i), + 4) of row b, thread i: each
// valid element's slot (k, past T + 1 for a negative), NO_SLOT for a masked
// row, as uint16 codes into codes[b * pitch + c].  The row's loads go out before
// the block sets up the thresholds and the bucket table in shared memory.
template <bool VEC>
__global__ void __launch_bounds__(CODE_THREADS)
sweep_codes_kernel(const float* __restrict__ logits, const float* __restrict__ labels,
                   const float* __restrict__ mask, const float* __restrict__ sorted_th, int Lb,
                   int L, int T, int pitch, uint16_t* __restrict__ codes) {
  __shared__ float s_th[MAX_THRESHOLDS];
  __shared__ int s_tab[BUCKETS + 2];
  const int b = blockIdx.y;
  const int c0 = 4 * (blockIdx.x * CODE_THREADS + threadIdx.x);
  const bool valid = __ldg(mask + b) > 0.0f;
  const float* xr = logits + static_cast<size_t>(b) * Lb + c0;
  const float* yr = labels + static_cast<size_t>(b) * Lb + c0;
  float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid && VEC && c0 + 3 < L) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(xr));
    const float4 yv = __ldg(reinterpret_cast<const float4*>(yr));
    x[0] = xv.x, x[1] = xv.y, x[2] = xv.z, x[3] = xv.w;
    y[0] = yv.x, y[1] = yv.y, y[2] = yv.z, y[3] = yv.w;
  } else if (valid) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = c0 + j < L ? __ldg(xr + j) : 0.f;
      y[j] = c0 + j < L ? __ldg(yr + j) : 0.f;
    }
  }
  for (int i = threadIdx.x; i < T; i += CODE_THREADS) s_th[i] = sorted_th[i];
  __syncthreads();
  for (int i = threadIdx.x; i <= BUCKETS + 1; i += CODE_THREADS)
    s_tab[i] = i <= BUCKETS ? count_below(s_th, T, static_cast<float>(i) / BUCKETS) : T;
  __syncthreads();
  if (c0 >= L) return;
  uint32_t w[2] = {0xffffffffu, 0xffffffffu};  // NO_SLOT
  if (valid) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t slot = (y[j] > 0.0f ? 0 : T + 1) + threshold_count(s_th, s_tab, prob_of(x[j]));
      w[j >> 1] = (w[j >> 1] & ~(0xffffu << (16 * (j & 1)))) | (slot << (16 * (j & 1)));
    }
  }
  uint16_t* o = codes + static_cast<size_t>(b) * pitch + c0;
  if (c0 + 3 < L && (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
    *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
  } else {
    for (int j = 0; j < 4 && c0 + j < L; ++j) o[j] = static_cast<uint16_t>(w[j >> 1] >> (16 * (j & 1)));
  }
}

// Block (x, y): columns [128x, 128x + 128) and slots [y * range, (y + 1) *
// range) of the histogram, over `rows` rows of codes (`pitch` apart).  Warp w counts column
// group w % 4 (32 columns, a lane each) on rows w / 4, w / 4 + 8, ...; the
// rows' code loads go out before the counts are zeroed.  Shared memory holds
// `range` slots of 32 count words.
__global__ void __launch_bounds__(FLUSH_THREADS)
sweep_flush_kernel(const uint16_t* __restrict__ codes, int rows, int L, int pitch, int T,
                   int range, int* __restrict__ hist) {
  extern __shared__ uint32_t s_cnt[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp & 3, phase = warp >> 2;
  const int c = blockIdx.x * COLS + group * 32 + lane;
  const bool col_ok = c < L;
  const int s0 = blockIdx.y * range;
  const int slots = min(range, 2 * (T + 1) - s0);
  const uint32_t one = 1u << (8 * group);
  uint32_t code[LOADS];
  // rows first, first + 8, ... of the chunk ending at end into code
  auto load_rows = [&](int first, int end) {
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int b = first + u * ROW_PHASES;
      code[u] = col_ok && b < end ? __ldg(codes + static_cast<size_t>(b) * pitch + c) : NO_SLOT;
    }
  };
  int r0 = 0, r1 = min(rows, CHUNK_ROWS), b0 = phase;
  load_rows(b0, r1);  // in flight while the counts are zeroed
  for (int i = threadIdx.x; i < slots * 32; i += FLUSH_THREADS) s_cnt[i] = 0u;
  __syncthreads();
  for (;;) {
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int slot = static_cast<int>(code[u]) - s0;  // NO_SLOT lands past every range
      if (slot >= 0 && slot < slots) atomicAdd(s_cnt + slot * 32 + lane, one);
    }
    b0 += ROW_PHASES * LOADS;
    if (b0 < r1) {
      load_rows(b0, r1);
      continue;
    }
    __syncthreads();  // every count of the chunk is in
    // a warp a slot: lane l holds columns l + 32j (byte j) of the block
    for (int slot = warp; slot < slots; slot += FLUSH_THREADS / 32) {
      const uint32_t w = s_cnt[slot * 32 + lane];
      if (__ballot_sync(0xffffffffu, w != 0u) == 0u) continue;
      int* row = hist + static_cast<size_t>(s0 + slot) * L + blockIdx.x * COLS + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = (w >> (8 * j)) & 0xff;
        if (n != 0 && blockIdx.x * COLS + 32 * j + lane < L) atomicAdd(row + 32 * j, n);
      }
    }
    r0 += CHUNK_ROWS;
    if (r0 >= rows) break;
    r1 = min(rows, r0 + CHUNK_ROWS);
    b0 = r0 + phase;
    load_rows(b0, r1);
    __syncthreads();  // the counts are read before they are zeroed for the next chunk
    for (int i = threadIdx.x; i < slots * 32; i += FLUSH_THREADS) s_cnt[i] = 0u;
    __syncthreads();
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

// One batch's slot codes: logits/labels (B, Lb) f32, mask (B,) f32,
// sorted_th (T,) f32 ascending, codes (B, L) uint16 rows `pitch` apart
// (columns c >= L are dropped).  Returns a cudaError_t.
extern "C" int threshold_sweep_codes(const void* logits, const void* labels, const void* mask,
                                     const void* sorted_th, int B, int Lb, int L, int T,
                                     int pitch, void* codes, void* stream) {
  if (B <= 0 || B > 65535 || Lb <= 0 || L <= 0 || L > Lb || T <= 0 || T > MAX_THRESHOLDS ||
      pitch < L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((L + 4 * CODE_THREADS - 1) / (4 * CODE_THREADS), B);
  const bool vec = Lb % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(labels) % 16 == 0;
  const auto* lg = static_cast<const float*>(logits);
  const auto* lb = static_cast<const float*>(labels);
  const auto* mk = static_cast<const float*>(mask);
  const auto* th = static_cast<const float*>(sorted_th);
  auto* out = static_cast<uint16_t*>(codes);
  if (vec)
    sweep_codes_kernel<true><<<grid, CODE_THREADS, 0, s>>>(lg, lb, mk, th, Lb, L, T, pitch, out);
  else
    sweep_codes_kernel<false><<<grid, CODE_THREADS, 0, s>>>(lg, lb, mk, th, Lb, L, T, pitch, out);
  return (int)cudaGetLastError();
}

// `rows` rows of codes (rows, L), `pitch` apart, into hist 2 * (T + 1) * L int32 (positives,
// then negatives; slot-major: hist[slot * L + c]).  `range`: the slots a
// block counts (2 * (T + 1) when they fit its shared memory;
// ops/threshold_sweep.py:flush_plan).  Returns a cudaError_t.
extern "C" int threshold_sweep_flush(const void* codes, int rows, int L, int pitch, int T,
                                     int range, void* hist, void* stream) {
  if (rows <= 0 || L <= 0 || pitch < L || T <= 0 || T > MAX_THRESHOLDS || range <= 0 ||
      range * 128 > SLOT_BYTES)
    return (int)cudaErrorInvalidValue;
  const int ranges = (2 * (T + 1) + range - 1) / range;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((L + COLS - 1) / COLS, ranges);
  const size_t smem = 128 * static_cast<size_t>(range);
  if (smem > 48 * 1024) {  // past the default limit (T > 191): the thread's device allows it
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_flush_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return (int)err;
  }
  sweep_flush_kernel<<<grid, FLUSH_THREADS, smem, s>>>(static_cast<const uint16_t*>(codes),
                                                       rows, L, pitch, T, range,
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
