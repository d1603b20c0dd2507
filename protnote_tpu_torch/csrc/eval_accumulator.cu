// On-device evaluation accumulator (K3) for Hopper (sm_90a): confusion
// counts, samplewise sums and per-label binned-AUPRC histograms of one eval
// batch, then the per-label, micro and macro average precision.
//
// Replaces the TPU op chain protnote_tpu/evaln/metrics.py:
// DeviceEvalAccumulator.update_fn (the batch update) and
// finalize_into._finalize (AP from the histograms), whose scatter form is
// BinnedAUPRC.device_update.  State layout is the JAX one: tp/fp/fn (L,)
// int32; hist 2 * L * nb int32, the positive histograms of all labels first,
// then the negative ones; the scalar sums.  For a batch of B rows and Lb
// columns, with p = 1 / (1 + expf(-logit)) in f32 and
//
//   valid = example_mask[b] > 0 && label_mask[c] > 0
//   t     = target[b, c] > 0 && valid,    pred = p >= th && valid
//
// each valid element adds one to hist[(t ? row : L + row) * nb + bin] with
// bin = clip(int(p * nb), 0, nb - 1), and to tp/fp/fn of its row.  The TPU
// computed the histogram as a dense (B, L, nb) compare-reduce with pos and
// valid packed into one int32, to keep scatters off its vector unit; here
// each thread owns one label column and writes its bins directly.
//
// What bounds it: memory.  The update reads B * Lb logits and targets (8 MB
// at B = 32, Lb = 32,102) and read-modify-writes one histogram word per
// valid element; finalize reads the 131 MB of histograms once.  Both are a
// few tens of microseconds at 3.35 TB/s, small next to the forward pass
// that produces the logits (hundreds of ms).  The design is the simple one:
//
// * eval_acc_update: one thread per label column, looping over the B rows,
//   so reads of logits[b, c] coalesce across a warp.  tp/fp/fn stay in
//   registers.  Without `cols` (the batch's columns are state rows
//   0..Lb-1) only that thread touches its column's counters and histogram
//   rows, so it writes them without atomics.  With `cols` (a label subset)
//   two columns may name one state row (the JAX cols_for pads a subset with
//   row 0), so that path uses atomicAdd for every state write; columns with
//   label_mask 0 contribute nothing and are skipped.  Per-row sums (tp_row,
//   pred_row, t_row) are warp ballots, summed per block in shared memory
//   and added to a (B, 3) int32 scratch with atomicAdd.
// * eval_acc_row_tail: one block folds the (B, 3) scratch into the
//   samplewise precision/recall sums (f32) and counts.
// * eval_acc_finalize: one block per label (grid-stride) scans the label's
//   nb bins from the top bin down as integers and reduces AP in f32; the
//   same pass adds each bin's counts into 64-bit label-axis sums (integers,
//   exact; the JAX code sums in f32).  A one-block tail computes micro AP
//   from those sums and the macro mean over labels with positives (NaN when
//   there are none).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int UPDATE_THREADS = 256;
constexpr int ROW_CHUNK = 32;   // batch rows per shared-memory row-sum pass
constexpr int MAX_BINS = 1024;  // one thread per bin in the finalize blocks
constexpr int FINALIZE_BLOCKS = 1056;  // 8 per SM on 132 SMs, grid-stride

__device__ __forceinline__ float prob_of(float x) {
  return 1.0f / (1.0f + expf(-x));  // accurate expf, IEEE division
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the result.  `smem` holds 32 T.
template <typename T>
__device__ T block_sum(T v, T* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? smem[lane] : T(0);
    w = warp_sum(w);
    if (lane == 0) smem[0] = w;
  }
  __syncthreads();
  const T out = smem[0];
  __syncthreads();
  return out;
}

// Inclusive prefix sum over the block in thread order; `total` gets the
// block's sum.  `smem` holds 32 T.
template <typename T>
__device__ T block_inclusive_scan(T v, T* smem, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? smem[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    __syncwarp();
    smem[lane] = w;
  }
  __syncthreads();
  const T out = v + (warp > 0 ? smem[warp - 1] : T(0));
  *total = smem[nwarps - 1];
  __syncthreads();
  return out;
}

template <bool SCATTER>
__global__ void __launch_bounds__(UPDATE_THREADS)
update_kernel(const float* __restrict__ logits, const float* __restrict__ targets,
              const float* __restrict__ example_mask,
              const float* __restrict__ label_mask, const int* __restrict__ cols,
              int B, int Lb, int L, int nb, float th, int* tp, int* fp, int* fn,
              int* hist, int* row_counts) {
  __shared__ int s_rows[ROW_CHUNK * 3];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // every thread runs every loop (the ballots need whole warps); columns
  // past Lb or with label_mask 0 are simply never valid
  const bool col_ok = c < Lb && label_mask[c] > 0.0f;
  const int row = col_ok ? (SCATTER ? cols[c] : c) : 0;
  int tp_c = 0, fp_c = 0, fn_c = 0;
  for (int b0 = 0; b0 < B; b0 += ROW_CHUNK) {
    const int nr = min(ROW_CHUNK, B - b0);
    if (threadIdx.x < ROW_CHUNK * 3) s_rows[threadIdx.x] = 0;
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const int b = b0 + r;
      bool t = false, pred = false;
      if (col_ok && example_mask[b] > 0.0f) {
        const size_t off = (size_t)b * Lb + c;
        const float p = prob_of(logits[off]);
        t = targets[off] > 0.0f;
        pred = p >= th;
        const int bin = min(max((int)(p * (float)nb), 0), nb - 1);
        int* h = hist + ((size_t)(t ? row : L + row) * nb + bin);
        if (SCATTER) atomicAdd(h, 1); else *h += 1;
        tp_c += pred && t;
        fp_c += pred && !t;
        fn_c += !pred && t;
      }
      const unsigned tp_bits = __ballot_sync(0xffffffffu, pred && t);
      const unsigned pred_bits = __ballot_sync(0xffffffffu, pred);
      const unsigned t_bits = __ballot_sync(0xffffffffu, t);
      if (lane == 0) {
        if (tp_bits) atomicAdd(&s_rows[3 * r], __popc(tp_bits));
        if (pred_bits) atomicAdd(&s_rows[3 * r + 1], __popc(pred_bits));
        if (t_bits) atomicAdd(&s_rows[3 * r + 2], __popc(t_bits));
      }
    }
    __syncthreads();
    if (threadIdx.x < nr * 3 && s_rows[threadIdx.x])
      atomicAdd(&row_counts[3 * b0 + threadIdx.x], s_rows[threadIdx.x]);
    __syncthreads();
  }
  if (!col_ok) return;
  if (SCATTER) {
    if (tp_c) atomicAdd(&tp[row], tp_c);
    if (fp_c) atomicAdd(&fp[row], fp_c);
    if (fn_c) atomicAdd(&fn[row], fn_c);
  } else {
    tp[row] += tp_c;
    fp[row] += fp_c;
    fn[row] += fn_c;
  }
}

__global__ void row_tail_kernel(const int* __restrict__ row_counts,
                                const float* __restrict__ example_mask, int B,
                                float* precision_sum, int* precision_count,
                                float* recall_sum, int* recall_count, int* covered) {
  __shared__ float s_f[32];
  __shared__ int s_i[32];
  float ps = 0.0f, rs = 0.0f;
  int pc = 0, rc = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const bool row_valid = example_mask[b] > 0.0f;
    const int tp_row = row_counts[3 * b], pred_row = row_counts[3 * b + 1];
    const int t_row = row_counts[3 * b + 2];
    if (pred_row > 0 && row_valid) {
      ps += (float)tp_row / (float)max(pred_row, 1);
      pc += 1;
    }
    if (row_valid) {
      rs += (float)tp_row / (float)max(t_row, 1);
      rc += 1;
    }
  }
  ps = block_sum(ps, s_f);
  rs = block_sum(rs, s_f);
  pc = block_sum(pc, s_i);
  rc = block_sum(rc, s_i);
  if (threadIdx.x == 0) {
    *precision_sum += ps;
    *precision_count += pc;
    *recall_sum += rs;
    *recall_count += rc;
    *covered += pc;  // rows with a valid positive prediction
  }
}

// AP of one reversed-cumulative histogram, thread j at bin nb-1-j:
// (recall_j - recall_{j-1}) * precision_j, in f32 from exact counts.
template <typename T>
__device__ __forceinline__ float ap_term(T tp_incl, T pos, T fp_incl, T n_pos) {
  const float tpf = (float)tp_incl, fpf = (float)fp_incl, npf = (float)n_pos;
  const float precision = tpf / fmaxf(tpf + fpf, 1.0f);
  const float recall = tpf / fmaxf(npf, 1.0f);
  const float recall_prev = (float)(tp_incl - pos) / fmaxf(npf, 1.0f);
  return (recall - recall_prev) * precision;
}

__global__ void finalize_labels_kernel(const int* __restrict__ hist, int L, int nb,
                                       float* ap, float* npos,
                                       unsigned long long* micro) {
  __shared__ int s_i[32];
  __shared__ float s_f[32];
  const int j = threadIdx.x;
  const int bin = nb - 1 - j;
  unsigned long long acc_pos = 0, acc_neg = 0;
  for (int l = blockIdx.x; l < L; l += gridDim.x) {
    const int pos = j < nb ? hist[(size_t)l * nb + bin] : 0;
    const int neg = j < nb ? hist[(size_t)(L + l) * nb + bin] : 0;
    acc_pos += (unsigned long long)pos;
    acc_neg += (unsigned long long)neg;
    int n_pos, n_neg;
    const int tp_i = block_inclusive_scan(pos, s_i, &n_pos);
    const int fp_i = block_inclusive_scan(neg, s_i, &n_neg);
    const float term = j < nb ? ap_term(tp_i, pos, fp_i, n_pos) : 0.0f;
    const float s = block_sum(term, s_f);
    if (j == 0) {
      ap[l] = s;
      npos[l] = (float)n_pos;
    }
  }
  if (j < nb) {
    if (acc_pos) atomicAdd(&micro[bin], acc_pos);
    if (acc_neg) atomicAdd(&micro[nb + bin], acc_neg);
  }
}

__global__ void finalize_micro_kernel(const unsigned long long* __restrict__ micro,
                                      const float* __restrict__ ap,
                                      const float* __restrict__ npos, int L, int nb,
                                      float* out) {
  __shared__ unsigned long long s_u[32];
  __shared__ float s_f[32];
  __shared__ int s_i[32];
  const int j = threadIdx.x;
  const unsigned long long pos = j < nb ? micro[nb - 1 - j] : 0ull;
  const unsigned long long neg = j < nb ? micro[nb + nb - 1 - j] : 0ull;
  unsigned long long n_pos, n_neg;
  const unsigned long long tp_i = block_inclusive_scan(pos, s_u, &n_pos);
  const unsigned long long fp_i = block_inclusive_scan(neg, s_u, &n_neg);
  const float term = j < nb ? ap_term(tp_i, pos, fp_i, n_pos) : 0.0f;
  const float micro_ap = block_sum(term, s_f);
  float s = 0.0f;
  int n = 0;
  for (int l = j; l < L; l += blockDim.x) {
    if (npos[l] > 0.0f) {
      s += ap[l];
      n += 1;
    }
  }
  s = block_sum(s, s_f);
  n = block_sum(n, s_i);
  if (j == 0) {
    out[0] = n_pos > 0 ? micro_ap : NAN;
    out[1] = n > 0 ? s / (float)max(n, 1) : NAN;
  }
}

int threads_for_bins(int nb) { return (nb + 31) / 32 * 32; }

}  // namespace

// The batch update.  logits/targets (B, Lb) f32, example_mask (B,) f32,
// label_mask (Lb,) f32, cols (Lb,) int32 state rows or null (columns are
// rows 0..Lb-1), state tp/fp/fn (L,) and hist (2 * L * nb) int32,
// row_counts (B, 3) int32 zeroed by the caller.  Returns a cudaError_t.
extern "C" int eval_acc_update(const void* logits, const void* targets,
                               const void* example_mask, const void* label_mask,
                               const void* cols, int B, int Lb, int L, int nb,
                               float th, void* tp, void* fp, void* fn, void* hist,
                               void* row_counts, void* stream) {
  if (B <= 0 || Lb <= 0 || L <= 0 || nb <= 0 || (cols == nullptr && Lb > L))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((Lb + UPDATE_THREADS - 1) / UPDATE_THREADS);
  const float* lg = static_cast<const float*>(logits);
  const float* tg = static_cast<const float*>(targets);
  const float* em = static_cast<const float*>(example_mask);
  const float* lm = static_cast<const float*>(label_mask);
  int* tp_ = static_cast<int*>(tp);
  int* fp_ = static_cast<int*>(fp);
  int* fn_ = static_cast<int*>(fn);
  int* h = static_cast<int*>(hist);
  int* rc = static_cast<int*>(row_counts);
  if (cols == nullptr)
    update_kernel<false><<<grid, UPDATE_THREADS, 0, s>>>(
        lg, tg, em, lm, nullptr, B, Lb, L, nb, th, tp_, fp_, fn_, h, rc);
  else
    update_kernel<true><<<grid, UPDATE_THREADS, 0, s>>>(
        lg, tg, em, lm, static_cast<const int*>(cols), B, Lb, L, nb, th, tp_, fp_,
        fn_, h, rc);
  return (int)cudaGetLastError();
}

// Fold the (B, 3) row counts of one update into the samplewise sums.
extern "C" int eval_acc_row_tail(const void* row_counts, const void* example_mask,
                                 int B, void* precision_sum, void* precision_count,
                                 void* recall_sum, void* recall_count, void* covered,
                                 void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  row_tail_kernel<<<1, 256, 0, s>>>(
      static_cast<const int*>(row_counts), static_cast<const float*>(example_mask), B,
      static_cast<float*>(precision_sum), static_cast<int*>(precision_count),
      static_cast<float*>(recall_sum), static_cast<int*>(recall_count),
      static_cast<int*>(covered));
  return (int)cudaGetLastError();
}

// AP from the histograms: ap and npos (L,) f32 per label, out[0] micro AP,
// out[1] macro AP; micro is a (2 * nb) uint64 scratch.
extern "C" int eval_acc_finalize(const void* hist, int L, int nb, void* ap, void* npos,
                                 void* micro, void* out, void* stream) {
  if (L <= 0 || nb <= 0 || nb > MAX_BINS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(micro, 0, sizeof(unsigned long long) * 2 * nb, s);
  if (err != cudaSuccess) return (int)err;
  const int threads = threads_for_bins(nb);
  finalize_labels_kernel<<<min(L, FINALIZE_BLOCKS), threads, 0, s>>>(
      static_cast<const int*>(hist), L, nb, static_cast<float*>(ap),
      static_cast<float*>(npos), static_cast<unsigned long long*>(micro));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_micro_kernel<<<1, threads, 0, s>>>(
      static_cast<const unsigned long long*>(micro), static_cast<const float*>(ap),
      static_cast<const float*>(npos), L, nb, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
