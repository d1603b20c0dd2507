// On-device evaluation accumulator (K3) for Hopper (sm_90a): confusion
// counts, samplewise sums and per-label binned-AUPRC histograms of one eval
// batch, then the per-label, micro and macro average precision.
//
// Replaces the TPU op chain protnote_tpu/evaln/metrics.py:
// DeviceEvalAccumulator.update_fn (the batch update, line 601, with its row
// sums at 628) and finalize_into._finalize (AP from the histograms, 732),
// whose scatter form is BinnedAUPRC.device_update.  State layout is the JAX
// one: tp/fp/fn (L,) int32; hist 2 * L * nb int32, the positive histograms of
// all labels first, then the negative ones; the scalar sums.  For a batch of
// B rows and Lb columns, with p = 1 / (1 + expf(-logit)) in f32 (sigmoid.cuh)
// and
//
//   valid = example_mask[b] > 0 && label_mask[c] > 0
//   t     = target[b, c] > 0 && valid,    pred = p >= th && valid
//
// each valid element adds one to hist[(t ? row : L + row) * nb + bin] with
// bin = clip(int(p * nb), 0, nb - 1), and to tp/fp/fn of its row.  The TPU
// computed the histogram as a dense (B, L, nb) compare-reduce with pos and
// valid packed into one int32, to keep scatters off its vector unit; here
// each element writes its bin directly.
//
// What bounds it: memory.  The update reads B * Lb logits and targets (8 MB
// at B = 32, Lb = 32,102, 0.0051 ms at 3.35 TB/s counting each byte once)
// and adds one histogram word per valid element; finalize reads the 131 MB of
// histograms once (0.039 ms).  The histogram words of one batch are
// scattered over 131 MB, which the 50 MB L2 does not hold, so each costs a
// 32-byte sector in practice and the update cannot reach its bound.
//
// * eval_acc_update, one launch a batch: a block is 256 label columns x
//   ROWS_PER_THREAD batch rows (B = 32: 126 x 8 = 1,008 blocks, over seven
//   an SM), so that enough loads are in flight to cover the memory latency.
//   Each thread issues every logit and target load of its rows before its
//   first histogram write.  Histogram and tp/fp/fn writes are atomics whose
//   result is unused, which compile to fire-and-forget reductions (RED); the
//   counts are integers, exact whatever the order.  Per-row sums (tp_row,
//   pred_row, t_row) are warp ballots, gathered per block in shared memory
//   and added to a (B, 3) int32 scratch.  The last block to finish (a
//   done-counter after __threadfence) folds the scratch into the samplewise
//   sums, in float32, and sets the scratch and the counter back to 0 for the
//   next batch.  With `cols` (a label subset) two columns may name one state
//   row (the JAX cols_for pads a subset with row 0); every state write is an
//   atomic anyway, and columns with label_mask 0 add nothing.
// * eval_acc_finalize: one warp a label (grid-stride, as many blocks as fit
//   the SMs).  Lane j holds the PER = nb / 32 consecutive bins nb-1-j*PER
//   down to nb-(j+1)*PER, read as 16-byte vector loads when nb = 32 * PER
//   with PER a multiple of 4 (nb = 512: 16 bins, four loads a histogram).
//   The two reversed inclusive scans are a lane's serial sums plus a warp
//   shuffle scan of the lane totals, integers and exact; the AP terms are
//   summed in f32 by the lane, then by a butterfly (xor 16, 8, 4, 2, 1); no
//   block barrier inside the label loop.  A bin without positives adds
//   exactly 0, so its three IEEE divisions are skipped (with them the pass
//   was bound by the divisions, not the bytes).  Each lane keeps 64-bit
//   per-bin sums over its labels for micro AP (integers, exact; the JAX code
//   sums in f32); the block's warps add them into shared memory in turns,
//   and they go out with one atomic flush a block.  Each warp sums the AP of its labels with positives in
//   label order, each block its warps' sums, into a per-block partial.  A
//   one-block tail computes micro AP from the bin sums and the macro mean
//   from the block partials, in a fixed order (NaN when no label has
//   positives).  tests/test_torch_eval_accumulator.py emulates both orders
//   in numpy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sigmoid.cuh"

namespace {

constexpr int UPDATE_THREADS = 256;  // label columns a block
constexpr int ROWS_PER_THREAD = 4;   // batch rows a block (blockIdx.y's group)
constexpr int MAX_BINS = 1024;
constexpr int FINALIZE_WARPS = 8;    // labels in flight a block, one a warp

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

struct Sums {
  float* precision_sum;
  int* precision_count;
  float* recall_sum;
  int* recall_count;
  int* covered;
};

// The last block of an update: fold the (B, 3) row counts into the
// samplewise sums and set the counts back to 0.  Row b is thread b %
// blockDim.x's, which sums its rows in order before the block sum.
__device__ void row_tail(int* row_counts, const float* __restrict__ example_mask, int B,
                         Sums sums) {
  __shared__ float s_f[32];
  __shared__ int s_i[32];
  float ps = 0.0f, rs = 0.0f;
  int pc = 0, rc = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    // other blocks' atomics are in L2: read past L1
    const int tp_row = __ldcg(row_counts + 3 * b), pred_row = __ldcg(row_counts + 3 * b + 1);
    const int t_row = __ldcg(row_counts + 3 * b + 2);
    row_counts[3 * b] = row_counts[3 * b + 1] = row_counts[3 * b + 2] = 0;
    const bool row_valid = example_mask[b] > 0.0f;
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
    *sums.precision_sum += ps;
    *sums.precision_count += pc;
    *sums.recall_sum += rs;
    *sums.recall_count += rc;
    *sums.covered += pc;  // rows with a valid positive prediction
  }
}

__global__ void __launch_bounds__(UPDATE_THREADS)
update_kernel(const float* __restrict__ logits, const float* __restrict__ targets,
              const float* __restrict__ example_mask, const float* __restrict__ label_mask,
              const int* __restrict__ cols, int B, int Lb, int L, int nb, float th,
              int* tp, int* fp, int* fn, int* hist, int* row_counts, unsigned* done,
              Sums sums) {
  __shared__ int s_rows[ROWS_PER_THREAD * 3];
  __shared__ bool s_last;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b0 = blockIdx.y * ROWS_PER_THREAD;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < ROWS_PER_THREAD * 3) s_rows[threadIdx.x] = 0;
  // every thread runs every row (the ballots need whole warps); columns past
  // Lb or with label_mask 0, and rows past B or masked, are never valid
  const bool col_ok = c < Lb && label_mask[c] > 0.0f;
  const int row = col_ok ? (cols != nullptr ? cols[c] : c) : 0;
  bool ok[ROWS_PER_THREAD];
  float x[ROWS_PER_THREAD], y[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int b = b0 + r;
    ok[r] = col_ok && b < B && example_mask[b] > 0.0f;
    const size_t off = (size_t)b * Lb + c;
    x[r] = ok[r] ? logits[off] : 0.0f;
    y[r] = ok[r] ? targets[off] : 0.0f;
  }
  __syncthreads();  // s_rows is zero
  int tp_c = 0, fp_c = 0, fn_c = 0;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    bool t = false, pred = false;
    if (ok[r]) {
      const float p = prob_of(x[r]);
      t = y[r] > 0.0f;
      pred = p >= th;
      const int bin = min(max((int)(p * (float)nb), 0), nb - 1);
      atomicAdd(hist + ((size_t)(t ? row : L + row) * nb + bin), 1);
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
  if (tp_c) atomicAdd(&tp[row], tp_c);
  if (fp_c) atomicAdd(&fp[row], fp_c);
  if (fn_c) atomicAdd(&fn[row], fn_c);
  __syncthreads();
  if (threadIdx.x < ROWS_PER_THREAD * 3 && b0 + threadIdx.x / 3 < B &&
      s_rows[threadIdx.x])
    atomicAdd(&row_counts[3 * b0 + threadIdx.x], s_rows[threadIdx.x]);
  // the block's row counts are visible before it counts itself done
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  row_tail(row_counts, example_mask, B, sums);
  if (threadIdx.x == 0) *done = 0;
}

// AP term of one position of the reversed-cumulative histogram:
// (recall_i - recall_{i-1}) * precision_i, in f32 from exact counts.
template <typename T>
__device__ __forceinline__ float ap_term(T tp_incl, T pos, T fp_incl, T n_pos) {
  const float tpf = (float)tp_incl, fpf = (float)fp_incl, npf = (float)n_pos;
  const float precision = tpf / fmaxf(tpf + fpf, 1.0f);
  const float recall = tpf / fmaxf(npf, 1.0f);
  const float recall_prev = (float)(tp_incl - pos) / fmaxf(npf, 1.0f);
  return (recall - recall_prev) * precision;
}

// Lane `lane`'s PER bins of one histogram row, top bin first: v[k] is bin
// top - k with top = nb - 1 - lane * PER; bins below 0 read as 0.
template <int PER>
__device__ __forceinline__ void load_lane_bins(const int* __restrict__ h, int nb, int lane,
                                               bool vec, int (&v)[PER]) {
  const int lo = nb - (lane + 1) * PER;  // the lane's lowest bin
  if constexpr (PER % 4 == 0) {
    if (vec) {
      int tmp[PER];
#pragma unroll
      for (int q = 0; q < PER / 4; ++q) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(h + lo) + q);
        tmp[4 * q] = w.x;
        tmp[4 * q + 1] = w.y;
        tmp[4 * q + 2] = w.z;
        tmp[4 * q + 3] = w.w;
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) v[k] = tmp[PER - 1 - k];
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int bin = lo + PER - 1 - k;
    v[k] = bin >= 0 ? __ldg(h + bin) : 0;
  }
}

template <int PER>
__global__ void __launch_bounds__(FINALIZE_WARPS * 32)
finalize_labels_kernel(const int* __restrict__ hist, int L, int nb, float* ap,
                       float* npos, unsigned long long* micro, float* block_ap,
                       int* block_n) {
  // the block's bin sums, lane-major: [pos, neg][k][lane], so a warp's
  // 32 lanes touch consecutive words (bin nb-1-lane*PER-k; below 0: unused)
  extern __shared__ unsigned long long s_micro[];
  __shared__ float s_ap[FINALIZE_WARPS];
  __shared__ int s_n[FINALIZE_WARPS];
  constexpr int HALF = 32 * PER;
  for (int i = threadIdx.x; i < 2 * HALF; i += blockDim.x) s_micro[i] = 0ull;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * FINALIZE_WARPS + warp;
  const int stride = gridDim.x * FINALIZE_WARPS;
  const bool vec = nb == 32 * PER;
  unsigned long long acc_pos[PER], acc_neg[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) acc_pos[k] = acc_neg[k] = 0ull;
  float warp_ap = 0.0f;  // AP of the warp's labels with positives, in label order
  int warp_n = 0;
  for (int l = first; l < L; l += stride) {
    int pos[PER], neg[PER];
    load_lane_bins<PER>(hist + (size_t)l * nb, nb, lane, vec, pos);
    load_lane_bins<PER>(hist + (size_t)(L + l) * nb, nb, lane, vec, neg);
    int sp = 0, sn = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      sp += pos[k];
      sn += neg[k];
      acc_pos[k] += (unsigned long long)pos[k];
      acc_neg[k] += (unsigned long long)neg[k];
    }
    int ip = sp, in = sn;  // inclusive scans of the lane totals
    for (int o = 1; o < 32; o <<= 1) {
      const int np = __shfl_up_sync(0xffffffffu, ip, o);
      const int nn = __shfl_up_sync(0xffffffffu, in, o);
      if (lane >= o) {
        ip += np;
        in += nn;
      }
    }
    const int n_pos = __shfl_sync(0xffffffffu, ip, 31);
    int tp_i = ip - sp, fp_i = in - sn;
    float term = 0.0f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      tp_i += pos[k];
      fp_i += neg[k];
      // a bin without positives adds exactly 0 (recall does not move), so
      // its three divisions are skipped: most bins of a label have none
      if (pos[k] != 0) term += ap_term(tp_i, pos[k], fp_i, n_pos);
    }
    for (int o = 16; o > 0; o >>= 1) term += __shfl_xor_sync(0xffffffffu, term, o);
    if (lane == 0) {
      ap[l] = term;
      npos[l] = (float)n_pos;
      if (n_pos > 0) {
        warp_ap += term;
        warp_n += 1;
      }
    }
  }
  if (lane == 0) {
    s_ap[warp] = warp_ap;
    s_n[warp] = warp_n;
  }
  // the warps add their bin sums into shared memory in turns: a lane's
  // words are its own, so a turn needs no atomics (64-bit shared atomics,
  // eight warps at once on words 128 bytes apart, took as long as the
  // label loop)
  for (int w = 0; w < FINALIZE_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        s_micro[k * 32 + lane] += acc_pos[k];
        s_micro[HALF + k * 32 + lane] += acc_neg[k];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * HALF; i += blockDim.x) {
    const int r = i % HALF;
    const int bin = nb - 1 - (r % 32) * PER - r / 32;
    if (bin >= 0 && s_micro[i]) atomicAdd(&micro[(i / HALF) * nb + bin], s_micro[i]);
  }
  if (threadIdx.x == 0) {  // the block's macro partials, its warps in order
    float a = 0.0f;
    int n = 0;
    for (int w = 0; w < FINALIZE_WARPS; ++w) {
      a += s_ap[w];
      n += s_n[w];
    }
    block_ap[blockIdx.x] = a;
    block_n[blockIdx.x] = n;
  }
}

// Micro AP from the label-axis sums, one thread a bin; the macro mean from
// the label blocks' partials (thread j holds block j's), in a fixed order.
__global__ void finalize_micro_kernel(const unsigned long long* __restrict__ micro,
                                      const float* __restrict__ block_ap,
                                      const int* __restrict__ block_n, int blocks, int nb,
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
  const float term = j < nb && pos != 0 ? ap_term(tp_i, pos, fp_i, n_pos) : 0.0f;
  const float micro_ap = block_sum(term, s_f);
  float s = 0.0f;
  int n = 0;
  for (int b = j; b < blocks; b += blockDim.x) {
    s += block_ap[b];
    n += block_n[b];
  }
  s = block_sum(s, s_f);
  n = block_sum(n, s_i);
  if (j == 0) {
    out[0] = n_pos > 0 ? micro_ap : NAN;
    out[1] = n > 0 ? s / (float)max(n, 1) : NAN;
  }
}

// As many blocks as fit the SMs at once (found on the first call for each
// PER: the process drives one kind of card; a race stores the same value),
// at most `cap`.  Returns the blocks launched through `blocks`.
template <int PER>
cudaError_t launch_finalize_labels(const int* hist, int L, int nb, float* ap, float* npos,
                                   unsigned long long* micro, float* block_ap, int* block_n,
                                   int cap, int* blocks, cudaStream_t s) {
  const size_t smem = sizeof(unsigned long long) * 2 * 32 * PER;
  static int resident = 0;  // blocks of this PER resident on the card
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, finalize_labels_kernel<PER>, FINALIZE_WARPS * 32, smem);
    if (err != cudaSuccess) return err;
    resident = max(1, sms * per_sm);
  }
  *blocks = max(1, min(min((L + FINALIZE_WARPS - 1) / FINALIZE_WARPS, resident), cap));
  finalize_labels_kernel<PER><<<*blocks, FINALIZE_WARPS * 32, smem, s>>>(
      hist, L, nb, ap, npos, micro, block_ap, block_n);
  return cudaGetLastError();
}

}  // namespace

// The batch update.  logits/targets (B, Lb) f32, example_mask (B,) f32,
// label_mask (Lb,) f32, cols (Lb,) int32 state rows or null (columns are
// rows 0..Lb-1), state tp/fp/fn (L,) and hist (2 * L * nb) int32, the five
// samplewise sums, and a scratch of at least 3 * B + 1 int32 that is zero
// (row_counts, then at scratch[scratch_len - 1] the done-counter) and that
// the launch leaves zero.  Returns a cudaError_t.
extern "C" int eval_acc_update(const void* logits, const void* targets,
                               const void* example_mask, const void* label_mask,
                               const void* cols, int B, int Lb, int L, int nb,
                               float th, void* tp, void* fp, void* fn, void* hist,
                               void* precision_sum, void* precision_count,
                               void* recall_sum, void* recall_count, void* covered,
                               void* scratch, int scratch_len, void* stream) {
  if (B <= 0 || Lb <= 0 || L <= 0 || nb <= 0 || (cols == nullptr && Lb > L) ||
      scratch_len < 3 * B + 1)
    return (int)cudaErrorInvalidValue;
  const int row_groups = (B + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD;
  if (row_groups > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((Lb + UPDATE_THREADS - 1) / UPDATE_THREADS, row_groups);
  int* sc = static_cast<int*>(scratch);
  const Sums sums{static_cast<float*>(precision_sum), static_cast<int*>(precision_count),
                  static_cast<float*>(recall_sum), static_cast<int*>(recall_count),
                  static_cast<int*>(covered)};
  update_kernel<<<grid, UPDATE_THREADS, 0, s>>>(
      static_cast<const float*>(logits), static_cast<const float*>(targets),
      static_cast<const float*>(example_mask), static_cast<const float*>(label_mask),
      static_cast<const int*>(cols), B, Lb, L, nb, th, static_cast<int*>(tp),
      static_cast<int*>(fp), static_cast<int*>(fn), static_cast<int*>(hist), sc,
      reinterpret_cast<unsigned*>(sc + scratch_len - 1), sums);
  return (int)cudaGetLastError();
}

// AP from the histograms: ap and npos (L,) f32 per label, out[0] micro AP,
// out[1] macro AP; micro is a (2 * nb) uint64 scratch, block_ap (float) and
// block_n (int32) scratches of `cap` entries for the label blocks' macro
// partials (at most `cap` blocks run).
extern "C" int eval_acc_finalize(const void* hist, int L, int nb, void* ap, void* npos,
                                 void* micro, void* block_ap, void* block_n, int cap,
                                 void* out, void* stream) {
  if (L <= 0 || nb <= 0 || nb > MAX_BINS || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(micro, 0, sizeof(unsigned long long) * 2 * nb, s);
  if (err != cudaSuccess) return (int)err;
  const int* h = static_cast<const int*>(hist);
  float* ap_ = static_cast<float*>(ap);
  float* np_ = static_cast<float*>(npos);
  auto* mi = static_cast<unsigned long long*>(micro);
  float* ba = static_cast<float*>(block_ap);
  int* bn = static_cast<int*>(block_n);
  const int per = (nb + 31) / 32;
  int blocks = 0;
  if (per <= 1) err = launch_finalize_labels<1>(h, L, nb, ap_, np_, mi, ba, bn, cap, &blocks, s);
  else if (per <= 2) err = launch_finalize_labels<2>(h, L, nb, ap_, np_, mi, ba, bn, cap, &blocks, s);
  else if (per <= 4) err = launch_finalize_labels<4>(h, L, nb, ap_, np_, mi, ba, bn, cap, &blocks, s);
  else if (per <= 8) err = launch_finalize_labels<8>(h, L, nb, ap_, np_, mi, ba, bn, cap, &blocks, s);
  else if (per <= 16) err = launch_finalize_labels<16>(h, L, nb, ap_, np_, mi, ba, bn, cap, &blocks, s);
  else err = launch_finalize_labels<32>(h, L, nb, ap_, np_, mi, ba, bn, cap, &blocks, s);
  if (err != cudaSuccess) return (int)err;
  finalize_micro_kernel<<<1, (nb + 31) / 32 * 32, 0, s>>>(mi, ba, bn, blocks, nb,
                                                           static_cast<float*>(out));
  return (int)cudaGetLastError();
}
