// The dense training scorer's first layer over every (sequence, label) pair,
// and the side sums of its backward, for Hopper (sm_90a).
//
// Replaces the first layer of the TPU op chain
// protnote_tpu/ops/pair_scorer.py:108 pair_logits_dense (the joint embedding
// of :92 joint_embeddings through the output MLP's first Linear, :56
// output_mlp_apply) for concatenation and concatenation_diff, and the
// broadcast transposes of its backward.  The joint is never built: with
// a = P_e @ W1_p (B, H) and c = L_e @ W1_l (L, H) the float32 side products
// (the diff block folded into both),
//
//   pair_first_add:  z[b * L + l, n] = bf16(a[b, n] + c[l, n])
//   pair_side_sums:  sb[b, k] = sum_l x[b * L + l, k] * v[l, k]   (f32)
//                    sl[l, k] = sum_b x[b * L + l, k] * u[b, k]   (f32)
//
// where the side sums give the first layer's da = sum_l dz and dc =
// sum_b dz (u = v = 1), and for concatenation_prod the gradients of P_e and
// L_e through the prod block: x = dJ = dz @ W_prod^T, v = L_e, u = P_e.
// Each product of two bf16 values is exact in float32; every sum runs in a
// fixed order, so two calls give the same bits: sl over b in order; sb in
// label chunks of 64, within a chunk warp w of its 8 warps adding labels w,
// w + 8, ... (those < L) in order, the warps added in order, then the
// chunks in order.
//
// What bounds them: device memory.  pair_first_add walks the pairs label
// by label (the B rows of one label in turn), so each row of c comes from
// device memory once and a (393 KB) stays in L2; it writes z, 6.3 GB at 32 x
// 32,102 x 3072 (with c's 394 MB, 2.0 ms at 3.35 TB/s).  Each thread moves
// 16 bytes (8 bf16) an access, a warp 256 consecutive columns of a row.
//
// pair_side_sums reads x once (6.31 GB for dz at that shape, 1.88 ms) and
// writes sl (0.39 GB) and the chunks' partial sb rows (chunks x B x K
// float32, 0.20 GB, written and read once).  Persistent blocks
// walk items (a label chunk x a 256-column group); for each item a
// producer thread streams the 64 x 256 slice of x[b] (and u[b]'s 256
// columns) for b = 0 .. B - 1 in order through a ring of TMA stages in
// shared memory (a 3-D map over x viewed as (B, L, K): rows past L arrive
// as zeros and are skipped), tracked by full/empty mbarriers, so each SM
// keeps 64-200 KB of loads in flight.  Each consumer warp owns 8 labels of
// the chunk: their sl sums and v rows stay in registers across the B
// sequences (a lane 8 columns); per sequence its labels' x * v go into one
// register row, which the block's warps add in order through shared memory
// into partial row (chunk, b).  sl for the chunk's labels is complete when
// the item ends; a tail kernel adds the partial rows in chunk order.
//
// The float32 forms (pair_first_add_f32: z float32, nothing rounded;
// pair_side_sums_f32: x, u and v float32, each product x * u rounded once
// to float32 as JAX's float32 chain rounds it, MIXED_PRECISION False) are
// the same kernels on float32 elements, 8 columns a thread in two 16-byte
// accesses: twice the bytes of z and x.

#include "bn_columns.cuh"
#include "hopper.cuh"

#include <limits.h>
#include <string.h>

#include <type_traits>

namespace {

// z = T(a[b] + c[l]): each thread owns 8 columns of one row at a time;
// the grid-stride loop walks the pairs label-major (pair i is sequence
// i % B of label i / B), so the blocks in flight share c's rows.
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
pair_first_add_kernel(const float* __restrict__ a, const float* __restrict__ c,
                      T* __restrict__ z, int B, int L, int H) {
  const int vpr = H / VEC;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= vpr) return;
  const long long rows = (long long)B * L;
  for (long long i = blockIdx.x; i < rows; i += gridDim.x) {
    const int l = (int)(i / B);
    const int b = (int)(i - (long long)l * B);
    const long long r = (long long)b * L + l;
    const float4* ap = reinterpret_cast<const float4*>(a + (size_t)b * H + cv * VEC);
    const float4* cp = reinterpret_cast<const float4*>(c + (size_t)l * H + cv * VEC);
    float f[VEC];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 av = __ldg(ap + h);
      const float4 cw = __ldg(cp + h);
      f[4 * h] = __fadd_rn(av.x, cw.x);
      f[4 * h + 1] = __fadd_rn(av.y, cw.y);
      f[4 * h + 2] = __fadd_rn(av.z, cw.z);
      f[4 * h + 3] = __fadd_rn(av.w, cw.w);
    }
    store8(z + (r * vpr + cv) * VEC, f);
  }
}

// ---- pair_side_sums: both sums in one read of x ---------------------------

constexpr int SIDE_LABELS = 8;  // labels a consumer warp owns in its chunk
constexpr int SIDE_WARPS = 8;   // consumer warps a block: a chunk of 64 labels
constexpr int SMEM_LIMIT = 232448;

// A lane's 8 elements of a 256-column row and their columns: bf16 8 lane ..
// 8 lane + 7 (one 16-byte access); float32 4 lane .. 4 lane + 3 and 128 +
// 4 lane .. + 3 (two 16-byte accesses 512 bytes apart, so that a warp's
// shared-memory reads of one row meet every bank once).
template <typename T>
struct Lane8;
template <>
struct Lane8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* row, int lane) {
    w = *reinterpret_cast<const uint4*>(row + VEC * lane);
  }
  __device__ __forceinline__ void get(float* f) const { unpack8(w, f); }
  static __device__ __forceinline__ int col(int lane, int e) { return VEC * lane + e; }
};
template <>
struct Lane8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* row, int lane) {
    a = reinterpret_cast<const float4*>(row)[lane];
    b = reinterpret_cast<const float4*>(row + COLS / 2)[lane];
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
  static __device__ __forceinline__ int col(int lane, int e) {
    return e < 4 ? 4 * lane + e : COLS / 2 + 4 * lane + e - 4;
  }
};

// float32 values at the lane's 8 columns of a 256-column row
template <typename T>
__device__ __forceinline__ void store_lane8(float* row, int lane, const float* f) {
  *reinterpret_cast<float4*>(row + Lane8<T>::col(lane, 0)) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(row + Lane8<T>::col(lane, 4)) = make_float4(f[4], f[5], f[6], f[7]);
}

// Shared memory of a block: a ring of STAGES stages, each the M x 256 slice
// of x[b] and u[b]'s 256 columns; two buffers of the warps' sb rows; the
// mbarriers.
template <typename T>
struct SideLayout {
  static constexpr int WARPS = SIDE_WARPS;
  static constexpr int M = SIDE_LABELS * WARPS;
  static constexpr int X_BYTES = M * COLS * (int)sizeof(T);
  static constexpr int U_BYTES = COLS * (int)sizeof(T);
  static constexpr int STAGE = X_BYTES + U_BYTES;
  static constexpr int RED_BYTES = 2 * WARPS * COLS * 4;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - RED_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int RED_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = RED_OFF + RED_BYTES;
  static constexpr int BYTES = 128 + BAR_OFF + 2 * STAGES * 8;  // + alignment slack
  static constexpr int THREADS = 32 * (WARPS + 1);  // the producer warp last
  static_assert(STAGE % 128 == 0, "TMA destinations");
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

// a barrier of the consumer warps (id 1; the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(SIDE_WARPS * 32) : "memory");
}

// sb's partial rows and sl for x (B, L, K) as (B * L, K): item i is the
// 256-column group i % groups of label chunk i / groups.  u, v: null for
// ones (the maps of a null u are never read).
template <typename T>
__global__ void __launch_bounds__(SideLayout<T>::THREADS, 1)
side_sums_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_u,
                 const T* __restrict__ u, const T* __restrict__ v, float* __restrict__ part,
                 float* __restrict__ sl, int B, int L, int K, int chunks) {
  using Lay = SideLayout<T>;
  constexpr int STAGES = Lay::STAGES;
  constexpr int WARPS = Lay::WARPS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + Lay::BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (STAGES + s); };
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = K / COLS;
  const int items = chunks * groups;
  const bool weighted_l = u != nullptr;
  const bool weighted_b = v != nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), WARPS);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // ---- producer: one thread streams x[b]'s slice (and u[b]) ------------
    if (lane == 0) {
      const uint32_t tx = weighted_l ? Lay::STAGE : Lay::X_BYTES;
      int s = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int chunk = item / groups;
        const int c0 = (item - chunk * groups) * COLS;
        for (int b = 0; b < B; ++b) {
          mbar_wait(empty_bar(s), phase ^ 1u);
          const uint32_t st = base + s * Lay::STAGE;
          mbar_expect_tx(full_bar(s), tx);
          tma_load_3d(st, &tm_x, c0, chunk * Lay::M, b, full_bar(s));
          if (weighted_l) tma_load(st + Lay::X_BYTES, &tm_u, c0, b, full_bar(s));
          if (++s == STAGES) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warp w owns labels w + WARPS i (i < 8) of each chunk ------
  float* red = reinterpret_cast<float*>(smem + Lay::RED_OFF);
  int s = 0;
  uint32_t phase = 0;
  int rb = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int chunk = item / groups;
    const int c0 = (item - chunk * groups) * COLS;
    const int l0 = chunk * Lay::M + warp;  // the warp's first label
    float acc[SIDE_LABELS][VEC];
    Lane8<T> vr[SIDE_LABELS];
#pragma unroll
    for (int i = 0; i < SIDE_LABELS; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
      if (weighted_b && l0 + WARPS * i < L) vr[i].load(v + (size_t)(l0 + WARPS * i) * K + c0, lane);
    }
    for (int b = 0; b < B; ++b) {
      mbar_wait(full_bar(s), phase);
      const T* xs = reinterpret_cast<const T*>(smem + s * Lay::STAGE);
      float uf[VEC], sbw[VEC];
      if (weighted_l) {
        Lane8<T> ur;
        ur.load(reinterpret_cast<const T*>(smem + s * Lay::STAGE + Lay::X_BYTES), lane);
        ur.get(uf);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sbw[e] = 0.f;
#pragma unroll
      for (int i = 0; i < SIDE_LABELS; ++i) {
        if (l0 + WARPS * i < L) {  // the same for every lane of the warp
          Lane8<T> xr;
          xr.load(xs + (warp + WARPS * i) * COLS, lane);
          float xf[VEC], vf[VEC];
          xr.get(xf);
          if (weighted_b) vr[i].get(vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            acc[i][e] = __fadd_rn(acc[i][e], weighted_l ? __fmul_rn(xf[e], uf[e]) : xf[e]);
            sbw[e] = __fadd_rn(sbw[e], weighted_b ? __fmul_rn(xf[e], vf[e]) : xf[e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(s));  // the warp is done with the stage
      if (++s == STAGES) {
        s = 0;
        phase ^= 1u;
      }
      // the warps' rows of x * v added in warp order into partial row (chunk, b);
      // two buffers, so one barrier a sequence keeps a buffer from being
      // rewritten before its sums are read
      float* rows = red + (rb & 1) * WARPS * COLS;
      store_lane8<T>(rows + warp * COLS, lane, sbw);
      consumers_sync();
      if (threadIdx.x < COLS) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) t = __fadd_rn(t, rows[w * COLS + threadIdx.x]);
        part[((size_t)chunk * B + b) * K + c0 + threadIdx.x] = t;
      }
      ++rb;
    }
#pragma unroll
    for (int i = 0; i < SIDE_LABELS; ++i)
      if (l0 + WARPS * i < L) store_lane8<T>(sl + (size_t)(l0 + WARPS * i) * K + c0, lane, acc[i]);
  }
}

template <typename T>
cudaError_t launch_side_sums(const CUtensorMap (&maps)[2], const T* u, const T* v, float* part,
                             float* sl, int B, int L, int K, int chunks, cudaStream_t s) {
  using Lay = SideLayout<T>;
  auto kernel = side_sums_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int items = chunks * (K / COLS);
  kernel<<<std::min(items, sms), Lay::THREADS, Lay::BYTES, s>>>(maps[0], maps[1], u, v, part, sl,
                                                              B, L, K, chunks);
  return cudaGetLastError();
}

template <typename T>
int first_add(const void* a, const void* c, void* z, int B, int L, int H, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || H % VEC != 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * L;
  const int vpr = H / VEC;
  const dim3 grid((unsigned)std::min(rows, (long long)132 * 64),
                  (unsigned)((vpr + EW_THREADS - 1) / EW_THREADS));
  pair_first_add_kernel<T><<<grid, std::min(EW_THREADS, vpr), 0,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(c), static_cast<T*>(z), B, L, H);
  return (int)cudaGetLastError();
}

template <typename T>
int side_sums(const void* x, const void* u, const void* v, void* part, void* sb, void* sl, int B,
              int L, int K, int chunks, long long per, void* stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int M = SideLayout<T>::M;
  if (B <= 0 || L <= 0 || K <= 0 || K % COLS != 0 || per != M || chunks != (L + M - 1) / M ||
      (long long)B * K > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const MapType type = F32 ? MapType::F32 : MapType::BF16;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  if (!make_map_3d(&maps[0], x, type, B, L, K, M, COLS, false) ||
      (u != nullptr && !make_map(&maps[1], u, type, B, K, 1, COLS, false)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* part_ = static_cast<float*>(part);
  const cudaError_t err =
      launch_side_sums<T>(maps, static_cast<const T*>(u), static_cast<const T*>(v), part_,
                          static_cast<float*>(sl), B, L, K, chunks, s);
  if (err != cudaSuccess) return (int)err;
  const int cols = B * K;
  column_sums_tail_kernel<1><<<(cols + 255) / 256, 256, 0, s>>>(
      ChunkSums<1>{{part_}, {static_cast<float*>(sb)}}, chunks, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// z (B * L, H) bf16 with rows b * L + l: bf16(a[b] + c[l]); a (B, H) and c
// (L, H) f32, all contiguous and 16-byte aligned, H a multiple of 8.
// Returns a CUDA error (0 on success).
extern "C" int pair_first_add(const void* a, const void* c, void* z, int B, int L, int H,
                              void* stream) {
  return first_add<__nv_bfloat16>(a, c, z, B, L, H, stream);
}

// Its float32 form: z (B * L, H) float32, a[b] + c[l] as it is.
extern "C" int pair_first_add_f32(const void* a, const void* c, void* z, int B, int L, int H,
                                  void* stream) {
  return first_add<float>(a, c, z, B, L, H, stream);
}

// For x (B * L, K) bf16 with rows b * L + l: sb (B, K) = sum_l x[b, l] * v[l]
// and sl (L, K) = sum_b x[b, l] * u[b], f32; u (B, K) and v (L, K) bf16, or
// null for ones.  part is a f32 scratch of chunks x B x K: label chunks of
// `per` = 64 labels cover L, chunks = ceil(L / 64).  K is a
// multiple of 256; all contiguous and 16-byte aligned.  Returns a CUDA
// error (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int pair_side_sums(const void* x, const void* u, const void* v, void* part, void* sb,
                              void* sl, int B, int L, int K, int chunks, long long per,
                              void* stream) {
  return side_sums<__nv_bfloat16>(x, u, v, part, sb, sl, B, L, K, chunks, per, stream);
}

// Its float32 form: x, u and v float32.
extern "C" int pair_side_sums_f32(const void* x, const void* u, const void* v, void* part,
                                  void* sb, void* sl, int B, int L, int K, int chunks,
                                  long long per, void* stream) {
  return side_sums<float>(x, u, v, part, sb, sl, B, L, K, chunks, per, stream);
}
