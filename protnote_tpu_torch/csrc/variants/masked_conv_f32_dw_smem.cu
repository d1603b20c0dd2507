// K7's float32 dW with dy's pieces made in shared memory, a design the port
// does not use: chip_variants.py --k7-f32 times it against the kept
// masked_conv_dw_f32 (csrc/masked_conv_f32.cu, included whole below: the
// same plan, A formation, products, epilogue and dbias), which splits dy
// into a (3, B, T) bf16 buffer in one pass a call and reads the pieces by
// TMA.  Here a stage brings dy's float32 box (the step's positions x 128
// channels) by TMA beside x's, and the two consumer warpgroups split it together and
// write its three pieces MN-major (the layout TMA would write, 128-byte
// swizzled) into one of two piece buffers, then meet at a barrier before
// the products: dy is split once for every (tap, C_in tile) that reads it,
// 81 times at 1,100 channels, against once a call, and its float32 box
// brings 4 bytes an element where the pieces bring 6.  The buffer written
// at step i was last read by step i - 2's products, which every warpgroup
// waited for before step i - 1's barrier.

#include "masked_conv_f32.cu"

namespace {

constexpr int DS_DY_BYTES = (DW_BN / 32) * DW_XHALF;  // dy's float32 box: four 32-channel halves
constexpr int DS_STAGE = DW_X_BYTES + DS_DY_BYTES;
constexpr int DS_STAGES = 2;
constexpr int DS_PBUF = PIECES * DW_PIECE;              // dy's three pieces
constexpr int DS_PBUF_OFF = DS_STAGES * DS_STAGE;
constexpr int DS_BAR_OFF = DS_PBUF_OFF + 2 * DS_PBUF;
constexpr int DS_SMEM = 1024 + DS_BAR_OFF + 2 * DS_STAGES * 8;
static_assert(DS_SMEM <= SMEM_LIMIT, "shared memory");

// a barrier of the two consumer warpgroups' 256 threads
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// tm_x maps x (C_in, T, B) float32, box (32, DW_BK, 1); tm_dy dy (C_out, T,
// B) float32, box (32, DW_BK, 1).
__global__ void __launch_bounds__(THREADS, 1)
conv_dw_f32_smem_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_dy, const DwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + DS_BAR_OFF;
  auto full_bar = [&](int s) { return bar0 + 8u * s; };
  auto empty_bar = [&](int s) { return bar0 + 8u * (DS_STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < DS_STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
        const DwItem w = dw_item(a, it);
        for (int k = w.k0; k < w.k1; ++k) {
          const int b = a.steps[2 * k];
          const int t0 = a.steps[2 * k + 1] & 0xffff;
          mbar_wait(empty_bar(s), phase ^ 1u);
          const uint32_t st = base + s * DS_STAGE;
          mbar_expect_tx(full_bar(s), DS_STAGE);
#pragma unroll
          for (int h = 0; h < DW_BM / 32; ++h)
            tma_load_3d(st + h * DW_XHALF, &tm_x, w.m0 + 32 * h, t0 + w.s, b, full_bar(s));
#pragma unroll
          for (int h = 0; h < DW_BN / 32; ++h)
            tma_load_3d(st + DW_X_BYTES + h * DW_XHALF, &tm_dy, w.n0 + 32 * h, t0, b,
                        full_bar(s));
          if (++s == DS_STAGES) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x % 128;
  const int ct = wg * 128 + tid;  // 0..255: the thread's share of dy's split
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int q = lane & 3;
  float acc[DW_BN / 2];
  float sum[DW_BN / 2];
  uint32_t fa[PIECES][4][4];
  int s = 0, step = 0;
  uint32_t phase = 0;
  const bool even = (a.cout & 1) == 0;
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    const DwItem w = dw_item(a, it);
    const bool live = w.m0 + 64 * wg < a.cin;
#pragma unroll
    for (int i = 0; i < DW_BN / 2; ++i) sum[i] = 0.f;
    for (int k = w.k0; k < w.k1; ++k, ++step) {
      mbar_wait(full_bar(s), phase);
      const unsigned char* sp = smem + s * DS_STAGE;
      const uint32_t pbuf = base + DS_PBUF_OFF + (step & 1) * DS_PBUF;
      // dy's pieces: the thread's 16 channel pairs (a warp a row's 32 pairs
      // of one 64-channel box)
      const float* dyb = reinterpret_cast<const float*>(sp + DW_X_BYTES);
#pragma unroll 4
      for (int i = 0; i < DW_BK * DW_BN / 2 / 256; ++i) {
        const int idx = ct + 256 * i;
        const int p = idx / (DW_BN / 2), c = 2 * (idx % (DW_BN / 2));
        const float2 v = *reinterpret_cast<const float2*>(dyb + (c >> 5) * (DW_XHALF / 4) +
                                                          swz(p, c & 31));
        uint32_t u[PIECES];
        split3(v, u[0], u[1], u[2]);
        const int cl = c & 63;
        const uint32_t off = (c >> 6) * DW_BOX + p * 128 + ((((cl >> 3) ^ (p & 7))) << 4) +
                             (cl & 7) * 2;
#pragma unroll
        for (int r = 0; r < PIECES; ++r) st_shared(pbuf + r * DW_PIECE + off, u[r]);
      }
      if (live) {
        const int rows = a.steps[2 * k + 1] >> 16;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int cl = warp * 16 + g + 8 * rr;
          const float* hb =
              reinterpret_cast<const float*>(sp + (2 * wg + (cl >> 5)) * DW_XHALF);
          const int c5 = cl & 31;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int p = 16 * kk + 2 * q + 8 * cc;
              const float2 xv = make_float2(p < rows ? hb[swz(p, c5)] : 0.f,
                                            p + 1 < rows ? hb[swz(p + 1, c5)] : 0.f);
              const int e = rr + 2 * cc;
              split3(xv, fa[0][kk][e], fa[1][kk][e], fa[2][kk][e]);
            }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(s));  // the stage is read
      fence_async_smem();  // the pieces, written by threads, for wgmma's reads
      consumer_barrier();
      if (live) {
        const uint64_t d[PIECES] = {smem_desc_mn(pbuf, DW_BOX),
                                    smem_desc_mn(pbuf + DW_PIECE, DW_BOX),
                                    smem_desc_mn(pbuf + 2 * DW_PIECE, DW_BOX)};
        split_products<MmaRsT<DW_BN>>(acc, fa, d, 128);
#pragma unroll
        for (int i = 0; i < DW_BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      }
      if (++s == DS_STAGES) {
        s = 0;
        phase ^= 1u;
      }
    }
    if (!live) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = w.m0 + wg * 64 + warp * 16 + g + 8 * h;
      if (c >= a.cin) continue;
      float* out = a.splits == 1
                       ? a.dw + (static_cast<size_t>(w.j) * a.cin + c) * a.cout
                       : a.partial +
                             ((static_cast<size_t>(w.sp) * a.taps + w.j) * a.cin + c) * a.cout;
#pragma unroll
      for (int jn = 0; jn < DW_BN / 8; ++jn) {
        const int n = w.n0 + 8 * jn + 2 * q;
        if (even && n + 1 < a.cout) {
          *reinterpret_cast<float2*>(out + n) =
              make_float2(sum[4 * jn + 2 * h], sum[4 * jn + 2 * h + 1]);
        } else {
          if (n < a.cout) out[n] = sum[4 * jn + 2 * h];
          if (n + 1 < a.cout) out[n + 1] = sum[4 * jn + 2 * h + 1];
        }
      }
    }
  }
}

}  // namespace

// masked_conv_dw_f32's arguments (pieces unused: dy is split in shared
// memory; dy_pitch a multiple of 4, dy on 16 bytes).
extern "C" int masked_conv_dw_f32_smem(const void* x, const void* dy, void* pieces,
                                       const void* lengths, const void* plan, void* partial,
                                       void* bias_part, void* dw, void* db, int B, int T,
                                       int cin, int cout, int x_pitch, int dy_pitch, int taps,
                                       int dilation, int splits, int n_items, int grid,
                                       void* stream) {
  (void)pieces;
  const int mtiles = (cin + DW_BM - 1) / DW_BM, ntiles = (cout + DW_BN - 1) / DW_BN;
  if (B <= 0 || T <= 0 || T > 0xffff || cin <= 0 || cout <= 0 || taps <= 0 || dilation <= 0 ||
      splits <= 0 || grid <= 0 || x_pitch < cin || x_pitch % 4 != 0 || dy_pitch < cout ||
      dy_pitch % 4 != 0 || n_items != taps * splits * mtiles * ntiles || plan == nullptr ||
      (splits > 1 && partial == nullptr) || !aligned16(x) || !aligned16(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(conv_dw_f32_smem_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DS_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_x, tm_dy;
  memset(&tm_x, 0, sizeof(tm_x));
  memset(&tm_dy, 0, sizeof(tm_dy));
  if (!make_map_f32_pitched(&tm_x, x, B, T, cin, x_pitch, DW_BK) ||
      !make_map_f32_pitched(&tm_dy, dy, B, T, cout, dy_pitch, DW_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  DwArgs a{};
  a.items = static_cast<const int*>(plan);
  a.offsets = a.items + n_items;
  a.steps = a.offsets + taps * splits + 1;
  a.partial = static_cast<float*>(partial);
  a.dw = static_cast<float*>(dw);
  a.B = B, a.taps = taps, a.dilation = dilation, a.cin = cin, a.cout = cout;
  a.mtiles = mtiles, a.ntiles = ntiles, a.splits = splits, a.n_items = n_items;
  conv_dw_f32_smem_kernel<<<grid < n_items ? grid : n_items, THREADS, DS_SMEM, s>>>(tm_x, tm_dy,
                                                                                    a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const long long total = static_cast<long long>(taps) * cin * cout;
    const long long blocks = (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096;
    dw_reduce_f32_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const float*>(partial), a.dw, total, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  seq_col_sums_f32_kernel<<<dim3((cout + SUM_COLS - 1) / SUM_COLS, B), SUM_COLS, 0, s>>>(
      static_cast<const float*>(dy), static_cast<const int*>(lengths),
      static_cast<float*>(bias_part), T, cout, dy_pitch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dbias_f32_kernel<<<(cout + 255) / 256, 256, 0, s>>>(static_cast<const float*>(bias_part),
                                                      static_cast<float*>(db), B, cout);
  return static_cast<int>(cudaGetLastError());
}
