// Filter gradient of a 1x1 convolution for Hopper (sm_90a):
//   dw[Cin, Cout] (fp32) = sum over k of x[k, Cin]^T dy[k, Cout], K = N*H*W.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/conv_backward.py:_dw_kernel
// (:43), launched by dw_1x1 (:57) from conv1x1's backward (:119):
//   dw_1x1_kernel (bf16 and float16), dw_1x1_partial_f32_kernel (float32),
//   each with dw_1x1_reduce_kernel.
//
// What bounds it, against the H100 SXM data-sheet peaks (989 TFLOP/s bf16,
// 3.35 TB/s, at its 700 W limit): every row of x and dy is read once and the
// output is tiny, so at the ResNet-50 shapes it is bound by bytes: the
// stage-1 bottleneck (401,408 rows, 64 -> 256, bf16) does 13.15 GFLOP over
// 256.9 MB (0.0767 ms); the stride-2 projection shortcut (100,352 rows,
// 256 -> 512) 26.3 GFLOP over 154.7 MB (0.046 ms).
//
// What the design does about it. The TPU kernel streams K through one
// sequential accumulator in VMEM. On Hopper the K axis is split instead, and
// each piece is read from device memory once, with its loads kept in flight:
//   - bf16 and float16 (dw_1x1_kernel<T>, the same code on wgmma's .bf16
//     or .f16 kind): persistent warp-specialized blocks (flash_hopper.cuh:
//     a producer warpgroup that gives its registers to two consumer
//     warpgroups) walk the work items (K range, block tile); a block tile is
//     64 input by 256 output channels, each consumer warpgroup owning 128
//     output channels (m64 n128, 64 fp32 accumulators a thread). The items
//     of one K range are neighbours in the walk, so where there are several
//     block tiles (the shortcut: 4 x 2) their shared rows come from L2. The
//     producer streams a K range through a ring of as many stages as fit
//     (three of 112 rows at both ResNet-50 shapes) by TMA: a box of x's
//     rows (one 64-channel box) and up to four 64-channel boxes of dy's
//     same rows. Both operands
//     are MN-major (the channels are contiguous; the contraction runs over
//     the rows), so dw = x^T dy is one SS wgmma chain per stage with A
//     transposed. x is read in place through its tensor map: its rows are a
//     grid (N, H, W) with the view's strides, and a box is hb whole W-rows,
//     so the strided view of a stride-2 convolution needs no copy. A box's
//     W hb rows are padded to a multiple of 16 (wgmma's depth) with x rows
//     that are zeroed once; rows past the grid and channels past Cin or
//     Cout read as zeros, which add nothing.
//   - float32 (dw_1x1_partial_f32_kernel): the first version, a grid of
//     (Cout tiles, Cin tiles, K splits) blocks of four warps, each reducing
//     its rows into a 64 x 64 tile in registers by FMA, the next 64 rows
//     prefetched into registers.
// Each work item writes its fp32 tile to its own slice of a partial-sum
// buffer and a second kernel adds the partials in split order: no atomics,
// and the result is the same from run to run. It is a programmatic
// dependent launch, which the bf16 kernel lets go once its tiles are out,
// so its launch overlaps that kernel's last tiles. The wrapper
// (horovod_tpu_torch/ops/conv_backward.py) plans the geometry of x's rows
// and the split of K. Channel counts must be multiples of 8 (2-byte types) or
// 4 (float32) for 16-byte rows; the wrapper pads other counts with zero
// channels.
//
// C interface: the entry point launches on the given stream, does not
// synchronise, and returns the cudaError_t of the launches (0 on success),
// or HVD_ERR_TENSOR_MAP + the CUresult if a tensor map cannot be encoded.

#include "flash_hopper.cuh"

namespace {

// ===========================================================================
// bf16 and float16 on Hopper.
// ===========================================================================

constexpr int DW_CI = 64;    // input channels of a block tile: one box of x
constexpr int DW_CO = 256;   // output channels of a block tile: 128 per consumer warpgroup
constexpr int DW_MAX_STAGES = 8;

// A ring stage for boxes of `rows` rows (a multiple of 16): x's box, then
// dy's four boxes, each `rows` rows of 128 bytes.
__host__ __device__ constexpr int dw_stage_bytes(int rows) { return (1 + DW_CO / 64) * rows * 128; }

// Persistent: a grid of at most one block per SM walks the work items
// (split sp, block tile) with w = sp * tiles + tile. Split sp covers the
// boxes [sp * split, (sp + 1) * split) of x's row grid (Nd, Hd, Wd); box b
// is grid rows [h0, h0 + hb) of image n = b / hpb, h0 = (b % hpb) hb, and K
// rows from (n Hd + h0) Wd on. part: the item's fp32 tile goes to
// part + sp * Cin * Cout. The reduction of the partials is a programmatic
// dependent launch, let go once a block's tiles are out; it waits for this
// grid to finish.
template <typename T>
__global__ void __launch_bounds__(SM90_THREADS, 1)
dw_1x1_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dy,
              float* __restrict__ part, int Cin, int Cout, int Wd, int Hd, int hb, int rows,
              int nboxes, int split, int nsplit, int stages) {
  using FX = TileFormat<64>;   // x's box: 64 input channels
  using FY = TileFormat<128>;  // a consumer warpgroup's two boxes of dy
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int stage_bytes = dw_stage_bytes(rows);
  const uint32_t full_bar = base + stages * stage_bytes;  // stage s at + 8 s
  const uint32_t empty_bar = full_bar + 8 * stages;       // stage s at + 8 s
  const int co_tiles = (Cout + DW_CO - 1) / DW_CO;
  const int tiles = (Cin + DW_CI - 1) / DW_CI * co_tiles;
  const int nwork = nsplit * tiles;
  const int hpb = (Hd + hb - 1) / hb;  // boxes per image
  const int box_rows = Wd * hb;        // rows TMA writes; rows - box_rows are padding
  const int wg = threadIdx.x / WG;

  // x's padding rows of every stage are zero for good (TMA never writes them).
  for (int i = threadIdx.x; i < stages * (rows - box_rows) * 32; i += blockDim.x) {
    const int per = (rows - box_rows) * 32;  // words of one stage's padding
    st_shared_u32(base + (i / per) * stage_bytes + box_rows * 128 + (i % per) * 4, 0u);
  }
  fence_async_smem();
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMER_WGS) {
    // Producer, one thread: per work item its boxes of x and dy.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int kt = 0;  // stages loaded so far: the ring position
      for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
        const int sp = w / tiles, tile = w % tiles;
        const int ci0 = tile / co_tiles * DW_CI, co0 = tile % co_tiles * DW_CO;
        const int dy_boxes = min(DW_CO / 64, (Cout - co0 + 63) / 64);
        const int b1 = min(nboxes, (sp + 1) * split);
        for (int b = sp * split; b < b1; ++b, ++kt) {
          const int s = kt % stages;
          const uint32_t bar = full_bar + 8 * s;
          const uint32_t sX = base + s * stage_bytes;
          const int n = b / hpb, h0 = b % hpb * hb;
          mbar_wait(empty_bar + 8 * s, ((kt / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(bar, (box_rows + dy_boxes * rows) * 128);
          tma_load_4d(sX, &tm_x, bar, ci0, 0, h0, n);
          for (int j = 0; j < dy_boxes; ++j)
            tma_load_2d(sX + (1 + j) * rows * 128, &tm_dy, bar, co0 + 64 * j, (n * Hd + h0) * Wd);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: output channels [co0 + 128 wg, co0 + 128 wg + 128).
    // Where those lie past Cout, dy's boxes were not loaded and the
    // accumulators' columns hold no value; they are not written.
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // this thread's rows r, r + 8 of the 64
    int kt = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
      const int sp = w / tiles, tile = w % tiles;
      const int ci0 = tile / co_tiles * DW_CI, co0 = tile % co_tiles * DW_CO + 128 * wg;
      const int nb = min(nboxes, (sp + 1) * split) - sp * split;
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int i = 0; i < nb; ++i, ++kt) {
        const int s = kt % stages;
        const uint32_t sX = base + s * stage_bytes;
        const uint32_t sY = sX + (1 + 2 * wg) * rows * 128;
        mbar_wait(full_bar + 8 * s, (kt / stages) & 1);
        // acc += x^T dy over the stage's rows (SS, A and B MN-major).
        fence_regs(acc);
        wgmma_fence();
        for (int kk = 0; kk < rows / 16; ++kk)
          Wgmma<128, T>::template ss<1, 1>(acc, FX::mnmajor(sX, rows, kk),
                                           FY::mnmajor(sY, rows, kk));
        wgmma_commit();
        // The previous stage's products are done: its buffers go back
        // (with one stage, this stage's, once they are done).
        if (stages == 1) {
          wgmma_wait<0>();
        } else {
          wgmma_wait<1>();
          if (i == 0) continue;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * ((kt - (stages > 1)) % stages));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (nb > 0 && stages > 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * ((kt - 1) % stages));
      }
      // The tile into its split's slice, two columns per store.
      float* dst = part + (size_t)sp * Cin * Cout;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int ci = ci0 + r + 8 * ((i >> 1) & 1);
        const int co = co0 + 8 * (i >> 2) + 2 * tq;
        if (ci < Cin && co < Cout)
          *reinterpret_cast<float2*>(dst + (size_t)ci * Cout + co) = make_float2(acc[i], acc[i + 1]);
      }
    }
    // The reduction may launch now (sooner, its blocks would wait on SMs
    // this grid still streams through).
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  }
}

// ===========================================================================
// float32: the first version.
// ===========================================================================

constexpr int TC = 64;  // channels of an output tile, in Cin and in Cout
constexpr int TK = 64;  // rows of x and dy loaded per step
constexpr int DW_WARPS = 4;  // each owns 16 of the tile's input channels
constexpr int DW_THREADS = DW_WARPS * 32;
constexpr int LDC = TC + 4;  // fp32 staging of the output tile
constexpr int VEC = 4;  // floats per 16-byte load
constexpr int LD = TC + 8;  // operand row in shared memory
constexpr int PT = TK * (TC / VEC) / DW_THREADS;  // loads per operand per thread
constexpr size_t DW_SMEM = (size_t)2 * TK * LD * sizeof(float) > (size_t)TC * LDC * sizeof(float)
                               ? (size_t)2 * TK * LD * sizeof(float)
                               : (size_t)TC * LDC * sizeof(float);

static_assert(DW_WARPS * 16 == TC, "one 16-channel slice per warp");

// Element offset of row k of x, whose rows form the grid (N, H, W) with the
// given element strides.
__device__ __forceinline__ size_t row_offset(int k, int H, int W, long long sn, long long sh,
                                             long long sw) {
  const int n = k / (H * W);
  const int rem = k - n * H * W;
  const int h = rem / W;
  const int w = rem - h * W;
  return (size_t)(n * sn + h * sh + w * sw);
}

__global__ void __launch_bounds__(DW_THREADS)
dw_1x1_partial_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          float* __restrict__ part, int K, int Cin, int Cout, int rows_per_split,
                          int H, int W, long long sn, long long sh, long long sw) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem);
  T* sDY = sX + TK * LD;
  const int co0 = blockIdx.x * TC;
  const int ci0 = blockIdx.y * TC;
  const int kbeg = blockIdx.z * rows_per_split;
  const int kend = min(K, kbeg + rows_per_split);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  uint4 rx[PT], rdy[PT];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int idx = threadIdx.x + j * DW_THREADS;
      const int k = k0 + idx / (TC / VEC);
      const int c = (idx % (TC / VEC)) * VEC;
      rx[j] = make_uint4(0u, 0u, 0u, 0u);
      rdy[j] = make_uint4(0u, 0u, 0u, 0u);
      if (k < kend) {
        if (ci0 + c < Cin)
          rx[j] = *reinterpret_cast<const uint4*>(x + row_offset(k, H, W, sn, sh, sw) + ci0 + c);
        if (co0 + c < Cout)
          rdy[j] = *reinterpret_cast<const uint4*>(dy + (size_t)k * Cout + co0 + c);
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int idx = threadIdx.x + j * DW_THREADS;
      const int r = idx / (TC / VEC);
      const int c = (idx % (TC / VEC)) * VEC;
      *reinterpret_cast<uint4*>(sX + r * LD + c) = rx[j];
      *reinterpret_cast<uint4*>(sDY + r * LD + c) = rdy[j];
    }
  };

  RowAcc<float, TC> acc;
  acc.zero();
  if (kbeg < kend) fetch(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    stash();
    __syncthreads();
    if (k0 + TK < kend) fetch(k0 + TK);  // in flight while the warps multiply
    acc.template add_at_b<TK>(sX + warp * 16, LD, sDY, LD);
    __syncthreads();
  }

  float* st = reinterpret_cast<float*>(smem) + warp * 16 * LDC;
  acc.store(st, LDC);
  __syncwarp();
  float* out = part + (size_t)blockIdx.z * Cin * Cout;
  for (int e = lane; e < 16 * TC; e += 32) {
    const int ci = ci0 + warp * 16 + e / TC;
    const int co = co0 + e % TC;
    if (ci < Cin && co < Cout) out[(size_t)ci * Cout + co] = st[(e / TC) * LDC + e % TC];
  }
}

// out[i] = sum over splits of part[split][i], in split order. Launched as
// a programmatic dependent of the kernel that writes part: it waits here
// until that grid has finished and its writes are visible.
__global__ void dw_1x1_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int nsplit, size_t n) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < nsplit; ++p) s += part[(size_t)p * n + i];
    out[i] = s;
  }
}

template <typename T>
int launch_dw(const void* x, const void* dy, void* part, void* out, int K, int Cin, int Cout,
              int nsplit, int split, int hb, int rows, int Wd, int Hd, int Nd, long long sw,
              long long sh, long long sn, cudaStream_t stream) {
  if (K < 1 || Cin < 1 || Cout < 1 || Cin % (16 / (int)sizeof(T)) ||
      Cout % (16 / (int)sizeof(T)) || nsplit < 1 || Wd < 1 || Hd < 1 || Nd < 1 ||
      (long long)Wd * Hd * Nd != K)
    return cudaErrorInvalidValue;
  int err;
  if constexpr (!std::is_same<T, float>::value) {
    const int hpb = (Hd + hb - 1) / hb;
    const long long nboxes = (long long)hpb * Nd;
    if (hb < 1 || hb > 256 || Wd > 256 || rows % 16 || rows < Wd * hb || rows > 256 ||
        nboxes >= (1ll << 31) || (long long)nsplit * split < nboxes)
      return cudaErrorInvalidValue;
    // x: (Cin, Wd, Hd, Nd) with the view's strides, boxes of 64 channels by
    // hb whole W-rows; dy: (Cout, K), boxes of 64 channels by `rows` rows.
    CUtensorMap mx, mdy;
    const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)Wd, (cuuint64_t)Hd, (cuuint64_t)Nd};
    const cuuint64_t xstrides[3] = {(cuuint64_t)sw * sizeof(T), (cuuint64_t)sh * sizeof(T),
                                    (cuuint64_t)sn * sizeof(T)};
    const cuuint32_t xbox[4] = {64, (cuuint32_t)Wd, (cuuint32_t)hb, 1};
    const cuuint64_t ydims[2] = {(cuuint64_t)Cout, (cuuint64_t)K};
    const cuuint64_t ystrides[1] = {(cuuint64_t)Cout * sizeof(T)};
    const cuuint32_t ybox[2] = {64, (cuuint32_t)rows};
    if ((err = make_map<T>(&mx, x, 4, xdims, xstrides, xbox, 128)) ||
        (err = make_map<T>(&mdy, dy, 2, ydims, ystrides, ybox, 128)))
      return err;
    int stages = (int)((SMEM_LIMIT - 1024 - 16 * DW_MAX_STAGES) / dw_stage_bytes(rows));
    stages = stages < DW_MAX_STAGES ? stages : DW_MAX_STAGES;
    const size_t smem = (size_t)stages * dw_stage_bytes(rows) + 16 * stages + 1024;
    const int nwork = nsplit * ((Cin + DW_CI - 1) / DW_CI) * ((Cout + DW_CO - 1) / DW_CO);
    int sms = 0;
    if ((err = sm_count(&sms))) return err;
    err = launch(dw_1x1_kernel<T>, dim3(nwork < sms ? nwork : sms), SM90_THREADS, smem, stream, mx,
                 mdy, (float*)(nsplit == 1 ? out : part), Cin, Cout, Wd, Hd, hb, rows,
                 (int)nboxes, split, nsplit, stages);
  } else {
    if (nsplit > 65535 || (long long)nsplit * split < K) return cudaErrorInvalidValue;
    dim3 grid((Cout + TC - 1) / TC, (Cin + TC - 1) / TC, nsplit);
    dw_1x1_partial_f32_kernel<<<grid, DW_THREADS, DW_SMEM, stream>>>(
        (const float*)x, (const float*)dy, (float*)(nsplit == 1 ? out : part), K, Cin, Cout,
        split, Hd, Wd, sn, sh, sw);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || nsplit == 1) return err;
  const size_t n = (size_t)Cin * Cout;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dw_1x1_reduce_kernel, (const float*)part, (float*)out, nsplit, n);
}

}  // namespace

extern "C" {

int hvd_dw_1x1(const void* x, const void* dy, void* part, void* out, int K, int Cin, int Cout,
               int nsplit, int split, int hb, int rows, int Wd, int Hd, int Nd, long long sw,
               long long sh, long long sn, int dtype, void* stream) {
  if (dtype == DTYPE_BF16)
    return launch_dw<bf16>(x, dy, part, out, K, Cin, Cout, nsplit, split, hb, rows, Wd, Hd, Nd,
                           sw, sh, sn, (cudaStream_t)stream);
  if (dtype == DTYPE_F16)
    return launch_dw<f16>(x, dy, part, out, K, Cin, Cout, nsplit, split, hb, rows, Wd, Hd, Nd,
                          sw, sh, sn, (cudaStream_t)stream);
  if (dtype == DTYPE_F32)
    return launch_dw<float>(x, dy, part, out, K, Cin, Cout, nsplit, split, hb, rows, Wd, Hd, Nd,
                            sw, sh, sn, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
