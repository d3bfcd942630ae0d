// Filter gradient of a 1x1 convolution for Hopper (sm_90a):
//   dw[Cin, Cout] (fp32) = sum over k of x[k, Cin]^T dy[k, Cout], K = N*H*W.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/conv_backward.py:_dw_kernel
// (:43), launched by dw_1x1 (:57) from conv1x1's backward (:119):
//   dw_1x1_kernel (bf16 and float16), dw_1x1_3xtf32_kernel (float32), each
//   with dw_1x1_reduce_kernel.
//
// What bounds it, against the H100 SXM data-sheet peaks (989 TFLOP/s bf16,
// 495 TFLOP/s TF32, 3.35 TB/s, at its 700 W limit): every row of x and dy
// is read once and the output is tiny, so at the ResNet-50 shapes it is
// bound by bytes: the stage-1 bottleneck (401,408 rows, 64 -> 256, bf16)
// does 13.15 GFLOP over 256.9 MB (0.0767 ms); the stride-2 projection
// shortcut (100,352 rows, 256 -> 512) 26.3 GFLOP over 154.7 MB (0.046 ms).
// In float32 the bytes double (513.9 MB at stage 1: 0.1534 ms), and the
// FMA units' 67 TFLOP/s (0.1963 ms) would be the bound: only the tensor
// cores, in 3xTF32 (39.45 GFLOP of TF32, 0.0797 ms), leave it bound by
// bytes. The shortcut in float32: 308.8 MB (0.0922 ms) and 78.9 GFLOP of
// TF32 (0.1595 ms): bound by operations.
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
//   - float32 (dw_1x1_3xtf32_kernel): the same walk, ring and block tile,
//     in boxes of 32 channels (a 128-byte row of fp32: x's two boxes and
//     dy's eight a stage; three stages of 56 rows at both ResNet-50 shapes),
//     each consumer warp summing the 64 x 32 tile of its dy box on mma.sync
//     m16n8k8 in 3xTF32 (tf32x3.cuh): each fp32 value split into TF32 hi
//     and lo in registers, three TF32 products, and each stage's sum started
//     from zero and added in fp32, since the tensor cores truncate the sums
//     they form. wgmma's TF32 takes K-major operands only, and both of these
//     are MN-major; mma.sync reads them with 4-byte loads as they lie.
//     Boxes are padded to a multiple of 8 rows (mma.sync's depth), and a
//     grid row wider than a box is read in pieces.
// Each work item writes its fp32 tile to its own slice of a partial-sum
// buffer and a second kernel adds the partials in split order: no atomics,
// and the result is the same from run to run. It is a programmatic
// dependent launch, which both kernels let go once their tiles are out,
// so its launch overlaps their last tiles. The wrapper
// (horovod_tpu_torch/ops/conv_backward.py) plans the geometry of x's rows,
// the boxes and the split of K. Channel counts must be multiples of 8
// (2-byte types) or 4 (float32) for 16-byte rows; the wrapper pads other
// counts with zero channels.
//
// C interface: the entry point launches on the given stream, does not
// synchronise, and returns the cudaError_t of the launches (0 on success),
// or HVD_ERR_TENSOR_MAP + the CUresult if a tensor map cannot be encoded.

#include "flash_hopper.cuh"
#include "tf32x3.cuh"

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
// float32 on Hopper's tensor cores, in 3xTF32.
// ===========================================================================

constexpr int DW_XB = DW_CI / X_BOX;  // x's boxes of a block tile: 2
constexpr int DW_YB = DW_CO / X_BOX;  // dy's boxes of a block tile: 8, one per consumer warp
static_assert(DW_YB == CONSUMER_WARPS, "one 32-channel box of dy per consumer warp");

// A ring stage of the float32 kernel for boxes of `rows` rows (a multiple
// of 8): x's two boxes, then dy's eight, each `rows` rows of 128 bytes.
__host__ __device__ constexpr int dw_f32_stage_bytes(int rows) {
  return (DW_XB + DW_YB) * rows * 128;
}

// The float32 kernel: dw_1x1_kernel's walk and ring (persistent blocks, a
// producer warp, the work items (split sp, block tile) in the same order,
// partials in split order), with boxes of 32 channels (128-byte rows of
// fp32) and the products on mma.sync m16n8k8 in 3xTF32. A box is hb whole
// grid rows of x (Wd hb rows of K) or, where one grid row is wider than
// `rows` (hb = 1), one of np pieces of wb of its Wd rows (launch_dw's
// geometry); x's rows past the grid (or the piece's W) read as zeros,
// beside the dy rows that follow, and its rows past the box up to `rows`
// are zeroed once (per_split: boxes of a split, the other kernel's split).
// Consumer warp cw (of eight) sums x^T dy for all 64
// input channels of the block tile by dy's box cw (32 output channels):
// 16 accumulator tiles of 16 x 8, 64 registers. Both operands are MN-major
// (the contraction runs over a box's rows): a k-step of 8 rows takes its
// k = t and t + 4 from rows 2 t and 2 t + 1, so that every fragment is a
// 4-byte load whose 32 lanes fall on 32 distinct banks of the swizzle, and
// is split into hi and lo in registers. The tensor cores truncate each sum
// they form, so each stage's product sums from zero (64 more registers) and
// is added to the running sum in fp32.
__global__ void __launch_bounds__(SM90_THREADS, 1)
dw_1x1_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_dy, float* __restrict__ part, int Cin,
                     int Cout, int Wd, int Hd, int hb, int np, int wb, int rows, int nboxes,
                     int per_split, int nsplit, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int stage_bytes = dw_f32_stage_bytes(rows);
  const uint32_t full_bar = base + stages * stage_bytes;  // stage s at + 8 s
  const uint32_t empty_bar = full_bar + 8 * stages;       // stage s at + 8 s
  const int co_tiles = (Cout + DW_CO - 1) / DW_CO;
  const int tiles = (Cin + DW_CI - 1) / DW_CI * co_tiles;
  const int nwork = nsplit * tiles;
  const int bpi = (Hd + hb - 1) / hb * np;  // boxes per image
  const int box_rows = wb * hb;  // rows TMA writes; rows - box_rows are padding
  const int wg = threadIdx.x / WG;

  // x's padding rows of every stage are zero for good (TMA never writes them).
  const int pad = (rows - box_rows) * 32;  // words of one x box's padding
  for (int i = threadIdx.x; i < stages * DW_XB * pad; i += blockDim.x) {
    const int box = i / pad;  // stage box / DW_XB, x box box % DW_XB
    st_shared_u32(base + box / DW_XB * stage_bytes + (box % DW_XB * rows + box_rows) * 128 +
                      i % pad * 4,
                  0u);
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
    // Producer, one thread: per box its x boxes and dy boxes that start
    // inside Cin and Cout (the rest are not loaded and never read).
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WGS * WG) {
      int kt = 0;  // stages loaded so far: the ring position
      for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
        const int sp = w / tiles, tile = w % tiles;
        const int ci0 = tile / co_tiles * DW_CI, co0 = tile % co_tiles * DW_CO;
        const int x_boxes = min(DW_XB, (Cin - ci0 + X_BOX - 1) / X_BOX);
        const int dy_boxes = min(DW_YB, (Cout - co0 + X_BOX - 1) / X_BOX);
        const int b1 = min(nboxes, (sp + 1) * per_split);
        for (int b = sp * per_split; b < b1; ++b, ++kt) {
          const int s = kt % stages;
          const uint32_t bar = full_bar + 8 * s;
          const uint32_t sX = base + s * stage_bytes;
          const int n = b / bpi, rem = b % bpi;
          const int h0 = rem / np * hb, w0 = rem % np * wb;
          mbar_wait(empty_bar + 8 * s, ((kt / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(bar, (x_boxes * box_rows + dy_boxes * rows) * 128);
#pragma unroll 1
          for (int c = 0; c < x_boxes; ++c)
            tma_load_4d(sX + c * rows * 128, &tm_x, bar, ci0 + X_BOX * c, w0, h0, n);
#pragma unroll 1
          for (int j = 0; j < dy_boxes; ++j)
            tma_load_2d(sX + (DW_XB + j) * rows * 128, &tm_dy, bar, co0 + X_BOX * j,
                        (n * Hd + h0) * Wd + w0);
        }
      }
    }
  } else {
    // Consumer warp cw: output channels [co0 + 32 cw, + 32) by the tile's
    // input channels. A warp whose channels start past Cout, and the input
    // channel tiles past Cin, only wait and release.
    reg_alloc<CONSUMER_REGS>();
    const int cw = threadIdx.x / 32;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    int kt = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
      const int sp = w / tiles, tile = w % tiles;
      const int ci0 = tile / co_tiles * DW_CI, co0 = tile % co_tiles * DW_CO + X_BOX * cw;
      const int mtiles = co0 < Cout ? min(DW_CI / 16, (Cin - ci0 + 15) / 16) : 0;
      const int nb = min(nboxes, (sp + 1) * per_split) - sp * per_split;
      float acc[64];  // acc[16 mt + 4 nt + x]: m-tile mt (16 input channels), n-tile nt (8 output)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int i = 0; i < nb; ++i, ++kt) {
        const int s = kt % stages;
        const uint32_t sX = base + s * stage_bytes;
        const uint32_t sY = sX + (DW_XB + cw) * rows * 128;
        mbar_wait(full_bar + 8 * s, (kt / stages) & 1);
        float sum[64];  // this stage's product, from zero
#pragma unroll
        for (int j = 0; j < 64; ++j) sum[j] = 0.f;
        if (mtiles > 0) {
#pragma unroll 1
          for (int r0 = 0; r0 < rows; r0 += 8) {
            const int ra = r0 + 2 * t, rb = ra + 1;  // the k-step's k = t and t + 4
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              split(lds_u32(sY + box_at(ra, 8 * nt + g)), bh[nt][0], bl[nt][0]);
              split(lds_u32(sY + box_at(rb, 8 * nt + g)), bh[nt][1], bl[nt][1]);
            }
#pragma unroll
            for (int mt = 0; mt < DW_CI / 16; ++mt) {
              if (mt >= mtiles) break;
              const uint32_t xb = sX + (mt >> 1) * rows * 128;
              const int c = 16 * (mt & 1) + g;
              const uint32_t x[4] = {lds_u32(xb + box_at(ra, c)), lds_u32(xb + box_at(ra, c + 8)),
                                     lds_u32(xb + box_at(rb, c)), lds_u32(xb + box_at(rb, c + 8))};
              uint32_t ah[4], al[4];
              split(x, ah, al);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_3xtf32(sum + 16 * mt + 4 * nt, ah, al, bh[nt][0], bh[nt][1], bl[nt][0],
                           bl[nt][1]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] += sum[j];
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * s);
      }
      // The tile into its split's slice, two columns per store.
      float* dst = part + (size_t)sp * Cin * Cout;
#pragma unroll
      for (int mt = 0; mt < DW_CI / 16; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ci = ci0 + 16 * mt + g + 8 * h, co = co0 + 8 * nt + 2 * t;
            if (mt < mtiles && ci < Cin && co < Cout)
              *reinterpret_cast<float2*>(dst + (size_t)ci * Cout + co) =
                  make_float2(acc[16 * mt + 4 * nt + 2 * h], acc[16 * mt + 4 * nt + 2 * h + 1]);
          }
    }
    // The reduction may launch now (sooner, its blocks would wait on SMs
    // this grid still streams through).
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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
  // A box: BOX channels (128-byte rows) by hb whole grid rows, or in float32
  // (hb = 1) by one of np pieces of wb rows of a grid row wider than `rows`;
  // `rows` a multiple of the product's depth (wgmma's 16, mma.sync's 8).
  // This is the one place the C side derives the pieces; the wrapper's plan
  // (conv_backward.box_pieces) must give the same boxes, and its split of
  // them is checked to cover them with no empty split.
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int BOX = 128 / (int)sizeof(T);
  constexpr int DEPTH = F32 ? 8 : 16;
  if (hb < 1 || hb > 256 || Wd > 256 || rows < 1 || rows % DEPTH || rows > 256)
    return cudaErrorInvalidValue;
  const int np = Wd * hb > rows ? (Wd + rows - 1) / rows : 1;
  const int wb = (Wd + np - 1) / np;
  const long long nboxes = (long long)((Hd + hb - 1) / hb) * np * Nd;
  if ((np > 1 && (!F32 || hb > 1)) || nboxes >= (1ll << 31) ||
      (long long)nsplit * split < nboxes || (long long)(nsplit - 1) * split >= nboxes)
    return cudaErrorInvalidValue;
  const int stage_bytes = F32 ? dw_f32_stage_bytes(rows) : dw_stage_bytes(rows);
  int stages = (int)((SMEM_LIMIT - 1024 - 16 * DW_MAX_STAGES) / stage_bytes);
  stages = stages < DW_MAX_STAGES ? stages : DW_MAX_STAGES;
  if (stages < 1) return cudaErrorInvalidValue;
  // x: (Cin, Wd, Hd, Nd) with the view's strides, boxes of BOX channels by
  // wb x hb grid rows; dy: (Cout, K), boxes of BOX channels by `rows` rows.
  int err;
  CUtensorMap mx, mdy;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)Wd, (cuuint64_t)Hd, (cuuint64_t)Nd};
  const cuuint64_t xstrides[3] = {(cuuint64_t)sw * sizeof(T), (cuuint64_t)sh * sizeof(T),
                                  (cuuint64_t)sn * sizeof(T)};
  const cuuint32_t xbox[4] = {(cuuint32_t)BOX, (cuuint32_t)wb, (cuuint32_t)hb, 1};
  const cuuint64_t ydims[2] = {(cuuint64_t)Cout, (cuuint64_t)K};
  const cuuint64_t ystrides[1] = {(cuuint64_t)Cout * sizeof(T)};
  const cuuint32_t ybox[2] = {(cuuint32_t)BOX, (cuuint32_t)rows};
  if ((err = make_map<T>(&mx, x, 4, xdims, xstrides, xbox, 128)) ||
      (err = make_map<T>(&mdy, dy, 2, ydims, ystrides, ybox, 128)))
    return err;
  const size_t smem = (size_t)stages * stage_bytes + 16 * stages + 1024;
  const int nwork = nsplit * ((Cin + DW_CI - 1) / DW_CI) * ((Cout + DW_CO - 1) / DW_CO);
  int sms = 0;
  if ((err = sm_count(&sms))) return err;
  const dim3 grid(nwork < sms ? nwork : sms);
  float* const dst = (float*)(nsplit == 1 ? out : part);
  if constexpr (F32)
    err = launch(dw_1x1_3xtf32_kernel, grid, SM90_THREADS, smem, stream, mx, mdy, dst, Cin, Cout,
                 Wd, Hd, hb, np, wb, rows, (int)nboxes, split, nsplit, stages);
  else
    err = launch(dw_1x1_kernel<T>, grid, SM90_THREADS, smem, stream, mx, mdy, dst, Cin, Cout, Wd,
                 Hd, hb, rows, (int)nboxes, split, nsplit, stages);
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
