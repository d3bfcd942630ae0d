// Filter gradient of a 1x1 convolution for Hopper (sm_90a):
//   dw[Cin, Cout] (fp32) = sum over k of x[k, Cin]^T dy[k, Cout], K = N*H*W.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/conv_backward.py:_dw_kernel
// (:43), launched by dw_1x1 (:57) from conv1x1's backward (:119).
//
// What bounds it, against the H100 SXM data-sheet peaks (989 TFLOP/s bf16,
// 3.35 TB/s, at its 700 W limit): every row of x and dy is read once and the
// output is tiny, so at the ResNet-50 shapes it is bound by bytes: the
// stage-1 bottleneck (401,408 rows, 64 -> 256, bf16) does 13.15 GFLOP over
// 256.9 MB (0.0767 ms); the stride-2 projection shortcut (100,352 rows,
// 256 -> 512) 26.3 GFLOP over 154.7 MB (0.046 ms).
//
// What the design does about it: the TPU kernel streams K through one
// sequential accumulator in VMEM. On Hopper the K axis is split instead: the
// grid is (Cout tiles, Cin tiles, K splits); each block reduces its own range
// of rows into a 64 x 64 fp32 tile held in registers (four warps of 16 input
// channels, WMMA bf16 16x16x16 fragments or FMA for float32), prefetching the
// next 64 rows into registers while the tensor cores work on the current
// ones, and writes the tile to its own slice of a partial-sum buffer. A second
// kernel adds the partials in split order: no atomics, and the result is the
// same from run to run. The wrapper picks the number of splits so that about
// four blocks run per SM; the partials add 2 x splits x Cin x Cout x 4 bytes
// of traffic. The ragged K edge and channel counts that are not multiples of
// 64 are masked in the kernel (nothing is padded or copied), and x is read
// through its (N, H, W) strides, so the strided view of a stride-2
// convolution needs no contiguous copy. Channel counts must be multiples of
// 8 (bf16) or 4 (float32) for the 16-byte loads.
//
// C interface: the entry point launches on the given stream, does not
// synchronise, and returns the cudaError_t of the launches (0 on success).

#include "flash_common.cuh"

namespace {

constexpr int TC = 64;  // channels of an output tile, in Cin and in Cout
constexpr int TK = 64;  // rows of x and dy loaded per step
constexpr int DW_WARPS = 4;  // each owns 16 of the tile's input channels
constexpr int DW_THREADS = DW_WARPS * 32;
constexpr int LDC = TC + 4;  // fp32 staging of the output tile

static_assert(DW_WARPS * 16 == TC, "one 16-channel slice per warp");

template <typename T>
struct DwTile {
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte load
  static constexpr int LD = TC + 32 / (int)sizeof(T);  // operand row in shared memory
  static constexpr int PT = TK * (TC / VEC) / DW_THREADS;  // loads per operand per thread
  static constexpr size_t OPERANDS = (size_t)2 * TK * LD * sizeof(T);
  static constexpr size_t STAGING = (size_t)TC * LDC * sizeof(float);
  static constexpr size_t SMEM = OPERANDS > STAGING ? OPERANDS : STAGING;
};

// Element offset of row k of x, an [N, H, W, C] view with the given strides.
__device__ __forceinline__ size_t row_offset(int k, int H, int W, long long sn, long long sh,
                                             long long sw) {
  const int n = k / (H * W);
  const int rem = k - n * H * W;
  const int h = rem / W;
  const int w = rem - h * W;
  return (size_t)(n * sn + h * sh + w * sw);
}

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
dw_1x1_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ part,
                      int K, int Cin, int Cout, int rows_per_split, int H, int W, long long sn,
                      long long sh, long long sw) {
  using L = DwTile<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem);
  T* sDY = sX + TK * L::LD;

  const int co0 = blockIdx.x * TC;
  const int ci0 = blockIdx.y * TC;
  const int kbeg = blockIdx.z * rows_per_split;
  const int kend = min(K, kbeg + rows_per_split);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  uint4 rx[L::PT], rdy[L::PT];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < L::PT; ++j) {
      const int idx = threadIdx.x + j * DW_THREADS;
      const int k = k0 + idx / (TC / L::VEC);
      const int c = (idx % (TC / L::VEC)) * L::VEC;
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
    for (int j = 0; j < L::PT; ++j) {
      const int idx = threadIdx.x + j * DW_THREADS;
      const int r = idx / (TC / L::VEC);
      const int c = (idx % (TC / L::VEC)) * L::VEC;
      *reinterpret_cast<uint4*>(sX + r * L::LD + c) = rx[j];
      *reinterpret_cast<uint4*>(sDY + r * L::LD + c) = rdy[j];
    }
  };

  RowAcc<T, TC> acc;
  acc.zero();
  if (kbeg < kend) fetch(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    stash();
    __syncthreads();
    if (k0 + TK < kend) fetch(k0 + TK);  // in flight while the warps multiply
    acc.template add_at_b<TK>(sX + warp * 16, L::LD, sDY, L::LD);
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

// out[i] = sum over splits of part[split][i], in split order.
__global__ void dw_1x1_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int nsplit, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < nsplit; ++p) s += part[(size_t)p * n + i];
    out[i] = s;
  }
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* dy, void* part, void* out, int K, int Cin,
                      int Cout, int nsplit, int rows_per_split, int H, int W, long long sn,
                      long long sh, long long sw, cudaStream_t stream) {
  using L = DwTile<T>;
  static_assert(L::SMEM <= 48 * 1024, "fits the default dynamic shared memory");
  if (K < 1 || Cin < 1 || Cout < 1 || Cin % L::VEC || Cout % L::VEC || nsplit < 1 ||
      nsplit > 65535 || (long long)nsplit * rows_per_split < K || H * W < 1)
    return cudaErrorInvalidValue;
  dim3 grid((Cout + TC - 1) / TC, (Cin + TC - 1) / TC, nsplit);
  dw_1x1_partial_kernel<T><<<grid, DW_THREADS, L::SMEM, stream>>>(
      (const T*)x, (const T*)dy, (float*)(nsplit == 1 ? out : part), K, Cin, Cout,
      rows_per_split, H, W, sn, sh, sw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const size_t n = (size_t)Cin * Cout;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  dw_1x1_reduce_kernel<<<blocks, 256, 0, stream>>>((const float*)part, (float*)out, nsplit, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int hvd_dw_1x1(const void* x, const void* dy, void* part, void* out, int K, int Cin, int Cout,
               int nsplit, int rows_per_split, int H, int W, long long sn, long long sh,
               long long sw, int dtype, void* stream) {
  if (dtype == DTYPE_BF16)
    return (int)launch_dw<bf16>(x, dy, part, out, K, Cin, Cout, nsplit, rows_per_split, H, W, sn,
                                sh, sw, (cudaStream_t)stream);
  if (dtype == DTYPE_F32)
    return (int)launch_dw<float>(x, dy, part, out, K, Cin, Cout, nsplit, rows_per_split, H, W,
                                 sn, sh, sw, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
