// What the Hopper (sm_90a) flash-attention kernels of flash_attention.cu,
// flash_attention_single.cu, flash_attention_wide.cu and
// flash_attention_3xtf32.cu share: the warp-specialized block (two consumer
// warpgroups of 64 rows each, and a producer warpgroup that gives its
// registers to them), the softmax of a score tile on the consumers'
// accumulator registers, the epilogues that send a consumer's output tile
// out through shared memory by TMA or straight from registers, the tiles a
// row or key tile can see, the ring of TMA stages of the persistent
// kernels, and the launch of a grid.
//
// Everything sits in an anonymous namespace, as in flash_common.cuh.

#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "sm90.cuh"

// lse = LSE_MASKED for `rows` rows, queued on the stream: the library's
// one fill kernel (flash_attention.cu), which a forward with no key runs.
int fill_lse_masked(float* lse, long long rows, cudaStream_t stream);

namespace {

constexpr int WG = 128;            // threads of a warpgroup
constexpr int CONSUMER_WGS = 2;    // each owns 64 rows of the block's tile
constexpr int CONSUMER_WARPS = CONSUMER_WGS * 4;
constexpr int SM90_THREADS = (CONSUMER_WGS + 1) * WG;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 24 * 128 + 240 * 256 = 168 * 384
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Online softmax of one K tile on a consumer thread's registers: the scores
// sc (the m64 x BK accumulator) become P, as A fragments p of the 2-byte
// operand type T (bf16 or float16); the running max m (log2 units) and the
// partial row sums l move on, and corr is the factor that rescales the
// output accumulator of the thread's two rows (row0, row0 + 8). MASK: the
// tile holds keys past Sk or causally hidden keys for some of those rows.
// The scale folds into one FMA before exp2.
// With m = NEG_INF and l = 0 on entry it is the direct softmax of one tile.
template <typename T, int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(const float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             uint32_t (&p)[BK / 16][4], int row0, int k0, int Sk,
                                             float sl2, int causal, int q_offset, int k_offset,
                                             int tq) {
  auto hidden = [&](int i) {
    const int kj = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
    return kj >= Sk || (causal && q_offset + row0 + 8 * ((i >> 1) & 1) < k_offset + kj);
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    if (!MASK || !hidden(i)) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * sl2);  // m starts at NEG_INF (finite)
    corr[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    neg_m[h] = -m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r, h = r & 1;
      float e0 = exp2f(fmaf(sc[i], sl2, neg_m[h]));
      float e1 = exp2f(fmaf(sc[i + 1], sl2, neg_m[h]));
      if (MASK) {
        e0 = hidden(i) ? 0.f : e0;
        e1 = hidden(i + 1) ? 0.f : e1;
      }
      l[h] += e0 + e1;
      p[kk][r] = pack2<T>(e0, e1);
    }
}

// A consumer warpgroup's epilogue: its 64 x D accumulator acc (this thread
// holds rows r and r + 8 of the tile), row half h scaled by mul[h], goes in
// T into the warpgroup's output tile sO and leaves by one TMA store per
// box to rows [row_first, row_first + 64) of head bh; rows past the
// tensor's end are not written. The store runs on while the next work tile
// starts: the next call first waits until it has read sO.
template <typename T, int D>
__device__ __forceinline__ void store_out(const CUtensorMap* map, uint32_t sO,
                                          const float (&acc)[D / 2], const float (&mul)[2], int r,
                                          int tq, int tid, int wg, int row_first, int bh) {
  using F = TileFormat<D>;
  if (tid == 0) bulk_wait_read<0>();
  named_sync(1 + wg, WG);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      st_shared_u32(sO + F::offset(64, r + 8 * h, 8 * j + 2 * tq),
                    pack2<T>(acc[i] * mul[h], acc[i + 1] * mul[h]));
    }
  fence_async_smem();
  named_sync(1 + wg, WG);
  if (tid == 0) {
    for (int b = 0; b < F::NB; ++b)
      tma_store_3d(map, sO + b * 64 * F::ROW_BYTES, b * F::CB, row_first, bh);
    bulk_commit();
  }
}

// The epilogue of a tile too wide to stage in shared memory beside the
// operands (D = 256, and the wide-head kernels): a consumer's 64 x W
// accumulator acc (this thread holds rows row and row + 8 of the output),
// row half h scaled by mul[h], goes in T straight from registers to
// columns [0, ncols) of those rows of out, a row-major matrix of nrows rows
// with ld elements per row; rows past nrows and columns past ncols are not
// written. ncols and ld are multiples of 8, out 16-byte aligned. Each quad
// (the four threads of two rows) transposes its 4 x 4 words of a
// 32-column group by two rounds of shuffles, so that each thread stores 8
// contiguous columns of one row in one 16-byte store: a quarter of the
// store instructions of 4-byte stores, each filling whole 32-byte sectors
// (the D = 256 forward's epilogue was its largest cost with 4-byte stores;
// PERF.md).
template <typename T, int W>
__device__ __forceinline__ void store_rows(T* out, int ld, const float (&acc)[W / 2],
                                           const float (&mul)[2], int row, int nrows, int tq,
                                           int ncols = W) {
  const bool odd = tq & 1, high = tq & 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int g = 0; g < W / 32; ++g) {
      uint32_t w[4];  // w[x]: columns 8 (4 g + x) + 2 tq, + 1
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 4 * (4 * g + x) + 2 * h;
        w[x] = pack2<T>(acc[i] * mul[h], acc[i + 1] * mul[h]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {  // words whose column parity differs from the lane's
        const uint32_t r = __shfl_xor_sync(0xffffffffu, odd ? w[2 * k] : w[2 * k + 1], 1);
        if (odd) w[2 * k] = r; else w[2 * k + 1] = r;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {  // words whose column bit 1 differs from the lane's
        const uint32_t r = __shfl_xor_sync(0xffffffffu, high ? w[k] : w[k + 2], 2);
        if (high) w[k] = r; else w[k + 2] = r;
      }
      // w[x] is now quad thread x's word of column group 4 g + tq.
      if (row + 8 * h < nrows && 8 * (4 * g + tq) < ncols)
        *reinterpret_cast<uint4*>(out + (size_t)(row + 8 * h) * ld + 8 * (4 * g + tq)) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Rows of a work tile and of a streamed tile in the persistent kernels of
// flash_attention_wide.cu and flash_attention_3xtf32.cu.
constexpr int SEQ_TILE = 64;

// K/V tiles of BK keys that rows [q0, q0 + ROWS) of Q can see.
template <int ROWS = SEQ_TILE, int BK = SEQ_TILE>
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int causal, int qo, int ko) {
  const int n = (Sk + BK - 1) / BK;
  if (!causal) return n;
  const int kmax = qo + min(q0 + ROWS, Sq) - 1 - ko;  // last visible key
  if (kmax < 0) return 0;
  return min(n, kmax / BK + 1);
}

// First Q tile of SEQ_TILE rows whose rows can see a key of the K/V tile at
// k0.
__device__ __forceinline__ int first_query_tile(int k0, int causal, int qo, int ko) {
  if (!causal) return 0;
  const int qmin = ko + k0 - qo;  // first row that sees key k0
  return qmin <= 0 ? 0 : qmin / SEQ_TILE;
}

// A ring of stages of STAGE bytes that one producer thread fills by TMA and
// the CONSUMER_WARPS consumer warps read: item `it` sits in stage
// it % stages, at phase (it / stages) % 2.
template <int STAGE>
struct Ring {
  uint32_t base, full, empty;
  int stages;
  __device__ __forceinline__ uint32_t tile(int it) const {
    return base + (uint32_t)((it % stages) * STAGE);
  }
  __device__ __forceinline__ uint32_t bar(int it) const { return full + 8 * (it % stages); }
  // Consumer: wait until item `it` has landed; release it (every consumer
  // warp, once its reads are done).
  __device__ __forceinline__ void wait(int it) const {
    mbar_wait(bar(it), (it / stages) & 1);
  }
  __device__ __forceinline__ void release(int it, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % stages));
  }
  // Producer: wait until item `it`'s stage is free, expect `bytes` on its
  // full barrier (none: complete the phase at once), return the stage.
  __device__ __forceinline__ uint32_t fill(int it, uint32_t bytes) const {
    mbar_wait(empty + 8 * (it % stages), ((it / stages) & 1) ^ 1);
    if (bytes)
      mbar_arrive_expect_tx(bar(it), bytes);
    else
      mbar_arrive(bar(it));
    return tile(it);
  }
};

// The ring of `stages` stages at base, barriers at base + bar_offset, set
// up by thread 0 (the caller then syncs the block).
template <int STAGE>
__device__ __forceinline__ Ring<STAGE> make_ring(uint32_t base, int bar_offset, int stages) {
  const Ring<STAGE> ring{base, base + (uint32_t)bar_offset,
                         base + (uint32_t)bar_offset + 8u * stages, stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  return ring;
}

// Streaming multiprocessors of the current device: the grid of a persistent
// kernel.
int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// The calls with nothing to compute (no head, no query or no key), which
// every launcher takes as the plain versions do, before it builds a tensor
// map (a tensor map cannot have an empty dim): a forward writes O = 0 and
// lse = LSE_MASKED for the rows there are, dQ is 0 and dK, dV are 0 (none
// of them for a dim that is 0). Zeros are memsets of `bytes` at each
// output given; each returns the cudaError_t of what it queued.
inline int zero_fill(cudaStream_t stream, size_t bytes, void* a, void* b = nullptr) {
  cudaError_t err = cudaSuccess;
  if (bytes) err = cudaMemsetAsync(a, 0, bytes, stream);
  if (bytes && b && err == cudaSuccess) err = cudaMemsetAsync(b, 0, bytes, stream);
  return err;
}

inline int fwd_empty(void* o, size_t o_bytes, void* lse, long long rows, cudaStream_t stream) {
  const int err = zero_fill(stream, o_bytes, o);
  return err || !rows ? err : fill_lse_masked((float*)lse, rows, stream);
}

// Allow `smem` bytes of dynamic shared memory for `kernel`, then launch it.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
